"""Spec/Status conventions + MetadataStoreObject (the port's copy of
``fluvio_tpu/stream_model/core.py``).

Capability parity: fluvio-stream-model/src/core.rs:12-200 — the `Spec`
(LABEL, IndexKey, child-spec links) and `Status` traits, and
`MetadataStoreObject{spec, status, key, ctx}`. Specs/statuses here are
dataclasses that serialize to/from plain dicts (the wire form);
`to_dict`/`from_dict` replace the reference's serde derive.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, Generic, Type, TypeVar


def _to_plain(value: Any) -> Any:
    """Dataclass/enum tree -> plain JSON/YAML-able structure."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_plain(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, bytes):
        import base64

        return {"__bytes__": base64.b64encode(value).decode()}
    if isinstance(value, dict):
        return {k: _to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    return value


def _from_plain(cls: Type, data: Any) -> Any:
    """Inverse of _to_plain for dataclass targets (best-effort typed)."""
    import typing

    if data is None:
        return None
    if isinstance(data, dict) and "__bytes__" in data:
        import base64

        return base64.b64decode(data["__bytes__"])
    if dataclasses.is_dataclass(cls):
        if hasattr(cls, "from_dict"):
            return cls.from_dict(data)
        kwargs = {}
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if not isinstance(data, dict) or f.name not in data:
                continue
            kwargs[f.name] = _coerce(hints.get(f.name, Any), data[f.name])
        return cls(**kwargs)
    return _coerce(cls, data)


def _coerce(hint: Any, value: Any) -> Any:
    import typing

    origin = typing.get_origin(hint)
    if value is None:
        return None
    if isinstance(value, dict) and "__bytes__" in value:
        import base64

        return base64.b64decode(value["__bytes__"])
    if origin is typing.Union:
        for arg in typing.get_args(hint):
            if arg is type(None):
                continue
            try:
                return _coerce(arg, value)
            except (TypeError, ValueError, KeyError):
                continue
        return value
    if origin in (list, tuple):
        (arg,) = typing.get_args(hint) or (Any,)
        out = [_coerce(arg, v) for v in value]
        return tuple(out) if origin is tuple else out
    if origin is dict:
        args = typing.get_args(hint)
        kt = args[0] if len(args) == 2 else Any
        vt = args[1] if len(args) == 2 else Any
        # JSON object keys are always strings; restore int-keyed maps
        def _key(k):
            return int(k) if kt is int and isinstance(k, str) else k

        return {_key(k): _coerce(vt, v) for k, v in value.items()}
    if isinstance(hint, type):
        if dataclasses.is_dataclass(hint):
            return _from_plain(hint, value)
        if issubclass(hint, enum.Enum):
            return hint(value)
        if hint is bytes and isinstance(value, str):
            return value.encode()
    return value


class Spec:
    """Base for object specs.

    Class attributes (parity: the Spec trait's consts):
    - ``LABEL``: human name, e.g. "Topic"
    - ``KIND``: store key, e.g. "topic" (used in files/wire)
    """

    LABEL: ClassVar[str] = "Spec"
    KIND: ClassVar[str] = "spec"
    STATUS: ClassVar[Type["Status"]]

    def to_dict(self) -> Dict[str, Any]:
        return _to_plain(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        return _from_plain_dataclass(cls, data)


class Status:
    """Base for object statuses."""

    def to_dict(self) -> Dict[str, Any]:
        return _to_plain(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        return _from_plain_dataclass(cls, data)


def _from_plain_dataclass(cls: Type, data: Dict[str, Any]):
    import typing

    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name in (data or {}):
            kwargs[f.name] = _coerce(hints.get(f.name, Any), data[f.name])
    return cls(**kwargs)


S = TypeVar("S", bound=Spec)


@dataclass
class MetadataStoreObject(Generic[S]):
    """One stored object: key + spec + status + revision.

    Parity: MetadataStoreObject in core.rs; `ctx.item().rev` maps to
    ``revision`` here (bumped by the store on every apply).
    """

    key: str
    spec: S
    status: Any = None
    revision: int = 0

    def __post_init__(self) -> None:
        if self.status is None and hasattr(type(self.spec), "STATUS"):
            self.status = type(self.spec).STATUS()

    def with_spec(self, spec: S) -> "MetadataStoreObject[S]":
        return MetadataStoreObject(
            key=self.key, spec=spec, status=self.status, revision=self.revision
        )

    def with_status(self, status: Any) -> "MetadataStoreObject[S]":
        return MetadataStoreObject(
            key=self.key, spec=self.spec, status=status, revision=self.revision
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "kind": type(self.spec).KIND,
            "revision": self.revision,
            "spec": _to_plain(self.spec),
            "status": _to_plain(self.status),
        }

    @classmethod
    def from_dict(
        cls, spec_type: Type[S], data: Dict[str, Any]
    ) -> "MetadataStoreObject[S]":
        spec = _from_plain_dataclass(spec_type, data.get("spec") or {})
        status_type = getattr(spec_type, "STATUS", None)
        status = (
            _from_plain_dataclass(status_type, data.get("status") or {})
            if status_type
            else None
        )
        return cls(
            key=data["key"],
            spec=spec,
            status=status,
            revision=int(data.get("revision", 0)),
        )
