"""SmartModule definition and source artifacts.

The port's counterpart of ``fluvio_tpu/smartmodule/sdk.py``: a
`SmartModuleDef` holds a module's hooks and DSL programs by kind, and
`load_source` builds one from SmartModule source text, the payload an
AdHoc invocation carries. The source runs with the port's ``dsl`` and
``smartmodule`` namespaces bound; each decorator records its Python
function as the module's hook of that kind (``hooks``) and its ``dsl=``
program, when given, beside it (``dsl``). The engine runs a transform
that carries a DSL program on the card and one that carries none as a
host hook (`smartengine.hooks`); ``@smartmodule.init`` and
``@smartmodule.look_back`` are hooks only, run on the host at chain
build and at a look-back. User function contracts (the Rust SDK's
signatures):

- ``@smartmodule.filter``      ``fn(record) -> bool``
- ``@smartmodule.map``         ``fn(record) -> bytes | (key, value)``
- ``@smartmodule.filter_map``  ``fn(record) -> None | bytes | (key, value)``
- ``@smartmodule.array_map``   ``fn(record) -> list[bytes | (key, value)]``
- ``@smartmodule.aggregate``   ``fn(acc: bytes, record) -> bytes``
- ``@smartmodule.init``        ``fn(params: dict) -> None``
- ``@smartmodule.look_back``   ``fn(record) -> None``

A source that imports the JAX
package (``from fluvio_tpu.smartmodule.sdk import smartmodule``, the form
the JAX package's own tests push) is refused at that import: the port
never imports that package. Sources in the namespace form, with no
import, load in both packages.
"""

from __future__ import annotations

import builtins
import hashlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from fluvio_tpu_torch.smartmodule import dsl as dsl_mod
from fluvio_tpu_torch.smartmodule.types import TRANSFORM_KIND_ORDER, SmartModuleKind


@dataclass
class SmartModuleDef:
    """A SmartModule: its Python hooks and its DSL programs, each keyed
    by kind (a transform may carry either or both)."""

    name: str = "adhoc"
    dsl: Dict[SmartModuleKind, Any] = field(default_factory=dict)
    hooks: Dict[SmartModuleKind, Callable] = field(default_factory=dict)
    # stable identity for the metering quarantine: the source's hash when
    # the module came from source bytes, else the name (adhoc names collide)
    meter_key: str = ""

    def transform_kind(self) -> SmartModuleKind:
        """Detect the module's transform kind in the engine's export
        probing order (filter -> map -> filter_map -> array_map ->
        aggregate)."""
        for kind in TRANSFORM_KIND_ORDER:
            if kind in self.hooks or kind in self.dsl:
                return kind
        raise ValueError(
            f"SmartModule {self.name!r} exports no transform "
            f"(expected one of filter/map/filter_map/array_map/aggregate)"
        )

    def hook(self, kind: SmartModuleKind) -> Optional[Callable]:
        return self.hooks.get(kind)

    def dsl_program(self, kind: SmartModuleKind):
        return self.dsl.get(kind)

    def has_init(self) -> bool:
        return SmartModuleKind.INIT in self.hooks

    def has_look_back(self) -> bool:
        return SmartModuleKind.LOOK_BACK in self.hooks


# the JAX package: the port's own package name without its ``_torch``
_JAX_PACKAGE = __name__.split(".")[0].removesuffix("_torch")


def _import_refusing_the_jax_package(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` for a source's namespace: the JAX package and its
    submodules raise ``ValueError``, every other import goes through."""
    if level == 0 and (name == _JAX_PACKAGE or name.startswith(_JAX_PACKAGE + ".")):
        raise ValueError(
            f"the source imports {name}, of the JAX package, which the port never imports: "
            "write it in the namespace form (`smartmodule`, `dsl`, no import)"
        )
    return builtins.__import__(name, globals, locals, fromlist, level)


_SOURCE_BUILTINS = {**vars(builtins), "__import__": _import_refusing_the_jax_package}

# the module a source load is assembling, per thread, so concurrent loads
# do not interleave
_BUILDING = threading.local()


def current_module(reset: bool = True) -> SmartModuleDef:
    """The module assembled by decorator use since the last call."""
    m = getattr(_BUILDING, "module", None)
    if m is None:
        m = SmartModuleDef()
    _BUILDING.module = None if reset else m
    return m


class _SmartModuleNamespace:
    """The ``smartmodule`` decorator namespace a source sees:
    ``@smartmodule.<kind>`` (or ``@smartmodule.<kind>(dsl=program)``) over
    the hook's function."""

    @staticmethod
    def _register(kind: SmartModuleKind, fn: Callable, program: Any) -> Callable:
        m = current_module(reset=False)
        if kind in m.hooks or kind in m.dsl:
            raise ValueError(f"duplicate #[smartmodule({kind.value})] export")
        m.hooks[kind] = fn
        if program is not None:
            m.dsl[kind] = program
        return fn

    def _make(self, kind: SmartModuleKind):
        def decorator(fn: Callable = None, *, dsl: Any = None):
            if fn is None:
                return lambda f: self._register(kind, f, dsl)
            return self._register(kind, fn, dsl)

        decorator.__name__ = kind.value
        return decorator

    def __init__(self) -> None:
        self.filter = self._make(SmartModuleKind.FILTER)
        self.map = self._make(SmartModuleKind.MAP)
        self.filter_map = self._make(SmartModuleKind.FILTER_MAP)
        self.array_map = self._make(SmartModuleKind.ARRAY_MAP)
        self.aggregate = self._make(SmartModuleKind.AGGREGATE)
        self.init = self._make(SmartModuleKind.INIT)
        self.look_back = self._make(SmartModuleKind.LOOK_BACK)


smartmodule = _SmartModuleNamespace()


def load_source(source, name: str = "adhoc") -> SmartModuleDef:
    """Build a SmartModule from its source text (str or UTF-8 bytes): the
    source runs in a fresh namespace holding the port's ``smartmodule``
    and ``dsl``, and the decorators it applies assemble the module.
    Raises ``ValueError`` when it exports no transform, or imports the
    JAX package."""
    if isinstance(source, bytes):
        source = source.decode("utf-8")
    current_module(reset=True)  # drop what an earlier failed load left
    namespace: Dict[str, Any] = {
        "smartmodule": smartmodule,
        "dsl": dsl_mod,
        "__name__": f"smartmodule_{name}",
        "__builtins__": _SOURCE_BUILTINS,
    }
    exec(compile(source, f"<smartmodule:{name}>", "exec"), namespace)
    module = current_module(reset=True)
    module.name = name
    module.meter_key = hashlib.sha256(source.encode("utf-8")).hexdigest()[:16]
    module.transform_kind()  # validate: must export a transform
    return module
