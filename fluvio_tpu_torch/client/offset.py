"""Consumer start position (the port's copy of ``fluvio_tpu/client/offset.py``;
parity: fluvio/src/offset.rs).

Absolute / from-beginning / from-end, resolved against the partition's
(start_offset, hw, leo) fetched with FetchOffsetsRequest.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from fluvio_tpu_torch.schema.spu import FetchOffsetsResponse, Isolation


class _Kind(enum.Enum):
    ABSOLUTE = "absolute"
    FROM_BEGINNING = "from_beginning"
    FROM_END = "from_end"


@dataclass(frozen=True)
class Offset:
    kind: _Kind
    inner: int

    @classmethod
    def absolute(cls, offset: int) -> "Offset":
        if offset < 0:
            raise ValueError("absolute offset must be >= 0")
        return cls(_Kind.ABSOLUTE, offset)

    @classmethod
    def beginning(cls) -> "Offset":
        return cls(_Kind.FROM_BEGINNING, 0)

    @classmethod
    def from_beginning(cls, delta: int) -> "Offset":
        return cls(_Kind.FROM_BEGINNING, delta)

    @classmethod
    def end(cls) -> "Offset":
        return cls(_Kind.FROM_END, 0)

    @classmethod
    def from_end(cls, delta: int) -> "Offset":
        return cls(_Kind.FROM_END, delta)

    def resolve(
        self,
        offsets: FetchOffsetsResponse,
        isolation: Isolation = Isolation.READ_UNCOMMITTED,
    ) -> int:
        end = offsets.hw if isolation == Isolation.READ_COMMITTED else offsets.leo
        if self.kind == _Kind.ABSOLUTE:
            return max(offsets.start_offset, min(self.inner, end))
        if self.kind == _Kind.FROM_BEGINNING:
            return min(offsets.start_offset + self.inner, end)
        return max(offsets.start_offset, end - self.inner)
