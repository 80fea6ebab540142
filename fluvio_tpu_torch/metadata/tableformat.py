"""TableFormat spec (parity: fluvio-controlplane-metadata/src/tableformat/
spec.rs:154): named column layouts the CLI's table output renders
JSON records with.

The port's copy of ``fluvio_tpu/metadata/tableformat.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, List, Optional

from fluvio_tpu_torch.stream_model.core import Spec, Status


@dataclass
class TableFormatColumnConfig:
    key_path: str = ""  # JSON pointer into the record value
    header: Optional[str] = None
    width: Optional[int] = None
    primary_key: bool = False
    display: bool = True


@dataclass
class TableFormatSpec(Spec):
    LABEL: ClassVar[str] = "TableFormat"
    KIND: ClassVar[str] = "tableformat"

    name: str = ""
    input_format: str = "JSON"
    columns: List[TableFormatColumnConfig] = field(default_factory=list)
    smartmodule: Optional[str] = None


@dataclass
class TableFormatStatus(Status):
    pass


TableFormatSpec.STATUS = TableFormatStatus
