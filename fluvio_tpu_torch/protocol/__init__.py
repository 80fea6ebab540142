"""Wire protocol of the port: the versioned binary codec, records,
batches and record sets, compression codecs and error codes (copies of
``fluvio_tpu/protocol``'s host modules; the format is documented in
`record.py`)."""

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, DecodeError
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.protocol.record import Batch, BatchHeader, Record, RecordSet

__all__ = [
    "Batch",
    "BatchHeader",
    "ByteReader",
    "ByteWriter",
    "DecodeError",
    "ErrorCode",
    "FluvioError",
    "Record",
    "RecordSet",
]
