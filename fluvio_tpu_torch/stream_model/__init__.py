"""Metadata store core (the port's copy of ``fluvio_tpu/stream_model``;
parity: the `fluvio-stream-model` crate).

Epoch-versioned in-memory object stores with change fencing, the
substrate the SC's controllers and the client's metadata mirror sit on.
`LocalStore` holds `MetadataStoreObject`s (spec + status + key +
revision) in a `DualEpochMap` that stamps spec changes and status changes
with separate epochs, so a listener can ask "what changed since epoch E"
and get the spec and status deltas instead of a full resync.
"""

from fluvio_tpu_torch.stream_model.core import (  # noqa: F401
    MetadataStoreObject,
    Spec,
    Status,
)
from fluvio_tpu_torch.stream_model.epoch import DualEpochMap, EpochChanges  # noqa: F401
from fluvio_tpu_torch.stream_model.store import (  # noqa: F401
    ChangeListener,
    LocalStore,
    StoreContext,
)
