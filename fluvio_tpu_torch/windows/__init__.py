"""Device-resident windowed state with delta-only emission.

The port's counterpart of ``fluvio_tpu/windows``: tumbling/sliding windows
and per-key segmented state computed by one torch update per batch, with
the inter-batch carry (the state bank: (id, acc, count) rows + watermark)
resident on the device across batches and only the per-batch DELTA
(closed windows and touched entries) crossing the link down. Broker-side,
`MaterializedView` folds deltas into a queryable table; full-state images
ship only on attach/seed/migration.

- `spec`      — WindowSpec geometry and capacities
- `kernels`   — the update and merge as torch code (`WindowEagerOps`)
- `state`     — WindowStateBank (the device carry) + shard merge
- `engine`    — the WindowedRuntime / PartitionedWindowRuntime runtimes
- `views`     — MaterializedView (the broker read surface)
- `reference` — host-truth oracle for exactness pins
"""

from fluvio_tpu_torch.windows.engine import (
    PartitionedWindowRuntime,
    WindowDelta,
    WindowedRuntime,
)
from fluvio_tpu_torch.windows.kernels import WindowEagerOps
from fluvio_tpu_torch.windows.reference import HostWindowReference
from fluvio_tpu_torch.windows.spec import (
    WindowCapacityError,
    WindowSpec,
    delta_enabled,
)
from fluvio_tpu_torch.windows.state import WindowStateBank, merge_banks
from fluvio_tpu_torch.windows.views import MaterializedView

__all__ = [
    "HostWindowReference",
    "MaterializedView",
    "PartitionedWindowRuntime",
    "WindowCapacityError",
    "WindowDelta",
    "WindowEagerOps",
    "WindowSpec",
    "WindowStateBank",
    "WindowedRuntime",
    "delta_enabled",
    "merge_banks",
]
