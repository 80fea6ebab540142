"""Control-plane object model (the port's copy of ``fluvio_tpu/metadata``;
parity: `fluvio-controlplane-metadata`).

Topic / Partition / Spu / SpuGroup / SmartModule / TableFormat specs and
statuses, shared by the SC, the SPU's SC dispatcher and the admin client.
The metadata backends (a YAML directory, K8s) are not ported: the port's
SC keeps its metadata in memory.
"""

from fluvio_tpu_torch.metadata.topic import (  # noqa: F401
    CleanupPolicy,
    Deduplication,
    ReplicaSpec,
    TopicResolution,
    TopicSpec,
    TopicStatus,
)
from fluvio_tpu_torch.metadata.partition import (  # noqa: F401
    PartitionResolution,
    PartitionSpec,
    PartitionStatus,
    ReplicaStatus,
)
from fluvio_tpu_torch.metadata.spu import (  # noqa: F401
    Endpoint,
    SpuResolution,
    SpuSpec,
    SpuStatus,
)
from fluvio_tpu_torch.metadata.spg import SpuGroupSpec, SpuGroupStatus  # noqa: F401
from fluvio_tpu_torch.metadata.smartmodule import (  # noqa: F401
    SmartModuleArtifact,
    SmartModuleSpec,
    SmartModuleStatus,
)
from fluvio_tpu_torch.metadata.tableformat import (  # noqa: F401
    TableFormatSpec,
    TableFormatStatus,
)

ALL_SPECS = [
    TopicSpec,
    PartitionSpec,
    SpuSpec,
    SpuGroupSpec,
    SmartModuleSpec,
    TableFormatSpec,
]

SPEC_BY_KIND = {spec.KIND: spec for spec in ALL_SPECS}
