"""The SPU (broker) of the port: the public server (`server.SpuServer`,
`public_service`: produce, fetch, stream fetch and offsets over TCP), the
leader replicas over the log storage (`replica`), the global context and
the consume path, where stored batches run through a GPU chain and come
back as wire batches (`smart_chain`), the link to an SC (`sc_dispatcher`:
registration, replica and SmartModule pushes, offset reports), and
replication: the followers and their sync from the leader
(`follower`), the leader's side of it (`internal_service`), and the
retention cleaner's sweep (`cleaner_controller`)."""

from fluvio_tpu_torch.spu.cleaner_controller import CleanerController  # noqa: F401
from fluvio_tpu_torch.spu.config import SpuConfig  # noqa: F401
from fluvio_tpu_torch.spu.context import GlobalContext  # noqa: F401
from fluvio_tpu_torch.spu.follower import FollowerReplicaState, FollowersController  # noqa: F401
from fluvio_tpu_torch.spu.replica import LeaderReplicaState  # noqa: F401
from fluvio_tpu_torch.spu.server import SpuServer  # noqa: F401
