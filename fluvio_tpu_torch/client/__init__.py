"""Client library of the port (copies of ``fluvio_tpu/client``'s consumer
side): `Fluvio.connect` to a lone SPU, `PartitionConsumer` and its
`Offset` and `ConsumerConfig`."""

from fluvio_tpu_torch.client.consumer import ConsumerConfig, ConsumerRecord, PartitionConsumer
from fluvio_tpu_torch.client.fluvio import Fluvio, ScEndpointUnsupported
from fluvio_tpu_torch.client.offset import Offset

__all__ = [
    "ConsumerConfig",
    "ConsumerRecord",
    "Fluvio",
    "Offset",
    "PartitionConsumer",
    "ScEndpointUnsupported",
]
