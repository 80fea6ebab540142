"""Client library of the port (copies of ``fluvio_tpu/client``):
`Fluvio.connect` to an SC (metadata mirror, leader routing, `admin()`,
`topic_producer`, `consumer`) or to a lone SPU; `FluvioAdmin`;
`TopicProducer` and its `ProducerConfig`; `PartitionConsumer`,
`MultiplePartitionConsumer` and its `PartitionSelectionStrategy`, their
`Offset` and `ConsumerConfig`. The profile config and TLS are not
ported."""

from fluvio_tpu_torch.client.admin import AdminError, FluvioAdmin
from fluvio_tpu_torch.client.consumer import (
    ConsumerConfig,
    ConsumerRecord,
    MultiplePartitionConsumer,
    PartitionConsumer,
    PartitionSelectionStrategy,
)
from fluvio_tpu_torch.client.fluvio import Fluvio
from fluvio_tpu_torch.client.offset import Offset
from fluvio_tpu_torch.client.producer import (
    ProducerConfig,
    RecordMetadata,
    RetryPolicy,
    TopicProducer,
)

__all__ = [
    "AdminError",
    "ConsumerConfig",
    "ConsumerRecord",
    "Fluvio",
    "FluvioAdmin",
    "MultiplePartitionConsumer",
    "Offset",
    "PartitionConsumer",
    "PartitionSelectionStrategy",
    "ProducerConfig",
    "RecordMetadata",
    "RetryPolicy",
    "TopicProducer",
]
