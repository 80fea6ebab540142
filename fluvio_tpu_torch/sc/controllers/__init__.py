from fluvio_tpu_torch.sc.controllers.partitions import PartitionController
from fluvio_tpu_torch.sc.controllers.spus import SpuController
from fluvio_tpu_torch.sc.controllers.topics import TopicController, validate_topic_spec

__all__ = [
    "TopicController",
    "PartitionController",
    "SpuController",
    "validate_topic_spec",
]
