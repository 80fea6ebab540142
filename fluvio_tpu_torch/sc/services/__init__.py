from fluvio_tpu_torch.sc.services.public_service import ScPublicService
from fluvio_tpu_torch.sc.services.private_service import ScPrivateService

__all__ = ["ScPublicService", "ScPrivateService"]
