"""SC process assembly (the port's copy of ``fluvio_tpu/sc/start.py``;
parity: fluvio-sc/src/{start.rs:22-62,init.rs:22-108}).

Boot order follows the reference: controllers -> private server -> public
server. The metadata lives in memory; the reference's YAML and K8s
backends, its TLS endpoint and its read-only and role-based authorization
are not ported, so `ScConfig` holds the two listen addresses only.

    sc = ScServer(ScConfig())
    await sc.start()
    admin = await FluvioAdmin.connect(sc.public_addr)
    # SPUs dial sc.private_addr (SpuConfig.sc_addr)
    ...
    await sc.stop()
"""

from __future__ import annotations

from dataclasses import dataclass

from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.sc.controllers import (
    PartitionController,
    SpuController,
    TopicController,
)
from fluvio_tpu_torch.sc.services import ScPrivateService, ScPublicService
from fluvio_tpu_torch.transport.service import FluvioApiServer


@dataclass
class ScConfig:
    public_addr: str = "127.0.0.1:0"
    private_addr: str = "127.0.0.1:0"


class ScServer:
    def __init__(self, config: ScConfig = None):
        self.config = config or ScConfig()
        self.ctx = ScContext()
        self.topic_controller = TopicController(self.ctx)
        self.partition_controller = PartitionController(self.ctx)
        self.spu_controller = SpuController(self.ctx)
        self.public_server = FluvioApiServer(
            self.config.public_addr, ScPublicService(), self.ctx
        )
        self.private_server = FluvioApiServer(
            self.config.private_addr, ScPrivateService(), self.ctx
        )

    @property
    def public_addr(self) -> str:
        return self.public_server.local_addr

    @property
    def private_addr(self) -> str:
        return self.private_server.local_addr

    async def start(self) -> None:
        self.topic_controller.start()
        self.partition_controller.start()
        self.spu_controller.start()
        await self.private_server.start()
        await self.public_server.start()

    async def stop(self) -> None:
        await self.public_server.stop()
        await self.private_server.stop()
        await self.topic_controller.stop()
        await self.partition_controller.stop()
        await self.spu_controller.stop()
