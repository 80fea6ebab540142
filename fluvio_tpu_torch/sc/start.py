"""SC process assembly (the port's copy of ``fluvio_tpu/sc/start.py``;
parity: fluvio-sc/src/{start.rs:22-62,init.rs:22-108}).

Boot order follows the reference: metadata dispatchers (with a
``metadata_dir``: every store resynced from it before any controller
runs) -> controllers -> private server -> public server. Run modes: in
memory, or local (one file an object under ``metadata_dir``, the port's
`metadata/client.py`; a directory the JAX package's SC wrote reads back,
and the other way round). ``tls`` puts TLS on the public endpoint (the
private one stays plaintext); ``read_only`` and ``auth_policy_path``
choose the admin API's authorization, the policy judging each
connection's client certificate (`auth.Identity.from_socket`). The K8s
run mode is not ported.

    sc = ScServer(ScConfig(metadata_dir=d))
    await sc.start()
    admin = await FluvioAdmin.connect(sc.public_addr)
    # SPUs dial sc.private_addr (SpuConfig.sc_addr)
    ...
    await sc.stop()
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from fluvio_tpu_torch.auth import (
    BasicAuthorization,
    BasicRbacPolicy,
    Identity,
    ReadOnlyAuthorization,
)
from fluvio_tpu_torch.metadata.client import LocalMetadataClient, MetadataClient
from fluvio_tpu_torch.metadata.dispatcher import MetadataDispatcher
from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.sc.controllers import (
    PartitionController,
    SpuController,
    TopicController,
)
from fluvio_tpu_torch.sc.services import ScPrivateService, ScPublicService
from fluvio_tpu_torch.transport.service import FluvioApiServer
from fluvio_tpu_torch.transport.tls import ServerTlsConfig, server_ssl


@dataclass
class ScConfig:
    public_addr: str = "127.0.0.1:0"
    private_addr: str = "127.0.0.1:0"
    # None = in-memory metadata; a directory = the local file backend
    metadata_dir: Optional[str] = None
    reconcile_interval: Optional[float] = None
    # admin API access control (parity: the SC's auth options): read_only
    # forces ReadOnlyAuthorization; auth_policy_path loads a BasicRbacPolicy
    # JSON file; default is allow-all RootAuthorization
    read_only: bool = False
    auth_policy_path: Optional[str] = None
    # public-endpoint TLS; client certificates feed the x509 identity
    tls: ServerTlsConfig = field(default_factory=ServerTlsConfig)


class ScServer:
    def __init__(self, config: ScConfig = None, authorization=None):
        self.config = config or ScConfig()
        if authorization is None:
            if self.config.read_only:
                authorization = ReadOnlyAuthorization()
            elif self.config.auth_policy_path:
                # the policy judges each connection's x509 identity (its
                # client certificate; anonymous without one). The JAX
                # package's SC passes no authenticator here, so its policy
                # sees every connection as anonymous
                authorization = BasicAuthorization(
                    BasicRbacPolicy.load(self.config.auth_policy_path),
                    authenticator=Identity.from_socket,
                )
        self.ctx = ScContext(authorization=authorization)
        self.metadata_client: Optional[MetadataClient] = None
        self.dispatchers: List[MetadataDispatcher] = []
        if self.config.metadata_dir is not None:
            self.metadata_client = LocalMetadataClient(self.config.metadata_dir)
        self.topic_controller = TopicController(self.ctx)
        self.partition_controller = PartitionController(self.ctx)
        self.spu_controller = SpuController(self.ctx)
        self.public_server = FluvioApiServer(
            self.config.public_addr,
            ScPublicService(),
            self.ctx,
            ssl_context=server_ssl(self.config.tls),
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
        if self.metadata_client is not None:
            for store in (
                self.ctx.topics,
                self.ctx.partitions,
                self.ctx.spus,
                self.ctx.spgs,
                self.ctx.smartmodules,
                self.ctx.tableformats,
            ):
                d = MetadataDispatcher(
                    self.metadata_client,
                    store,
                    reconcile_interval=self.config.reconcile_interval,
                )
                await d.resync()  # load durable state before controllers run
                d.start()
                self.dispatchers.append(d)
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
        for d in self.dispatchers:
            await d.stop()
        self.dispatchers.clear()
