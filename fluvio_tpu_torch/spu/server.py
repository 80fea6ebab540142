"""SPU process assembly (the port's copy of ``fluvio_tpu/spu/server.py``;
parity: fluvio-spu/src/start.rs).

`SpuServer` builds the `GlobalContext` (its SmartEngine on the card, or
on the CPU when ``smart_engine.device`` is ``"cpu"``; without CUDA and
without that, construction raises `EngineError`) and runs the public API
server (TLS when ``config.tls`` is enabled), the internal (replication) server on ``private_addr`` that its
followers sync from, the followers controller that syncs the replicas
this SPU follows from their leaders, the retention cleaner and, when
``sc_addr`` is set, the SC dispatcher (register, replica and SmartModule
pushes, LRS reports), and, when ``monitoring_path`` is set, the
monitoring socket (`monitoring.MonitoringServer`: json, prom, spans,
trace, health, lag and memory). They start in that order and stop in the
reverse one. A ``config.telemetry`` is applied to the process's
telemetry (`telemetry.configure`) at construction, and a
``config.admission`` to its admission gate (`admission.configure`).

    server = SpuServer(SpuConfig(public_addr="127.0.0.1:0", log_base_dir=d))
    await server.start()
    leader = server.ctx.create_replica("bench", 0)
    await leader.write_record_set(records)
    client = await Fluvio.connect(server.public_addr)
    ...
    await server.stop()

With an SC, the replicas come from the topics an admin creates there
(``SpuConfig(id=..., sc_addr=sc.private_addr, ...)``, then
``admin.register_custom_spu(id, server.public_addr,
private_addr=server.private_addr)``).
"""

from __future__ import annotations

from typing import Optional

from fluvio_tpu_torch.admission import configure as configure_admission
from fluvio_tpu_torch.spu.cleaner_controller import CleanerController
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.context import GlobalContext
from fluvio_tpu_torch.spu.follower import FollowersController
from fluvio_tpu_torch.spu.internal_service import SpuInternalService
from fluvio_tpu_torch.spu.monitoring import MonitoringServer
from fluvio_tpu_torch.spu.public_service import SpuPublicService
from fluvio_tpu_torch.spu.sc_dispatcher import ScDispatcher
from fluvio_tpu_torch.transport.service import FluvioApiServer
from fluvio_tpu_torch.telemetry import configure as configure_telemetry
from fluvio_tpu_torch.transport.tls import server_ssl


class SpuServer:
    def __init__(self, config: SpuConfig):
        self.config = config
        if config.telemetry is not None:
            configure_telemetry(config.telemetry)
        if config.admission is not None:
            configure_admission(config.admission)
        self.ctx = GlobalContext(config)
        self.public_server = FluvioApiServer(
            config.public_addr, SpuPublicService(), self.ctx, ssl_context=server_ssl(config.tls)
        )
        self.internal_server: Optional[FluvioApiServer] = (
            FluvioApiServer(config.private_addr, SpuInternalService(), self.ctx)
            if config.private_addr
            else None
        )
        self.followers_controller = FollowersController(self.ctx)
        self.ctx.followers_controller = self.followers_controller
        self.cleaner = CleanerController(self.ctx, config.cleaner_interval_seconds)
        self.sc_dispatcher = ScDispatcher(self.ctx, config.sc_addr) if config.sc_addr else None
        self.monitoring: Optional[MonitoringServer] = (
            MonitoringServer(self.ctx, config.monitoring_path)
            if config.monitoring_path is not None
            else None
        )

    @property
    def public_addr(self) -> str:
        return self.public_server.local_addr

    @property
    def private_addr(self) -> str:
        assert self.internal_server is not None, "internal server disabled"
        return self.internal_server.local_addr

    async def start(self) -> None:
        await self.public_server.start()
        if self.internal_server is not None:
            await self.internal_server.start()
        self.followers_controller.start()
        self.cleaner.start()
        if self.sc_dispatcher is not None:
            self.sc_dispatcher.start()
        if self.monitoring is not None:
            await self.monitoring.start()

    async def run(self) -> None:
        await self.public_server.run()

    async def stop(self) -> None:
        if self.monitoring is not None:
            await self.monitoring.stop()
        if self.sc_dispatcher is not None:
            await self.sc_dispatcher.stop()
        await self.cleaner.stop()
        await self.followers_controller.stop()
        if self.internal_server is not None:
            await self.internal_server.stop()
        await self.public_server.stop()
        self.ctx.close()
