"""SPU process assembly (the port's copy of the public half of
``fluvio_tpu/spu/server.py``; parity: fluvio-spu/src/start.rs).

`SpuServer` builds the `GlobalContext` (its SmartEngine on the card, or
on the CPU when ``smart_engine.device`` is ``"cpu"``; without CUDA and
without that, construction raises `EngineError`) and runs the public API
server and, when ``sc_addr`` is set, the SC dispatcher (register, replica
and SmartModule pushes, LRS reports). The internal (replication) server,
followers, monitoring and the retention cleaner are not ported yet.

    server = SpuServer(SpuConfig(public_addr="127.0.0.1:0", log_base_dir=d))
    await server.start()
    leader = server.ctx.create_replica("bench", 0)
    await leader.write_record_set(records)
    client = await Fluvio.connect(server.public_addr)
    ...
    await server.stop()

With an SC, the replicas come from the topics an admin creates there
(``SpuConfig(id=..., sc_addr=sc.private_addr, ...)``, then
``admin.register_custom_spu(id, server.public_addr)``).
"""

from __future__ import annotations

from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.context import GlobalContext
from fluvio_tpu_torch.spu.public_service import SpuPublicService
from fluvio_tpu_torch.spu.sc_dispatcher import ScDispatcher
from fluvio_tpu_torch.transport.service import FluvioApiServer


class SpuServer:
    def __init__(self, config: SpuConfig):
        self.config = config
        self.ctx = GlobalContext(config)
        self.public_server = FluvioApiServer(config.public_addr, SpuPublicService(), self.ctx)
        self.sc_dispatcher = ScDispatcher(self.ctx, config.sc_addr) if config.sc_addr else None

    @property
    def public_addr(self) -> str:
        return self.public_server.local_addr

    async def start(self) -> None:
        await self.public_server.start()
        if self.sc_dispatcher is not None:
            self.sc_dispatcher.start()

    async def run(self) -> None:
        await self.public_server.run()

    async def stop(self) -> None:
        if self.sc_dispatcher is not None:
            await self.sc_dispatcher.stop()
        await self.public_server.stop()
        self.ctx.close()
