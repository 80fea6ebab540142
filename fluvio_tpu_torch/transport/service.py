"""Generic TCP API server scaffold (the port's copy of
``fluvio_tpu/transport/service.py``; parity: fluvio-service/src/server.rs).

`FluvioApiServer` binds an address and runs the accept loop; each accepted
connection is handed to the service's ``respond(context, socket)`` in its own
task. Shutdown is signalled with a StickyEvent, like the reference
(server.rs:34-150).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Generic, TypeVar

from fluvio_tpu_torch.transport.socket import FluvioSocket
from fluvio_tpu_torch.types import StickyEvent

logger = logging.getLogger(__name__)

C = TypeVar("C")


class FluvioService(Generic[C]):
    """A server-side API handler: one call per connection."""

    async def respond(self, context: C, socket: FluvioSocket) -> None:
        raise NotImplementedError


class FluvioApiServer(Generic[C]):
    """Bind + accept loop + per-connection handler tasks."""

    def __init__(self, addr: str, service: FluvioService[C], context: C):
        self.addr = addr
        self.service = service
        self.context = context
        self.shutdown = StickyEvent()
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set = set()

    @property
    def local_addr(self) -> str:
        """Actual bound address (resolves port 0 to the assigned port)."""
        assert self._server is not None, "server not started"
        sock = self._server.sockets[0]
        host, port = sock.getsockname()[:2]
        return f"{host}:{port}"

    async def start(self) -> None:
        host, port_s = self.addr.rsplit(":", 1)
        self._server = await asyncio.start_server(
            self._handle_connection, host, int(port_s)
        )
        logger.debug("server listening on %s", self.local_addr)

    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        socket = FluvioSocket(reader, writer)
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            await self.service.respond(self.context, socket)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("connection handler failed (%s)", socket.peer_addr)
        finally:
            await socket.close()

    async def run(self) -> None:
        """Serve until shutdown is notified."""
        if self._server is None:
            await self.start()
        await self.shutdown.wait()
        await self._shutdown_server()

    async def stop(self) -> None:
        self.shutdown.notify()
        await self._shutdown_server()

    async def _shutdown_server(self) -> None:
        if self._server is None:
            return
        self._server.close()
        # cancel live connection handlers BEFORE wait_closed: since py3.12
        # wait_closed blocks until every handler task completes
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None
