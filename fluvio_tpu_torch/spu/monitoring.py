"""SPU metrics endpoint over a unix socket.

The port's copy of ``fluvio_tpu/spu/monitoring.py`` (parity:
fluvio-spu/src/monitoring.rs:12-67): the broker's metrics are served to
any client that connects to a unix socket whose path is
``SpuConfig.monitoring_path`` ("" is `SPU_MONITORING_UNIX_SOCKET`; the
port reads no environment variable for it).

Protocol: the client MAY send one mode line before reading:

- ``json``  (or nothing — the legacy reader) → the metrics JSON dump,
  including the hook metering's quarantine state (``hook_quarantine``,
  the port's `metering.quarantine_state`) and the pipeline-telemetry
  snapshot,
- ``prom``  → Prometheus text-format exposition of the same snapshot,
- ``spans`` → the recent per-batch span ring as a JSON array,
- ``trace`` → the flight recorder's span/event/flow rings as one
  complete Chrome-trace/Perfetto JSON document,
- ``health``→ the SLO engine's verdict document (per-chain
  ok|warn|breach with window evidence; telemetry/slo.py),
- ``lag``   → the streaming lag document: per-chain@topic/partition
  consumer lag / record age joined against the replica high
  watermarks, plus the lag-rule SLO verdicts (telemetry/lag.py),
- ``memory``→ the device-memory ledger document: per-owner bytes, the
  peak watermark, leak-detector state, the card allocator's live bytes
  beside the ledger's and the hbm_headroom verdict (telemetry/memory.py).

A client that sends nothing still gets JSON after a short grace wait,
so pre-existing scrapers keep working unchanged. One document per
connection, then close — same as the reference.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

SPU_MONITORING_UNIX_SOCKET = "/tmp/fluvio-spu.sock"

#: the mode lines the endpoint answers
MODES = ("json", "prom", "spans", "trace", "health", "lag", "memory")

# grace wait for the optional mode line; legacy clients that connect and
# only read pay this once before the JSON dump starts
_MODE_LINE_TIMEOUT_S = 0.2


def monitoring_path(override: Optional[str] = None) -> str:
    return override or SPU_MONITORING_UNIX_SOCKET


class MonitoringServer:
    """Serves the SPU metrics (JSON / Prometheus text / spans / trace /
    health / lag / memory) on a unix socket."""

    def __init__(self, ctx, path: Optional[str] = None):
        self.ctx = ctx
        self.path = monitoring_path(path)
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
        self._server = await asyncio.start_unix_server(self._handle, path=self.path)
        logger.info("monitoring started on %s", self.path)

    def _payload(self, mode: str) -> bytes:
        from fluvio_tpu_torch.telemetry import TELEMETRY, render_prometheus, trace_json

        if mode == "prom":
            # the renderer reads the telemetry registry directly; only
            # the broker counter sections come from the metrics dict
            return render_prometheus(
                spu_metrics=self.ctx.metrics.to_dict(include_telemetry=False)
            ).encode()
        if mode == "spans":
            return (json.dumps(TELEMETRY.spans_json(), indent=1) + "\n").encode()
        if mode == "trace":
            return (trace_json() + "\n").encode()
        if mode == "health":
            from fluvio_tpu_torch.telemetry.slo import health_snapshot

            return (json.dumps(health_snapshot(), indent=1) + "\n").encode()
        if mode == "lag":
            from fluvio_tpu_torch.telemetry.lag import lag_snapshot

            return (json.dumps(lag_snapshot(), indent=1) + "\n").encode()
        if mode == "memory":
            from fluvio_tpu_torch.telemetry.memory import memory_snapshot

            return (json.dumps(memory_snapshot(), indent=1) + "\n").encode()
        return json.dumps(self.ctx.metrics.to_dict(), indent=2).encode()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        from fluvio_tpu_torch.telemetry import TELEMETRY

        try:
            mode = "json"
            try:
                line = await asyncio.wait_for(reader.readline(), _MODE_LINE_TIMEOUT_S)
                requested = line.decode("ascii", "replace").strip().lower()
                if requested in MODES:
                    mode = requested
            except (asyncio.TimeoutError, ValueError):
                # legacy client (no mode line) or a line exceeding the
                # stream reader's limit (readline raises ValueError):
                # fall through to the JSON dump either way
                pass
            writer.write(self._payload(mode))
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, ConnectionAbortedError) as e:
            # a scraper that disconnects mid-write must never take the
            # accept loop with it: count it and keep serving the next client
            logger.warning("monitoring client gone mid-request: %s", e)
            TELEMETRY.add_decline("client-gone")
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — one bad request is not an outage
            # log with traceback, keep the endpoint alive
            logger.exception("monitoring request failed")
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — transport already torn down
                pass

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if os.path.exists(self.path):
            os.remove(self.path)


async def _read_mode(path: Optional[str], mode: str) -> bytes:
    reader, writer = await asyncio.open_unix_connection(monitoring_path(path))
    try:
        writer.write(mode.encode("ascii") + b"\n")
        await writer.drain()
        return await reader.read()
    finally:
        writer.close()


async def read_metrics(path: Optional[str] = None) -> dict:
    """Client side: connect and decode one metrics dump (parity:
    fluvio-cli/src/monitoring.rs, the CLI's metrics reader)."""
    return json.loads(await _read_mode(path, "json"))


async def read_prometheus(path: Optional[str] = None) -> str:
    """Scrape the Prometheus text-format exposition."""
    return (await _read_mode(path, "prom")).decode()


async def read_spans(path: Optional[str] = None) -> list:
    """Fetch the recent per-batch span ring as a list of dicts."""
    return json.loads(await _read_mode(path, "spans"))


async def read_trace(path: Optional[str] = None) -> dict:
    """Fetch the flight recorder as one Chrome-trace JSON document."""
    return json.loads(await _read_mode(path, "trace"))


async def read_health(path: Optional[str] = None) -> dict:
    """Fetch the SLO engine's verdict document."""
    return json.loads(await _read_mode(path, "health"))


async def read_lag(path: Optional[str] = None) -> dict:
    """Fetch the streaming lag document."""
    return json.loads(await _read_mode(path, "lag"))


async def read_memory(path: Optional[str] = None) -> dict:
    """Fetch the device-memory ledger document."""
    return json.loads(await _read_mode(path, "memory"))
