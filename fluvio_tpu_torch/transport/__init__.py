"""Transport layer of the port: framed TCP sockets, the correlation-id
multiplexer, the version-negotiating socket and the TCP API server (copies
of ``fluvio_tpu/transport``'s modules; parity: `fluvio-socket` and
`fluvio-service`). Plaintext only: TLS is not ported yet.
"""

from fluvio_tpu_torch.transport.multiplexing import AsyncResponse, MultiplexerSocket
from fluvio_tpu_torch.transport.service import FluvioApiServer, FluvioService
from fluvio_tpu_torch.transport.sink import ExclusiveSink, FluvioSink
from fluvio_tpu_torch.transport.socket import FluvioSocket, connect
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket

__all__ = [
    "AsyncResponse",
    "ExclusiveSink",
    "FluvioApiServer",
    "FluvioService",
    "FluvioSink",
    "FluvioSocket",
    "MultiplexerSocket",
    "VersionedSerialSocket",
    "connect",
]
