"""SC (Streaming Controller): the control plane of the port.

The port's copy of ``fluvio_tpu/sc`` (parity: `fluvio-sc`), host code
only: it builds no SmartEngine and starts without a card. It holds the
metadata stores per spec (in memory, or persisted in a directory and
resynced at start), the topic / partition / SPU controllers, the
rack-aware partition scheduler, the public admin API (Create / Delete /
List / Watch; TLS, and root, read-only or role-based authorization) and
the private API the SPUs register with and receive metadata pushes from.
The K8s run mode is not ported.
"""

from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.sc.start import ScConfig, ScServer

__all__ = ["ScContext", "ScConfig", "ScServer"]
