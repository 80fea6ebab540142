"""Build observability: every native library the process builds or loads
becomes a compile event.

The port's counterpart of ``fluvio_tpu/telemetry/compiles.py``. The JAX
package's compile events are jit trace-cache misses, timed by a wrapper
around each jitted entry point, with the persistent ``.xla_cache``
outcome beside them. The port compiles no jit: what it builds before its
first batch are native libraries, each at first use into a ``_build/``
directory keyed by a hash of its source and flags:

- the CUDA kernels (``smartengine/gpu/native.py`` ``KERNELS.build``, one
  ``nvcc`` for ``sm_90a`` per ``csrc/*.cu``), kind ``nvcc``;
- the host codecs built with ``g++``: the record codec
  (``native/records.py``), lz4 / snappy (``protocol/native_codecs.py``)
  and the glz compressor (``smartengine/gpu/glz.py``), kind ``g++``.

Each library records ONE event with its seconds (the compiler's wall
time, or the load of a library already built) and its outcome:
``built``, or ``cached`` when it was found in ``_build/`` — the
counterpart of the JAX persistent-cache hit/miss, booked on the same
counters. The registry's recompile-storm detection and families apply
unchanged. The JAX package's jit wrapper has no counterpart here.
"""

from __future__ import annotations

from fluvio_tpu_torch.telemetry.registry import TELEMETRY

#: the outcomes a build event carries
OUTCOMES = ("built", "cached")


def note_build(kind: str, library: str, seconds: float, cached: bool) -> None:
    """Record one native library's build (``cached`` False) or load of an
    existing build (``cached`` True): a compile event of ``kind`` whose
    signature is ``"<library> <outcome>"``. Counters stay on with capture
    off, as every registry counter does; the flight-recorder event is
    gated with capture."""
    outcome = "cached" if cached else "built"
    TELEMETRY.add_compile(kind, f"{library} {outcome}", seconds, persistent_hit=cached)
