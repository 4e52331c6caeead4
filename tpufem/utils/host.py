"""Host-execution helpers for setup-time computation.

Problem setup (operator assembly, BC surgery, factorization) runs once and
is latency-bound, not throughput-bound: on an accelerator every small
eager setup op is its own compile and kernel launch, and many of them
need f64 or host LAPACK anyway.  ``host_context()`` pins JAX ops to the
CPU backend so setup math runs on host; only the finished operator
matrices are used on the accelerator.
"""

from __future__ import annotations

import contextlib

import jax


def cpu_device():
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def host_context():
    """Context manager running JAX ops on the host CPU backend."""
    dev = cpu_device()
    if dev is None:
        return contextlib.nullcontext()
    return jax.default_device(dev)
