"""The one place that maps the JAX backend to an implementation.

Workloads ask here instead of testing ``jax.default_backend()`` themselves,
so every backend-dependent choice is visible in one module and a test can
inject a backend string (``monkeypatch.setattr(platform, "backend", ...)``)
to check the GPU choice on a CPU-only machine.

The choices:

* Stokes ``cg_storage="auto"``: on the GPU, the stencil-offset operator
  where the node numbering covers ≥ 90% of the nonzeros (generated
  pad_hole meshes), else the banded sweep; on the CPU, CSR
  (gather/segment-sum), which XLA's CPU backend runs fastest.
* Navier–Stokes and the sparse Taylor–Hood stepper have one form on every
  backend (stencil-if-covered/CSR and the CSR Uzawa engine), so they do
  not ask.
"""

from __future__ import annotations

import jax

# cg_storage values a caller may request explicitly
STOKES_STORAGES = ("csr", "banded", "stencil")


def backend() -> str:
    """The JAX backend the workloads build for ("cpu" | "gpu")."""
    return jax.default_backend()


def stokes_storage(requested: str = "auto") -> str:
    """Resolve ``StokesConfig.cg_storage`` to a concrete storage; "auto"
    on an accelerator gives "accel": stencil if it covers the operator,
    else banded."""
    if requested == "auto":
        return "csr" if backend() == "cpu" else "accel"
    if requested not in STOKES_STORAGES:
        raise ValueError(
            f"unknown cg_storage {requested!r}; expected 'auto' or one of "
            f"{STOKES_STORAGES}"
        )
    return requested
