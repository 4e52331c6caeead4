"""Global configuration helpers.

The reference enables float64 in every main file
(``/root/reference/code/StokesColor.py:14``); we expose that as an explicit
opt-in so the framework can also run the fast f32 path.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Path to the read-only reference checkout whose bundled Triangle meshes we
# use as test fixtures / parity inputs.  Data assets only — never code.
REFERENCE_DIR = os.environ.get("TPUFEM_REFERENCE_DIR", "/root/reference")


def enable_x64() -> None:
    """Enable double precision (parity mode with the reference)."""
    jax.config.update("jax_enable_x64", True)


def default_float():
    """The current default floating dtype (f64 if x64 is enabled)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def reference_mesh_path(name: str) -> str | None:
    """Resolve a bundled reference mesh stem (e.g. ``mesh.1``) to a path.

    Returns None if the reference checkout is not present; callers should
    fall back to :func:`tpufem.mesh.generate_annulus_mesh`.
    """
    candidates = [
        os.path.join(REFERENCE_DIR, "code", "mesh", name),
        os.path.join(REFERENCE_DIR, "resources", name),
    ]
    for stem in candidates:
        if os.path.exists(stem + ".node"):
            return stem
    return None
