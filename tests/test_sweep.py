"""Squirmer-gait sweep — scientific-result parity (README.md:43-45).

The full 6000-step campaign reproduced neutral 46.7%, pusher 98.8%,
puller 99.6% vs the reference's published ~50/97/98%.  The CI test runs a shortened campaign and checks the
published ordering: swimming gaits (pusher/puller) feed far better than
the neutral squirmer.
"""

import numpy as np
import pytest

from tpufem.workloads import sweep


def test_sharded_sweep_matches_sequential(mesh1):
    """The one-program sharded gait campaign reproduces the sequential
    per-gait sweep's capture counts."""
    import jax

    if len(jax.devices()) < 6:
        pytest.skip("needs 6 virtual devices")
    from jax.sharding import Mesh as DeviceMesh

    dmesh = DeviceMesh(np.asarray(jax.devices()[:6]).reshape(3, 2), ("data", "space"))
    cfg = sweep.SweepConfig(steps=150, tracer_density=12, precision="f32")
    seq = sweep.food_capture_sweep(mesh1, cfg)
    sh = sweep.food_capture_sweep_sharded(mesh1, dmesh, cfg)
    for b2 in cfg.b2_values:
        # sequential uses the fused step, sharded the staged one — f32
        # trajectories differ at ~1e-6, so threshold-crossing counts may
        # wobble by a tracer or two
        assert abs(sh[b2]["eaten"] - seq[b2]["eaten"]) <= 2, (b2, sh[b2], seq[b2])


def test_gait_ordering_short(mesh1):
    cfg = sweep.SweepConfig(steps=800, precision="f64", fused=False)
    res = sweep.food_capture_sweep(mesh1, cfg)
    neutral = res[0.0]["consumed_fraction"]
    pusher = res[-5.0]["consumed_fraction"]
    puller = res[5.0]["consumed_fraction"]
    assert pusher > neutral + 0.1
    assert puller > neutral + 0.1
    assert 0.0 < neutral < 1.0
    assert res[0.0]["tracers"] == 488  # 25×25 grid minus cylinder
