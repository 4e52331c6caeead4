"""``chip_smoke.py``: its device guard, its last line, and its phases at
tiny sizes on the CPU (the real sizes run on the card)."""

import json
import os
import sys
from types import SimpleNamespace

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def _dev(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="'cpu'"):
        chip_smoke.require_gpu()
    gpus = [_dev("gpu", "NVIDIA H100 80GB HBM3")]
    assert chip_smoke.require_gpu(gpus) is gpus


def test_main_exits_nonzero_and_prints_no_result_on_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "cpu" in err


def test_result_line_format():
    line = chip_smoke.result_line([_dev("gpu", "NVIDIA H100 80GB HBM3")] * 4)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }
    assert "\n" not in line


def test_phase_device_without_card_query():
    row = chip_smoke.phase_device(query_card=False)
    assert row["count"] == len(jax.devices()) and "card" not in row


def test_phase_headline_tiny():
    row = chip_smoke.phase_headline(n_side=16, n_circle=20, steps=60,
                                    tracer_density=20)
    assert row["u_rel_f32_vs_f64"] < chip_smoke.HEADLINE_U_RTOL
    assert 0 < row["eaten_f32"] < row["tracers"]


def test_phase_large_tiny():
    row = chip_smoke.phase_large(n_side=40, n_circle=48, steps=4, cmp_steps=2)
    assert row["u_rel_f32_stencil_vs_f64_csr"] < chip_smoke.LARGE_U_RTOL
    assert row["ref_storage"] == "CSROperator"
    assert "mixing_progress" in row


def test_phase_entry_points_tiny():
    rows = chip_smoke.phase_entry_points(
        ns=(80, 96, 20), field=(24, 32), heat_steps=3, th=(12, 1),
        sweep=(14, 16, 200))
    assert set(rows) == {"ns", "poisson", "heat", "th_sparse", "sweep"}


@pytest.mark.parametrize("phase", ["ensemble", "halo"])
def test_phase_four_tiny(phase):
    """The --four phases on 4 of the virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    if phase == "ensemble":
        row = chip_smoke.phase_four_ensemble(n_side=14, n_circle=16, steps=20,
                                             tracer_density=12)
        assert row["mesh"] == {"data": 2, "space": 2}
    else:
        row = chip_smoke.phase_four_halo(n_side=32, n_circle=40, steps=2)
        assert row["mesh"] == {"data": 1, "space": 4}
