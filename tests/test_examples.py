"""Smoke test of the gallery pipeline (viz + all workloads end-to-end)."""

import os
import sys


def test_gallery_quick(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import make_gallery

    make_gallery.main(str(tmp_path), quick=True)
    produced = set(os.listdir(tmp_path))
    for f in ("mesh.png", "poisson.png", "heat.png", "stokes_flow.png", "food.png"):
        assert f in produced, f
    assert any(f.startswith("dye_mixing") for f in produced)
    assert any(f.startswith("food.mp4") or f.startswith("food.gif")
               for f in produced)


def test_xl_dye_movie_quick(tmp_path):
    """The flagship-movie pipeline (run_with_frames → animate) regenerates
    — smoke size; the committed 410k artifact is produced by
    ``python examples/make_gallery.py --xl``."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import make_gallery

    path = make_gallery.xl_dye_movie(str(tmp_path), quick=True)
    assert os.path.exists(path)
    assert os.path.getsize(path) > 1000
