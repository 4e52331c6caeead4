"""Metrics recording: stacked on-device series → JSONL / CSV on host.

The reference's observability is per-step ``print()`` of Max-U / Div /
mixing progress / eaten counts (``code/StokesColor.py:586``,
``code/StokesFood.py:505`` — SURVEY.md §5).  Here metrics are computed
*inside* the jitted scan, returned as stacked arrays, and written once —
no host sync in the hot loop.
"""

from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager

import jax
import numpy as np


def metrics_to_rows(metrics: dict) -> list[dict]:
    """Stacked metric arrays {name: (steps,)} → per-step row dicts."""
    arrays = {k: np.asarray(v) for k, v in metrics.items()}
    n = max(a.shape[0] for a in arrays.values())
    rows = []
    for i in range(n):
        row = {"step": i}
        for k, a in arrays.items():
            if a.shape and a.shape[0] == n:
                v = a[i]
                row[k] = v.item() if np.ndim(v) == 0 else v.tolist()
        rows.append(row)
    return rows


def write_jsonl(path: str, metrics: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in metrics_to_rows(metrics):
            f.write(json.dumps(row) + "\n")
    return path


def write_csv(path: str, metrics: dict) -> str:
    rows = metrics_to_rows(metrics)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return path


def summarize(metrics: dict) -> dict:
    """Final/extreme values per metric — the one-line run summary."""
    out = {}
    for k, v in metrics.items():
        a = np.asarray(v, dtype=np.float64)
        out[k] = {
            "final": float(a[-1]),
            "max": float(a.max()),
            "min": float(a.min()),
        }
    return out


def print_reference_style(metrics: dict, every: int = 1, file=None) -> None:
    """Emit the reference's per-step console line from stacked metrics —
    e.g. ``Step: 12, Div(u*): 1.2e-01, Final Div(u): 3.4e-02, ...``
    (StokesColor.py:586 / StokesFood.py:505 format), printed after the
    run instead of inside the hot loop."""
    rows = metrics_to_rows(metrics)
    for row in rows[::every]:
        parts = [f"Step: {row['step']}"]
        if "div_star_max" in row:
            parts.append(f"Div(u*): {row['div_star_max']:.2e}")
        if "final_div_max" in row:
            parts.append(f"Final Div(u): {row['final_div_max']:.2e}")
        if "mixing_progress" in row:
            parts.append(f"Color mixing progress={row['mixing_progress']:.3f}")
        if "eaten" in row:
            parts.append(f"Eaten (Red): {int(row['eaten'])}")
        if "max_u" in row:
            parts.append(f"Max U: {row['max_u']:.2e}")
        print(", ".join(parts), file=file)


# ---------------------------------------------------------------------------
# Profiling / tracing (SURVEY.md §5 "tracing" rebuild)
# ---------------------------------------------------------------------------


class PhaseTimer:
    """Wall-clock per-phase timing with device sync at phase ends."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                jax.block_until_ready(sync_on)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [
            f"{name:24s} {t:8.3f}s  {100 * t / total:5.1f}%"
            for name, t in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextmanager
def xla_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
