"""Warm, min-over-k candidate timing (port of fedmse_tpu/tune/measure.py).

`best_wall`: one untimed call first (the kernel library's build and load,
the allocators' warm-up), then the MINIMUM wall over `repeats` timed calls
— min, not mean, because a launch-size decision cares about what a
configuration can achieve, and scheduler noise only ever adds. A kernel
wrapper returns once its launch is enqueued, so every timed call is
bracketed by `torch.cuda.synchronize()` whenever CUDA is in use: the wall
is the card's work, not the host's enqueue. `measure_candidates` runs it
over a candidate list and returns the argmin with the whole table (a
choice without its losing candidates is not auditable).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def best_wall(fn: Callable[[], Any], repeats: int = 3) -> float:
    """Min wall seconds of `fn()` over `repeats`, after one warm call,
    each call waited for on the card."""
    fn()
    _sync()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_candidates(candidates: Sequence[Any],
                       run: Callable[[Any], Any],
                       repeats: int = 3) -> Dict[str, Any]:
    """Time `run(candidate)` for each candidate; return
    {"choice", "wall_s", "candidates": [{"value", "wall_s"}, ...]}."""
    rows: List[Dict[str, Any]] = []
    for cand in candidates:
        rows.append({"value": cand,
                     "wall_s": best_wall(lambda: run(cand), repeats=repeats)})
    best = min(rows, key=lambda r: r["wall_s"])
    return {"choice": best["value"], "wall_s": best["wall_s"],
            "candidates": rows}
