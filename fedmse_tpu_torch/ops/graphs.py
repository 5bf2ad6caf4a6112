"""A body of device work captured once into a CUDA graph and replayed.

The JAX package compiles a round, or a chunk of rounds, into one XLA
program. On the card the counterpart is a CUDA graph: a body of small
kernels captured once on static buffers and replayed with one host call,
so the host no longer issues each of them. `CapturedBody(fn, device)`
wraps a function that reads and writes only tensors allocated before its
first call (it updates them in place):

  * on the CPU a call is `fn()`, eagerly;
  * on a CUDA device the first call runs `fn()` on a side stream (the
    warm-up, which is also that call's real work: libraries load, the
    kernels' attributes and plans are cached), then captures `fn` into a
    graph without running it; every later call replays the graph. A
    failed capture raises: nothing falls back to eager replays.

Launch counts stay launches: a kernel wrapper called under capture counts
in its `captured` integer, not in `launches` (ops/native.count_launch), and
the body keeps the wrappers' capture deltas as its kernels per replay.
Each replay adds them to the wrappers' `launches`, so a run's totals count
every kernel that ran, whether a graph or the host launched it.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Optional

import torch

from fedmse_tpu_torch.knn.score import dist_tiles
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.fused_train import fused_train_grads

# every kernel wrapper of the port, by the name chip_smoke reports
WRAPPERS = {"fused_ae_forward": fused_forward_stats,
            "fused_ae_train": fused_train_grads,
            "dist_tiles": dist_tiles}


def _new_graph():
    """(graph, kept): keep_graph keeps the cudaGraph_t for the node count;
    a torch build without that argument instantiates at capture's end."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def graph_nodes(graph) -> int:
    """Nodes of a captured, kept graph, read through the driver
    (cuGraphGetNodes)."""
    lib = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(count.value)


class CapturedBody:
    """fn() on `device`: eager on the CPU, a replayed CUDA graph on a card
    (see the module docstring). `replays`, `replay_seconds` (the host's
    time in them), `capture_seconds`, `nodes` and `kernels` (kernel
    launches per replay, by wrapper name) describe the graph once
    captured."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 name: str):
        self.fn = fn
        self.device = device
        self.name = name
        self.graph = None
        self.kernels: Dict[str, int] = {}
        self.replays = 0
        self.replay_seconds = 0.0  # the host's time in replay() calls
        self.capture_seconds = 0.0
        self.nodes: Optional[int] = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            self._warm_up_and_capture()
            return
        t0 = time.perf_counter()
        self.graph.replay()
        self.replay_seconds += time.perf_counter() - t0
        self.replays += 1
        for name, n in self.kernels.items():
            WRAPPERS[name].launches += n

    def _warm_up_and_capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        t0 = time.perf_counter()
        before = {k: w.captured for k, w in WRAPPERS.items()}
        graph, kept = _new_graph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            self.fn()
        if kept:
            graph.instantiate()
            self.nodes = graph_nodes(graph)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.kernels = {k: w.captured - before[k]
                        for k, w in WRAPPERS.items()
                        if w.captured != before[k]}
        self.graph = graph

    def stats(self) -> dict:
        return {"replays": self.replays, "nodes": self.nodes,
                "replay_seconds": self.replay_seconds,
                "capture_seconds": self.capture_seconds,
                "kernels_per_replay": dict(self.kernels)}
