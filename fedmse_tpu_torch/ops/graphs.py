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
    graph on that same stream without running it; every later call
    replays the graph. A failed capture raises: nothing falls back to
    eager replays.

A capture runs in "thread_local" mode: only the capturing thread is barred
from calls that are unsafe during a capture (a synchronize, an allocation
of pinned memory). So a body may be captured on a worker thread while
another thread goes on launching, copying and synchronizing on its own
streams: the flywheel's fine-tune (flywheel/controller.py) captures its
round on a background thread while the serving front harvests.

The cyclic garbage collector is held off during a capture: a dead
engine's graphs live in reference cycles, and destroying a graph while a
stream captures invalidates the capture (torch's graph context no longer
collects before it captures, so such garbage can be due at any moment).

A body may run collectives across ranks (a round sharded over a client
mesh, parallel/): every collective in it goes through `collective(...)`,
which cuts the capture there. The first call runs the whole body eagerly,
collectives included; the capture then records one graph per stretch
between two collectives (sharing one memory pool) and, at each cut, the
collective's source tensor; a replay runs graph 0, collective 0, graph 1,
... with each collective an eager call writing into the output buffer its
first call allocated, which the next graph reads. A body that runs no
collective (every body off a mesh) is one stretch: one graph, the same
nodes as a capture of the whole body. Outside a body being captured (the
CPU, or no body at all) `collective` simply runs.

Launch counts stay launches: a kernel wrapper called under capture counts
in its `captured` integer, not in `launches` (ops/native.count_launch), and
the body keeps the wrappers' capture deltas as its kernels per replay.
Each replay adds them to the wrappers' `launches`, so a run's totals count
every kernel that ran, whether a graph or the host launched it.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from fedmse_tpu_torch.knn.score import dist_tiles
from fedmse_tpu_torch.ops.adam_update import adam_update
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.fused_train import fused_train_grads
from fedmse_tpu_torch.ops.kitnet import (kitnet_forward_stats,
                                         kitnet_train_grads)

# every kernel wrapper of the port, by the name chip_smoke reports
WRAPPERS = {"fused_ae_forward": fused_forward_stats,
            "fused_ae_train": fused_train_grads,
            "dist_tiles": dist_tiles,
            "adam_update": adam_update,
            "kitnet_forward": kitnet_forward_stats,
            "kitnet_train": kitnet_train_grads}
# the kernels each model family's main path launches, by those names
FAMILY_KERNELS = {"autoencoder": ("fused_ae_forward", "fused_ae_train",
                                  "dist_tiles", "adam_update"),
                  "kitnet": ("kitnet_forward", "kitnet_train",
                             "adam_update")}


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


_ACTIVE = threading.local()


def collective(src: torch.Tensor,
               alloc: Callable[[torch.Tensor], torch.Tensor],
               run: Callable[[torch.Tensor, torch.Tensor], None]
               ) -> torch.Tensor:
    """A collective on `src` into a buffer `alloc(src)` made once, by
    `run(src, dst)`: run now, or, inside a body being captured, cut
    the capture here and run at each replay (module docstring)."""
    body = getattr(_ACTIVE, "body", None)
    if body is None:
        dst = alloc(src)
        run(src, dst)
        return dst
    return body._collective(src, alloc, run)


class _Slot:
    """One collective of a body: its capture-time source, its
    output buffer and the call that fills it."""

    def __init__(self, dst: torch.Tensor, run: Callable) -> None:
        self.src: Optional[torch.Tensor] = None
        self.dst = dst
        self.run = run


class CapturedBody:
    """fn() on `device`: eager on the CPU, replayed CUDA graphs on a card
    (see the module docstring). `replays`, `replay_seconds` (the host's
    time in them), `capture_seconds`, `nodes` (over every graph) and
    `kernels` (kernel launches per replay, by wrapper name) describe the
    graphs once captured."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 name: str):
        self.fn = fn
        self.device = device
        self.name = name
        self.graphs: List = []  # the stretches' graphs, in replay order
        self._slots: List[_Slot] = []  # the collectives between them
        self._mode = ""
        self._at = 0
        self._pool = None
        self.kernels: Dict[str, int] = {}
        self.replays = 0
        self.replay_seconds = 0.0  # the host's time in replay() calls
        self.capture_seconds = 0.0
        self.nodes: Optional[int] = None

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        if not self.graphs:
            self._warm_up_and_capture()
            return
        t0 = time.perf_counter()
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self._slots):
                slot = self._slots[i]
                slot.run(slot.src, slot.dst)
        self.replay_seconds += time.perf_counter() - t0
        self.replays += 1
        for name, n in self.kernels.items():
            WRAPPERS[name].launches += n

    def _collective(self, src, alloc, run) -> torch.Tensor:
        if self._mode == "warm":  # the eager first call: run it
            dst = alloc(src)
            run(src, dst)
            self._slots.append(_Slot(dst, run))
            return dst
        slot = self._slots[self._at]  # capturing: cut the graph here
        self._at += 1
        slot.src = src
        self._end_graph()
        self._begin_graph()
        return slot.dst

    def _begin_graph(self) -> None:
        if self._pool is None:  # one memory pool for every stretch
            self._pool = torch.cuda.graph_pool_handle()
        graph, kept = _new_graph()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        self._capturing.append((graph, kept))

    def _end_graph(self) -> None:
        self._capturing[-1][0].capture_end()

    def _warm_up_and_capture(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self._slots = []
        self._mode, _ACTIVE.body = "warm", self
        try:
            with torch.cuda.stream(side):
                self.fn()
        finally:
            _ACTIVE.body = None
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        before = {k: w.captured for k, w in WRAPPERS.items()}
        collecting = gc.isenabled()
        gc.disable()
        self._mode, self._at, self._capturing = "capture", 0, []
        try:
            with torch.cuda.device(dev):
                # as torch.cuda.graph does: free what the graph may use
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                with torch.cuda.stream(side):
                    self._begin_graph()
                    _ACTIVE.body = self
                    try:
                        self.fn()
                    finally:
                        _ACTIVE.body = None
                        self._end_graph()
        finally:
            if collecting:
                gc.enable()
        if self._at != len(self._slots):
            raise RuntimeError(
                f"body {self.name!r} ran {len(self._slots)} collectives "
                f"eagerly but {self._at} under capture")
        nodes = 0
        for graph, kept in self._capturing:
            if kept:
                graph.instantiate()
                nodes += graph_nodes(graph)
        self.nodes = nodes if all(k for _, k in self._capturing) else None
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.kernels = {k: w.captured - before[k]
                        for k, w in WRAPPERS.items()
                        if w.captured != before[k]}
        self.graphs = [g for g, _ in self._capturing]
        del self._capturing

    def stats(self) -> dict:
        return {"replays": self.replays, "nodes": self.nodes,
                "segments": len(self.graphs),
                "replay_seconds": self.replay_seconds,
                "capture_seconds": self.capture_seconds,
                "kernels_per_replay": dict(self.kernels)}
