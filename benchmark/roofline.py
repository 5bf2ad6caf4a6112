"""The yardstick's arithmetic: the H100's published peaks, the least time
each kernel's work can take, the operations a federated round needs, and
the CUDA-event timing of a kernel replayed alone in a CUDA graph.

Every count here is taken from the shapes of the work a cell asks for,
never from a kernel's own loops, so the same work reads the same whatever
implements it. The formulas are those of `chip_smoke.py` (`bound`,
`train_bound`, `dist_bound`, `train_flops_per_row`, `graph_ms`), copied so
that the program cannot move its own yardstick.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit): f32
# outside the tensor cores, bf16 on them, HBM3 bandwidth
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# calls in the graph that times a kernel: a replay's launch gap spread over
# them (chip_smoke.GRAPH_CALLS)
GRAPH_CALLS = 16


def esize(precision: str) -> int:
    return 2 if precision == "bf16" else 4


def forward_flops_per_row(dims: Tuple[int, int, int]) -> int:
    """The forward pass of D -> H -> L -> H -> D: 2 (DH + HL + LH + HD)."""
    d, h, lat = dims
    return 2 * (d * h + h * lat + lat * h + h * d)


def train_flops_per_row(dims: Tuple[int, int, int]) -> int:
    """A trained row: the forward, plus the backward's
    2 (2HD + 2LH + 2HL + DH) (the input's gradient is not needed)."""
    d, h, lat = dims
    return forward_flops_per_row(dims) \
        + 2 * (2 * h * d + 2 * lat * h + 2 * h * lat + d * h)


def param_count(dims: Tuple[int, int, int]) -> int:
    d, h, lat = dims
    return 2 * d * h + 2 * h * lat + 2 * h + lat + d


def _least(flops: float, nbytes: float, precision: str):
    t_ops = flops / PEAK_FLOPS[precision]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def forward_bound(rows: int, models: int, precision: str,
                  dims: Tuple[int, int, int]):
    """(ms, what bounds it): the fused forward's least time, its FLOPs over
    the peak of the input type or the bytes it must move (x, the model
    index and the outputs once, every used model's weights once) over HBM
    bandwidth."""
    d, h, lat = dims
    e = esize(precision)
    macs = d * h + h * lat + lat * h + h * d
    flops = 2.0 * macs * rows
    nbytes = (rows * (d * e + 4 + 4 * (lat + 2))
              + min(models, rows) * (macs * e + 4 * (2 * h + lat + d)))
    return _least(flops, nbytes, precision)


def train_bound(rows: int, clients: int, precision: str,
                dims: Tuple[int, int, int]):
    """(ms, what bounds it): the fused train step's least time, `rows` rows
    of each of `clients` clients: its FLOPs over the peak, or the bytes
    (x and the mask once, each client's f32 parameters read once, its P
    f32 gradients and its loss written once) over HBM bandwidth."""
    d, _, _ = dims
    p = param_count(dims)
    flops = float(train_flops_per_row(dims)) * rows * clients
    nbytes = clients * (rows * (d * esize(precision) + 4) + 4 * p
                        + 4 * (p + 1))
    return _least(flops, nbytes, precision)


def dist_bound(rows: int, bank: int, banks_read: int, lat: int):
    """(ms, what bounds it): the distance tiles' least time, the cross
    term's 2 L T B f32 FLOPs over the f32 peak, or the bytes (the [T, B]
    f32 output written once, q [T, L] and the bank index [T] read once,
    each distinct bank [B, L] read once) over HBM bandwidth."""
    flops = 2.0 * lat * rows * bank
    nbytes = 4.0 * (rows * bank + rows * (lat + 1) + banks_read * bank * lat)
    return _least(flops, nbytes, "f32")


def round_flops(shapes: Dict[str, int], dims: Tuple[int, int, int],
                score: str, update: str) -> Dict[str, float]:
    """The FLOPs one federated round needs at a cell's shapes, by part:

    * train: every cohort client's real train rows, every configured
      epoch, as trained rows;
    * forward: the rows the round forwards: each epoch's validation of
      the cohort, the vote (every model over the first voter's
      validation rows), the merge's dev scoring of the cohort (mse_avg
      only), the verification rows, and the evaluation's test rows of
      every gateway (and, for the kNN score, its train rows encoded for
      the bank);
    * knn: 2 L B per scored test row against its gateway's B-slot bank.
    """
    n, s = shapes["gateways"], shapes["cohort"]
    epochs = shapes["epochs"]
    train = float(s * shapes["train_rows"] * epochs)
    fwd = (s * shapes["valid_rows"] * epochs + n * shapes["valid_rows"]
           + shapes["valid_rows"] + n * shapes["test_rows"])
    if update == "mse_avg":
        fwd += s * shapes["dev_rows"]
    knn = 0.0
    if score == "knn":
        fwd += n * shapes["train_rows"]
        knn = 2.0 * dims[2] * shapes["bank"] * n * shapes["test_rows"]
    return {"train": train * train_flops_per_row(dims),
            "forward": float(fwd) * forward_flops_per_row(dims),
            "knn": knn}


def graph_ms(fn: Callable[[], object], reps: int = 200,
             calls: int = GRAPH_CALLS) -> float:
    """Mean device milliseconds per call of fn() (work on the current CUDA
    device and stream), by CUDA events around `reps` back-to-back replays
    of a CUDA graph of `calls` calls, after an eager warm-up: the call's
    kernels with a replay's launch gap spread over `calls`, and no
    profiler (chip_smoke.graph_ms)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)
