"""The yardstick of KitNET's two kernels (fedmse_tpu_torch/csrc/kitnet.cu):
the operations and bytes of the forward statistic and of the train step
at a cell's shapes, their least time on one H100 (benchmark/roofline's
peaks), and the FLOPs of a federated round of KitNET models.

Counts come from the model's shapes alone (the feature map and the
hidden ratio), never from the kernels' loops: a multiply-add is 2 FLOPs;
the sigmoids, softpluses and square roots are not counted (the peaks are
of multiply-adds). An autoencoder of n inputs and h hidden units is
2 n h multiply-adds a row forward (u W, then y W^T) and 3 n h more in the
train step's backward (e W, u^T dh, e^T y).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from benchmark.roofline import _least

FeatureMap = Sequence[Sequence[int]]


def shapes(fmap: FeatureMap, beta: float = 0.75) -> Tuple[Tuple[int, int],
                                                           ...]:
    """(n, h) of every autoencoder: the ensemble's, then the output's."""
    def hidden(n):
        return max(1, int(math.ceil(beta * n)))
    out = [(len(c), hidden(len(c))) for c in fmap]
    return tuple(out + [(len(fmap), hidden(len(fmap)))])


def param_count(fmap: FeatureMap, beta: float = 0.75) -> int:
    return sum(n * h + h + n for n, h in shapes(fmap, beta))


def stats_width(fmap: FeatureMap) -> int:
    return 2 * len(fmap)


def forward_flops_per_row(fmap: FeatureMap, beta: float = 0.75) -> int:
    """2 x 2 n h over every autoencoder."""
    return sum(4 * n * h for n, h in shapes(fmap, beta))


def train_flops_per_row(fmap: FeatureMap, beta: float = 0.75) -> int:
    """The forward and the backward: 2 x 5 n h over every autoencoder."""
    return sum(10 * n * h for n, h in shapes(fmap, beta))


def forward_bound(rows: int, models: int, fmap: FeatureMap,
                  beta: float = 0.75):
    """(ms, what bounds it): the forward's least time over `rows` rows of
    `models` models: its FLOPs over the f32 peak, or its bytes (each row's
    D features and model index read and its two f32 outputs written once,
    each used model's P params and 2k statistics read once) over HBM
    bandwidth."""
    d = sum(len(c) for c in fmap)
    p, q = param_count(fmap, beta), stats_width(fmap)
    flops = float(forward_flops_per_row(fmap, beta)) * rows
    nbytes = rows * (4 * d + 4 + 8) + min(models, rows) * 4 * (p + q)
    return _least(flops, nbytes, "f32")


def train_bound(rows: int, clients: int, fmap: FeatureMap,
                beta: float = 0.75):
    """(ms, what bounds it): the train step's least time, `rows` rows of
    each of `clients` clients: its FLOPs over the f32 peak, or its bytes
    (each row's D features and mask read once; each client's P params
    read, its 2k statistics read and written, its P gradients and its loss
    written) over HBM bandwidth."""
    d = sum(len(c) for c in fmap)
    p, q = param_count(fmap, beta), stats_width(fmap)
    flops = float(train_flops_per_row(fmap, beta)) * rows * clients
    nbytes = clients * (rows * (4 * d + 4) + 4 * p + 8 * q + 4 * p + 4)
    return _least(flops, nbytes, "f32")


def round_flops(shapes_: Dict[str, int], fmap: FeatureMap, update: str,
                beta: float = 0.75) -> Dict[str, float]:
    """The FLOPs one round needs at a cell's shapes (benchmark/roofline.
    round_flops' parts for KitNET): every cohort client's train rows each
    configured epoch as trained rows; the forward of each epoch's
    validation of the cohort, the vote (every model over the first
    voter's validation rows), the merge's dev scoring (mse_avg only), the
    verification rows and every gateway's test rows."""
    n, s = shapes_["gateways"], shapes_["cohort"]
    epochs = shapes_["epochs"]
    train = float(s * shapes_["train_rows"] * epochs)
    fwd = (s * shapes_["valid_rows"] * epochs + n * shapes_["valid_rows"]
           + shapes_["valid_rows"] + n * shapes_["test_rows"])
    if update == "mse_avg":
        fwd += s * shapes_["dev_rows"]
    return {"train": train * train_flops_per_row(fmap, beta),
            "forward": float(fwd) * forward_flops_per_row(fmap, beta)}
