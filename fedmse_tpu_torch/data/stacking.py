"""Stack per-client arrays into padded tensors (port of
fedmse_tpu/data/stacking.py).

All N clients stack on a leading client axis with row masks: padding rows
carry mask 0 and count in no loss or metric; padding clients carry
client_mask 0. Train/valid rows are batch-major [N, NB, B, D], the layout
of the reference's unshuffled per-epoch minibatch loop.
`pad_federated_data` grows a stacked federation's client axis afterwards.
`client_range=(start, stop)` stacks only rows [start, stop) of the padded
client axis, bit for bit those rows of the full stack: the dimensions come
from the whole client list (or `dims=`), so slices tile one tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.data.loader import ClientData
from fedmse_tpu_torch.device import DeviceLike, resolve_device


def _pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    pad = target - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate(
        [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)], axis=0)


def _to_batches(x: np.ndarray, n_rows: int, batch_size: int,
                num_batches: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows to num_batches * batch_size and reshape to [NB, B, ...],
    with the row mask."""
    total = num_batches * batch_size
    xb = _pad_rows(x, total).reshape(num_batches, batch_size, *x.shape[1:])
    mask = (np.arange(total) < n_rows).astype(np.float32)
    return xb, mask.reshape(num_batches, batch_size)


@dataclasses.dataclass
class FederatedData:
    """All federation data as stacked tensors. N = padded client count,
    B = batch size; row masks are float32 {0, 1}."""

    train_xb: torch.Tensor  # [N, NB, B, D]
    train_mb: torch.Tensor  # [N, NB, B]
    valid_xb: torch.Tensor  # [N, NVB, B, D]
    valid_mb: torch.Tensor  # [N, NVB, B]
    valid_x: torch.Tensor   # [N, V, D]
    valid_m: torch.Tensor   # [N, V]
    test_x: torch.Tensor    # [N, T, D]
    test_m: torch.Tensor    # [N, T]
    test_y: torch.Tensor    # [N, T]
    dev_x: torch.Tensor     # [M, D]
    client_mask: torch.Tensor  # [N]


@dataclasses.dataclass(frozen=True)
class StackDims:
    """The stacked tensors' dimensions, computed from client row counts."""

    n_real: int
    n_pad: int
    nb: int
    nvb: int
    v_max: int
    t_max: int
    dim: int


def stack_dims(clients: Sequence[ClientData], batch_size: int,
               pad_clients_to: Optional[int] = None) -> StackDims:
    n_real = len(clients)
    n_pad = pad_clients_to or n_real
    if n_pad < n_real:
        raise ValueError(f"pad_clients_to={n_pad} < {n_real} clients")

    def ceil_div(a: int, b: int) -> int:
        return -(-a // b)

    return StackDims(
        n_real=n_real, n_pad=n_pad,
        nb=max(ceil_div(len(c.train_x), batch_size) for c in clients),
        nvb=max(ceil_div(len(c.valid_x), batch_size) for c in clients),
        v_max=max(len(c.valid_x) for c in clients),
        t_max=max(len(c.test_x) for c in clients),
        dim=clients[0].train_x.shape[1],
    )


def stack_clients(clients: Sequence[ClientData], dev_x: np.ndarray,
                  batch_size: int, pad_clients_to: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None,
                  client_range: Optional[Tuple[int, int]] = None,
                  dims: Optional[StackDims] = None, *,
                  device: DeviceLike = "cuda") -> FederatedData:
    """The stacked FederatedData on `device`. `dtype` (the precision
    policy's compute dtype; None = float32) is the storage dtype of the
    feature tensors; masks and labels stay float32. `client_range=(start,
    stop)` stacks rows [start, stop) of the padded client axis only, with
    the dimensions of `dims` (default: the whole client list's)."""
    dev = resolve_device(device)
    d = dims or stack_dims(clients, batch_size, pad_clients_to)
    start, stop = client_range or (0, d.n_pad)
    if not 0 <= start <= stop <= d.n_pad:
        raise ValueError(f"client_range ({start}, {stop}) outside the "
                         f"padded client axis [0, {d.n_pad})")
    zeros = lambda *s: np.zeros(s, dtype=np.float32)  # noqa: E731
    pad_client = ClientData(name="<pad>", train_x=zeros(1, d.dim),
                            valid_x=zeros(1, d.dim), test_x=zeros(1, d.dim),
                            test_y=zeros(1), dev_raw=None, scaler=None)
    cols = {k: [] for k in ("train_xb", "train_mb", "valid_xb", "valid_mb",
                            "valid_x", "valid_m", "test_x", "test_m",
                            "test_y")}
    for i in range(start, stop):
        is_real = i < d.n_real
        c = clients[i] if is_real else pad_client
        n_train = len(c.train_x) if is_real else 0
        n_valid = len(c.valid_x) if is_real else 0
        n_test = len(c.test_x) if is_real else 0
        xb, mb = _to_batches(c.train_x, n_train, batch_size, d.nb)
        cols["train_xb"].append(xb)
        cols["train_mb"].append(mb)
        xb, mb = _to_batches(c.valid_x, n_valid, batch_size, d.nvb)
        cols["valid_xb"].append(xb)
        cols["valid_mb"].append(mb)
        cols["valid_x"].append(_pad_rows(c.valid_x, d.v_max))
        cols["valid_m"].append(
            (np.arange(d.v_max) < n_valid).astype(np.float32))
        cols["test_x"].append(_pad_rows(c.test_x, d.t_max))
        cols["test_m"].append((np.arange(d.t_max) < n_test).astype(np.float32))
        cols["test_y"].append(_pad_rows(c.test_y, d.t_max))

    feat_dtype = dtype or torch.float32
    features = ("train_xb", "valid_xb", "valid_x", "test_x")

    def place(name, arrays):
        t = torch.from_numpy(np.stack(arrays, axis=0))
        return t.to(device=dev, dtype=feat_dtype if name in features
                    else torch.float32)

    client_mask = (np.arange(start, stop) < d.n_real).astype(np.float32)
    return FederatedData(
        **{name: place(name, arrays) for name, arrays in cols.items()},
        dev_x=torch.from_numpy(np.asarray(dev_x, np.float32)).to(
            device=dev, dtype=feat_dtype),
        client_mask=torch.from_numpy(client_mask).to(dev))


def pad_federated_data(data: FederatedData, n_pad: int) -> FederatedData:
    """Grow a stacked federation's client axis to `n_pad` by appending zero
    clients (client_mask 0, every row mask 0): excluded from selection,
    aggregation and evaluation exactly like stack-time padding. The dev
    set has no client axis and is kept."""
    n_old = data.client_mask.shape[0]
    if n_pad == n_old:
        return data
    if n_pad < n_old:
        raise ValueError(f"cannot shrink the client axis {n_old} -> {n_pad}")

    def grow(t: torch.Tensor) -> torch.Tensor:
        pad = torch.zeros((n_pad - n_old,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        return torch.cat([t, pad], dim=0)

    return FederatedData(**{
        f.name: (getattr(data, f.name) if f.name == "dev_x"
                 else grow(getattr(data, f.name)))
        for f in dataclasses.fields(FederatedData)})
