"""kNN anomaly scoring: distance tiles on a hand-written CUDA kernel, then
partial top-k (port of fedmse_tpu/knn/score.py).

Score = Euclidean distance to the k-th nearest latent in the row's gateway
bank (knn/bank.py).

  * **distance tiles** (`dist_tiles`): ||q||^2 - 2 q.b + ||b||^2 clamped at 0,
    f32, every query row against its OWN bank out of a stacked [N, B, L]
    ReferenceBank (`gw`, the per-row bank index). The TPU kernel `_dist_kernel`
    becomes csrc/dist_tiles.cu (its header states the bound and design). The
    JAX package took one bank per call, so its routed serving scorer encoded
    the routing in a one-hot [b, N*L] operand or gathered a bank per row;
    with the per-row index both the evaluator's client-major rows and a
    serving bucket are ONE launch.
  * **exact top-k**: per-block partial top-k, then top-k over the survivors.
  * **approximate top-k**: each STRIDED bin (slot i -> bin i % bins) keeps its
    minimum, then top-k over the bin minima; bins = pow2(k * 32).

Masking (slot >= count of the row's bank -> +inf) and the top-k run as torch
ops after the kernel, as the JAX code runs them outside its Pallas kernel.
`dist_tiles.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from fedmse_tpu_torch.knn.bank import ReferenceBank, pow2_bank_size
from fedmse_tpu_torch.ops import native
from fedmse_tpu_torch.ops.distance import sq_norms

MAX_LATENT = 128  # the TPU kernel packed the latent into 128 lanes
_FLOAT_INPUTS = (torch.float32, torch.bfloat16)


# --------------------------- distance tiles ---------------------------- #

def _check(q: torch.Tensor, banks: torch.Tensor,
           gw: Optional[torch.Tensor]) -> torch.Tensor:
    """Validate the operands; returns the banks as [N, B, L]."""
    if banks.dim() == 2:
        banks = banks.unsqueeze(0)
    if q.dim() != 2 or banks.dim() != 3:
        raise ValueError(f"q must be [T, L] and banks [N, B, L] (or one bank "
                         f"[B, L]); got {tuple(q.shape)} and "
                         f"{tuple(banks.shape)}")
    if q.shape[1] != banks.shape[2]:
        raise ValueError(f"q has latent_dim {q.shape[1]}, the banks "
                         f"{banks.shape[2]}")
    if q.dtype not in _FLOAT_INPUTS:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if banks.dtype != torch.float32:
        raise ValueError(f"banks must be float32, got {banks.dtype}")
    if banks.device != q.device:
        raise ValueError(f"banks are on {banks.device}, q on {q.device}")
    if gw is not None:
        if gw.dtype != torch.int32 or tuple(gw.shape) != (q.shape[0],):
            raise ValueError("gw must be int32 [T], got "
                             f"{gw.dtype} {tuple(gw.shape)}")
        if gw.device != q.device:
            raise ValueError(f"gw is on {gw.device}, q on {q.device}")
    return banks


def dist_tiles_plain(q: torch.Tensor, banks: torch.Tensor,
                     gw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each row's bank gathered,
    cross = einsum('tl,tbl->tb'), then (qn - 2 cross) + bn clamped at 0. A
    row whose bank index lies outside [0, N) gets NaN, as in the kernel. On
    a CUDA tensor it requires TF32 off."""
    banks = _check(q, banks, gw)
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain distance tiles on the card need "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    q = q.to(torch.float32)
    n = banks.shape[0]
    if gw is None:
        gw = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    valid = (gw >= 0) & (gw < n)
    g = gw.clamp(0, max(n - 1, 0)).long()
    cross = torch.einsum("tl,tbl->tb", q, banks[g])
    d = sq_norms(q)[:, None] - 2.0 * cross + sq_norms(banks)[g]
    d = torch.clamp(d, min=0.0)
    return torch.where(valid[:, None], d, torch.full_like(d, float("nan")))


GROUP = 4  # consecutive slots per thread of the kernel
MIN_GROUPS, MAX_GROUPS = 32, 256  # slot groups per pass: a warp to a CTA
CTA_WARPS, BLOCKS_PER_SM = 8, 3
STREAM_BYTES = 48 << 20  # outputs above this take evict-first stores


def dist_plan(rows: int, bank: int, lat: int, sms: int
              ) -> Tuple[int, int, bool]:
    """(slot groups per pass, CTAs, evict-first stores) of one distance
    launch over `rows` rows of `bank` slots at latent width `lat` on a card
    of `sms` SMs; csrc/dist_tiles.cu refuses any other plan.

    A thread owns 4 consecutive slots; one pass over a row takes the power
    of two of such groups covering the bank, from one warp (128 slots) to
    the CTA's 256 threads (1,024 slots; wider banks take several passes),
    so a CTA of 8 warps works on 8 / (groups / 32) rows at a time. CTAs:
    enough for every such row set to run at once, at most 3 per SM (the
    kernel's launch bound, which leaves it 80 registers a thread), each
    then given an equal contiguous run of rows. Stores are evict-first
    when the [rows, bank] f32 output exceeds STREAM_BYTES (most of the
    H100's 50 MB L2: nothing would find it there; on an H100 the hint took
    the evaluation's launch from 0.0255 to 0.0232 ms and its kNN path down
    by 0.001-0.007 ms, and moved neither serving bucket beyond noise)."""
    if rows < 1 or bank < 1 or not 1 <= lat <= MAX_LATENT or sms < 1:
        raise ValueError(f"no distance plan for rows={rows}, bank={bank}, "
                         f"latent_dim={lat}, sms={sms}")
    groups = MIN_GROUPS
    while groups < -(-bank // GROUP) and groups < MAX_GROUPS:
        groups *= 2
    row_step = CTA_WARPS // (groups // 32)
    ctas = min(-(-rows // row_step), BLOCKS_PER_SM * sms)
    if rows // ctas >= 1 << 30:  # the kernel indexes a CTA's rows in 32 bits
        raise ValueError(f"no distance plan for rows={rows}: over 2**30 "
                         f"rows a CTA")
    return groups, ctas, 4 * rows * bank > STREAM_BYTES


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.load("dist_tiles")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dist_tiles.argtypes = ([ptr] * 4 + [ctypes.c_longlong] + [i32] * 8
                               + [ptr])
    lib.dist_tiles.restype = i32
    lib.dist_tiles_error_string.argtypes = [i32]
    lib.dist_tiles_error_string.restype = ctypes.c_char_p
    return lib


def dist_tiles(q: torch.Tensor, banks: torch.Tensor,
               gw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared distances [T, B] f32 of each query row against its bank.

    q: [T, L] f32 or bf16. banks: [N, B, L] f32 (or one bank [B, L]).
    gw: int32 [T], each row's bank (None: bank 0); a row outside [0, N)
    gets NaN. The kernel reads bf16 queries itself and upcasts them in
    registers, which is exact; the JAX package's banks are always f32 and
    its bf16 x bf16 products are exact in f32, so the f32 arithmetic
    carries the whole contract of `_dist_kernel` (f32 accumulation whatever
    the operand dtype). CPU tensors run `dist_tiles_plain`; CUDA tensors
    launch csrc/dist_tiles.cu once, in either dtype, on their device's
    current stream over the plan of `dist_plan`, or raise (L > 128,
    non-contiguous operands, a failed build or launch). T = 0 or B = 0
    returns an empty tensor without a launch."""
    banks = _check(q, banks, gw)
    if q.device.type == "cpu":
        return dist_tiles_plain(q, banks, gw)
    if q.device.type != "cuda":
        raise ValueError(f"distance tiles run on cuda or cpu, got {q.device}")
    rows, lat = q.shape
    n, b, _ = banks.shape
    if lat < 1 or lat > MAX_LATENT:
        raise ValueError(f"the distance kernel takes 1 <= latent_dim <= "
                         f"{MAX_LATENT}; got {lat}")
    out = torch.empty((rows, b), dtype=torch.float32, device=q.device)
    if rows == 0 or b == 0:
        return out
    operands = (q, banks) + ((gw,) if gw is not None else ())
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the distance kernel takes contiguous tensors")
    lib = _library()
    index = q.device.index
    groups, ctas, streaming = dist_plan(rows, b, lat, _sm_count(index))
    # the device's current stream in one C call, with no device context
    # entered around the launch (the C entry sets the device if it must)
    rc = lib.dist_tiles(q.data_ptr(), banks.data_ptr(),
                        None if gw is None else gw.data_ptr(),
                        out.data_ptr(), rows, n, b, lat,
                        int(q.dtype == torch.bfloat16), groups, ctas,
                        int(streaming), index,
                        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("dist_tiles launch failed: "
                           + lib.dist_tiles_error_string(rc).decode())
    dist_tiles.launches += 1
    return out


dist_tiles.launches = 0


# ------------------------------- top-k --------------------------------- #

def _pad_inf(x: torch.Tensor, k: int) -> torch.Tensor:
    """Right-pad the last axis with +inf up to k columns."""
    if x.shape[1] >= k:
        return x
    pad = torch.full((x.shape[0], k - x.shape[1]), float("inf"),
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(x, k, dim=-1, largest=False, sorted=True).values


def _blocked_smallest_k(d: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """[T, B] -> [T, k] smallest distances ascending: per-block partial
    top-k, then top-k over the survivors (exact: each block keeps its own
    k, so the true k nearest all survive their block's cut)."""
    t, b = d.shape
    block = min(block, b)
    if b % block:
        block = b  # ragged banks: one block
    nb = b // block
    part = _smallest(d.reshape(t, nb, block), min(k, block))
    return _smallest(_pad_inf(part.reshape(t, -1), k), k)


def _binned_smallest_k(d: torch.Tensor, k: int, bins: int) -> torch.Tensor:
    """[T, B] -> [T, k] approximate smallest: each STRIDED bin (slot i ->
    bin i % bins) keeps its minimum, top-k over the bin minima. A ragged
    bank's valid rows occupy its first `count` slots; strided bins spread
    them over every bin, and when count <= bins each valid row is its own
    candidate (the approximation is exact)."""
    t, b = d.shape
    bins = min(bins, b)
    if b % bins:
        bins = b
    mins = d.reshape(t, b // bins, bins).amin(dim=1)
    return _smallest(_pad_inf(mins, k), k)


def _smallest_k(d: torch.Tensor, k: int, topk: str, block: int,
                approx_oversample: int) -> torch.Tensor:
    """The one top-k dispatch: 'exact' -> blocked, 'approx' -> binned with
    bins = pow2(k * approx_oversample)."""
    if topk == "exact":
        return _blocked_smallest_k(d, k, block)
    if topk == "approx":
        return _binned_smallest_k(d, k, pow2_bank_size(k * approx_oversample))
    raise ValueError(f"unknown topk {topk!r}; expected 'exact' | 'approx'")


def _mask_padding(d: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Slots at or past the row's bank count -> +inf, so padding can never
    be a neighbour. counts: a scalar or [T]."""
    slot = torch.arange(d.shape[1], device=d.device)
    counts = counts.reshape(-1, 1) if counts.dim() else counts
    return torch.where(slot[None, :] < counts, d,
                       torch.full_like(d, float("inf")))


def knn_smallest_k(q: torch.Tensor, bank: torch.Tensor,
                   count: Union[int, torch.Tensor], k: int,
                   topk: str = "exact", block: int = 512,
                   approx_oversample: int = 32) -> torch.Tensor:
    """[T, k] smallest squared distances to one bank [B, L], ascending;
    padding slots (>= count) are masked to +inf first."""
    d = dist_tiles(q, bank)
    counts = torch.as_tensor(count, device=d.device)
    return _smallest_k(_mask_padding(d, counts), k, topk, block,
                       approx_oversample)


def _kth_of_smallest(smallest: torch.Tensor,
                     counts: Union[int, torch.Tensor], k: int
                     ) -> torch.Tensor:
    """[T, k] ascending candidates + valid counts (scalar or [T]) -> the
    k-th neighbour score [T] f32. A row whose bank holds fewer than k valid
    latents scores against its farthest available neighbour; an EMPTY bank
    scores 0."""
    t = smallest.shape[0]
    counts = torch.as_tensor(counts, device=smallest.device).expand(t)
    idx = (torch.clamp(counts, max=k) - 1).clamp(0, k - 1).long()
    kth = torch.gather(smallest, 1, idx[:, None])[:, 0]
    return torch.where(counts > 0, torch.sqrt(kth), torch.zeros_like(kth))


def knn_kth_distance(q: torch.Tensor, bank: torch.Tensor,
                     count: Union[int, torch.Tensor], k: int,
                     topk: str = "exact", block: int = 512) -> torch.Tensor:
    """The anomaly score [T]: Euclidean distance to the k-th nearest latent
    of one bank [B, L], f32."""
    smallest = knn_smallest_k(q, bank, count, k, topk=topk, block=block)
    return _kth_of_smallest(smallest, count, k)


def routed_kth_distance(latents: torch.Tensor, gw: torch.Tensor,
                        bank: ReferenceBank, k: int, topk: str = "exact",
                        block: int = 512, approx_oversample: int = 32,
                        max_onehot_cols: int = 4096) -> torch.Tensor:
    """Multi-tenant k-th distance: row i scores against bank gw[i] of a
    stacked ReferenceBank, in ONE distance launch with gw as the per-row
    bank index whatever N * L is (the JAX one-hot / gather split was a TPU
    shape). `max_onehot_cols` is kept for the JAX API and ignored."""
    del max_onehot_cols
    d = dist_tiles(latents, bank.latents, gw)
    counts = bank.count[gw.long()]
    d = _mask_padding(d, counts)
    return _kth_of_smallest(_smallest_k(d, k, topk, block, approx_oversample),
                            counts, k)
