"""Per-gateway reference banks of normal latents, the kNN scorer's state
(port of fedmse_tpu/knn/bank.py).

A gateway's bank is a fixed-capacity sample of the latents its OWN model
assigns to its own normal training rows. All N banks stack into one
[N, B, L] tensor with a per-gateway valid `count`, so the federation scores
in one launch:

  * count >= B: a uniform random subset of B valid latents, drawn by the
    priority trick (one uniform priority per row, invalid rows pinned to
    +inf, the B smallest win, in ascending priority);
  * count < B: every valid latent first, the tail zeroed; the scorer masks
    slots past `count` to +inf distance.

Random draws: the JAX package keys gateway g's priorities with
fold_in(key(seed), g). The port cannot reproduce threefry's stream without
JAX; it draws them from a CPU torch.Generator seeded from (seed, absolute
gateway index) and moves them to the device, so the card and the CPU build
the same bank. JAX's two rules hold: gateway g's bank does not depend on the
number of gateways, and `build_banks` builds exactly the bank the evaluator
builds in program from the same inputs.

Persistence: `save_bank` / `load_bank` write and read npz with the keys
`latents` and `count`, the JAX package's file, so either package reads the
other's banks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.ops.fused_ae import encode_rows


def pow2_bank_size(bank_size: int) -> int:
    """Round a requested capacity up to a power of two."""
    if bank_size < 1:
        raise ValueError(f"bank_size must be >= 1, got {bank_size}")
    return 1 << (bank_size - 1).bit_length()


@dataclasses.dataclass
class ReferenceBank:
    """Stacked per-gateway banks."""

    latents: torch.Tensor  # [N, B, L] f32; slots past count[g] are padding
    count: torch.Tensor    # [N] int32; valid slots per gateway (<= B)

    @property
    def num_gateways(self) -> int:
        return self.latents.shape[0]

    @property
    def bank_size(self) -> int:
        return self.latents.shape[1]

    @property
    def latent_dim(self) -> int:
        return self.latents.shape[2]

    def to(self, device: DeviceLike) -> "ReferenceBank":
        dev = resolve_device(device)
        return ReferenceBank(
            latents=torch.as_tensor(self.latents).to(dev, torch.float32)
            .contiguous(),
            count=torch.as_tensor(self.count).to(dev, torch.int32))


def bank_generator(seed: int, gateway: int) -> torch.Generator:
    """The CPU generator of gateway `gateway`'s priority draw: seeded from
    (seed, absolute gateway index) only."""
    state = np.random.SeedSequence([int(seed), int(gateway)]).generate_state(
        2, dtype=np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) & 0x7fffffff) << 32 | int(state[1]))


def bank_priorities(seed: int, n: int, rows: int, first: int = 0,
                    device: DeviceLike = "cpu") -> torch.Tensor:
    """[n, rows] uniform priorities of gateways first .. first + n - 1,
    drawn on the CPU and moved to `device`."""
    pri = torch.stack([torch.rand(rows, generator=bank_generator(seed, g))
                       for g in range(first, first + n)]) if n else \
        torch.empty((0, rows))
    return pri.to(device)


def downsample_stacked(latent: torch.Tensor, valid: torch.Tensor,
                       priority: torch.Tensor, bank_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The priority trick over a stack of gateways: latent [N, S, L], valid
    [N, S] bool, priority [N, S] -> (bank [N, B, L] f32, count [N] int32);
    valid rows lead in ascending priority, padding slots are zero."""
    bank_size = pow2_bank_size(bank_size)
    n, rows, lat = latent.shape
    pri = torch.where(valid, priority, torch.full_like(priority,
                                                      float("inf")))
    if rows <= bank_size:
        # every row fits: keep all, valid rows first, pad to B
        order = torch.argsort(pri, dim=1, stable=True)
        idx = torch.cat([order, torch.zeros((n, bank_size - rows),
                                            dtype=order.dtype,
                                            device=order.device)], dim=1)
    else:
        idx = torch.topk(pri, bank_size, dim=1, largest=False,
                         sorted=True).indices
    bank = torch.gather(latent.to(torch.float32), 1,
                        idx[:, :, None].expand(n, bank_size, lat))
    count = torch.clamp(valid.sum(dim=1), max=bank_size).to(torch.int32)
    slot = torch.arange(bank_size, device=latent.device)
    keep = (slot[None, :] < count[:, None])[:, :, None]
    return torch.where(keep, bank, torch.zeros_like(bank)), count


def downsample_latents(latent: torch.Tensor, mask: Optional[torch.Tensor],
                       bank_size: int, generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bank [B, L] f32, count int32): a uniform sample of one gateway's
    valid rows `latent` [S, L] (mask [S] or None: all valid), priorities
    drawn from the CPU `generator` (bank_generator for gateway g)."""
    rows = latent.shape[0]
    valid = (torch.ones(rows, device=latent.device) if mask is None
             else mask.reshape(rows)) > 0
    pri = torch.rand(rows, generator=generator).to(latent.device)
    bank, count = downsample_stacked(latent[None], valid[None], pri[None],
                                     bank_size)
    return bank[0], count[0]


@torch.no_grad()
def build_banks(model, stacked_params: Any, train_x, train_m=None,
                bank_size: Optional[int] = None, seed: int = 0,
                existing: Optional[ReferenceBank] = None) -> ReferenceBank:
    """Encode each gateway's train rows with ITS OWN params and downsample
    to a stacked ReferenceBank on the params' device.

    train_x: batch-major [N, NB, B, D] or flat [N, S, D]; train_m the
    matching row mask (None: all valid). Gateway g's draw is seeded from
    (seed, g), as in the evaluator, so a persisted bank and the evaluator's
    in-program bank from the same inputs are identical.

    REFRESH (`existing`): the rows are NEW normal latents merged into a
    resident bank; each gateway's refreshed bank is a uniform sample over
    its retained slots (slot < count) and its valid new rows, with the old
    bank's padding and the new rows' mask both excluded. Capacity defaults
    to the existing bank's (pass `bank_size` to change it). This is the
    drift-triggered hot-swap payload of ContinuousBatcher.swap(banks=...)."""
    latent = encode_rows(model, stacked_params, train_x)
    n, s, _ = latent.shape
    dev = latent.device
    valid = (torch.ones((n, s), dtype=torch.bool, device=dev)
             if train_m is None
             else torch.as_tensor(train_m).to(dev).reshape(n, s) > 0)
    if existing is not None:
        if existing.num_gateways != n:
            raise ValueError(f"existing bank holds {existing.num_gateways} "
                             f"gateways, refresh rows cover {n}")
        old = existing.to(dev)
        slot = torch.arange(old.bank_size, device=dev)
        latent = torch.cat([old.latents, latent], dim=1)
        valid = torch.cat([slot[None, :] < old.count[:, None], valid], dim=1)
    if bank_size is None:
        bank_size = existing.bank_size if existing is not None else 1024
    pri = bank_priorities(seed, n, latent.shape[1], device=dev)
    bank, count = downsample_stacked(latent, valid, pri, bank_size)
    return ReferenceBank(latents=bank, count=count)


# ------------------------------ persistence ------------------------------ #

def save_bank(path: str, bank: ReferenceBank) -> str:
    """Persist a bank as npz (f32 latents, int32 count)."""
    np.savez(path,
             latents=torch.as_tensor(bank.latents).detach().cpu().numpy()
             .astype(np.float32),
             count=torch.as_tensor(bank.count).detach().cpu().numpy()
             .astype(np.int32))
    return path


def load_bank(path: str, device: DeviceLike = "cuda") -> ReferenceBank:
    """A bank saved by either package, placed on `device`."""
    with np.load(path) as z:
        return ReferenceBank(latents=torch.from_numpy(z["latents"]),
                             count=torch.from_numpy(z["count"])).to(device)


def bank_path(writer, run: int, model_type: str, update_type: str) -> str:
    """The bank's place in the run's Serving tree, beside the calibration
    JSON."""
    d = writer.serving_dir(run)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{model_type}_{update_type}_knn_bank.npz")
