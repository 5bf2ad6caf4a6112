"""Per-gateway fresh-data reservoirs fed from the serving hot path (port of
fedmse_tpu/flywheel/buffer.py; numpy only, its reservoirs the JAX
package's bit for bit).

The flywheel's training data is the traffic the fleet just served: rows
the deployed detector verdicted NORMAL accumulate in fixed-capacity host
reservoirs, one per gateway, so a drift-triggered fine-tune always has a
recent sample of each gateway's live normal traffic (the paper's
semi-supervised premise applied to the serving stream).

Reservoir mechanics are the host twin of knn/bank.py's priority trick:
every admitted row draws a uniform priority from its gateway's OWN stream
and the `capacity` smallest priorities win, a uniform sample over
everything the gateway ever admitted, as one vectorized sort per (batch,
gateway).

Recency weighting (`decay`): with λ in (0, 1], the j-th row a gateway ever
admits draws priority log E_j + j·log λ (E_j a unit exponential from the
same stream): A-Res weighted reservoir sampling in log space, so a row
admitted d rows ago survives with relative weight λ^d and the reservoir
tracks a walking regime without being emptied. None (the default) keeps
the uniform path and its draw stream.

Determinism: gateway g's priority stream is seeded by (seed, g) with g
the ABSOLUTE gateway index and consumed in g's own arrival order, so what
g retains depends only on (seed, g, g's admitted rows): padding the
gateway axis or interleaving other gateways' traffic cannot move it.

`tap()` is the `ContinuousBatcher(intake=...)` callable: one call per
harvested batch with its (rows, gateways, scores, verdicts).
`build_finetune_data` stacks the reservoirs into the host arrays of a
FederatedData; `FinetuneData.federated(device, dtype)` places them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def stack_ragged_rows(rows_list: List[np.ndarray], dim: int,
                      width: Optional[int] = None):
    """[N, S, D] zero-padded stack + [N, S] float row mask from ragged
    per-gateway rows (S = `width`, default the max length, floored at 1
    so the stacked shape stays valid) — the ONE home of the flywheel's
    ragged-stack padding contract (build_finetune_data and the swap
    payload's bank/centroid refresh both use it)."""
    n = len(rows_list)
    s = width if width is not None else max(
        1, max((len(r) for r in rows_list), default=1))
    x = np.zeros((n, s, dim), np.float32)
    m = np.zeros((n, s), np.float32)
    for g, rows in enumerate(rows_list):
        x[g, :len(rows)] = rows
        m[g, :len(rows)] = 1.0
    return x, m


@dataclasses.dataclass
class FinetuneData:
    """One fine-tune's worth of buffered data, split and stacked.

    `arrays` holds the host arrays of a FederatedData over the FULL
    gateway axis (the fused round wants static shapes), by field name;
    `federated(device, dtype)` places them. `eligible` marks the gateways
    that hold enough fresh rows to train (a roster member AND >= min_rows
    buffered): the others carry zero row masks and client_mask 0, sit the
    fine-tune out, and keep their params, bank and threshold through the
    swap (flywheel/swap.py)."""

    arrays: Dict[str, np.ndarray]
    eligible: np.ndarray              # [N] bool
    train_rows: List[np.ndarray]      # per gateway [t_g, D] (empty if not
    valid_rows: List[np.ndarray]      # per gateway [v_g, D]  eligible)

    def federated(self, device, dtype=None):
        """The FederatedData of these arrays on `device`: the feature
        tensors in `dtype` (the precision policy's compute dtype; None =
        float32), masks and labels float32."""
        import torch

        from fedmse_tpu_torch.data.stacking import FederatedData

        features = ("train_xb", "valid_xb", "valid_x", "test_x", "dev_x")
        return FederatedData(**{
            name: torch.tensor(a).to(
                device=device, dtype=(dtype or torch.float32)
                if name in features else torch.float32)
            for name, a in self.arrays.items()})


class FlywheelBuffer:
    """Fixed-capacity per-gateway reservoirs of served-normal rows."""

    def __init__(self, num_gateways: int, dim: int, capacity: int = 512,
                 seed: int = 0, decay: Optional[float] = None,
                 margin_frac: Optional[float] = None,
                 thresholds_fn=None,
                 influence_cap: Optional[float] = None):
        if num_gateways < 1:
            raise ValueError(f"num_gateways must be >= 1, got {num_gateways}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if decay is not None and not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if margin_frac is not None and not 0.0 < margin_frac <= 1.0:
            raise ValueError(f"margin_frac must be in (0, 1], got "
                             f"{margin_frac}")
        if margin_frac is not None and thresholds_fn is None:
            # a floor with no threshold source would silently admit
            # everything — the defense must fail loudly, not open
            raise ValueError("margin_frac needs thresholds_fn (a callable "
                             "returning the DEPLOYED per-gateway [N] "
                             "thresholds — e.g. lambda: front.engine."
                             "calibration.thresholds)")
        if influence_cap is not None and not 0.0 < influence_cap <= 1.0:
            raise ValueError(f"influence_cap must be in (0, 1], got "
                             f"{influence_cap}")
        self.num_gateways = num_gateways
        self.dim = dim
        self.capacity = capacity
        self.seed = seed
        # None = uniform reservoir (the byte-pinned default); else the
        # exponential recency weight per admitted row (module docstring)
        self.decay = decay
        self._log_decay = None if decay is None else float(np.log(decay))
        # reservoir admission hardening (redteam/traffic.py): margin_frac
        # admits only rows scoring <= margin_frac x the DEPLOYED
        # threshold — the slow-drift adversary's probe rows live
        # just under threshold, exactly the band the floor excludes;
        # influence_cap bounds one gateway's share of a fine-tune's train
        # rows. Both default None = byte-identical to the unhardened path.
        self.margin_frac = margin_frac
        self.thresholds_fn = thresholds_fn
        self.influence_cap = influence_cap
        self._rows = np.zeros((num_gateways, capacity, dim), np.float32)
        self._pri = np.full((num_gateways, capacity), np.inf)
        self.count = np.zeros(num_gateways, np.int64)  # valid slots
        self.seen = np.zeros(num_gateways, np.int64)   # rows ever admitted
        # per-gateway priority streams, created lazily on first traffic
        # (a 100k-gateway fleet should not pay 100k Generator objects for
        # the handful of gateways that actually see rows)
        self._rngs: Dict[int, np.random.Generator] = {}

    def _rng(self, g: int) -> np.random.Generator:
        rng = self._rngs.get(g)
        if rng is None:
            # seeded by (seed, ABSOLUTE gateway index): the host analog of
            # fold_in(key(seed), g) — gateway g's stream is independent of
            # the axis length and of every other gateway
            rng = self._rngs[g] = np.random.default_rng((self.seed, g))
        return rng

    def admit(self, rows, gateway_ids, verdicts=None, scores=None) -> int:
        """Admit one served batch; returns the rows admitted.

        `verdicts` (bool [n], True = anomalous) filters to the NORMAL
        rows — the semi-supervised admission rule. None admits everything
        (callers that pre-filter). `scores` is unused UNLESS the
        verdict-margin floor is armed (`margin_frac` + `thresholds_fn`):
        then a row must score <= margin_frac x its gateway's DEPLOYED
        threshold to be admitted — "verdicted normal" stops being enough,
        the row must be normal with margin. A slow-drift poisoner's rows
        ride just under threshold by construction, so the floor cuts it
        off at margin_frac of the walk while genuinely normal traffic
        (which scores well below threshold) passes untouched."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        gw = np.broadcast_to(np.asarray(gateway_ids, np.int32),
                             (rows.shape[0],))
        sc = (None if scores is None else
              np.broadcast_to(np.asarray(scores, np.float64),
                              (rows.shape[0],)))
        if verdicts is not None:
            keep = ~np.asarray(verdicts, bool)
            rows, gw = rows[keep], gw[keep]
            sc = None if sc is None else sc[keep]
        if self.margin_frac is not None and sc is not None:
            thr = np.asarray(self.thresholds_fn(), np.float64)
            rows_ok = sc <= self.margin_frac * thr[gw]
            rows, gw = rows[rows_ok], gw[rows_ok]
        if not len(rows):
            return 0
        for g in np.unique(gw):
            sel = gw == g
            self._admit_one(int(g), rows[sel])
        return len(rows)

    def _admit_one(self, g: int, xs: np.ndarray) -> None:
        if self._log_decay is None:
            pri = self._rng(g).random(len(xs))
        else:
            # A-Res in log space (module docstring): key_j = E_j / λ^{-j}
            # -> log E_j + j log λ, with j the gateway's ABSOLUTE
            # admission index — like the uniform path, the priority is a
            # pure function of (seed, g, j), so padding/layout/interleave
            # invariance carries over unchanged
            j = self.seen[g] + np.arange(len(xs), dtype=np.float64)
            e = self._rng(g).standard_exponential(len(xs))
            pri = np.log(e) + j * self._log_decay
        cnt = int(self.count[g])
        pool_pri = np.concatenate([self._pri[g, :cnt], pri])
        pool_rows = np.concatenate([self._rows[g, :cnt], xs], axis=0)
        # keep the capacity smallest priorities (the bank.py top_k trick,
        # host-side); argsort — not argpartition — so slot order is a pure
        # function of the priorities, never of numpy partition internals
        order = np.argsort(pool_pri, kind="stable")[:self.capacity]
        k = len(order)
        self._rows[g, :k] = pool_rows[order]
        self._pri[g, :k] = pool_pri[order]
        self._pri[g, k:] = np.inf
        self.count[g] = k
        self.seen[g] += len(xs)

    def tap(self):
        """The `ContinuousBatcher(intake=...)` callable."""
        def intake(rows, gateway_ids, scores, verdicts):
            self.admit(rows, gateway_ids, verdicts=verdicts, scores=scores)
        return intake

    def rows_for(self, g: int) -> np.ndarray:
        """Gateway g's current reservoir contents [count_g, D] (a copy)."""
        return self._rows[g, :int(self.count[g])].copy()

    def occupancy(self) -> Dict:
        """JSON-safe fill telemetry (the sweep's buffer_occupancy field)."""
        return {
            "capacity": self.capacity,
            "count": self.count.tolist(),
            "seen": self.seen.tolist(),
            "fill_fraction": float(np.mean(self.count / self.capacity)),
        }

    def clear(self, gateways=None) -> None:
        """Drop buffered rows (all gateways, or the given subset). The
        priority STREAMS keep advancing — a cleared gateway's future
        retention stays deterministic."""
        idx = (slice(None) if gateways is None
               else np.asarray(gateways, np.int64))
        self._pri[idx] = np.inf
        self.count[idx] = 0

    # ------------------------- fine-tune stacking ------------------------ #

    def build_finetune_data(self, batch_size: int, dev_x: np.ndarray,
                            valid_frac: float = 0.25, min_rows: int = 16,
                            member: Optional[np.ndarray] = None
                            ) -> FinetuneData:
        """Stack the reservoirs into the arrays of a FederatedData for the
        fine-tune rounds (federation/rounds.py RoundEngine consumes it
        unchanged, placed by `FinetuneData.federated`).

        Each eligible gateway's reservoir splits train/valid by slot
        order (slot order is already a uniform shuffle — it is priority
        order; under `decay` it is recency-biased instead, so the valid
        tail skews toward the oldest retained rows — the conservative
        side for threshold refits under drift); ineligible gateways
        (non-`member` under the serving roster, or fewer than `min_rows`
        buffered) get zero row masks and client_mask 0. The fine-tune has
        no labeled test traffic, so the test tensors alias the valid split
        with all-normal labels —
        per-round AUC is NaN by construction (single class) and every
        consumer is nan-aware; recovery is measured by the serving-side
        evaluation, not the fine-tune's internal metric.
        `dev_x` is the incumbent federation's shared dev set (aggregation
        weighting + dev-method verification need it)."""
        if not 0.0 < valid_frac < 1.0:
            raise ValueError(f"valid_frac must be in (0, 1), got {valid_frac}")
        if min_rows < 2:
            raise ValueError(f"min_rows must be >= 2 (the split needs at "
                             f"least one train and one valid row), got "
                             f"{min_rows}")
        n = self.num_gateways
        member = (np.ones(n, bool) if member is None
                  else np.asarray(member, bool))
        eligible = member & (self.count >= min_rows)
        train_rows: List[np.ndarray] = []
        valid_rows: List[np.ndarray] = []
        for g in range(n):
            if not eligible[g]:
                train_rows.append(np.zeros((0, self.dim), np.float32))
                valid_rows.append(np.zeros((0, self.dim), np.float32))
                continue
            rows = self.rows_for(g)
            # clamp BOTH ends: at least one valid row, and at least one
            # train row even when valid_frac rounds to the whole
            # reservoir (min_rows >= 2 makes the clamp satisfiable)
            n_valid = min(len(rows) - 1,
                          max(1, int(round(valid_frac * len(rows)))))
            train_rows.append(rows[:-n_valid])
            valid_rows.append(rows[-n_valid:])

        if self.influence_cap is not None:
            # per-gateway influence cap: no single gateway
            # may contribute more than influence_cap of the fine-tune's
            # total train rows — a captive gateway streaming at full rate
            # cannot dominate the update however fast it fills its
            # reservoir. Trimming keeps the FIRST slots (priority order =
            # a uniform subsample), so the cap is deterministic and the
            # kept rows remain an unbiased sample of the reservoir.
            total = sum(len(r) for r in train_rows)
            cap = max(1, int(self.influence_cap * total))
            train_rows = [r[:cap] for r in train_rows]

        def ceil_div(a: int, b: int) -> int:
            return -(-a // b)

        def batched(rows_list, nb):
            xb = np.zeros((n, nb, batch_size, self.dim), np.float32)
            mb = np.zeros((n, nb, batch_size), np.float32)
            flat_dim = nb * batch_size
            for g, rows in enumerate(rows_list):
                xb[g].reshape(flat_dim, self.dim)[:len(rows)] = rows
                mb[g].reshape(flat_dim)[:len(rows)] = 1.0
            return xb, mb

        nb = max(1, max((ceil_div(len(r), batch_size) for r in train_rows),
                        default=1))
        nvb = max(1, max((ceil_div(len(r), batch_size) for r in valid_rows),
                         default=1))
        train_xb, train_mb = batched(train_rows, nb)
        valid_xb, valid_mb = batched(valid_rows, nvb)
        valid_x, valid_m = stack_ragged_rows(valid_rows, self.dim)
        arrays = dict(
            train_xb=train_xb, train_mb=train_mb,
            valid_xb=valid_xb, valid_mb=valid_mb,
            valid_x=valid_x, valid_m=valid_m,
            # no labeled test traffic mid-serve: the valid normals stand in
            # (all labels 0 -> NaN per-round metric, docstring above)
            test_x=valid_x, test_m=valid_m,
            test_y=np.zeros(valid_m.shape, np.float32),
            dev_x=np.asarray(dev_x, np.float32),
            client_mask=eligible.astype(np.float32),
        )
        return FinetuneData(arrays=arrays, eligible=eligible,
                            train_rows=train_rows, valid_rows=valid_rows)
