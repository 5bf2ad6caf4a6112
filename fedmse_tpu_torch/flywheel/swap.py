"""One atomic, roster-aware swap payload: params + banks + thresholds (port
of fedmse_tpu/flywheel/swap.py).

The flywheel's output lands in the serving front as ONE event: params
installed without their thresholds would verdict the first post-swap
batches against a threshold fit under the old model, and a kNN bank
refreshed without the params that encoded it would measure distances in a
stale latent space. So the payload is built completely before anything is
installed:

  1. splice: fine-tuned params for eligible gateways, incumbent rows for
     every other gateway, bit for bit (a gateway the fine-tune never
     touched serves exactly what it served before);
  2. score state: kNN banks merge the buffered fresh latents under the NEW
     params (`knn.build_banks(existing=...)`: one forward launch encodes
     every gateway's rows), centroid engines refit their per-gateway
     centroids on the same rows; ineligible gateways keep bank or
     centroid bit for bit;
  3. thresholds: each eligible gateway's held-out buffered normals are
     scored against the CANDIDATE state in one routed forward launch
     (`ServingEngine.score_candidate`: nothing installed) and its
     threshold, mean and std refit (`refit_calibration`);
  4. install: ONE `ContinuousBatcher.swap(params=, banks=, centroids=,
     calibration=)`: batches in flight keep the old regime, the forming
     batch dispatches under the new one, the drift monitor rebaselines
     and arms its cooldown, and no ticket is dropped or scored twice.

Every tensor of the payload is new: the resident state is never written
in place, so what the engine serves changes only at the install.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from fedmse_tpu_torch.flywheel.buffer import stack_ragged_rows
from fedmse_tpu_torch.knn.bank import ReferenceBank, build_banks
from fedmse_tpu_torch.models.centroid import CentroidClassifier
from fedmse_tpu_torch.serving.calibration import (ServingCalibration,
                                                  refit_row)
from fedmse_tpu_torch.serving.engine import fit_gateway_centroids

logger = logging.getLogger(__name__)


def refit_calibration(base: ServingCalibration,
                      scores_by_gateway: Dict[int, np.ndarray]
                      ) -> ServingCalibration:
    """One COPY of `base` with each given gateway's threshold, mean, std
    and count refit on fresh normal scores: chaining
    `ServingCalibration.refit` per gateway, in one copy. Gateways not in
    the dict keep their calibration."""
    thresholds = base.thresholds.copy()
    mean, std = base.mean.copy(), base.std.copy()
    count = base.count.copy()
    for g, scores in scores_by_gateway.items():
        thresholds[g], mean[g], std[g], count[g] = refit_row(
            scores, base.percentile)
    return ServingCalibration(percentile=base.percentile,
                              thresholds=thresholds, mean=mean, std=std,
                              count=count, model_type=base.model_type)


def _select(eligible: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Row g of `new` where eligible[g], else of `old` ([N, ...] leaves),
    as a new f32 tensor."""
    sel = eligible.view((-1,) + (1,) * (new.dim() - 1))
    return torch.where(sel, new.to(torch.float32), old.to(torch.float32))


def _splice(eligible: np.ndarray, new_tree, old_tree):
    """The per-gateway select of `_select` over two params trees."""
    if isinstance(new_tree, dict):
        return {k: _splice(eligible, new_tree[k], old_tree[k])
                for k in new_tree}
    old = torch.as_tensor(old_tree)
    new = (new_tree if isinstance(new_tree, torch.Tensor)
           else torch.from_numpy(np.array(new_tree, np.float32)))
    new = new.to(old.device)
    return _select(torch.as_tensor(eligible, device=old.device), new, old)


def build_and_apply_swap(batcher, model, finetune, new_params,
                         extra_event: Optional[Dict] = None) -> Dict:
    """Build the full payload from a finished fine-tune and install it with
    ONE `batcher.swap` call (module docstring); returns the swap event,
    extended with the flywheel's bookkeeping.

    `finetune` is the FinetuneData the fine-tune trained on (its train
    split refreshes the banks or centroids, its valid split refits the
    thresholds); `new_params` the fine-tuned stacked f32 tree (tensors or
    numpy, [N, ...] leaves); `model` encodes the rows."""
    engine = batcher.engine
    eligible = np.asarray(finetune.eligible, bool)
    if not eligible.any():
        raise ValueError("swap payload: no eligible gateway (nothing was "
                         "fine-tuned)")
    dev = engine.device
    payload_params = _splice(eligible, new_params, engine.params)
    sel = torch.as_tensor(eligible, device=dev)

    # banks and centroids refresh on the TRAIN split only: a valid row
    # merged into the bank would self-match at ~zero latent distance and
    # bias the threshold refit on those very rows low
    fresh_x, fresh_m = stack_ragged_rows(finetune.train_rows, engine.dim)

    banks_payload = None
    if engine.score_kind == "knn" and engine.banks is not None:
        old = engine.banks
        merged = build_banks(model, payload_params, fresh_x, fresh_m,
                             existing=old)
        # ineligible gateways keep their bank EXACTLY (a resample of the
        # retained slots would preserve the distribution, not the bits)
        banks_payload = ReferenceBank(
            latents=_select(sel, merged.latents, old.latents),
            count=torch.where(sel, merged.count, old.count))

    centroids_payload = None
    if engine.score_kind == "centroid" and engine.centroids is not None:
        refit = fit_gateway_centroids(model, payload_params, fresh_x,
                                      fresh_m)
        old = engine.centroids
        centroids_payload = CentroidClassifier(**{
            f.name: _select(sel, getattr(refit, f.name), getattr(old, f.name))
            for f in dataclasses.fields(CentroidClassifier)})

    # thresholds fit on CANDIDATE scores, what the post-swap engine will
    # give each gateway's held-out normals: one routed dispatch per bucket
    # for the whole eligible set, split back per gateway
    candidate = engine.candidate_state(
        params=payload_params, banks=banks_payload,
        centroids=centroids_payload)
    gateways = [int(g) for g in np.flatnonzero(eligible)]
    counts = [len(finetune.valid_rows[g]) for g in gateways]
    all_rows = np.concatenate([finetune.valid_rows[g] for g in gateways])
    all_gws = np.repeat(np.asarray(gateways, np.int32), counts)
    all_scores = engine.score_candidate(candidate, all_rows, all_gws)
    scores_by_gateway: Dict[int, np.ndarray] = dict(
        zip(gateways, np.split(all_scores, np.cumsum(counts)[:-1])))
    calibration = refit_calibration(batcher.calibration, scores_by_gateway)

    t0 = time.perf_counter()
    event = batcher.swap(params=payload_params, banks=banks_payload,
                         centroids=centroids_payload,
                         calibration=calibration)
    event["flywheel"] = {
        # the serving thread's stall: what the install itself took
        "install_seconds": time.perf_counter() - t0,
        "eligible_gateways": gateways,
        "refit_thresholds": {g: float(calibration.thresholds[g])
                             for g in scores_by_gateway},
        "bank_refreshed": banks_payload is not None,
        "centroids_refreshed": centroids_payload is not None,
        **(extra_event or {}),
    }
    logger.info("flywheel swap installed: %s (gateways %s)",
                event["kinds"], gateways)
    return event
