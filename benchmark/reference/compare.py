"""The comparison that decides `correct` for the federated training cells.

Both sides are given as {"params0": [N, P], "rounds": [one dict a round],
"states": [{"params", "mu"} after each set-up chunk], "evals": [{"scores"
[N, T]} after each set-up chunk but the first]} on the host; a round
holds "aggregator" (-1: none), "scores" and "weights" [N], "rejected" [N]
(-1 where not reported), "metrics" [N] (AUC) and "tracking" [N, E, 3]
(NaN rows: not selected; (train loss, valid loss, 1) where the epoch ran).

The numbers, each the worst over the set-up rounds:

* `first_epoch_gap`: the first round's first epoch, each cohort client's
  train and validation losses, |program - reference| / |reference|, the
  larger of the two, the median client (the first epoch is the steady
  reading: later epochs of the shrink autoencoder carry the chaos of its
  latent-norm gradient, PERF.md);
* `loss_gap`: the cohort's mean train loss (each client's mean over the
  epochs it ran), |program - reference| / |reference|;
* `moment_gap` (Adam's first moment after the first round, standing for
  the gradient as the optimizer gets it; the first round's cohort) and
  `change_gap` (the parameters' change from the initial ones after the
  set-up rounds; every client): for each client its worst parameter
  tensor's |program's norm - reference's norm| / max(reference's norm,
  the client's median tensor's), then the median client. Tensors whose
  reference moment is under a thousandth of the client's median tensor's
  move under Adam by round-off alone and are left out of both. (Over the
  whole stacked tensors instead, a few clients whose early stop falls on
  the other side of a tie dominate: PERF.md gives both readings);
* `election_margin`: the election judged by what it says: by how much the
  score the program's winning voter gave the program's aggregator lies
  above the least score among that voter's candidates (the reference's
  cohort but the voter; the quota cannot bind in the first rounds), as a
  share of it; infinite when the program found no aggregator;
* `vote_gap`: the winning voter's scores, max |p - r| / |r|;
* `weight_gap`: the merge's weights, max |p - r| / max r;
* `vote_gap_first`, `weight_gap_first`: the same, of the first round
  alone, whatever aggregator each side chose (both start the round from
  the same state, and its voter is the first selected client on both);
  infinite where one side found an aggregator and the other did not;
* `auc_gap`: every client's AUC, max |p - r|;
* `score_gap`: the evaluation's anomaly scores of every test row of
  every client (reconstruction MSE, or the kNN distance), the program's
  against the reference's under the same parameters (those the program
  held after the round: the reference recomputes the scores, and for the
  kNN score the banks, from them): each client's widest |p - r| over its
  rows, as a share of the larger of its own largest |r| and the median
  client's largest |r|, the widest over the clients. (Per row, a gap is
  ill-conditioned: a kNN distance far smaller than the latents' norms,
  or a client whose latents have collapsed to zero, reads rounding as a
  large share of itself, PERF.md);
* `aggregator_flips`: the rounds whose aggregator differs (exact);
* `decisions`: the rounds whose aggregator differs plus the clients
  whose rejection count differs (exact).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.reference.fedmse import leaf_shapes

NUMBERS = ("first_epoch_gap", "loss_gap", "moment_gap", "change_gap",
           "election_margin", "vote_gap", "weight_gap", "vote_gap_first",
           "weight_gap_first", "auc_gap", "score_gap", "aggregator_flips",
           "decisions")
EXACT = ("aggregator_flips", "decisions")
# a tensor whose reference gradient is under this share of the median
# tensor's moves under Adam by round-off alone
NOUGHT = 1e-3


def _cohort_loss(tracking: np.ndarray) -> float:
    ran = tracking[..., 2] == 1
    rows = ~np.isnan(tracking[:, 0, 0])
    per = np.where(ran, tracking[..., 0], 0.0).sum(axis=1) \
        / np.maximum(ran.sum(axis=1), 1)
    return float(per[rows].mean())


def _leaf_norms(flat: np.ndarray, dims) -> np.ndarray:
    """[N, 8]: each client's norm of each parameter tensor."""
    out, at = [], 0
    for shape in leaf_shapes(dims):
        size = int(np.prod(shape))
        out.append(np.linalg.norm(flat[:, at:at + size].astype(np.float64),
                                  axis=1))
        at += size
    return np.stack(out, axis=1)


def _rel(p: np.ndarray, r: np.ndarray) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape or (np.isnan(p) != np.isnan(r)).any():
        return float("inf")
    ok = ~np.isnan(r)
    if not ok.any():
        return 0.0
    den = np.maximum(np.abs(r[ok]), 1e-30)
    return float((np.abs(p[ok] - r[ok]) / den).max())


def median_client_gap(prog: np.ndarray, ref: np.ndarray,
                      keep: np.ndarray) -> float:
    """The median over clients (rows) of the worst kept tensor's gap of
    norms, each against max(its reference norm, the client's median)."""
    floor = np.median(ref, axis=1, keepdims=True)
    gaps = np.abs(prog - ref) / np.maximum(np.maximum(ref, floor), 1e-30)
    return float(np.median(np.where(keep, gaps, 0.0).max(axis=1)))


def _first_epoch_gap(p: np.ndarray, r: np.ndarray) -> float:
    rows = ~np.isnan(r[:, 0, 0])
    p, r = p[rows, 0].astype(np.float64), r[rows, 0].astype(np.float64)
    if not rows.any():
        return 0.0
    if (p[:, 2] != 1).any():
        return float("inf")
    gap = np.abs(p[:, :2] - r[:, :2]) / np.maximum(np.abs(r[:, :2]), 1e-30)
    return float(np.median(gap.max(axis=1)))


def _election_margin(p: Dict, r: Dict) -> float:
    if p["aggregator"] < 0:
        return float("inf")
    sel = r["selected"]
    scores = np.asarray(p["scores"], np.float64)
    cands = [c for c in sel if c != sel[0]]
    best = min(scores[c] for c in cands)
    return float((scores[p["aggregator"]] - best) / max(abs(best), 1e-30))


def _score_gap(p: np.ndarray, r: np.ndarray) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return float("inf")
    top = np.abs(r).max(axis=1)
    den = np.maximum(top, np.median(top))
    return float((np.abs(p - r).max(axis=1) / np.maximum(den, 1e-30)).max())


def compare(prog: Dict, ref: Dict, dims) -> Dict[str, float]:
    """The numbers of the module docstring."""
    out = {k: 0 if k in EXACT else 0.0 for k in NUMBERS}
    out["first_epoch_gap"] = _first_epoch_gap(prog["rounds"][0]["tracking"],
                                              ref["rounds"][0]["tracking"])
    for i, (p, r) in enumerate(zip(prog["rounds"], ref["rounds"])):
        out["election_margin"] = max(out["election_margin"],
                                     _election_margin(p, r))
        lr_, lp = _cohort_loss(r["tracking"]), _cohort_loss(p["tracking"])
        out["loss_gap"] = max(out["loss_gap"],
                              abs(lp - lr_) / max(abs(lr_), 1e-30))
        both = p["aggregator"] >= 0 and r["aggregator"] >= 0
        if both:
            vote = _rel(p["scores"], r["scores"])
            wr = np.asarray(r["weights"], np.float64)
            weight = float(np.abs(np.asarray(p["weights"]) - wr).max()
                           / max(wr.max(), 1e-30))
        if i == 0:
            out["vote_gap_first"], out["weight_gap_first"] = (
                (vote, weight) if both else (0.0, 0.0)
                if p["aggregator"] == r["aggregator"] else
                (float("inf"), float("inf")))
        if p["aggregator"] != r["aggregator"]:
            out["decisions"] += 1
            out["aggregator_flips"] += 1
        elif both:
            out["vote_gap"] = max(out["vote_gap"], vote)
            out["weight_gap"] = max(out["weight_gap"], weight)
        reported = (np.asarray(p["rejected"]) >= 0) & \
            (np.asarray(r["rejected"]) >= 0)
        out["decisions"] += int((np.asarray(p["rejected"])[reported]
                                 != np.asarray(r["rejected"])[reported]).sum())
        ap, ar = np.asarray(p["metrics"], np.float64), \
            np.asarray(r["metrics"], np.float64)
        if (np.isnan(ap) != np.isnan(ar)).any():
            out["auc_gap"] = float("inf")
        else:
            ok = ~np.isnan(ar)
            if ok.any():
                out["auc_gap"] = max(out["auc_gap"],
                                     float(np.abs(ap[ok] - ar[ok]).max()))
    cohort = ~np.isnan(ref["rounds"][0]["tracking"][:, 0, 0])
    for name, at, rows, take in (
            ("moment_gap", 0, cohort, lambda rec, i: rec["states"][i]["mu"]),
            ("change_gap", -1, slice(None),
             lambda rec, i: rec["states"][i]["params"] - rec["params0"])):
        moment = _leaf_norms(ref["states"][at]["mu"], dims)[rows]
        keep = moment >= NOUGHT * np.median(moment, axis=1, keepdims=True)
        out[name] = median_client_gap(_leaf_norms(take(prog, at), dims)[rows],
                                      _leaf_norms(take(ref, at), dims)[rows],
                                      keep)
    if not prog.get("evals") or \
            len(ref.get("evals", ())) < len(prog["evals"]):
        out["score_gap"] = float("inf")
    for p, r in zip(prog.get("evals", ()), ref.get("evals", ())):
        out["score_gap"] = max(out["score_gap"],
                               _score_gap(p["scores"], r["scores"]))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> List[Dict]:
    """Each compared number beside its limit; a number with no limit in
    `limits` is not compared."""
    return [{"name": k, "value": numbers[k], "limit": limits[k],
             "ok": bool(numbers[k] <= limits[k])}
            for k in NUMBERS if k in limits]
