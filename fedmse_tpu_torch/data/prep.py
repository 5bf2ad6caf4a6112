"""Offline federated shard creation (port of fedmse_tpu/data/prep.py, numpy
only: the card's machine has no pandas or sklearn).

The reference notebook's data-prep pipeline (Data-Examination.ipynb):
  1. walk the RAW per-device N-BaIoT tree
     `<root>/<device>/{normal,abnormal}/*.csv` ('benign' files are normal,
     'mirai'/'gafgyt' files are attacks), sample 5% of each device's benign
     rows and 0.5% of each attack file's rows;
  2. the non-IID 'label' is the device of origin, integer-encoded;
  3. hold out 40% of the pooled normal rows as the 'new device'
     test_normal split;
  4. shard normal/abnormal/test_normal across K clients by per-label
     Dirichlet(alpha) proportions (FedArtML's `method="dirichlet"`);
  5. per client, drop origin classes with < 10 rows and write headerless
     `Client-k/{normal,abnormal,test_normal}/data.csv`.

Sources: `--raw` ingests the raw per-device tree (steps 1-3, its files
carry a header line); `--source` pools existing Client-k shards back
together (rows keep their source client as origin label). Modes: IID (a
uniform random partition), non-IID (per-label Dirichlet, `--alpha`), or
`--target-matrix` (the published non-IID split's 10 x 9 count matrix,
rebuilt cell for cell over feature-space modes from `--cluster-labels`).
Every split reports its Jensen-Shannon distance (`js_distance`).

A pooled split is a pair (float64 rows [n, F], origin labels [n]); files
parse through the host reader (data/fast_csv.py). Every draw of
`np.random.default_rng(seed)` is the JAX package's, in its order, so the
same seed picks the same rows. Shards are written with each float64's
shortest round-trip digits (`repr`), so they parse back to the same bits.
`--cluster-labels` runs a k-means++ / Lloyd loop in float64 torch on
`--device` (the card unless `--device cpu`) in place of sklearn's KMeans.

CLI:
  python -m fedmse_tpu_torch.data.prep --source <dir-with-Client-k-shards> \\
      --n-clients 50 --mode noniid --alpha 0.5 --out Data/nbaiot-50
  python -m fedmse_tpu_torch.data.prep --raw <dir-with-device-folders> \\
      --n-clients 10 --mode noniid --alpha 0.5 --out Data/nbaiot-noniid
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.data.fast_csv import read_csv_f64, read_dir_f64
from fedmse_tpu_torch.data.synthetic import dirichlet_partition
from fedmse_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

SPLITS = ("normal", "abnormal", "test_normal")

Pooled = Dict[str, Tuple[np.ndarray, np.ndarray]]


def pool_source_shards(source_dir: str) -> Pooled:
    """Read existing Client-k dirs back into pooled float64 rows; rows keep
    their source-client index as the origin label."""
    clients = sorted(
        (d for d in os.listdir(source_dir) if d.startswith("Client-")),
        key=lambda s: int(s.split("-")[1]))
    pooled = {}
    for split in SPLITS:
        frames, origins = [], []
        for i, c in enumerate(clients):
            path = os.path.join(source_dir, c, split)
            if not os.path.isdir(path):
                continue
            # float64: the shards are rewritten, and must keep their digits
            x = read_dir_f64(path, allow_header=False)
            frames.append(x)
            origins.append(np.full(len(x), i))
        pooled[split] = (np.concatenate(frames), np.concatenate(origins))
    return pooled


def pool_raw_devices(raw_dir: str, benign_frac: float = 0.05,
                     abnormal_frac: float = 0.005, holdout_frac: float = 0.4,
                     seed: int = 42) -> Pooled:
    """Ingest the raw per-device tree: sample `benign_frac` of each device's
    'benign' files and `abnormal_frac` of each 'mirai'/'gafgyt' file (per
    device, benign files first, each file's rows drawn without
    replacement), label rows by device index, and hold out `holdout_frac`
    of the pooled normal rows as test_normal. Device dirs without a
    `normal/` subdir are skipped."""
    rng = np.random.default_rng(seed)
    devices = sorted(
        d for d in os.listdir(raw_dir)
        if os.path.isdir(os.path.join(raw_dir, d, "normal")))
    if not devices:
        raise FileNotFoundError(
            f"no raw device folders (with a normal/ subdir) under {raw_dir}")

    def read_sampled(device_idx: int, path: str, frac: float):
        x = read_csv_f64(path, allow_header=True)
        n = int(frac * x.shape[0])
        take = rng.choice(len(x), size=n, replace=False)
        return x[take], np.full(n, device_idx)

    normal, n_origin, abnormal, a_origin = [], [], [], []
    for i, dev in enumerate(devices):
        ndir = os.path.join(raw_dir, dev, "normal")
        for fname in sorted(os.listdir(ndir)):
            if "benign" in fname:
                x, o = read_sampled(i, os.path.join(ndir, fname), benign_frac)
                normal.append(x)
                n_origin.append(o)
        adir = os.path.join(raw_dir, dev, "abnormal")
        if os.path.isdir(adir):
            for fname in sorted(os.listdir(adir)):
                if "mirai" in fname or "gafgyt" in fname:
                    x, o = read_sampled(i, os.path.join(adir, fname),
                                        abnormal_frac)
                    abnormal.append(x)
                    a_origin.append(o)
    normal, n_origin = np.concatenate(normal), np.concatenate(n_origin)
    abnormal, a_origin = np.concatenate(abnormal), np.concatenate(a_origin)

    hold = rng.choice(len(normal), size=int(holdout_frac * len(normal)),
                      replace=False)
    mask = np.zeros(len(normal), dtype=bool)
    mask[hold] = True
    logger.info("raw pool: %d devices, %d normal / %d abnormal / %d "
                "test_normal rows", len(devices), int((~mask).sum()),
                len(abnormal), int(mask.sum()))
    return {"normal": (normal[~mask], n_origin[~mask]),
            "abnormal": (abnormal, a_origin),
            "test_normal": (normal[mask], n_origin[mask])}


def _kmeans_centers(x: torch.Tensor, k: int, rng: np.random.Generator,
                    n_init: int = 10, max_iter: int = 300,
                    tol: float = 1e-4) -> torch.Tensor:
    """The best of `n_init` k-means++ seeded Lloyd runs (lowest inertia):
    sklearn's KMeans algorithm, not its draws. `tol` scales with the
    features' mean variance, as sklearn's does."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    tol = tol * float(x.var(0, unbiased=False).mean())

    def sq_dist(centers):
        return (sq[:, None] - 2.0 * x @ centers.T
                + (centers * centers).sum(1)[None, :]).clamp_min_(0.0)

    best, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = x[[int(rng.integers(n))]]
        for _ in range(1, k):  # k-means++: D^2 sampling
            d = sq_dist(centers).min(1).values.cpu().numpy()
            p = d / d.sum() if d.sum() > 0 else None
            centers = torch.cat([centers, x[[int(rng.choice(n, p=p))]]])
        for _ in range(max_iter):
            # one-hot product, not index_add_: the card's atomics would
            # sum in a different order each run, and a row near a tie
            # would change label between runs of one seed
            onehot = torch.nn.functional.one_hot(
                sq_dist(centers).argmin(1), k).to(x.dtype)
            counts = onehot.sum(0)
            sums = onehot.T @ x
            new = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
            shift = float(((new - centers) ** 2).sum())
            centers = new
            if shift <= tol:
                break
        inertia = float(sq_dist(centers).min(1).values.sum())
        if inertia < best_inertia:
            best, best_inertia = centers, inertia
    return best


def relabel_by_clusters(pooled: Pooled, n_clusters: int, seed: int = 0,
                        device: DeviceLike = "cuda") -> Pooled:
    """Replace origin labels with feature-space cluster ids: k-means over
    the pooled normal rows (log-signed, standardized), every split's rows
    labelled by their nearest normal-mode center. When only already-sharded
    data survives, client-of-origin labels are device mixtures; the
    clusters recover the compact traffic modes the published split skews
    over."""
    dev = resolve_device(device)

    def tf(v):
        return np.log1p(np.abs(v)) * np.sign(v)

    z = tf(pooled["normal"][0])
    mean = z.mean(axis=0)
    std = z.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)  # sklearn: zero variance -> 1

    def scaled(v):
        return torch.as_tensor((tf(v) - mean) / std, dtype=torch.float64,
                               device=dev)

    centers = _kmeans_centers(scaled(pooled["normal"][0]), n_clusters,
                              np.random.default_rng(seed))
    csq = (centers * centers).sum(1)
    out = {}
    for split, (x, _) in pooled.items():
        xs = scaled(x)
        labels = (csq[None, :] - 2.0 * xs @ centers.T).argmin(1).cpu().numpy()
        out[split] = (x, labels)
        logger.info("%s: %d rows -> %d cluster labels (sizes %s)", split,
                    len(x), n_clusters,
                    np.bincount(labels, minlength=n_clusters).tolist())
    return out


# The published non-IID split's surviving normal-traffic profile: the
# notebook's hard-coded chart data (Data-Examination.ipynb cells 40/42),
# a 10-client x 9-device count matrix (totals 313..4283, 37/90 zero cells,
# min nonzero 14).
PUBLISHED_NONIID_MATRIX = np.array([
    [917, 0, 0, 0, 56, 39, 166, 0, 21],      # Client1
    [298, 0, 0, 0, 197, 38, 0, 220, 0],      # Client2
    [0, 225, 88, 0, 0, 0, 0, 0, 0],          # Client3
    [92, 285, 0, 219, 0, 0, 0, 616, 760],    # Client4
    [586, 0, 0, 0, 239, 1235, 0, 0, 0],      # Client5
    [27, 29, 0, 182, 266, 17, 154, 275, 39],  # Client6
    [116, 0, 366, 986, 0, 0, 72, 57, 38],    # Client7
    [514, 1002, 67, 0, 0, 464, 75, 0, 0],    # Client8
    [708, 0, 14, 0, 348, 3213, 0, 0, 0],     # Client9
    [0, 41, 0, 20, 763, 234, 0, 0, 326],     # Client10
])


def _apportion(weights: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to `total`, proportional to `weights`
    (largest-remainder method; zero weights stay zero)."""
    if weights.sum() == 0 or total == 0:
        return np.zeros(len(weights), dtype=int)
    quota = weights / weights.sum() * total
    counts = np.floor(quota).astype(int)
    rem = total - counts.sum()
    order = np.argsort(-(quota - counts))
    counts[order[:rem]] += 1
    return counts


def match_modes_to_columns(origins: np.ndarray,
                           matrix: np.ndarray) -> np.ndarray:
    """Bijection mode label -> matrix column by size rank (the largest mode
    plays the most-sampled device). Returns col_of_label[l]."""
    avail = np.bincount(origins, minlength=matrix.shape[1])
    # a zero mode would silently blank a whole device column downstream
    if len(avail) != matrix.shape[1] or (avail > 0).sum() != matrix.shape[1]:
        raise ValueError(
            f"target matrix has {matrix.shape[1]} device columns but the "
            f"pool carries {int((avail > 0).sum())} populated origin labels "
            f"— run with --cluster-labels {matrix.shape[1]} (or --raw with "
            f"{matrix.shape[1]} devices)")
    need = matrix.sum(axis=0)
    col_of_label = np.empty(matrix.shape[1], dtype=int)
    col_of_label[np.argsort(-avail)] = np.argsort(-need)
    return col_of_label


def matrix_partition(origins: np.ndarray, matrix: np.ndarray,
                     col_of_label: np.ndarray, rng: np.random.Generator,
                     how: str) -> List[np.ndarray]:
    """Partition one split's rows to clients against the count matrix.

    'exact' (normal): client c gets exactly matrix[c, col] rows of each
    mode; a mode short of its column is topped up by re-sampling its rows
    with replacement. 'proportions' (test_normal): each mode's rows split
    by matrix[c, col] / colsum (zero cells stay zero). 'row_share'
    (abnormal): the pooled rows split by the matrix's per-client totals.
    'uniform': an IID partition."""
    n_clients = matrix.shape[0]
    if how == "uniform":
        return iid_partition(len(origins), n_clients, rng)
    if how == "row_share":
        idx = rng.permutation(len(origins))
        counts = _apportion(matrix.sum(axis=1).astype(float), len(idx))
        return list(np.split(idx, np.cumsum(counts)[:-1]))
    shards: List[List[np.ndarray]] = [[] for _ in range(n_clients)]
    for label in range(matrix.shape[1]):
        col = col_of_label[label]
        idx = np.flatnonzero(origins == label)
        rng.shuffle(idx)
        counts = (matrix[:, col].astype(int) if how == "exact"
                  else _apportion(matrix[:, col].astype(float), len(idx)))
        need = int(counts.sum())
        if need > len(idx):
            if how == "exact" and len(idx) > 0:
                extra = rng.choice(idx, size=need - len(idx), replace=True)
                logger.warning(
                    "mode %d (column %d): %d rows available, %d required — "
                    "re-sampling %d with replacement", label, col, len(idx),
                    need, need - len(idx))
                idx = np.concatenate([idx, extra])
            else:
                counts = _apportion(counts.astype(float), len(idx))
        cuts = np.cumsum(counts)[:-1]
        for k, part in enumerate(np.split(idx[:int(counts.sum())], cuts)):
            shards[k].append(part)
    return [np.concatenate(s) if s else np.empty(0, dtype=int)
            for s in shards]


def js_distance(origins: np.ndarray, parts: List[np.ndarray]) -> float:
    """Generalized Jensen-Shannon distance of the clients' origin-label
    distributions (uniform client weights, base 2, normalized by log2 K,
    then sqrt): FedArtML's skew statistic; the published non-IID split's
    chart cites 0.83."""
    labels = np.unique(origins)
    dists = []
    for idx in parts:
        if len(idx) == 0:
            continue
        counts = np.array([(origins[idx] == c).sum() for c in labels], float)
        dists.append(counts / counts.sum())
    if len(dists) < 2:  # 0 or 1 non-empty client: no divergence
        return 0.0
    p = np.stack(dists)

    def entropy(q):
        q = q[q > 0]
        return -(q * np.log2(q)).sum()

    jsd = entropy(p.mean(0)) - np.mean([entropy(row) for row in p])
    return float(np.sqrt(jsd / np.log2(len(p))))


def iid_partition(n_rows: int, n_clients: int,
                  rng: np.random.Generator) -> List[np.ndarray]:
    idx = rng.permutation(n_rows)
    return list(np.array_split(idx, n_clients))


def filter_small_classes(origins: np.ndarray, idx: np.ndarray,
                         min_rows: int = 10) -> np.ndarray:
    """Drop a client's origin classes with < min_rows rows (the notebook's
    `groupby(label).filter(lambda x: len(x) >= 10)`)."""
    if len(idx) == 0:
        return idx
    labels = origins[idx]
    keep_labels = [c for c in np.unique(labels)
                   if (labels == c).sum() >= min_rows]
    return idx[np.isin(labels, keep_labels)]


def write_shard(path: str, rows: np.ndarray) -> None:
    """Headerless CSV, each float64 at its shortest round-trip digits."""
    with open(path, "w") as f:
        for row in rows.tolist():
            f.write(",".join(map(repr, row)))
            f.write("\n")


def create_federated_shards(
    source_dir: Optional[str],
    out_dir: str,
    n_clients: int,
    mode: str = "iid",
    alpha: float = 0.5,
    seed: int = 42,
    sample_frac: float = 1.0,
    raw_dir: Optional[str] = None,
    benign_frac: float = 0.05,
    abnormal_frac: float = 0.005,
    holdout_frac: float = 0.4,
    min_class_rows: int = 10,
    correlated_splits: bool = True,
    cluster_labels: int = 0,
    target_matrix: Optional[np.ndarray] = None,
    matrix_tests: str = "correlated",
    device: DeviceLike = "cuda",
) -> Dict[str, float]:
    """Shard pooled traffic into n_clients federated clients under
    `out_dir/Client-k/{split}/data.csv`; returns {split: JS distance}.

    Exactly one source: `source_dir` (existing Client-k shards) or
    `raw_dir` (the raw per-device tree). `correlated_splits` (non-IID) draws
    the same per-label Dirichlet proportions for every split, as the
    notebook's re-seeded FedArtML calls do; each client's test_normal then
    matches its training mixture. `device` runs the `cluster_labels`
    k-means (resolved only when clustering)."""
    rng = np.random.default_rng(seed)
    if (source_dir is None) == (raw_dir is None):
        raise ValueError("exactly one of source_dir / raw_dir is required")
    pooled = (pool_raw_devices(raw_dir, benign_frac, abnormal_frac,
                               holdout_frac, seed)
              if raw_dir else pool_source_shards(source_dir))
    if cluster_labels:
        pooled = relabel_by_clusters(pooled, cluster_labels, seed, device)
    col_of_label = None
    if target_matrix is not None:
        if mode != "noniid":
            raise ValueError("target_matrix requires mode='noniid'")
        if n_clients != target_matrix.shape[0]:
            raise ValueError(
                f"target matrix is for {target_matrix.shape[0]} clients, "
                f"got --n-clients {n_clients}")
        col_of_label = match_modes_to_columns(pooled["normal"][1],
                                              target_matrix)
        logger.info("mode -> matrix-column assignment (by size rank): %s",
                    col_of_label.tolist())
    js: Dict[str, float] = {}
    for split in SPLITS:
        x, origins = pooled[split]
        if sample_frac < 1.0:  # extra subsample of already-pooled shards
            keep = rng.random(len(x)) < sample_frac
            x, origins = x[keep], origins[keep]
        if target_matrix is not None:
            how = ({"normal": "exact", "abnormal": "uniform",
                    "test_normal": "uniform"} if matrix_tests == "uniform"
                   else {"normal": "exact", "abnormal": "row_share",
                         "test_normal": "proportions"})[split]
            parts = matrix_partition(origins, target_matrix, col_of_label,
                                     rng, how)
        elif mode == "iid":
            parts = iid_partition(len(x), n_clients, rng)
        elif mode == "noniid":
            parts = dirichlet_partition(
                origins, n_clients, alpha, rng,
                prop_seed=seed if correlated_splits else None)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "noniid" and min_class_rows > 1:
            parts = [filter_small_classes(origins, idx, min_class_rows)
                     for idx in parts]
        if target_matrix is not None:
            achieved = np.zeros_like(target_matrix)
            for k, idx in enumerate(parts):
                for label in range(target_matrix.shape[1]):
                    achieved[k, col_of_label[label]] = \
                        (origins[idx] == label).sum()
            if split == "normal":
                mism = int((achieved != target_matrix).sum())
                logger.info("normal vs published matrix: %s",
                            "EXACT cell-for-cell match" if mism == 0 else
                            f"{mism}/{target_matrix.size} cells differ (max "
                            f"|d| {np.abs(achieved - target_matrix).max()})")
            else:
                logger.info("%s achieved per-client totals: %s", split,
                            achieved.sum(axis=1).tolist())
        for k, idx in enumerate(parts, start=1):
            if len(idx) == 0:
                continue  # no shard dir: the loader treats it as a data gap
            d = os.path.join(out_dir, f"Client-{k}", split)
            os.makedirs(d, exist_ok=True)
            write_shard(os.path.join(d, "data.csv"), x[idx])
        sizes = [len(p) for p in parts]
        js[split] = js_distance(origins, parts)
        logger.info("%s: %d rows -> %d clients (min %d / max %d), "
                    "JS distance %.3f", split, len(x), n_clients,
                    min(sizes), max(sizes), js[split])
    return js


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(
        description="Build federated Client-k shards from a raw per-device "
                    "tree or from existing shards.")
    p.add_argument("--source", default=None,
                   help="dir containing Client-k/{normal,abnormal,test_normal}")
    p.add_argument("--raw", default=None,
                   help="dir containing raw per-device folders "
                        "(<device>/{normal,abnormal}/*.csv)")
    p.add_argument("--out", required=True)
    p.add_argument("--n-clients", type=int, required=True)
    p.add_argument("--mode", choices=("iid", "noniid"), default="iid")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sample-frac", type=float, default=1.0)
    p.add_argument("--benign-frac", type=float, default=0.05)
    p.add_argument("--abnormal-frac", type=float, default=0.005)
    p.add_argument("--holdout-frac", type=float, default=0.4)
    p.add_argument("--min-class-rows", type=int, default=10)
    p.add_argument("--uncorrelated-splits", action="store_true",
                   help="draw independent Dirichlet proportions per split "
                        "instead of the notebook's correlated draws")
    p.add_argument("--cluster-labels", type=int, default=0,
                   help="replace origin labels with K feature-space k-means "
                        "cluster ids before the non-IID skew (device-mode "
                        "reconstruction when the raw tree is gone)")
    p.add_argument("--target-matrix", action="store_true",
                   help="rebuild the published non-IID split cell for cell "
                        "from the notebook's 10x9 count matrix (implies "
                        "--mode noniid and 10 clients; pair with "
                        "--cluster-labels 9 when sharding from Client-k "
                        "shards)")
    p.add_argument("--matrix-tests", choices=("correlated", "uniform"),
                   default="correlated",
                   help="with --target-matrix: abnormal/test_normal follow "
                        "each client's training mixture ('correlated') or "
                        "an IID partition ('uniform')")
    p.add_argument("--device", default="cuda",
                   help="where the --cluster-labels k-means runs: cuda "
                        "(default; raises without a card) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no silent CPU run
    if args.target_matrix:
        args.mode = "noniid"  # the matrix is the (published) non-IID skew
    js = create_federated_shards(
        args.source, args.out, args.n_clients, args.mode, args.alpha,
        args.seed, args.sample_frac, raw_dir=args.raw,
        benign_frac=args.benign_frac, abnormal_frac=args.abnormal_frac,
        holdout_frac=args.holdout_frac, min_class_rows=args.min_class_rows,
        correlated_splits=not args.uncorrelated_splits,
        cluster_labels=args.cluster_labels,
        target_matrix=(PUBLISHED_NONIID_MATRIX if args.target_matrix
                       else None),
        matrix_tests=args.matrix_tests, device=args.device)
    print(json.dumps({"js_distance": js}))
    return js


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    main()
