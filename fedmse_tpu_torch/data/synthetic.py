"""Synthetic federated IoT-like data (port of fedmse_tpu/data/synthetic.py,
numpy only).

Standardized normal traffic per client and shifted/scaled abnormal traffic,
with the reference's 40/10/40/10 train/valid/dev/test split of the normal
rows. Four fleets, each the JAX package's generator draw for draw, so the
same seed gives the same arrays bit for bit (`dev_raw` is an np.ndarray
here, a DataFrame there):

  * `synthetic_clients`: IID or per-client shifted Gaussians;
  * `synthetic_multimodal_clients`: each client's normal traffic a mixture
    of well-separated modes, its anomalies between them;
  * `synthetic_typed_clients`: gateways of `types` device types sharing
    their type's modes, each gateway's anomalies another type's normal
    traffic (the fleet clustered federation is measured on);
  * `synthetic_dirichlet_clients`: a pooled population of modes split
    across clients by `dirichlet_partition` (the numpy copy of
    fedmse_tpu/data/prep.py's partitioner), optionally with label shift.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from fedmse_tpu_torch.data.loader import ClientData, IoTDataProcessor


def synthetic_clients(n_clients: int = 4, dim: int = 16, n_normal: int = 240,
                      n_abnormal: int = 120, seed: int = 0,
                      noniid: bool = False) -> List[ClientData]:
    """Per-client ClientData with the reference's 40/10/40/10 discipline."""
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(n_clients):
        shift = rng.normal(0, 2.0, size=dim) if noniid else np.zeros(dim)
        normal = rng.normal(0, 1.0, size=(n_normal, dim)) + shift
        abnormal = rng.normal(4.0, 2.0, size=(n_abnormal, dim)) + shift

        n_train = int(0.4 * n_normal)
        n_valid = int(0.1 * n_normal)
        n_dev = int(0.4 * n_normal)
        train, valid = normal[:n_train], normal[n_train:n_train + n_valid]
        dev = normal[n_train + n_valid:n_train + n_valid + n_dev]
        test = normal[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler="standard")
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        ab_x, ab_y = proc.transform(abnormal, type="abnormal")

        clients.append(ClientData(
            name=f"synthetic-{i + 1}",
            train_x=train_x.astype(np.float32),
            valid_x=valid_x.astype(np.float32),
            test_x=np.concatenate([test_x, ab_x]).astype(np.float32),
            test_y=np.concatenate([test_y, ab_y]).astype(np.float32),
            dev_raw=dev,
            scaler=proc,
        ))
    return clients


def dirichlet_partition(origins: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator,
                        prop_seed: Optional[int] = None) -> List[np.ndarray]:
    """Label-skew partition: each origin label's row indices split across
    clients by Dirichlet(alpha) proportions. With `prop_seed`, a label's
    proportions come from a generator keyed by (prop_seed, label), so every
    split partitioned with the same prop_seed gives each label the same
    client proportions (the reference notebook's correlated draws)."""
    shards: List[List[np.ndarray]] = [[] for _ in range(n_clients)]
    for label in np.unique(origins):
        idx = np.flatnonzero(origins == label)
        rng.shuffle(idx)
        prop_rng = (np.random.default_rng([prop_seed, int(label)])
                    if prop_seed is not None else rng)
        props = prop_rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].append(part)
    return [np.concatenate(s) if s else np.empty(0, dtype=int) for s in shards]


def synthetic_multimodal_clients(
    n_clients: int = 4,
    dim: int = 16,
    n_normal: int = 240,
    n_abnormal: int = 120,
    modes: int = 3,
    seed: int = 0,
) -> List[ClientData]:
    """Multi-MODAL per-client normal traffic — the regime single-prototype
    scores degrade in.

    Each client's normal traffic is a mixture of `modes` well-separated
    Gaussian clusters (several distinct device behaviors behind one
    gateway); its abnormal traffic sits BETWEEN the clusters, near their
    common mean. A centroid score (distance from the standardized origin ≈
    the mixture mean) assigns those anomalies LOW scores — they are close
    to the mean while being far from every actual normal point — whereas a
    kNN score against a bank of real normal latents stays high. Same
    40/10/40/10 split discipline as `synthetic_clients`."""
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(n_clients):
        centers = rng.normal(0, 4.0, size=(modes, dim))
        assign = rng.integers(0, modes, size=n_normal)
        normal = centers[assign] + rng.normal(0, 0.5, size=(n_normal, dim))
        # anomalies: tight around the mixture mean — between the modes,
        # close to the centroid, far from every cluster
        abnormal = centers.mean(axis=0) + rng.normal(
            0, 0.5, size=(n_abnormal, dim))

        n_train = int(0.4 * n_normal)
        n_valid = int(0.1 * n_normal)
        n_dev = int(0.4 * n_normal)
        train, valid = normal[:n_train], normal[n_train:n_train + n_valid]
        dev = normal[n_train + n_valid:n_train + n_valid + n_dev]
        test = normal[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler="standard")
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        ab_x, ab_y = proc.transform(abnormal, type="abnormal")

        clients.append(ClientData(
            name=f"multimodal-{i + 1}",
            train_x=train_x.astype(np.float32),
            valid_x=valid_x.astype(np.float32),
            test_x=np.concatenate([test_x, ab_x]).astype(np.float32),
            test_y=np.concatenate([test_y, ab_y]).astype(np.float32),
            dev_raw=dev,
            scaler=proc,
        ))
    return clients


def synthetic_typed_clients(
    n_clients: int = 8,
    types: int = 2,
    dim: int = 16,
    n_normal: int = 240,
    n_abnormal: int = 120,
    modes: int = 3,
    type_scale: float = 8.0,
    seed: int = 0,
) -> List[ClientData]:
    """The TYPED multimodal fleet — the clustered-federation extension of
    `synthetic_multimodal_clients`.

    Gateways come in `types` device types (client i is type i % types —
    camera, thermostat, ...). Gateways of a type SHARE that type's
    `modes` Gaussian mode centers (each gateway still sees a multimodal
    normal mixture), and the types are far apart
    (`type_scale`). A gateway's ANOMALIES are another type's normal
    traffic (drawn from the NEXT type's modes) — the cross-device-
    contamination threat: a compromised camera gateway starts emitting
    thermostat-shaped flows. Traffic that is anomalous FOR THIS GATEWAY
    while being perfectly normal somewhere else in the fleet.

    Why clustering wins here, by construction: the single global model
    is federated across every type, so the "anomalous" traffic IS part
    of its training manifold — it reconstructs the contamination as
    readily as the gateway's own traffic and the separation collapses
    toward chance. A per-type cluster model never trained on the other
    type's manifold: own normals reconstruct tightly, cross-type rows
    stay off-manifold, and the separation survives. Latent statistics
    cleanly separate the types, so the Gaussian-JS assignment recovers
    them (cluster/assign.py).

    The contamination is RADIUS-MATCHED: the other type's rows are
    z-scored in THEIR OWN frame and mapped into this gateway's raw frame
    (z_other · σ_own + μ_own), so per-gateway standardization reproduces
    exactly the other type's standardized mode layout — same scale and
    spread as the gateway's own traffic, different geometry. Without
    this, cross-type rows are trivial norm outliers under the gateway's
    scaler and EVERY model (global included) detects them — the
    distance confound would fake a win for everyone."""
    rng = np.random.default_rng(seed)
    type_centers = [rng.normal(0, type_scale, size=(modes, dim))
                    for _ in range(types)]
    # per-type population statistics (for the radius-matched z-mapping):
    # one large draw per type, fixed across clients
    type_stats = []
    for t in range(types):
        pool = (type_centers[t][rng.integers(0, modes, size=2000)]
                + rng.normal(0, 0.5, size=(2000, dim)))
        type_stats.append((pool.mean(axis=0), pool.std(axis=0) + 1e-8))
    clients = []
    for i in range(n_clients):
        centers = type_centers[i % types]
        other_t = (i + 1) % types  # the contaminating type
        assign = rng.integers(0, modes, size=n_normal)
        normal = centers[assign] + rng.normal(0, 0.5, size=(n_normal, dim))
        ab_assign = rng.integers(0, modes, size=n_abnormal)
        other_rows = (type_centers[other_t][ab_assign]
                      + rng.normal(0, 0.5, size=(n_abnormal, dim)))
        o_mu, o_sd = type_stats[other_t]
        s_mu, s_sd = type_stats[i % types]
        abnormal = (other_rows - o_mu) / o_sd * s_sd + s_mu

        n_train = int(0.4 * n_normal)
        n_valid = int(0.1 * n_normal)
        n_dev = int(0.4 * n_normal)
        train, valid = normal[:n_train], normal[n_train:n_train + n_valid]
        dev = normal[n_train + n_valid:n_train + n_valid + n_dev]
        test = normal[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler="standard")
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        ab_x, ab_y = proc.transform(abnormal, type="abnormal")

        clients.append(ClientData(
            name=f"typed-{i % types}-{i + 1}",
            train_x=train_x.astype(np.float32),
            valid_x=valid_x.astype(np.float32),
            test_x=np.concatenate([test_x, ab_x]).astype(np.float32),
            test_y=np.concatenate([test_y, ab_y]).astype(np.float32),
            dev_raw=dev,
            scaler=proc,
        ))
    return clients


def synthetic_dirichlet_clients(
    n_clients: int = 4,
    dim: int = 16,
    rows_per_client: int = 240,
    abnormal_per_client: int = 120,
    modes: int = 3,
    alpha: float = 0.5,
    label_shift: float = 0.0,
    min_rows: int = 40,
    seed: int = 0,
) -> List[ClientData]:
    """Non-IID federated grid via the prep-tool partitioner.

    A pooled population of `modes` well-separated Gaussian traffic modes
    (each row labeled by its mode of origin) is partitioned across clients
    with `dirichlet_partition(alpha)` — small alpha gives each
    client a narrow mode mixture (heterogeneous feature distributions),
    alpha ~ 1000 degenerates to IID. Abnormal rows (shifted/scaled, as in
    `synthetic_clients`) are labeled by their NEAREST normal mode and
    partitioned with the SAME per-label proportions (`prop_seed` —
    the notebook's correlated-draw construction), so each
    client is tested against anomalies near the modes it actually serves.

    `label_shift` > 0 additionally skews per-client anomaly PREVALENCE
    (class-prior shift): each client's share of the anomaly pool is drawn
    from Dirichlet(label_shift) instead of tracking its normal share —
    small values give a few anomaly-flooded clients and many anomaly-free
    ones. 0 (default) keeps prevalence tied to the feature partition.

    Thin shards are expected under skew; `min_rows` tops up starved
    clients with uniform pool re-draws so every client stays trainable
    (the federation layer handles ragged shards via row masks). Splits and
    standardization are per client, same 40/10/40/10 discipline as the
    other generators."""
    rng = np.random.default_rng(seed)
    n_normal_total = n_clients * rows_per_client
    n_abnormal_total = n_clients * abnormal_per_client
    centers = rng.normal(0, 3.0, size=(modes, dim))
    origin = rng.integers(0, modes, size=n_normal_total)
    normal = centers[origin] + rng.normal(0, 1.0, size=(n_normal_total, dim))
    ab_mode = rng.integers(0, modes, size=n_abnormal_total)
    abnormal = (centers[ab_mode] + 4.0
                + rng.normal(0, 2.0, size=(n_abnormal_total, dim)))

    parts = dirichlet_partition(origin, n_clients, alpha, rng,
                                prop_seed=seed)
    if label_shift > 0:
        # label shift: anomaly prevalence decouples from the feature
        # partition — per-client anomaly volume from its own Dirichlet
        shares = np.random.default_rng([seed, 0x4C53]).dirichlet(
            np.full(n_clients, label_shift))
        counts = np.floor(shares * n_abnormal_total).astype(int)
        idx = rng.permutation(n_abnormal_total)
        ab_parts = list(np.split(idx, np.cumsum(counts)[:-1]))[:n_clients]
    else:
        ab_parts = dirichlet_partition(ab_mode, n_clients, alpha, rng,
                                       prop_seed=seed)

    clients = []
    for i in range(n_clients):
        idx = parts[i]
        if len(idx) < min_rows:  # top up starved shards: stay trainable
            extra = rng.choice(n_normal_total, size=min_rows - len(idx),
                               replace=False)
            idx = np.concatenate([idx, extra]).astype(int)
        rows = normal[idx]
        rng.shuffle(rows)
        ab_rows = abnormal[ab_parts[i]] if len(ab_parts[i]) else \
            np.empty((0, dim))

        n = len(rows)
        n_train = int(0.4 * n)
        n_valid = max(1, int(0.1 * n))
        n_dev = int(0.4 * n)
        train = rows[:n_train]
        valid = rows[n_train:n_train + n_valid]
        dev = rows[n_train + n_valid:n_train + n_valid + n_dev]
        test = rows[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler="standard")
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        if len(ab_rows):
            ab_x, ab_y = proc.transform(ab_rows, type="abnormal")
            test_x = np.concatenate([test_x, ab_x])
            test_y = np.concatenate([test_y, ab_y])

        clients.append(ClientData(
            name=f"dirichlet-{i + 1}",
            train_x=train_x.astype(np.float32),
            valid_x=valid_x.astype(np.float32),
            test_x=test_x.astype(np.float32),
            test_y=test_y.astype(np.float32),
            dev_raw=dev,
            scaler=proc,
        ))
    return clients
