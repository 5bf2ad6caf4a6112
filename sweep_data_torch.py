"""Shared pieces of the port's sweep and study drivers
(attack_sweep_torch.py, chaos_sweep_torch.py, churn_sweep_torch.py,
redteam_sweep_torch.py, cluster_sweep_torch.py,
drift_recovery_sweep_torch.py, paper_check_torch.py,
quirk_ablation_torch.py, parity_probe_torch.py): the federations they run
on, the command line they share, and the provenance their artifacts
record.

The federations come from numpy-only copies of the JAX harness's
(`bench.py` `build_data`, `_light_clients`, `_bulk_host_federation`), so
the same seed gives the same rows in both packages. `build_data` reads
real shards only from `--shards DIR` (the `DatasetConfig.for_client_dirs`
layout); without it every driver runs on the synthetic federation, and
each artifact's `protocol` says which.

Every driver runs on the card unless `--device cpu` is passed: without a
CUDA device it raises. No driver falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.chaos import ChaosMasks
from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
from fedmse_tpu_torch.data import (ClientData, FederatedData,
                                   build_dev_dataset, prepare_clients,
                                   stack_clients, synthetic_clients)
from fedmse_tpu_torch.device import resolve_device
from fedmse_tpu_torch.ops.precision import get_policy
from fedmse_tpu_torch.utils.platform import capture_provenance
from fedmse_tpu_torch.utils.seeding import ExperimentRngs


def build_data(cfg: ExperimentConfig, n_clients: int = 10,
               shards: Optional[str] = None, *, device="cuda"
               ) -> Tuple[FederatedData, int, ExperimentRngs]:
    """(stacked federation on `device`, real clients, the streams that drew
    it): `n_clients` shards of `shards` (Client-1 .. Client-n), or without
    it the synthetic federation of the same dimensionality (1,700 normal
    and 3,300 abnormal rows a client, seed 0), as bench.py builds when the
    N-BaIoT shards are absent."""
    rngs = ExperimentRngs(run=0, data_seed=cfg.data_seed)
    if shards is not None:
        clients = prepare_clients(
            DatasetConfig.for_client_dirs(shards, n_clients), cfg,
            rngs.data_rng, network_size=n_clients)
    else:
        clients = synthetic_clients(n_clients=n_clients,
                                    dim=cfg.dim_features, n_normal=1700,
                                    n_abnormal=3300)
    dev_x = build_dev_dataset(clients, rngs.data_rng)
    data = stack_clients(clients, dev_x, cfg.batch_size,
                         dtype=get_policy(cfg.precision).compute_dtype,
                         device=device)
    return data, len(clients), rngs


def data_source(shards: Optional[str], n_clients: int) -> str:
    """The `protocol` phrase naming the federation a driver ran on."""
    if shards is not None:
        return f"{n_clients}-client shards under {shards}"
    return (f"{n_clients}-client synthetic federation (synthetic_clients, "
            f"1,700 normal / 3,300 abnormal rows a client, seed 0)")


def tie_break_phrase(cfg, n_sel: int) -> str:
    """The `protocol` phrase naming a tier run's vote tie-break: off, the
    generator's [S, S] sheet, or keyed rows (federation/tiered.py's size
    rule, at `n_sel` clients selected a round)."""
    from fedmse_tpu_torch.federation.tiered import keyed_tie_break
    if not cfg.compat.vote_tie_break:
        return "vote tie-break off"
    if keyed_tie_break(cfg, n_sel):
        return ("vote tie-break on (keyed rows: only the voter the "
                "election reads)")
    return "vote tie-break on (the generator's [S, S] sheet)"


def light_clients(n_clients: int, dim: int, rows_train: int = 16,
                  rows_valid: int = 4, rows_test: int = 10, seed: int = 0
                  ) -> Tuple[List[ClientData], np.ndarray]:
    """n ClientData straight from bulk numpy draws (no per-client scaler
    fit), and a 256-row dev set: the thin shards of the 10k-client row."""
    rng = np.random.default_rng(seed)
    rows = rows_train + rows_valid + 2 * rows_test
    normal = rng.normal(0, 1.0, size=(n_clients, rows, dim)).astype(np.float32)
    abnormal = rng.normal(3.0, 1.5, size=(n_clients, rows_test, dim)
                          ).astype(np.float32)
    test_y = np.concatenate([np.zeros(rows_test, np.float32),
                             np.ones(rows_test, np.float32)])
    clients = []
    for i in range(n_clients):
        r = normal[i]
        test_x = np.concatenate([r[rows_train + rows_valid:
                                   rows_train + rows_valid + rows_test],
                                 abnormal[i]])
        clients.append(ClientData(
            name=f"shard-{i}", train_x=r[:rows_train],
            valid_x=r[rows_train:rows_train + rows_valid],
            test_x=test_x, test_y=test_y.copy(), dev_raw=None, scaler=None))
    return clients, rng.normal(0, 1.0, size=(256, dim)).astype(np.float32)


def bulk_host_federation(n_clients: int, dim: int, batch_size: int,
                         seed: int = 0) -> FederatedData:
    """A host-resident FederatedData (CPU tensors) from bulk numpy draws,
    for the tiered engine at fleet scale: one train batch, 4 valid rows,
    8 normal + 8 abnormal test rows per client, a 256-row dev set."""
    rng = np.random.default_rng(seed)
    b, f32 = batch_size, np.float32
    train = rng.normal(0, 1.0, (n_clients, 1, b, dim)).astype(f32)
    v_rows = 4
    valid = rng.normal(0, 1.0, (n_clients, v_rows, dim)).astype(f32)
    valid_xb = np.zeros((n_clients, 1, b, dim), f32)
    valid_xb[:, 0, :v_rows] = valid
    valid_mb = np.zeros((n_clients, 1, b), f32)
    valid_mb[:, 0, :v_rows] = 1.0
    t_half = 8
    test = np.concatenate(
        [rng.normal(0, 1.0, (n_clients, t_half, dim)),
         rng.normal(3.0, 1.5, (n_clients, t_half, dim))], axis=1).astype(f32)
    test_y = np.concatenate([np.zeros((n_clients, t_half), f32),
                             np.ones((n_clients, t_half), f32)], axis=1)
    t = torch.from_numpy
    return FederatedData(
        train_xb=t(train), train_mb=t(np.ones((n_clients, 1, b), f32)),
        valid_xb=t(valid_xb), valid_mb=t(valid_mb),
        valid_x=t(valid), valid_m=t(np.ones((n_clients, v_rows), f32)),
        test_x=t(test), test_m=t(np.ones((n_clients, 2 * t_half), f32)),
        test_y=t(test_y),
        dev_x=t(rng.normal(0, 1.0, (256, dim)).astype(f32)),
        client_mask=t(np.ones((n_clients,), f32)))


def feed_chaos(engine, masks) -> None:
    """Replace `engine`'s chaos-mask source with `masks` (four [T, N]
    fields, e.g. another engine's `_chaos_masks(0, T)`): the chunk of
    rounds [s, s + n) reads rows [s, s + n)."""
    held = ChaosMasks(*(np.asarray(m) for m in masks))
    engine._chaos_masks = lambda start, n: ChaosMasks(
        *(m[start:start + n] for m in held))


def parser(doc: str, out: str) -> argparse.ArgumentParser:
    """The options every driver takes: --device, --out and --commit."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--out", default=out, help="the artifact's path")
    p.add_argument("--commit", default=None,
                   help="the commit to record where the run has no git "
                        "checkout (a copy of the tree)")
    return p


def start(args) -> Tuple[torch.device, dict]:
    """The run's device (raises without a card unless --device cpu) and
    its provenance, pinned before any timed work."""
    device = resolve_device(args.device)
    return device, provenance(device, args.commit)


def smi_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, or None where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def provenance(device: torch.device, commit: Optional[str] = None) -> dict:
    """What an artifact records of where it ran: the card (nvidia-smi's
    name and power limit, torch's device name), torch and CUDA versions,
    and the commit (`commit` where the run has no git checkout)."""
    prov = capture_provenance()
    if prov["git_commit"] is None and commit is not None:
        prov["git_commit"] = commit
    return {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "nvidia_smi": smi_line() if device.type == "cuda" else None,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        **prov,
    }


def sync(device) -> None:
    """Wait for the card's queued work where `device` is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def states_equal(a, b) -> bool:
    """Whether two ClientStates hold the same bits in every tensor (the
    params, the Adam state, prev_global and the verifier history)."""
    return all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))


def timed(fn, *args, **kw):
    """(fn(*args, **kw), wall seconds), the card synchronized at the end."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def write(path: str, out: dict) -> None:
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
