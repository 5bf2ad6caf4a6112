"""Results artifacts and the ClientModel tree (port of
fedmse_tpu/checkpointing/io.py; same paths and file formats).

Under one checkpoint root:
  * per-round metrics, JSON lines appended to
    `Results/Update/{N}/{exp}/Run_{r}/{metric}/
     {scen}_{ratio}_{model}_{update}_results.json`
    ({round, client_metrics, update_type, model_type, global_loss});
  * verification rows, JSON lines appended to
    `Results/Update/{N}/{exp}/Run_{r}/verification_results.json`;
  * `Results/Update/{N}/{exp}/training_summary.json`;
  * per-client models at
    `{N}/{exp}/{run}/ClientModel/{scen}/{model}/{update}/{device}/model.npz`
    with one array per parameter, keyed like `jax.tree_util.keystr`
    ("['encoder']['Dense_0']['kernel']"), and `training_tracking.pkl`
    [(train_loss, valid_loss), ...] beside each;
  * the hybrid's test latents, `LatentData/{N}/{exp}/Run_{r}/
    latent_hybrid_{update}.pkl`;
  * serving artifacts under `{N}/{exp}/{run}/Serving/{scen}`.
A tree the JAX package's writer wrote loads here as it is, and the
reverse. Full-federation resume is not ported yet.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device

_KEY = re.compile(r"\['([^']*)'\]")


class ResultsWriter:
    """Path layout of the reference's checkpoint root."""

    def __init__(self, checkpoint_root: str, network_size: int,
                 experiment_name: str, scen_name: str, metric: str,
                 num_participants: float):
        self.root = checkpoint_root
        self.network_size = network_size
        self.exp = experiment_name
        self.scen = scen_name
        self.metric = metric
        self.ratio = num_participants
        self.results_dir = os.path.join(checkpoint_root, "Results", "Update",
                                        str(network_size), experiment_name)

    def append_round_metrics(self, run: int, round_index: int,
                             client_metrics: Sequence[float],
                             model_type: str, update_type: str) -> str:
        d = os.path.join(self.results_dir, f"Run_{run}", self.metric)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{self.scen}_{self.ratio}_{model_type}_"
                               f"{update_type}_results.json")
        metrics = np.asarray(client_metrics, dtype=float)
        finite = metrics.size and bool(np.any(~np.isnan(metrics)))
        with open(path, "a") as f:
            json.dump({
                "round": round_index + 1,
                "client_metrics": [None if np.isnan(m) else float(m)
                                   for m in metrics],
                "update_type": update_type,
                "model_type": model_type,
                "global_loss": (float(np.nanmin(metrics)) if finite
                                else float("inf")),
            }, f)
            f.write("\n")
        return path

    def append_verification(self, run: int, round_index: int,
                            rows: List[Dict]) -> Optional[str]:
        if not rows:
            return None
        d = os.path.join(self.results_dir, f"Run_{run}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "verification_results.json")
        with open(path, "a") as f:
            json.dump({"round": round_index + 1,
                       "verification_results": rows}, f)
            f.write("\n")
        return path

    def write_summary(self, best_metrics: Dict, num_runs: int,
                      results: Optional[Dict] = None) -> str:
        os.makedirs(self.results_dir, exist_ok=True)
        path = os.path.join(self.results_dir, "training_summary.json")
        doc = {"best_metrics": best_metrics, "metric_type": self.metric,
               "num_runs": num_runs, "network_size": self.network_size,
               "experiment_name": self.exp}
        if results is not None:
            doc["results"] = results
        with open(path, "w") as f:
            json.dump(doc, f, indent=4)
        return path

    def latent_dir(self, run: int) -> str:
        return os.path.join(self.root, "LatentData", str(self.network_size),
                            self.exp, f"Run_{run}")

    def client_model_dir(self, run: int, model_type: str, update_type: str,
                         device_name: str) -> str:
        return os.path.join(self.root, str(self.network_size), self.exp,
                            str(run), "ClientModel", self.scen, model_type,
                            update_type, device_name)

    def serving_dir(self, run: int) -> str:
        """Serving artifacts (calibration thresholds) beside the run's
        ClientModel tree."""
        return os.path.join(self.root, str(self.network_size), self.exp,
                            str(run), "Serving", self.scen)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def keystr(path: Sequence[str]) -> str:
    """The `jax.tree_util.keystr` spelling of a dict path."""
    return "".join(f"['{k}']" for k in path)


def save_client_models(writer: ResultsWriter, run: int, model_type: str,
                       update_type: str, device_names: Sequence[str],
                       stacked_params: Dict[str, Any]) -> None:
    """Per-client `model.npz` (f32 arrays) in the ClientModel layout."""
    arrays = {keystr(path): torch.as_tensor(leaf).detach().to(
                  "cpu", torch.float32).numpy()
              for path, leaf in _flatten(stacked_params)}
    for i, name in enumerate(device_names):
        d = writer.client_model_dir(run, model_type, update_type, name)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "model.npz"),
                 **{k: v[i] for k, v in arrays.items()})


def load_client_models(writer: ResultsWriter, run: int, model_type: str,
                       update_type: str, device_names: Sequence[str], *,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Re-stack the per-client `model.npz` files into a [N, ...] f32 param
    tree on `device`. Every client must carry the same keys."""
    dev = resolve_device(device)
    per_key: Dict[str, List[np.ndarray]] = {}
    keys = None
    for name in device_names:
        path = os.path.join(
            writer.client_model_dir(run, model_type, update_type, name),
            "model.npz")
        with np.load(path) as z:
            if keys is None:
                keys = sorted(z.files)
            elif sorted(z.files) != keys:
                raise ValueError(f"{path} holds params {sorted(z.files)}, "
                                 f"the first client {keys}; was it saved "
                                 "for a different model topology?")
            for k in keys:
                per_key.setdefault(k, []).append(z[k])
    if not keys:
        raise ValueError("no client models to load")
    tree: Dict[str, Any] = {}
    for k, parts in per_key.items():
        path = _KEY.findall(k)
        if keystr(path) != k:
            raise ValueError(f"unrecognized parameter key {k!r}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(
            np.stack(parts, axis=0).astype(np.float32)).to(dev)
    return tree


def save_training_tracking(writer: ResultsWriter, run: int, model_type: str,
                           update_type: str, device_names: Sequence[str],
                           tracking: np.ndarray) -> None:
    """Per-client training_tracking.pkl: [(train_loss, valid_loss), ...]
    for the epochs that ran (tracking [N, E, 3] with an active flag)."""
    for i, name in enumerate(device_names):
        d = writer.client_model_dir(run, model_type, update_type, name)
        os.makedirs(d, exist_ok=True)
        rows = [(float(t), float(v)) for t, v, active in tracking[i]
                if active > 0 and np.isfinite(t)]
        with open(os.path.join(d, "training_tracking.pkl"), "wb") as f:
            pickle.dump(rows, f)


def save_latent_data(writer: ResultsWriter, run: int, update_type: str,
                     test_latent: np.ndarray, labels: np.ndarray) -> str:
    """The hybrid's (latents, labels) pickle for the latent plots."""
    d = writer.latent_dir(run)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"latent_hybrid_{update_type}.pkl")
    with open(path, "wb") as f:
        pickle.dump((np.asarray(test_latent), np.asarray(labels)), f)
    return path
