"""The ClientModel tree (port of the serving half of
fedmse_tpu/checkpointing/io.py).

Per-client best models live at
`{root}/{N}/{exp}/{run}/ClientModel/{scen}/{model}/{update}/{device}/model.npz`
with one array per parameter, keyed like `jax.tree_util.keystr`
("['encoder']['Dense_0']['kernel']"), and serving artifacts beside them
under `{root}/{N}/{exp}/{run}/Serving/{scen}`. A tree the JAX package's
`save_client_models` wrote loads here as it is, and the reverse. The
per-round results files and full-federation resume wait for the training
slice.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Sequence, Tuple

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
