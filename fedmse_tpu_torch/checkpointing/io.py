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
reverse.

`CheckpointManager` snapshots the whole federation for a resume: the
client states, the host counters, the round index, the loss curve so far
and a dict `extra` of run metadata. It writes the JAX package's
pod-sharded format with one shard (its `save_shard` / `restore_sharded`
at H = 1): `{tag}.podshard0of1.npz` holds every ClientStates leaf under
its `jax.tree_util.keystr` name ("['params']['encoder']['Dense_0']
['kernel']", "['opt_state'][0].mu[...]"), `{tag}.pod.json` the manifest
(blocks, host counters, round index, extra) and `{tag}.pod.tracking.npz`
the curve. A snapshot written by either package resumes in the other.
The tiered layout writes its host tier padded to the dense width
(federation/tiered.py `states_for_checkpoint`) and restores with
device="cpu" (`restore_states`), so a dense snapshot resumes a tiered run
and a tiered snapshot a dense one. A host-sharded tier over W ranks
writes the pod format at H = W (`save_shard`: each rank its rows in
`{tag}.podshard{j}of{H}.npz`, rank 0 the manifest, then a barrier), and
`restore(rows=)` reassembles any rows from whichever shards hold them: a
snapshot saved at W ranks resumes at 1, and the other way round.
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
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               NumpyClientStates,
                                               client_states_from_numpy,
                                               client_states_to_numpy,
                                               fresh_states)
from fedmse_tpu_torch.models.flat import ParamLayout

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


def keystr(path: Sequence[str]) -> str:
    """The `jax.tree_util.keystr` spelling of a dict path."""
    return "".join(f"['{k}']" for k in path)


def _keyed_leaves(node: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs of a tree of dicts (sorted keys, "['k']"),
    NamedTuples (".field") and tuples ("[i]"), as jax.tree_util spells
    them."""
    if isinstance(node, dict):
        return [kv for k in sorted(node)
                for kv in _keyed_leaves(node[k], f"{prefix}['{k}']")]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [kv for f in node._fields
                for kv in _keyed_leaves(getattr(node, f), f"{prefix}.{f}")]
    if isinstance(node, tuple):
        return [kv for i, v in enumerate(node)
                for kv in _keyed_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, node)]


def _rebuilt(node: Any, arrays: Dict[str, np.ndarray], prefix: str = ""):
    """`node`'s structure with each leaf replaced by arrays[its keystr]."""
    if isinstance(node, dict):
        return {k: _rebuilt(v, arrays, f"{prefix}['{k}']")
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuilt(getattr(node, f), arrays,
                                     f"{prefix}.{f}") for f in node._fields))
    if isinstance(node, tuple):
        return tuple(_rebuilt(v, arrays, f"{prefix}[{i}]")
                     for i, v in enumerate(node))
    return arrays[prefix]


def save_client_models(writer: ResultsWriter, run: int, model_type: str,
                       update_type: str, device_names: Sequence[str],
                       stacked_params: Dict[str, Any]) -> None:
    """Per-client `model.npz` (f32 arrays) in the ClientModel layout."""
    arrays = {key: torch.as_tensor(leaf).detach().to(
                  "cpu", torch.float32).numpy()
              for key, leaf in _keyed_leaves(stacked_params)}
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


class CheckpointManager:
    """Whole-federation snapshots under one directory, in the JAX package's
    pod-sharded format at one shard (module docstring)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def _shard_path(self, tag: str, j: int = 0, h: int = 1) -> str:
        return self._path(tag) + f".podshard{j}of{h}.npz"

    def _write_meta(self, tag: str, n: int, blocks, host: HostState,
                    round_index: int, extra, tracking) -> None:
        meta = {"n_real": n, "blocks": [list(b) for b in blocks],
                "aggregation_count": host.aggregation_count.tolist(),
                "votes_received": host.votes_received.tolist(),
                "rounds_aggregated": [list(map(int, x))
                                      for x in host.rounds_aggregated],
                "round_index": int(round_index), "extra": extra or {}}
        mpath = self._path(tag) + ".pod.json"
        with open(mpath + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(mpath + ".tmp", mpath)
        tpath = self._path(tag) + ".pod.tracking.npz"
        if tracking is not None:
            np.savez(tpath + ".tmp.npz", tracking=tracking)
            os.replace(tpath + ".tmp.npz", tpath)
        elif os.path.exists(tpath):
            os.remove(tpath)  # an older curve must not outlive its round

    def save(self, tag: str, states: ClientStates, host: HostState,
             round_index: int, *, layout: ParamLayout,
             extra: Optional[Dict] = None,
             tracking: Optional[np.ndarray] = None) -> None:
        """Write the snapshot of `round_index` rounds done; each file is
        written to a temporary name and moved into place."""
        arrays = dict(_keyed_leaves(
            client_states_to_numpy(states, layout)._asdict()))
        n = states.params.shape[0]
        path = self._shard_path(tag)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
        self._write_meta(tag, n, [(0, n)], host, round_index, extra,
                         tracking)

    def save_shard(self, tag: str, states: ClientStates, host: HostState,
                   round_index: int, start: int, stop: int, blocks, *,
                   layout: ParamLayout, extra: Optional[Dict] = None,
                   tracking: Optional[np.ndarray] = None,
                   mesh=None) -> None:
        """This rank's rows [start, stop) (one of `blocks`, the ranks'
        tier blocks in rank order) as shard j of H, and on rank 0 the
        manifest and the curve. Collective on `mesh`: every rank calls it,
        and a barrier ends it (a snapshot is whole only once every shard
        landed)."""
        blocks = [tuple(b) for b in blocks]
        if (start, stop) not in blocks:
            raise ValueError(f"({start}, {stop}) is not one of the tier "
                             f"blocks {blocks}")
        if states.params.shape[0] != stop - start:
            raise ValueError(f"shard states hold {states.params.shape[0]} "
                             f"rows; block ({start}, {stop}) holds "
                             f"{stop - start}")
        j, h = blocks.index((start, stop)), len(blocks)
        arrays = dict(_keyed_leaves(
            client_states_to_numpy(states, layout)._asdict()))
        path = self._shard_path(tag, j, h)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
        if mesh is None or mesh.rank == 0:
            self._write_meta(tag, blocks[-1][1], blocks, host, round_index,
                             extra, tracking)
        if mesh is not None:
            mesh.barrier()

    @staticmethod
    def _validate_extra(tag: str, saved: Dict,
                        expected_extra: Optional[Dict],
                        extra_defaults: Optional[Dict]) -> None:
        """A setting that changes what the snapshot means must fail with
        its NAME; a key the snapshot never recorded compares against its
        default (a snapshot written before the setting existed)."""
        for key, want in (expected_extra or {}).items():
            if key in saved:
                recorded = saved[key]
            elif extra_defaults is not None and key in extra_defaults:
                recorded = extra_defaults[key]
            else:
                continue
            if recorded != want:
                raise ValueError(
                    f"checkpoint {tag!r} was written with {key}="
                    f"{recorded!r} but this run uses {key}={want!r};"
                    f" resume with the matching setting or start fresh")

    def restore(self, tag: str, *, layout: ParamLayout,
                device: DeviceLike = "cuda",
                expected_extra: Optional[Dict] = None,
                extra_defaults: Optional[Dict] = None,
                rows: Optional[Tuple[int, int]] = None):
        """(states on `device`, host, round_index, tracking or None) of a
        snapshot, after `expected_extra` is checked against the recorded
        extra: rows [start, stop) = `rows` (default: all of them),
        reassembled from whichever of its H shards hold them."""
        device = resolve_device(device)  # before any file is read
        with open(self._path(tag) + ".pod.json") as f:
            meta = json.load(f)
        self._validate_extra(tag, meta.get("extra", {}), expected_extra,
                             extra_defaults)
        blocks = [tuple(b) for b in meta["blocks"]]
        start, stop = rows if rows is not None else (0, meta["n_real"])
        if not 0 <= start < stop <= meta["n_real"]:
            raise ValueError(f"rows ({start}, {stop}) outside checkpoint "
                             f"{tag!r}'s {meta['n_real']}")
        n = stop - start
        like = client_states_to_numpy(
            fresh_states(torch.zeros((n, layout.size))), layout)._asdict()
        shapes = {k: np.shape(v) for k, v in _keyed_leaves(like)}
        parts: Dict[str, List[np.ndarray]] = {k: [] for k in shapes}
        for j, (lo, hi) in enumerate(blocks):
            a, b = max(lo, start), min(hi, stop)
            if a >= b:
                continue
            path = self._shard_path(tag, j, len(blocks))
            with np.load(path) as z:
                missing = [k for k in shapes if k not in z.files]
                if missing:
                    raise ValueError(
                        f"{path} lacks state leaves {missing[:3]}"
                        f"{'...' if len(missing) > 3 else ''}; was it saved "
                        f"for another model or state layout?")
                for k in shapes:
                    parts[k].append(z[k][a - lo:b - lo])
        arrays = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
        path = self._shard_path(tag, 0, len(blocks))
        for k, shape in shapes.items():
            if arrays[k].shape != shape:
                raise ValueError(f"{path} holds {k} of shape "
                                 f"{arrays[k].shape}; this model's is "
                                 f"{shape}")
        states = client_states_from_numpy(
            NumpyClientStates(**_rebuilt(like, arrays)), layout,
            device=device)
        host = HostState(
            aggregation_count=np.asarray(meta["aggregation_count"]),
            votes_received=np.asarray(meta["votes_received"]),
            rounds_aggregated=[tuple(x) for x in meta["rounds_aggregated"]])
        tpath = self._path(tag) + ".pod.tracking.npz"
        tracking = (np.load(tpath)["tracking"] if os.path.exists(tpath)
                    else None)
        return states, host, int(meta["round_index"]), tracking

    def exists(self, tag: str) -> bool:
        """True iff the manifest and every shard it names are on disk."""
        mpath = self._path(tag) + ".pod.json"
        if not os.path.exists(mpath):
            return False
        with open(mpath) as f:
            h = len(json.load(f)["blocks"])
        return all(os.path.exists(self._shard_path(tag, j, h))
                   for j in range(h))

    def extra(self, tag: str) -> Dict:
        """The snapshot's recorded extra."""
        with open(self._path(tag) + ".pod.json") as f:
            return json.load(f).get("extra", {})
