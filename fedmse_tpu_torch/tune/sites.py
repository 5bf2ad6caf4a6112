"""The measured launch-size call sites (port of fedmse_tpu/tune/sites.py):
`tune_*` measures and stores a winner, `lookup_*` is the hot path's pure
cache read.

Each site races its candidates on a fixed PROBE and keys its entry on a
signature of (backend, device name, probe, candidates), so an entry
measured on another card, another backend or another grid is invisible:

  * `serve_bucket_ladder` — serving/engine.py bucket_ladder="auto". Races
    whole LADDERS ('pow2' against 'pow2_mid', which adds the 3·2^k rung per
    octave) on the port's forward kernel (ops/fused_ae.py): each distinct
    rung's launch is timed once, then each ladder scores as the mean wall
    over a deterministic spread of request sizes. Keyed on {"backend":
    "cuda", "device": torch.cuda.get_device_name(), "max_bucket", "dim",
    "probe_draws"}.
  * `tier_init_chunk` — federation/tiered.py init_chunk=None. Races
    `TieredClientStore.create` (federation/state.py: the host tier's init,
    drawn layer by layer in chunks of clients) over TIER_CHUNK_CANDIDATES
    at 4,096 probe clients. The tier's rows are the dense init's bits
    whatever the chunk, so the chunk moves only the init's wall.

  * `merge_plan` — parallel/costmodel.plan_merge (aggregation_backend
    "auto" on a client mesh). Races the exact merge against the quantized
    one per group count and block size (QUANT_BLOCK_CANDIDATES: the pow2
    trio and the 192 / 384 midpoints) on the real process group, keyed on
    the device name, the world size, the mesh's backend and the call's
    arguments.

The JAX package's `pallas_block_rows` site has no counterpart: the port's
forward kernel plans its tiles from the row count alone
(`ops.fused_ae.tile_plan`), so there is no block size to race.

On the CPU the backend is 'cpu' and the device 'torch-cpu' (the JAX
package names its CPU device 'cpu'), so no entry of one package matches a
lookup of the other.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.tune.cache import TuningCache, default_cache
from fedmse_tpu_torch.tune.measure import measure_candidates

TIER_CHUNK_CANDIDATES = (512, 1024, 2048, 3072, 4096, 6144, 8192)
QUANT_BLOCK_CANDIDATES = (128, 192, 256, 384, 512)

# probe shapes: the reference AE topology
_PROBE_DIM, _PROBE_HIDDEN, _PROBE_LATENT = 115, 27, 7
_TIER_PROBE_CLIENTS = 4096
_LADDER_PROBE_DRAWS = 64


def backend_signature(device: DeviceLike = "cuda") -> Dict[str, str]:
    """What a measurement on `device` is valid for: the backend and the
    card's name."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"backend": "cuda",
                "device": torch.cuda.get_device_name(dev)}
    return {"backend": "cpu", "device": "torch-cpu"}


def _probe_params(rng: np.random.Generator, dim: int,
                  device: torch.device) -> Dict[str, Any]:
    """One model's f32 params stacked [1, in, out] (the forward's layout)."""
    def dense(din, dout):
        return {"kernel": torch.as_tensor(
                    rng.normal(size=(1, din, dout)) * 0.1,
                    dtype=torch.float32).to(device),
                "bias": torch.as_tensor(rng.normal(size=(1, dout)) * 0.01,
                                        dtype=torch.float32).to(device)}

    return {"encoder": {"Dense_0": dense(dim, _PROBE_HIDDEN),
                        "Dense_1": dense(_PROBE_HIDDEN, _PROBE_LATENT)},
            "decoder": {"Dense_0": dense(_PROBE_LATENT, _PROBE_HIDDEN),
                        "Dense_1": dense(_PROBE_HIDDEN, dim)}}


# --------------------------- serving bucket ladder ----------------------- #

def pow2_ladder(max_bucket: int) -> List[int]:
    out, b = [], 1
    while b <= max_bucket:
        out.append(b)
        b <<= 1
    return out


def ladder_candidates(max_bucket: int) -> Dict[str, List[int]]:
    """The raced ladders. 'pow2' is the engine's default; 'pow2_mid' adds
    the 3·2^k rung per octave (worst-case row padding 2x -> 1.33x, one
    more bucket shape per octave)."""
    p2 = pow2_ladder(max_bucket)
    mids = {3 * b for b in p2 if 3 * b < max_bucket}
    return {"pow2": p2, "pow2_mid": sorted(set(p2) | mids)}


def ladder_bucket_for(n_rows: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung holding n_rows (ladder sorted ascending)."""
    i = bisect_left(ladder, max(n_rows, 1))
    if i >= len(ladder):
        raise ValueError(f"{n_rows} rows exceed max bucket {ladder[-1]}")
    return int(ladder[i])


def probe_sizes(max_bucket: int) -> List[int]:
    """The deterministic pseudo-uniform request sizes in [1, max_bucket]
    each ladder is scored over (golden-ratio stride)."""
    return [int(((i * 0.6180339887) % 1.0) * max_bucket) + 1
            for i in range(1, _LADDER_PROBE_DRAWS + 1)]


def _serve_signature(max_bucket: int, dim: int,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    return {**backend_signature(device), "max_bucket": int(max_bucket),
            "dim": int(dim), "probe_draws": _LADDER_PROBE_DRAWS}


def lookup_serve_ladder(max_bucket: int, dim: int = _PROBE_DIM,
                        cache: Optional[TuningCache] = None,
                        device: DeviceLike = "cuda") -> Optional[List[int]]:
    """The tuned ladder for (device, max_bucket, dim), or None (the
    engine keeps pow2). Never measures."""
    cache = cache or default_cache()
    hit = cache.lookup("serve_bucket_ladder",
                       _serve_signature(max_bucket, dim, device))
    return [int(b) for b in hit["choice"]] if hit else None


def tune_serve_ladder(max_bucket: int = 1024, dim: int = _PROBE_DIM,
                      repeats: int = 3,
                      cache: Optional[TuningCache] = None,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Race whole ladders on the forward kernel: time each distinct rung's
    launch once (min over `repeats`, each waited for), score each ladder
    as the mean wall over `probe_sizes`, store the winner."""
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats

    dev = resolve_device(device)
    cache = cache or default_cache()
    sig = _serve_signature(max_bucket, dim, dev)
    ladders = ladder_candidates(max_bucket)
    rng = np.random.default_rng(0)
    params = _probe_params(rng, dim, dev)
    sizes = probe_sizes(max_bucket)
    rungs = sorted({ladder_bucket_for(n, lad)
                    for lad in ladders.values() for n in sizes})
    xs = {r: torch.as_tensor(rng.normal(size=(r, dim)),
                             dtype=torch.float32).to(dev) for r in rungs}

    def run(rung):
        return fused_forward_stats(params, xs[rung])[1]

    walls = {r["value"]: r["wall_s"]
             for r in measure_candidates(rungs, run,
                                         repeats=repeats)["candidates"]}
    scored = {name: float(np.mean([walls[ladder_bucket_for(n, lad)]
                                   for n in sizes]))
              for name, lad in ladders.items()}
    best_name = min(scored, key=scored.get)
    return cache.store(
        "serve_bucket_ladder", sig, list(ladders[best_name]),
        ladder_name=best_name, expected_wall_s=scored,
        pow2_wall_s=scored["pow2"],
        rung_walls={str(k): v for k, v in walls.items()})


# --------------------------- tiered init chunk --------------------------- #

def _tier_signature(candidates: Sequence[int] = TIER_CHUNK_CANDIDATES,
                    device: DeviceLike = "cuda",
                    probe_clients: Optional[int] = None) -> Dict[str, Any]:
    if probe_clients is None:
        probe_clients = _TIER_PROBE_CLIENTS
    return {**backend_signature(device), "probe_clients": int(probe_clients),
            "dim": _PROBE_DIM, "candidates": list(candidates)}


def lookup_tier_chunk(cache: Optional[TuningCache] = None,
                      device: DeviceLike = "cuda") -> Optional[int]:
    """The tuned tier init chunk for `device`, or None (the engine keeps
    4096). Never measures."""
    cache = cache or default_cache()
    hit = cache.lookup("tier_init_chunk", _tier_signature(device=device))
    return int(hit["choice"]) if hit else None


def tune_tier_chunk(cache: Optional[TuningCache] = None, repeats: int = 2,
                    candidates: Sequence[int] = TIER_CHUNK_CANDIDATES,
                    probe_clients: Optional[int] = None,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Race `TieredClientStore.create` (the tier's init, the call site
    itself) across chunk sizes at `probe_clients` clients; store the
    winner under `device`'s signature (the tiered engine that reads it
    runs there)."""
    from fedmse_tpu_torch.federation.state import TieredClientStore
    from fedmse_tpu_torch.models import make_model

    dev = resolve_device(device)
    cache = cache or default_cache()
    sig = _tier_signature(candidates, dev, probe_clients)
    probe_clients = sig["probe_clients"]
    model = make_model("autoencoder", _PROBE_DIM, _PROBE_HIDDEN,
                       _PROBE_LATENT, device="cpu")

    def run(chunk):
        store = TieredClientStore.create(
            model, int(probe_clients), torch.Generator().manual_seed(0),
            init_chunk=int(chunk))
        return store.host.params

    result = measure_candidates(candidates, run, repeats=repeats)
    pow2 = next((r["wall_s"] for r in result["candidates"]
                 if int(r["value"]) == 4096), None)
    return cache.store("tier_init_chunk", sig, int(result["choice"]),
                       wall_s=result["wall_s"], pow2_default_wall_s=pow2,
                       candidates=result["candidates"])
