"""Byte accounting of the merge's collectives and the measured merge plan
(port of fedmse_tpu/parallel/costmodel.py).

  * `seam` (a `SeamCounters`): the merges of parallel/collectives.py
    report each merge's wire profile from the actual leaf sizes
    (`note_merge`), and the host-side gathers of parallel/multihost.py and
    `mesh.host_fetch` their true bytes per call (`add_host_collective`);
  * the byte formulas of the two wire patterns, copied from the JAX
    package (D ranks, H host groups, S merged payload bytes): the flat f32
    merge crosses hosts with 2 H (D - 1) / D S_f32 bytes under a ring
    lowering, the lane-sliced int8 exchange with G (G - 1) S_q. The port's
    exact merges gather W partials instead of a ring sum (every rank the
    same bits), so these are the JAX package's model of the wire, kept as
    the plan's score term, not a count of the port's bytes;
  * `plan_merge`: times each candidate (the flat exact merge, and the
    quantized one per group count and block size) on the real process
    group with a synthetic payload of the engine's leaf sizes, best of
    `repeats` (CUDA events on the card, perf_counter on the CPU), and
    scores wall + modelled cross-host bytes / `dcn_gbps`. `dcn_gbps` (the
    config's `merge_dcn_gbps`, 25.0) is a planning constant of the JAX
    package's pod, not a measured rate of any link of the card's machine.
    Plans persist in the port's tune cache (tune/cache.py) under the site
    'merge_plan', keyed on the device name and the world size with the
    call's arguments; a hit skips the measurement, and stores write only
    under FEDMSE_TUNE=1.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

F32_BYTES = 4
SCALE_BYTES = 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def quantized_payload_bytes(elem_counts: Sequence[int], k: int,
                            per_group: int, block_size: int) -> int:
    """S_q: total quantized host-partial bytes across one host group's
    lanes — int8 block payloads + one f32 scale per block, per cluster
    row, including the pad to lane-aligned whole blocks."""
    per = max(per_group, 1)
    total = 0
    for e in elem_counts:
        nb_pad = _ceil_div(_ceil_div(e, block_size), per) * per
        total += k * nb_pad * (block_size + SCALE_BYTES)
    return total


def flat_psum_dcn_bytes(merged_elems: int, n_devices: int,
                        n_hosts: int) -> float:
    """Cross-host bytes of the f32 flat all-reduce merge (ring lowering,
    totalled over links): 2 · H · (D-1)/D · 4 · elems. Zero when all
    devices share one host."""
    if n_hosts <= 1 or n_devices <= 1:
        return 0.0
    return 2.0 * n_hosts * (n_devices - 1) / n_devices \
        * merged_elems * F32_BYTES


def lane_sliced_dcn_bytes(payload_bytes: int, n_groups: int) -> float:
    """Cross-host bytes of the lane-sliced hierarchical exchange:
    G(G-1) · S_q (each host partial's quantized bytes cross each pairwise
    boundary once; the reassembly all_gather is intra-host)."""
    if n_groups <= 1:
        return 0.0
    return float(n_groups * (n_groups - 1) * payload_bytes)


def merge_profile(*, backend: str, elem_counts: Sequence[int], k: int,
                  n_devices: int, n_groups: int = 0, per_group: int = 0,
                  block_size: int = 0) -> Dict[str, Any]:
    """Wire profile of ONE merge with these leaf shapes. For the explicit
    f32 backends `n_groups` may be 0 (host topology unknown at build —
    resolve the DCN bytes at query time via `flat_psum_dcn_bytes`)."""
    merged = k * int(sum(elem_counts))
    prof: Dict[str, Any] = {
        "backend": backend,
        "k": k,
        "n_devices": n_devices,
        "n_groups": n_groups,
        "per_group": per_group,
        "block_size": block_size,
        "merged_elems": merged,
        "merged_f32_bytes": merged * F32_BYTES,
    }
    if backend == "quantized":
        payload = quantized_payload_bytes(elem_counts, k,
                                          per_group, block_size)
        prof["dcn_payload_bytes"] = payload
        prof["dcn_bytes"] = lane_sliced_dcn_bytes(payload, n_groups)
        flat = flat_psum_dcn_bytes(merged, n_devices, max(n_groups, 1))
        prof["dcn_bytes_f32_same_topology"] = flat
        prof["dcn_reduction_vs_f32"] = (
            flat / prof["dcn_bytes"] if prof["dcn_bytes"] else None)
    else:
        prof["dcn_bytes"] = (
            flat_psum_dcn_bytes(merged, n_devices, n_groups)
            if n_groups else None)
    return prof


class SeamCounters:
    """Process-global byte accounting for the collective seams.

    Two kinds of entries: `note_merge` keeps the LATEST per-merge wire
    profile per backend name (reported when a merge is built: multiply by
    round counts host-side); `add_host_collective` accumulates the true
    per-call bytes of the host-side gathers, counted as they happen."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.merge_profiles: Dict[str, Dict[str, Any]] = {}
        self.host_collectives: Dict[str, Dict[str, float]] = {}

    def note_merge(self, name: str, profile: Dict[str, Any]) -> None:
        self.merge_profiles[name] = profile

    def add_host_collective(self, name: str, payload_bytes: int,
                            wire_bytes: int) -> None:
        c = self.host_collectives.setdefault(
            name, {"calls": 0, "payload_bytes": 0, "wire_bytes": 0})
        c["calls"] += 1
        c["payload_bytes"] += int(payload_bytes)
        c["wire_bytes"] += int(wire_bytes)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "merge_profiles": {k: dict(v)
                               for k, v in self.merge_profiles.items()},
            "host_collectives": {k: dict(v)
                                 for k, v in self.host_collectives.items()},
        }


seam = SeamCounters()


def _group_count_candidates(n_devices: int, n_hosts: int) -> List[int]:
    """num_groups candidates for the quantized backend: the real host
    count first, then the other divisors of the mesh ≥ 2 (virtual-host
    emulation widths)."""
    divs = [g for g in range(2, n_devices + 1) if n_devices % g == 0]
    if n_hosts in divs:
        divs.remove(n_hosts)
        divs.insert(0, n_hosts)
    return divs


def _best_wall(fn, repeats: int, device: torch.device) -> float:
    """The best of `repeats` timed calls of fn(), after one untimed call:
    CUDA events around each call on the card, perf_counter on the CPU."""
    fn()
    best = float("inf")
    cuda = device.type == "cuda"
    for _ in range(max(repeats, 1)):
        if cuda:
            torch.cuda.synchronize(device)
            start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            wall = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        best = min(best, wall)
    return best


def _broadcast_json(mesh, obj: Any) -> Any:
    """Rank 0's JSON-able `obj` on every rank of `mesh`."""
    if not mesh.sharded:
        return obj
    raw = np.frombuffer(json.dumps(obj).encode(), np.uint8) \
        if mesh.rank == 0 else np.zeros(0, np.uint8)
    size = int(mesh.broadcast_host(np.asarray([raw.size], np.int64))[0])
    buf = np.zeros(size, np.uint8)
    buf[:raw.size] = raw
    return json.loads(mesh.broadcast_host(buf).tobytes().decode())


def plan_merge(mesh, elem_counts: Sequence[int], *, k: int = 1,
               n_hosts: Optional[int] = None,
               group_counts: Optional[Sequence[int]] = None,
               block_sizes: Optional[Sequence[int]] = None,
               dcn_gbps: float = 25.0, repeats: int = 3,
               max_group_candidates: int = 2) -> Dict[str, Any]:
    """The measured search over merge plans for [k, e] payloads, e per leaf
    in `elem_counts`: the flat exact merge (gather and sum in rank order,
    what 'einsum' and 'shard_map' run) and the lane-sliced int8 exchange
    per (num_groups, block_size). Every rank of `mesh` calls it together
    (the candidates are collectives); rank 0's walls decide, so every rank
    adopts the same plan. Returns the candidate table and the chosen
    {"backend", "num_groups", "block_size"}; a hit in rank 0's cache
    returns rank 0's entry on every rank, with "cached": True.

    `block_sizes=None` races tune.sites.QUANT_BLOCK_CANDIDATES. `n_hosts`
    is the host count of the flat merge's modelled bytes (default: the
    mesh's real hosts); `group_counts` the quantized candidates' group
    counts (default: the real host count first, then the mesh's other
    divisors, `max_group_candidates` of them)."""
    from fedmse_tpu_torch.parallel.collectives import (
        host_groups, make_quantized_exchange)
    from fedmse_tpu_torch.tune.cache import default_cache
    from fedmse_tpu_torch.tune.sites import (QUANT_BLOCK_CANDIDATES,
                                             backend_signature)

    if block_sizes is None:
        block_sizes = QUANT_BLOCK_CANDIDATES
    n_devices = mesh.world_size
    if n_hosts is None:
        n_hosts = len(host_groups(mesh, 0))
    if group_counts is None:
        group_counts = _group_count_candidates(
            n_devices, n_hosts)[:max_group_candidates]
    cache = default_cache()
    plan_sig = {**backend_signature(mesh.device),
                "world_size": n_devices, "mesh_backend": mesh.backend,
                "elem_counts": [int(e) for e in elem_counts], "k": int(k),
                "n_hosts": int(n_hosts),
                "group_counts": [int(g) for g in group_counts],
                "block_sizes": [int(b) for b in block_sizes],
                "dcn_gbps": float(dcn_gbps), "repeats": int(repeats)}
    # rank 0's cache decides for every rank: a rank that missed while
    # rank 0 hit would sit alone in the candidates' gathers below
    hit = _broadcast_json(mesh, cache.lookup("merge_plan", plan_sig))
    if hit is not None:
        return {**hit["plan"], "cached": True}
    merged = k * int(sum(elem_counts))
    payloads = [torch.ones((k, int(e)), device=mesh.device)
                for e in elem_counts]
    candidates: List[Dict[str, Any]] = []

    def add_candidate(backend, num_groups, block_size, wall, dcn):
        candidates.append({
            "backend": backend, "num_groups": int(num_groups),
            "block_size": int(block_size), "wall_s": float(wall),
            "dcn_bytes": float(dcn),
            "score_s": float(wall + dcn / (dcn_gbps * 1e9))})

    def flat():
        for p in payloads:
            stack = mesh.all_gather(p)
            total = stack[0]
            for j in range(1, stack.shape[0]):
                total = total + stack[j]

    add_candidate("shard_map", 0, 0, _best_wall(flat, repeats, mesh.device),
                  flat_psum_dcn_bytes(merged, n_devices, n_hosts))
    for g in group_counts:
        if g <= 1 or n_devices % g:
            continue
        per = n_devices // g
        for bs in block_sizes:
            exchange = make_quantized_exchange(mesh, g, int(bs))

            def hier(_ex=exchange):
                for p in payloads:
                    _ex(p)

            add_candidate("quantized", g, bs,
                          _best_wall(hier, repeats, mesh.device),
                          lane_sliced_dcn_bytes(quantized_payload_bytes(
                              elem_counts, k, per, int(bs)), g))
    # rank 0's walls decide: every rank must adopt the same plan
    walls = mesh.broadcast_host(
        np.asarray([c["score_s"] for c in candidates]))
    for c, s in zip(candidates, walls):
        c["score_s"] = float(s)
    best = min(candidates, key=lambda c: c["score_s"])
    plan = {"chosen": {"backend": best["backend"],
                       "num_groups": best["num_groups"],
                       "block_size": best["block_size"]},
            "candidates": candidates, "merged_elems": merged,
            "merged_f32_bytes": merged * F32_BYTES, "k": k,
            "n_devices": n_devices, "n_hosts": int(n_hosts),
            "dcn_gbps": float(dcn_gbps)}
    if mesh.rank == 0:
        cache.store("merge_plan", plan_sig, plan["chosen"], plan=plan)
    return {**plan, "cached": False}
