"""Clustered + personalized federation sweep on the PyTorch port: K
cluster-level global models against the single global on the grids where
one prior fails (the port of cluster_sweep.py, on fedmse_tpu_torch/
cluster/).

  * **typed multimodal grid** (synthetic_typed_clients: gateways come in
    8 device types with far-apart multimodal manifolds, anomalies between
    each gateway's own modes): K in {1, 2, 4, 8} x score_kind {mse,
    centroid, knn}, plus personalized K = 1 and K = 8 on mse, against the
    K = 1 single-global cell of the same score_kind;
  * **Dirichlet(0.1) + label-shift grid** (synthetic_dirichlet_clients):
    K in {1, 4} x {mse, knn};
  * **K = 1 pin**: ClusterSpec(k=1) against no spec, the ClientStates
    tensors bit for bit;
  * **padding invariance**: the same fleet padded wider fits the same
    assignment;
  * **churn composition**: a leave burst and rejoin wave at K = 4; the
    fraction of joined slots whose latent statistics match the cluster
    they recycled into (nearest pooled Gaussian by JS), bar >= 0.9;
  * **serving swap**: per-cluster models gathered into the per-gateway
    layout (cluster.cluster_models) installed by an ordinary hot swap with
    the roster's cluster column. The port's ServingEngine compiles nothing
    per shape, so "zero retrace" reads: across the swap no kernel library
    is built or loaded, and the forward kernel's launch counter grows by
    exactly the buckets the two `score` calls dispatched (on the CPU,
    where the plain version runs, by none).

`--podscale` runs the clustered semantics at 100k gateways on the tiered
engine with `host_sharded=True` (one card: world 1, so the tier's one
block is the fleet), full participation, the vote tie-break on as in the
JAX driver (keyed rows above the tier's size rule, federation/tiered.py):
the K = 1 pin on the host tier's states, the typed fleet's assignment
purity, and K = 4 against the single global.

Writes CLUSTER_torch.json / CLUSTER_PODSCALE_torch.json (--out) and prints
one line per row. On the card: `python3 cluster_sweep_torch.py --out
CLUSTER_torch_h100.json` and `python3 cluster_sweep_torch.py --podscale
--out CLUSTER_PODSCALE_torch_h100.json`; on the CPU add `--device cpu`
(`--podscale --device cpu --clients 2000`).
"""

import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sweep_data_torch as sweep  # noqa: E402

DIM = 16
ROUNDS = 8
TYPES = 8
GRID_CLIENTS = 24
MODES = 3


def base_cfg(score_kind="mse", **kw):
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    return ExperimentConfig(
        dim_features=DIM, hidden_neus=12, latent_dim=5, epochs=10,
        batch_size=16, num_rounds=ROUNDS, num_participants=0.5,
        network_size=GRID_CLIENTS, score_kind=score_kind,
        knn_bank_size=64, knn_k=4,
        compat=CompatConfig(vote_tie_break=False), **kw)


def model_type_for(score_kind: str) -> str:
    """mse and knn cells run the plain AE (the cross-type contrast needs a
    learned reconstruction: the shrink penalty pins it near 1.0 at these
    sizes); centroid keeps the reference's hybrid pairing."""
    return "hybrid" if score_kind == "centroid" else "autoencoder"


def _stack(cfg, clients, device, pad=None, rngs=None):
    """The stacked federation, its dev set drawn from `rngs` (default: the
    run-0 streams of cfg.data_seed)."""
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    if rngs is None:
        rngs = ExperimentRngs(run=0, data_seed=cfg.data_seed)
    dev_x = build_dev_dataset(clients, rngs.data_rng)
    return stack_clients(clients, dev_x, cfg.batch_size,
                         pad_clients_to=pad, device=device)


def build_typed_grid(cfg, n_clients=GRID_CLIENTS, types=TYPES, seed=11, *,
                     device="cuda"):
    from fedmse_tpu_torch.data import synthetic_typed_clients
    clients = synthetic_typed_clients(
        n_clients=n_clients, types=types, dim=cfg.dim_features,
        n_normal=200, n_abnormal=80, modes=MODES, seed=seed)
    return _stack(cfg, clients, device), len(clients)


def build_dirichlet_grid(cfg, n_clients=GRID_CLIENTS, alpha=0.1,
                         label_shift=0.5, seed=7, *, device="cuda"):
    from fedmse_tpu_torch.data import synthetic_dirichlet_clients
    clients = synthetic_dirichlet_clients(
        n_clients=n_clients, dim=cfg.dim_features, rows_per_client=200,
        abnormal_per_client=80, modes=TYPES, alpha=alpha,
        label_shift=label_shift, seed=seed)
    return _stack(cfg, clients, device), len(clients)


def make_cell_model(cfg, device):
    from fedmse_tpu_torch.models import make_model
    return make_model(model_type_for(cfg.score_kind), cfg.dim_features,
                      cfg.hidden_neus, cfg.latent_dim,
                      shrink_lambda=cfg.shrink_lambda, device=device)


def run_cell(cfg, data, n_real, spec=None, elastic=None, label="cell", *,
             states=None, elastic_masks=None):
    """One federation on `data`'s device: (row, engine). AUC is the nanmean
    over the final evaluation of every real client (slots retired at the
    horizon left out). `states` replaces the engine's own init;
    `elastic_masks` (a MembershipMasks) replaces the spec's timeline."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    device = data.train_xb.device
    engine = RoundEngine(make_cell_model(cfg, device), cfg, data,
                         n_real=n_real,
                         rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
                         model_type=model_type_for(cfg.score_kind),
                         update_type="mse_avg", fused=True, cluster=spec,
                         elastic=elastic, elastic_masks=elastic_masks,
                         states=states)
    (results, _, _), sec = sweep.timed(engine.run_schedule_chunk, 0,
                                       cfg.num_rounds)
    final = engine.evaluate()
    if results[-1].members is not None:
        member = np.zeros(n_real, bool)
        member[results[-1].members] = True
        final = np.where(member, final, np.nan)
    row = {
        "label": label,
        "score_kind": cfg.score_kind,
        "k": 1 if spec is None else spec.k,
        "personalize": bool(spec is not None and spec.personalize),
        "auc_mean": round(float(np.nanmean(final)), 4),
        "auc_min": round(float(np.nanmin(final)), 4),
        "sec_per_round": sec / cfg.num_rounds,
        "aggregated_rounds": sum(1 for r in results
                                 if r.aggregator is not None),
    }
    if engine.cluster_assignment is not None:
        row["cluster_sizes"] = np.bincount(
            engine.cluster_assignment, minlength=spec.k).tolist()
        if engine.cluster_fit is not None:
            row["assignment_consistency"] = round(
                engine.cluster_fit.consistency(device), 4)
    return row, engine


def k1_bitwise_pin(cfg, data, n_real, *, states=None):
    """ClusterSpec(k=1) builds nothing: after 4 rounds the ClientStates
    tensors equal those of an engine with no spec, bit for bit."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    c = cfg.replace(num_rounds=4)
    _, plain = run_cell(c, data, n_real, label="k1-pin-plain", states=states)
    _, null = run_cell(c, data, n_real, spec=ClusterSpec(k=1),
                       label="k1-pin-null", states=states)
    return {"label": "k1_bitwise_pin",
            "states_bit_identical": sweep.states_equal(plain.states,
                                                       null.states)}


def padding_invariance(cfg, seed=11, *, device="cuda", states=None):
    """The same 8-gateway fleet stacked unpadded and padded to 12 fits the
    same K = 2 assignment. `states` (one ClientStates per stacking)
    replaces the engines' own inits."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.data import synthetic_typed_clients
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    clients = synthetic_typed_clients(n_clients=8, types=2, dim=DIM,
                                      n_normal=160, n_abnormal=64,
                                      seed=seed)
    model = make_model("hybrid", DIM, cfg.hidden_neus, cfg.latent_dim,
                       shrink_lambda=cfg.shrink_lambda, device=device)
    vecs = []
    for i, pad in enumerate((None, 12)):
        data = _stack(cfg, clients, device, pad, ExperimentRngs(run=0))
        eng = RoundEngine(model, cfg, data, n_real=8,
                          rngs=ExperimentRngs(run=0), model_type="hybrid",
                          update_type="mse_avg", fused=True,
                          cluster=ClusterSpec(k=2),
                          states=None if states is None else states[i])
        eng._ensure_cluster_fit(0)
        vecs.append(eng.cluster_assignment)
    return {"label": "padding_invariance",
            "assignment": vecs[0].tolist(),
            "invariant": bool(np.array_equal(vecs[0], vecs[1]))}


CHURN_SPEC = dict(leave_p=0.25, join_p=0.6, leave_window=(2, 4),
                  join_window=(4, None))


def churn_composition(cfg, data, n_real, *, states=None,
                      elastic_masks=None):
    """A leave burst and rejoin wave at K = 4: joins recycle into
    assignment[slot]'s incumbent mean; the row measures how often that
    cluster is the one the slot's latents match statistically."""
    from fedmse_tpu_torch.cluster import ClusterSpec, nearest_cluster
    from fedmse_tpu_torch.federation.elastic import ElasticSpec

    c = cfg.replace(num_rounds=10)
    row, engine = run_cell(c, data, n_real, spec=ClusterSpec(k=4),
                           elastic=ElasticSpec(**CHURN_SPEC),
                           label="churn-composition", states=states,
                           elastic_masks=elastic_masks)
    fit = engine.cluster_fit
    joined = np.flatnonzero(engine.generation_at(c.num_rounds) > 0)
    near = nearest_cluster(fit.means, fit.covs, fit.cl_means, fit.cl_covs,
                           fit.counts, device=engine.device)
    match = near[joined] == fit.assignment[joined]
    rate = float(match.mean()) if len(joined) else 1.0
    row.update({
        "label": "churn_composition",
        "elastic": {"leave_p": 0.25, "join_p": 0.6,
                    "leave_window": [2, 4], "join_window": [4, None]},
        "joined_slots": joined.tolist(),
        "join_cluster_match_rate": round(rate, 4),
    })
    return row


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def serving_cluster_swap(engine, n_real):
    """Per-cluster models (each cluster's member mean) in the per-gateway
    layout installed by a hot swap with the roster's cluster column. When
    every member accepted the last clustered broadcast it holds its
    cluster's merge (`members_hold_cluster_merge`), and the gathered
    cluster models must then score as the trained per-gateway params did
    (routing parity); a member that rejected it keeps its own params.
    Whatever the round did, each row must score as its gateway's cluster
    model served directly (`routed_to_cluster_model`). No kernel library
    may be built or loaded across the swap, and the forward kernel
    launches once a dispatched bucket (on the card; the CPU runs the
    plain version and launches none)."""
    from fedmse_tpu_torch.cluster import cluster_models
    from fedmse_tpu_torch.ops import native
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.serving import ServingEngine, ServingRoster

    assignment = engine.cluster_assignment
    k = engine.cluster.k
    device = engine.device
    params = _tree_map(lambda t: t[:n_real].detach().cpu().numpy(),
                       engine.model_params())
    cl_params = _tree_map(lambda t: np.stack([
        t[assignment == c].mean(axis=0) if (assignment == c).any()
        else t.mean(axis=0) for c in range(k)]), params)

    def roster():
        return ServingRoster(member=np.ones(n_real, bool),
                             generation=np.zeros(n_real, np.int64),
                             cluster=assignment)

    eng = ServingEngine.from_federation(
        engine.model, "autoencoder", params, score_kind="mse",
        max_bucket=64, roster=roster(), device=device)
    eng.warmup()
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(64, DIM)).astype(np.float32)
    gws = (np.arange(64) % n_real).astype(np.int32)
    sweep.sync(device)
    loads, launches = native.load.cache_info().misses, \
        fused_forward_stats.launches
    before = eng.score(rows, gws)
    eng.swap_state(params=cluster_models(cl_params, assignment),
                   roster=roster())
    after = eng.score(rows, gws)
    sweep.sync(device)
    loaded = native.load.cache_info().misses - loads
    launched = fused_forward_stats.launches - launches
    buckets = 2 * -(-len(rows) // eng.max_bucket)
    want = buckets if device.type == "cuda" else 0
    # the K cluster models served directly, each row on its gateway's
    # cluster: what the swapped per-gateway layout must route to
    direct = ServingEngine.from_federation(
        engine.model, "autoencoder", cl_params, score_kind="mse",
        max_bucket=64, device=device).score(rows, assignment[gws])
    flat = engine.states.params[:n_real]
    held = all(bool((flat[assignment == c] == flat[assignment == c][:1])
                    .all()) for c in range(k) if (assignment == c).any())
    return {"label": "serving_cluster_swap",
            "k": int(k),
            "zero_retrace": bool(loaded == 0 and launched == want),
            "libraries_loaded_across_swap": int(loaded),
            "forward_launches_across_swap": int(launched),
            "buckets_dispatched": int(buckets),
            "routing_parity": bool(np.allclose(before, after, rtol=1e-4)),
            "members_hold_cluster_merge": held,
            "routed_to_cluster_model": bool(np.allclose(after, direct,
                                                        rtol=1e-5)),
            "buckets_compiled": len(eng.buckets)}


def quick_cell(device="cuda", *, states=None):
    """The reduced grid: the typed 2-type / 8-gateway grid, mse score, K = 2
    clustered against the single global, the K = 1 pin, and the serving
    swap on the K = 2 federation. `states` replaces the engines' init."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    cfg = base_cfg("mse").replace(network_size=8, num_rounds=6)
    data, n_real = build_typed_grid(cfg, n_clients=8, types=2, device=device)
    single, _ = run_cell(cfg, data, n_real, label="quick-single",
                         states=states)
    clustered, eng = run_cell(cfg, data, n_real, spec=ClusterSpec(k=2),
                              label="quick-k2", states=states)
    pin = k1_bitwise_pin(cfg, data, n_real, states=states)
    delta = clustered["auc_mean"] - single["auc_mean"]
    return {
        "single_global_auc": single["auc_mean"],
        "clustered_k2_auc": clustered["auc_mean"],
        "delta_auc": round(delta, 4),
        "cluster_sizes": clustered.get("cluster_sizes"),
        "k1_bit_identical": pin["states_bit_identical"],
        "acceptance_met": bool(pin["states_bit_identical"]
                               and delta >= 0.1),
        "serving": serving_cluster_swap(eng, n_real),
    }


def bulk_typed_federation(n: int, dim: int, batch: int, types: int,
                          seed: int = 11):
    """(host FederatedData, type of each gateway): the typed fleet of the
    100k cell drawn in bulk, the JAX driver's `_bulk_typed_federation`
    bit for bit. Gateways come in `types` device types with far-apart,
    radius-matched manifolds, and each gateway's anomalies are the next
    type's normal traffic: a single global model trained on every type
    reconstructs them as well as the legitimate rows, so only a
    cluster-scoped model can separate them."""
    from fedmse_tpu_torch.data import FederatedData

    rng = np.random.default_rng(seed)
    f32 = np.float32
    t_of = np.arange(n) % types
    shifts = rng.normal(0, 4.0, (types, dim)).astype(f32)
    shifts *= (np.linalg.norm(shifts, axis=1, keepdims=True).mean()
               / np.linalg.norm(shifts, axis=1, keepdims=True))
    own = shifts[t_of]
    other = shifts[(t_of + 1) % types]
    nb = 2

    def at(mode, tail):
        return (rng.normal(0, 1.0, (n, *tail)).astype(f32)
                + mode.reshape(n, *([1] * (len(tail) - 1)), dim))

    train = at(own, (nb, batch, dim))
    v_rows = 4
    valid = at(own, (v_rows, dim))
    valid_xb = np.zeros((n, nb, batch, dim), f32)
    valid_xb[:, 0, :v_rows] = valid
    valid_mb = np.zeros((n, nb, batch), f32)
    valid_mb[:, 0, :v_rows] = 1.0
    t_half = 8
    test = np.concatenate([at(own, (t_half, dim)),
                           at(other, (t_half, dim))], axis=1)
    test_y = np.concatenate([np.zeros((n, t_half), f32),
                             np.ones((n, t_half), f32)], axis=1)
    dev_types = rng.integers(0, types, 256)
    dev_x = rng.normal(0, 1.0, (256, dim)).astype(f32) + shifts[dev_types]
    t = torch.from_numpy
    return FederatedData(
        train_xb=t(train), train_mb=t(np.ones((n, nb, batch), f32)),
        valid_xb=t(valid_xb), valid_mb=t(valid_mb),
        valid_x=t(valid), valid_m=t(np.ones((n, v_rows), f32)),
        test_x=t(test), test_m=t(np.ones((n, 2 * t_half), f32)),
        test_y=t(test_y), dev_x=t(dev_x),
        client_mask=t(np.ones((n,), f32))), t_of


POD_TYPES, POD_ROUNDS, POD_DIMS = 4, 6, (8, 6, 3)


def podscale_config(n):
    """The --podscale federation's config: 8/6/3, full participation on
    the host-sharded tier, 2 epochs a round, the vote tie-break on."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    dim, hid, lat = POD_DIMS
    return ExperimentConfig(
        dim_features=dim, hidden_neus=hid, latent_dim=lat, network_size=n,
        epochs=2, batch_size=16, num_rounds=POD_ROUNDS,
        num_participants=1.0, state_layout="tiered", host_sharded=True,
        compat=CompatConfig(shared_last_client_val=False))


def podscale_run(cfg, data, spec, rounds, mesh, device, states=None):
    """One tiered federation of the --podscale cell: (engine, final
    per-gateway metric, results, seconds a round). `states` replaces the
    tier's own init."""
    from fedmse_tpu_torch.federation import TieredRoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    n = cfg.network_size
    eng = TieredRoundEngine(
        make_model("hybrid", cfg.dim_features, cfg.hidden_neus,
                   cfg.latent_dim, cfg.shrink_lambda, device=device),
        cfg, data, n_real=n,
        rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
        model_type="hybrid", update_type="mse_avg", mesh=mesh,
        cluster=spec, host_sharded=True, device=device, states=states)
    assert eng.host_sharded and eng.cohort == n, (eng.cohort, n)
    results, secs = [], []
    eng.run_rounds(0, rounds,
                   lambda r, s: (results.append(r), secs.append(s)) and False)
    final = np.asarray(eng.evaluate_final_streamed())
    if final.ndim == 2:
        final = final[:, 0]
    return eng, final, results, secs


def purity(assignment, t_of, types):
    """The size-weighted majority-type fraction of the clusters."""
    return float(sum(
        np.bincount(t_of[assignment == c], minlength=types).max()
        for c in range(types) if (assignment == c).any()) / len(t_of))


def podscale_main(args, device, prov, states=None):
    """`--podscale`: the clustered semantics at 100k gateways on the tiered
    engine with host_sharded=True, full participation (every slot holds a
    converged merge at evaluation), the vote tie-break on. Rows: the
    K = 1 pin on the host tier's states, and K = 4 against the single
    global with the assignment's purity against the generating types.
    `states` replaces every run's init."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.parallel.mesh import client_mesh

    t_start = time.perf_counter()
    n = args.clients or 100_000
    types, rounds = POD_TYPES, POD_ROUNDS
    cohort = n
    dim, hid, lat = POD_DIMS
    cfg = podscale_config(n)
    mesh = client_mesh(device)
    data, t_of = bulk_typed_federation(n, dim, cfg.batch_size, types)

    def run(spec, rounds_=rounds):
        return podscale_run(cfg, data, spec, rounds_, mesh, device, states)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    t0 = time.perf_counter()
    e_none, f_none, _, _ = run(None, rounds_=2)
    e_k1, f_k1, _, _ = run(ClusterSpec(k=1), rounds_=2)
    k1_bit = bool(np.array_equal(f_none, f_k1, equal_nan=True)
                  and sweep.states_equal(e_none.store.host, e_k1.store.host))
    emit({"label": "k1-bitwise-pin-100k", "n_gateways": n, "rounds": 2,
          "states_bit_identical": k1_bit,
          "wall_s": time.perf_counter() - t0})
    del e_none, e_k1

    t0 = time.perf_counter()
    _, f_s, res_s, secs_s = run(None)
    e_c, f_c, res_c, secs_c = run(ClusterSpec(k=types))
    assignment = np.asarray(e_c.cluster_assignment)
    pure = purity(assignment, t_of, types)
    sel = np.zeros(n, bool)
    for r in res_s:
        sel[list(r.selected)] = True
    assert all(list(a.selected) == list(b.selected)
               for a, b in zip(res_s, res_c))
    delta = float(np.nanmean(f_c[sel]) - np.nanmean(f_s[sel]))
    emit({"label": "typed-100k-k4-vs-single", "n_gateways": n,
          "types": types, "cohort": cohort, "rounds": rounds,
          "sec_per_round_single": min(secs_s[1:] or secs_s),
          "sec_per_round_clustered": min(secs_c[1:] or secs_c),
          "cluster_sizes": np.bincount(assignment,
                                       minlength=types).tolist(),
          "assignment_purity": round(pure, 4),
          "cohort_covered_gateways": int(sel.sum()),
          "single_auc_covered": round(float(np.nanmean(f_s[sel])), 4),
          "clustered_auc_covered": round(float(np.nanmean(f_c[sel])), 4),
          "delta_auc_covered": round(delta, 4),
          "wall_s": time.perf_counter() - t0})

    acceptance = {
        "bar": f"{n} gateways under the host-sharded tier: K=1 bitwise to "
               "no-spec, assignment purity >= 0.9 vs the generating types, "
               "clustered K=4 beats single-global by >= 0.1 AUC on the "
               "cohort-covered gateways",
        "k1_bit_identical": k1_bit,
        "purity": round(pure, 4),
        "purity_met": bool(pure >= 0.9),
        "delta_auc": round(delta, 4),
        "delta_met": bool(delta >= 0.1),
    }
    acceptance["met"] = bool(acceptance["k1_bit_identical"]
                             and acceptance["purity_met"]
                             and acceptance["delta_met"])
    out = {
        "protocol": f"{n}-gateway bulk typed fleet ({types} device types, "
                    f"far-apart manifolds), tiered engine (state_layout="
                    f"tiered host_sharded=True, world {mesh.world_size}: one "
                    f"block, the fleet; cohort {cohort}), hybrid+mse_avg "
                    f"{dim}/{hid}/{lat}, {rounds} rounds x 2 epochs, "
                    f"{sweep.tie_break_phrase(cfg, cohort)}; the bars pin "
                    f"that the clustered "
                    f"semantics hold on the tier at fleet scale",
        "rows": rows, "acceptance": acceptance,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out,
                      "acceptance_met": acceptance["met"]}))
    return out


def best_delta(rows, kind):
    """The best same-grid clustered-or-personalized minus single-global AUC
    delta for one score_kind (pooling grids would let the spread between
    datasets fake or mask a win)."""
    deltas = []
    for grid in sorted({r["grid"] for r in rows if r.get("grid")}):
        cells = [r for r in rows if r.get("grid") == grid
                 and r["score_kind"] == kind]
        singles = [r["auc_mean"] for r in cells if r["k"] == 1
                   and not r["personalize"]]
        multis = [r["auc_mean"] for r in cells if r["k"] > 1
                  or r["personalize"]]
        if singles and multis:
            deltas.append(max(multis) - singles[0])
    return round(max(deltas), 4) if deltas else None


def acceptance_block(rows, pin, pad, churn, serve):
    deltas = {kind: best_delta(rows, kind)
              for kind in ("mse", "centroid", "knn")}
    best = max(d for d in deltas.values() if d is not None)
    acceptance = {
        "bar": "K=1 bit-identical to the single-global program; some K>1 "
               "clustered or personalized cell beats the single-global AUC "
               "for the same score_kind by >= 0.1 absolute; assignments "
               "padding-invariant; >= 90% of churn joins recycle into the "
               "cluster whose incumbents they statistically match; no "
               "kernel rebuilt and one forward launch a bucket across "
               "cluster-model hot swaps in serving",
        "k1_bit_identical": pin["states_bit_identical"],
        "best_delta_auc_by_kind": deltas,
        "best_delta_auc": best,
        "delta_ok": bool(best >= 0.1),
        "padding_invariant": pad["invariant"],
        "join_cluster_match_rate": churn["join_cluster_match_rate"],
        "join_match_ok": bool(churn["join_cluster_match_rate"] >= 0.9),
        "serving_zero_retrace": serve["zero_retrace"],
        "serving_routing_parity": serve["routing_parity"],
    }
    acceptance["met"] = bool(
        acceptance["k1_bit_identical"] and acceptance["delta_ok"]
        and acceptance["padding_invariant"] and acceptance["join_match_ok"]
        and acceptance["serving_zero_retrace"]
        and acceptance["serving_routing_parity"])
    return acceptance


def main(argv=None):
    p = sweep.parser(__doc__, "CLUSTER_torch.json")
    p.add_argument("--podscale", action="store_true",
                   help="the 100k-gateway tiered run instead of the grids")
    p.add_argument("--clients", type=int, default=None,
                   help="with --podscale, the fleet (default 100,000)")
    args = p.parse_args(argv)
    if args.podscale and args.out == "CLUSTER_torch.json":
        args.out = "CLUSTER_PODSCALE_torch.json"
    device, prov = sweep.start(args)
    if args.podscale:
        return podscale_main(args, device, prov)
    from fedmse_tpu_torch.cluster import ClusterSpec

    def emit(row):
        print(json.dumps(row), flush=True)
        return row

    rows = []
    t_start = time.perf_counter()
    typed = {}
    serve_engine = None
    for kind in ("mse", "centroid", "knn"):
        cfg = base_cfg(kind)
        data, n_real = typed.setdefault(kind, build_typed_grid(
            cfg, device=device))
        for k in (1, 2, 4, 8):
            spec = None if k == 1 else ClusterSpec(k=k)
            row, eng = run_cell(cfg, data, n_real, spec=spec,
                                label=f"multimodal/{kind}/k{k}")
            rows.append(emit({"grid": "multimodal", **row}))
            if kind == "mse" and k in (1, 8):
                prow, _ = run_cell(
                    cfg, data, n_real,
                    spec=ClusterSpec(k=k, personalize=True),
                    label=f"multimodal/{kind}/k{k}-personalized")
                rows.append(emit({"grid": "multimodal", **prow}))
            if kind == "mse" and k == 4:
                serve_engine = eng

    for kind in ("mse", "knn"):
        cfg = base_cfg(kind)
        data_d, n_real_d = build_dirichlet_grid(cfg, device=device)
        for k in (1, 4):
            spec = None if k == 1 else ClusterSpec(k=k)
            row, _ = run_cell(cfg, data_d, n_real_d, spec=spec,
                              label=f"dirichlet/{kind}/k{k}")
            rows.append(emit({"grid": "dirichlet-a0.1-ls0.5", **row}))
        del data_d

    cfg = base_cfg("mse")
    data, n_real = typed["mse"]
    pin = emit(k1_bitwise_pin(cfg, data, n_real))
    pad = emit(padding_invariance(cfg, device=device))
    churn = emit(churn_composition(cfg, data, n_real))
    serve = emit(serving_cluster_swap(serve_engine, n_real))
    acceptance = acceptance_block(rows, pin, pad, churn, serve)

    out = {
        "metric": "clustered + personalized federation AUC vs the single "
                  f"global on the typed multimodal ({TYPES} types) and "
                  "Dirichlet(0.1)+label-shift grids "
                  f"({GRID_CLIENTS} gateways, dim {DIM})",
        "value": acceptance["best_delta_auc"],
        "unit": "best same-score-kind AUC delta (K>1 minus K=1)",
        "rows": rows, "k1_pin": pin, "padding": pad, "churn": churn,
        "serving": serve, "acceptance": acceptance,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out, "acceptance_met": acceptance["met"],
                      "best_delta_auc": acceptance["best_delta_auc"]}))
    return out


if __name__ == "__main__":
    main()
