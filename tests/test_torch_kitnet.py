"""KitNET in the port (models/kitnet.py, ops/kitnet.py) held to its plain
reference (models/kitnet_reference.py) on the CPU, at a small size: 4
gateways, 4 statistics x 5 windows (20 features, the windows of one
statistic strided by 4 as N-BaIoT lays them out), at most 10 features an
ensemble member.

Tolerances. The port's plain twins compute each autoencoder as batched
products over the clients and rows; the reference one model at a time,
its gradients by autograd. Both are f32, so they differ by the order of
their sums alone: some tens of products a sum, each ~6e-8 relative, so
1e-5 of the largest magnitude (per row for the statistic, per leaf for
the gradients) leaves two orders of magnitude of room while a wrong term
or a missed factor (a gradient without its mask, a loss without the
output autoencoder) moves them by far more.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.federation import init_client_states
from fedmse_tpu_torch.federation.rounds import RoundEngine
from fedmse_tpu_torch.federation.state import ClientStates
from fedmse_tpu_torch.federation.verification import make_verify_fn
from fedmse_tpu_torch.main import run_combination
from fedmse_tpu_torch.models import kitnet, kitnet_reference as ref
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import KitnetLayout, ParamLayout
from fedmse_tpu_torch.ops import kitnet as ops
from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                          fused_loss_terms)
from fedmse_tpu_torch.ops.fused_train import fused_train_grads
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(2)

N, STATS, WINDOWS, BATCH, MAX_AE = 4, 4, 5, 12, 10
D = STATS * WINDOWS
TOL = 1e-5


def windowed(g: torch.Generator, n: int, rows: int) -> torch.Tensor:
    """[n, rows, D]: column w * STATS + j is statistic j's window w,
    sqrt(0.9) u_j + sqrt(0.1) eps."""
    u = torch.randn((n, rows, STATS), generator=g)
    eps = torch.randn((n, rows, WINDOWS, STATS), generator=g)
    x = (0.9 ** 0.5) * u[:, :, None, :] + (0.1 ** 0.5) * eps
    return x.reshape(n, rows, D)


GROUPS = [frozenset(w * STATS + j for w in range(WINDOWS))
          for j in range(STATS)]


def _batches(t: torch.Tensor):
    n, rows, d = t.shape
    nb = -(-rows // BATCH)
    xb = torch.nn.functional.pad(t, (0, 0, 0, nb * BATCH - rows)).view(
        n, nb, BATCH, d)
    mb = (torch.arange(nb * BATCH) < rows).float().view(1, nb, BATCH)
    return xb.contiguous(), mb.expand(n, nb, BATCH).contiguous()


def federation(seed: int = 0) -> FederatedData:
    g = torch.Generator().manual_seed(seed)
    normal = windowed(g, N, 150)
    abnormal = 4.0 + 2.0 * windowed(g, N, 30)
    train = normal[:, :60]
    lo, hi = train.amin(1, keepdim=True), train.amax(1, keepdim=True)
    scale = lambda t: (t - lo) / (hi - lo)  # noqa: E731
    txb, tmb = _batches(scale(train))
    valid = scale(normal[:, 60:75])
    vxb, vmb = _batches(valid)
    test = torch.cat([scale(normal[:, 75:]), scale(abnormal)], dim=1)
    dev = scale(normal[:, 60:75]).reshape(-1, D)[:40]
    return FederatedData(
        train_xb=txb, train_mb=tmb, valid_xb=vxb, valid_mb=vmb,
        valid_x=valid.contiguous(), valid_m=torch.ones(N, 15),
        test_x=test.contiguous(), test_m=torch.ones(N, test.shape[1]),
        test_y=torch.cat([torch.zeros(75), torch.ones(30)]).expand(
            N, -1).contiguous(),
        dev_x=dev.contiguous(), client_mask=torch.ones(N))


@pytest.fixture(scope="module")
def fed():
    return federation()


@pytest.fixture(scope="module")
def fmap(fed):
    return kitnet.federated_feature_map(fed.train_xb, fed.train_mb,
                                        fed.client_mask, MAX_AE)


def cfg(**kw) -> ExperimentConfig:
    base = dict(scaler="minmax", dim_features=D, epochs=3, num_rounds=3,
                num_participants=0.5, lr_rate=1e-2,
                compat=CompatConfig(vote_tie_break=False))
    return ExperimentConfig(**{**base, **kw})


def random_models(layout: KitnetLayout, n: int, seed: int = 3):
    """n models of seeded random weights large enough to saturate some
    units, with statistics of every kind: seen (lo < hi), one seen value
    (lo = hi) and none (hi < lo)."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((n, layout.size), generator=g) * 0.8
    k = layout.k
    lo = torch.rand((n, k), generator=g) * 0.2
    hi = lo + torch.rand((n, k), generator=g) * 0.5
    hi[0, 0] = lo[0, 0]
    stats = torch.cat([lo, hi], dim=1)
    stats[-1] = kitnet.fresh_stats(1, layout, "cpu")[0]
    return flat, stats


def _leaf_gap(got, want, layout):
    return max(float((got[:, sl] - want[:, sl]).abs().max()
                     / want[:, sl].abs().max().clamp(min=1e-30))
               for sl in layout.slices())


# ---- the layout ---- #

def test_layout_of_the_map(fmap):
    model = make_model("kitnet", D, feature_map=fmap, device="cpu")
    layout = ParamLayout.of(model)
    assert isinstance(layout, KitnetLayout) and layout.family == "kitnet"
    assert layout.k == len(fmap) and layout.stats_width == 2 * len(fmap)
    sizes = [(len(c), -(-3 * len(c) // 4)) for c in fmap]
    sizes.append((len(fmap), -(-3 * len(fmap) // 4)))
    assert layout.size == sum(n * h + h + n for n, h in sizes)
    assert ref.shapes(fmap) == sizes
    # each leaf's columns, in the order the reference reads them
    row = torch.arange(layout.size, dtype=torch.float32)
    mine = layout.views(row[None])
    for (name, _, _), (w, b, c) in zip(layout.autoencoders(),
                                       ref.unflatten(row, fmap)):
        for leaf, t in (("W", w), ("b", b), ("c", c)):
            assert torch.equal(mine[name][leaf][0], t), (name, leaf)
    assert torch.equal(layout.flatten(mine), row[None])
    table = ops.table_rows(layout)
    assert table[:5] == [layout.k, D, sum(h for _, h in sizes[:-1]),
                         sizes[-1][1], layout.size]
    assert len(table) == 8 + 5 * layout.k + D + layout.size


def test_feature_map_recovers_the_planted_groups(fed, fmap):
    rows = [fed.train_xb[i].reshape(-1, D).numpy() for i in range(N)]
    assert fmap == ref.feature_map(rows, MAX_AE)
    flat = sorted(f for c in fmap for f in c)
    assert flat == list(range(D))
    for cluster in fmap:
        assert len(cluster) <= MAX_AE
        assert frozenset(cluster) in GROUPS or any(
            frozenset(cluster) == a | b for a in GROUPS for b in GROUPS
            if a != b), cluster


def test_feature_map_cuts_as_break_clust():
    """A chain of distances: the cut takes whole subtrees of at most
    max_ae leaves, left before right, each in pre-order."""
    d = np.full((6, 6), 0.9)
    for a, b, v in ((0, 1, 0.1), (2, 3, 0.2), (4, 5, 0.3), (1, 2, 0.5)):
        d[a, b] = d[b, a] = v
    np.fill_diagonal(d, 0.0)
    got = kitnet.cluster_map(d, 4)
    assert sorted(map(sorted, got)) == [[0, 1, 2, 3], [4, 5]]
    assert kitnet.cluster_map(d, 1) == tuple((i,) for i in
                                             sum(map(list, got), []))


# ---- the forward and the train step against the reference ---- #

def test_forward_statistic_matches_the_reference(fed, fmap):
    layout = KitnetLayout(fmap)
    flat, stats = random_models(layout, N)
    x = fed.test_x.reshape(-1, D)
    idx = torch.arange(N, dtype=torch.int32).repeat_interleave(
        fed.test_x.shape[1])
    latent, stat, zn = fused_forward_stats(
        layout.tree(flat, stats=stats), x, idx)
    loss, no_latent = fused_loss_terms(layout.tree(flat, stats=stats), x,
                                       idx)
    assert latent.shape == (x.shape[0], 0)
    assert not zn.any() and not no_latent.any()  # no latent: norm 0
    for m in range(N):
        rows = idx == m
        want_s, want_l = ref.forward(flat[m], stats[m], x[rows], fmap)
        assert torch.isfinite(want_s).all()
        for got, want in ((stat[rows], want_s), (loss[rows], want_l)):
            gap = (got - want).abs() / want.abs().clamp(min=1e-30)
            assert float(gap.max()) <= TOL, (m, float(gap.max()))


def test_forward_routes_each_row_to_its_model(fed, fmap):
    """A routed bucket scores each row as its model alone does; a row
    of a model outside [0, G) is NaN."""
    layout = KitnetLayout(fmap)
    flat, stats = random_models(layout, N)
    x = fed.test_x[0, :9]
    idx = torch.tensor([2, 0, 3, 1, 2, -1, 0, 4, 3], dtype=torch.int32)
    stat, loss = ops.kitnet_forward_stats(layout.tree(flat, stats=stats), x,
                                          idx)
    for r, m in enumerate(idx.tolist()):
        if not 0 <= m < N:
            assert torch.isnan(stat[r]) and torch.isnan(loss[r])
            continue
        one = ops.kitnet_forward_stats(layout.tree(
            flat[m:m + 1], stats=stats[m:m + 1]), x[r:r + 1])
        assert float(stat[r]) == float(one[0][0])
        assert float(loss[r]) == float(one[1][0])


def test_train_step_matches_the_reference(fed, fmap):
    layout = KitnetLayout(fmap)
    flat, stats = random_models(layout, N)
    x, m = fed.train_xb[:, -1], fed.train_mb[:, -1].clone()
    m[1, 7:] = 0.0  # a short batch
    new = stats.clone()
    loss, grads = fused_train_grads(flat, x, m, layout=layout, stats=new)
    want = [ref.train_step(flat[c], stats[c], x[c], m[c], fmap)
            for c in range(N)]
    for c, (w_loss, w_grads, w_stats) in enumerate(want):
        assert abs(float(loss[c] - w_loss)) <= TOL * abs(float(w_loss))
        torch.testing.assert_close(new[c], w_stats, rtol=TOL, atol=0.0)
    assert _leaf_gap(grads, torch.stack([w[1] for w in want]),
                     layout) <= TOL


def test_statistics_update_before_the_normalisation(fed, fmap):
    """From Kitsune's initial (+inf, -inf) the step's statistics are the
    min and max of the real rows' RMSEs under the pre-step params, and
    the step's loss is normalised by them; an inactive client keeps its
    statistics; padded rows are left out."""
    layout = KitnetLayout(fmap)
    flat = kitnet.init_flat(layout, N, torch.Generator().manual_seed(1),
                            device="cpu")
    stats = kitnet.fresh_stats(N, layout, "cpu")
    x, m = fed.train_xb[:, 0], fed.train_mb[:, 0].clone()
    m[:, 5:] = 0.0
    active = torch.tensor([True, True, False, True])
    new = stats.clone()
    loss, _ = ops.kitnet_train_grads(flat, new, x, m, layout=layout,
                                     active=active)
    for c in range(N):
        s = ref.rmses(flat[c], x[c, :5], fmap)
        if not active[c]:
            assert torch.equal(new[c], stats[c])
            continue
        torch.testing.assert_close(new[c], torch.cat([s.min(0).values,
                                                      s.max(0).values]),
                                   rtol=TOL, atol=0.0)
        # normalised by the updated statistics, not the fresh ones
        _, per = ref.forward(flat[c], new[c], x[c], fmap)
        want = (per * m[c]).sum() / m[c].sum()
        assert abs(float(loss[c] - want)) <= TOL * abs(float(want))
        _, stale = ref.forward(flat[c], stats[c], x[c], fmap)
        assert abs(float((stale * m[c]).sum() / m[c].sum() - want)) > 1e-3


def test_untrained_models_score_finitely(fed, fmap):
    """hi < lo (nothing seen: a fresh or pad client) reads s itself."""
    layout = KitnetLayout(fmap)
    flat = kitnet.init_flat(layout, 1, torch.Generator().manual_seed(2),
                            device="cpu")
    stats = kitnet.fresh_stats(1, layout, "cpu")
    x = fed.test_x[0]
    stat, loss = ops.kitnet_forward_stats(layout.tree(flat, stats=stats), x)
    assert torch.isfinite(stat).all() and torch.isfinite(loss).all()
    s = ref.rmses(flat[0], x, fmap)
    assert torch.equal(ref.normalize(s, stats[0]), s)


def test_empty_mask_gives_nan_like_the_autoencoder(fed, fmap):
    layout = KitnetLayout(fmap)
    flat, stats = random_models(layout, N)
    m = torch.zeros(N, BATCH)
    new = stats.clone()
    loss, grads = ops.kitnet_train_grads(flat, new, fed.train_xb[:, 0], m,
                                         layout=layout)
    assert torch.isnan(loss).all() and torch.isnan(grads).all()
    assert torch.equal(new, stats)


# ---- the merge and verification ---- #

def test_merged_statistics_are_the_min_and_max_of_the_merged():
    stats = torch.tensor([[0.1, 0.5, 0.9, 0.8], [0.0, 0.7, 0.4, 0.9],
                          [-1.0, 0.0, 5.0, 5.0],
                          [float("inf"), float("inf"), float("-inf"),
                           float("-inf")]])
    w = torch.tensor([0.25, 0.75, 0.0, 0.0])
    got = kitnet.merge_stats(stats, w)
    assert torch.equal(got, torch.tensor([0.0, 0.5, 0.9, 0.9]))


def test_rejected_broadcast_keeps_the_statistics(fed, fmap):
    """A client that accepts takes the broadcast's params and statistics,
    one that rejects keeps both of its own, the aggregator loads both;
    the deltas read the params alone."""
    layout = KitnetLayout(fmap)
    model = make_model("kitnet", D, feature_map=fmap, device="cpu")
    flat, stats = random_models(layout, N)
    states = init_client_states(model, N, torch.Generator().manual_seed(0),
                                device="cpu").replace(
        params=flat.clone(), stats=stats.clone(),
        hist_params=flat.clone(), hist_seen=torch.ones(N, dtype=torch.bool))
    agg = flat[1].clone()
    agg_stats = torch.linspace(0.0, 1.0, layout.stats_width)
    onehot = torch.tensor([0.0, 1.0, 0.0, 0.0])
    # a threshold between the clients' deltas: the nearest accepts, the
    # other two reject
    deltas = sum(torch.sqrt(torch.square(flat[:, sl] - agg[sl]).sum(1))
                 for sl in layout.slices())
    near, *far = sorted((0, 2, 3), key=lambda c: float(deltas[c]))
    thr = float((deltas[near] + deltas[far[0]]) / 2)
    verify = make_verify_fn(model, verification_threshold=thr,
                            performance_threshold=1e9)
    out = verify(states, agg, fed.valid_x[-1], fed.valid_m[-1], onehot,
                 fed.client_mask, agg_stats=agg_stats)
    accepted = out.accepted.tolist()
    assert accepted == [c in (1, near) for c in range(N)]
    for c in range(N):
        want = agg_stats if accepted[c] else stats[c]
        assert torch.equal(out.states.stats[c], want), c
        assert torch.equal(out.states.params[c],
                           agg if accepted[c] else flat[c]), c
    np.testing.assert_allclose(out.param_delta.numpy(),
                               torch.where(onehot > 0, 0.0, deltas).numpy())


# ---- the round ---- #

def engine(fed, fmap, update_type="fedprox", fused=True, states=None,
           **kw):
    model = make_model("kitnet", D, feature_map=fmap, device="cpu")
    return RoundEngine(model, cfg(**kw), fed, n_real=N,
                       rngs=ExperimentRngs(run=0, data_seed=7),
                       model_type="kitnet", update_type=update_type,
                       states=states, fused=fused)


@pytest.mark.parametrize("update_type, kw", [
    ("avg", {}), ("fedprox", {}), ("mse_avg", {}),
    ("fedprox", {"hardened_verification": True}),
    ("mse_avg", {"compact_cohort": False})])
def test_fused_round_is_the_per_phase_round_bitwise(fed, fmap, update_type,
                                                    kw):
    per = engine(fed, fmap, update_type, fused=False, **kw)
    fus = engine(fed, fmap, update_type, fused=True,
                 states=per.states.clone(), **kw)
    assert torch.isinf(per.states.stats).all()
    for r in range(3):
        got, want = fus.run_round(r), per.run_round(r)
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        for name in ("client_metrics", "mse_scores", "agg_weights",
                     "tracking", "min_valid"):
            a, b = getattr(got, name), getattr(want, name)
            if a is None or b is None:
                assert a is None and b is None, name
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        for f in dataclasses.fields(ClientStates):
            a, b = getattr(fus.states, f.name), getattr(per.states, f.name)
            pairs = zip(a, b) if f.name == "opt_state" else [(a, b)]
            for x, y in pairs:
                assert torch.equal(x, y), f.name
    # the cohort trained: its statistics are seen values now
    assert torch.isfinite(fus.states.stats).any()


@pytest.mark.parametrize("update_type", ["avg", "fedprox", "mse_avg"])
def test_every_merge_runs_through_the_driver(fed, fmap, update_type):
    """model_type 'kitnet' through main.run_combination on the fused,
    pipelined schedule: finite AUCs, a merge in the first round."""
    c = cfg(fused_schedule_chunk=2)
    out = run_combination(c, fed, N, "kitnet", update_type, run=0)
    assert out["rounds_run"] == 3
    assert np.isfinite(out["final_metrics"]).all()
    assert out["rounds"][0].aggregator is not None
    assert out["final_metrics"].mean() > 0.9
    eng = out["engine"]
    assert eng.layout.family == "kitnet"
    assert torch.isfinite(eng.states.stats).all()


def test_init_is_kitsunes(fmap):
    layout = KitnetLayout(fmap)
    flat = kitnet.init_flat(layout, 64, torch.Generator().manual_seed(0),
                            device="cpu")
    views = layout.views(flat)
    for name, n, _ in layout.autoencoders():
        w = views[name]["W"]
        assert float(w.abs().max()) <= 1.0 / n
        assert float(w.abs().max()) > 0.9 / n
        assert not views[name]["b"].any() and not views[name]["c"].any()
    pad = kitnet.init_pad_flat(layout, [5, 6], (3, 4), device="cpu")
    assert pad.shape == (2, layout.size)
    assert not torch.equal(pad[0], pad[1])


# ---- what KitNET does not run ---- #

@pytest.mark.parametrize("kw, flags, match", [
    ({"scaler": "standard"}, {}, "scaler"),
    ({"state_layout": "tiered"}, {}, "tiered"),
    ({}, {"batch_runs": True}, "batch-runs"),
    ({}, {"use_mesh": True}, "use-mesh"),
    ({}, {"serving": True}, "serving"),
    ({"score_kind": "knn"}, {}, "knn"),
    ({"score_kind": "centroid"}, {}, "centroid"),
    ({"precision": "bf16"}, {}, "bf16"),
    ({}, {"resume": True}, "resume"),
])
def test_unsupported_paths_raise(kw, flags, match):
    with pytest.raises(ValueError, match=match):
        kitnet.check_supported(cfg(**kw), **flags)


def test_engine_and_model_refuse_what_kitnet_does_not_run(fed, fmap):
    with pytest.raises(ValueError, match="bf16"):
        make_model("kitnet", D, feature_map=fmap, precision="bf16",
                   device="cpu")
    with pytest.raises(ValueError, match="feature map"):
        make_model("kitnet", D, device="cpu")
    with pytest.raises(ValueError, match="scaler"):
        engine(fed, fmap, scaler="standard")
    with pytest.raises(ValueError, match="knn"):
        engine(fed, fmap, score_kind="knn")
    from fedmse_tpu_torch.chaos import ChaosSpec
    model = make_model("kitnet", D, feature_map=fmap, device="cpu")
    with pytest.raises(ValueError, match="chaos"):
        RoundEngine(model, cfg(), fed, n_real=N, rngs=ExperimentRngs(run=0),
                    model_type="kitnet", update_type="fedprox", fused=True,
                    chaos=ChaosSpec(dropout_p=0.2))
    with pytest.raises(ValueError, match="tiered"):
        run_combination(cfg(state_layout="tiered"), fed, N, "kitnet",
                        "fedprox", run=0)
