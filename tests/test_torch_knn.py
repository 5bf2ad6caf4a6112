"""The port's kNN scorer (fedmse_tpu_torch/knn, the evaluator's 'knn' score)
against the JAX package: distance tiles, top-k, routed scoring, the bank
lifecycle and per-client evaluation, on the same numpy-seeded inputs.

Tolerances: distance tiles scale-normalized 1e-5 (f32 math in both, bf16
queries exact in f32; summation order only); k-th distances rtol 1e-4,
atol 1e-5 (the JAX package's own, tests/test_knn.py); AUC within 2e-3.
The port draws bank priorities from its own CPU generator (knn/bank.py),
so bank-level parity with JAX is held where the draw cannot matter (every
valid row fits the bank) or on a bank JAX built.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.data import stack_clients as jax_stack_clients
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.evaluation import make_evaluate_all as jax_evaluate_all
from fedmse_tpu.knn import ReferenceBank as JaxBank
from fedmse_tpu.knn import build_banks as jax_build_banks
from fedmse_tpu.knn import downsample_latents as jax_downsample
from fedmse_tpu.knn import knn_kth_distance as jax_kth
from fedmse_tpu.knn import knn_smallest_k as jax_smallest
from fedmse_tpu.knn import load_bank as jax_load_bank
from fedmse_tpu.knn import routed_kth_distance as jax_routed
from fedmse_tpu.knn import save_bank as jax_save_bank
from fedmse_tpu.knn.score import dist_tiles as jax_dist_tiles
from fedmse_tpu.models import init_stacked_params as jax_init_params
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.ops.distance import pairwise_sq_dists as jax_pairwise
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.knn import (ReferenceBank, build_banks, dist_tiles,
                                  downsample_latents, knn_kth_distance,
                                  knn_smallest_k, load_bank, pow2_bank_size,
                                  routed_kth_distance, save_bank)
from fedmse_tpu_torch.knn.bank import bank_generator, encode_rows
from fedmse_tpu_torch.knn.score import dist_tiles_plain
from fedmse_tpu_torch.models import make_model, params_from_numpy

torch.set_num_threads(1)

DIM, N, BATCH, L = 12, 3, 12, 7


def scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 and back (f32 numpy)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ----------------------------- distance tiles ----------------------------- #

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("banks", [128, 256, 100])
def test_dist_tiles_match_jax_pallas_interpret_and_xla(dtype, banks):
    rng = np.random.default_rng(banks)
    q = rng.normal(size=(45, L)).astype(np.float32) * 1.5
    b = rng.normal(size=(banks, L)).astype(np.float32)
    if dtype == "bf16":
        q = _bf16_values(q)
    tq = torch.from_numpy(q)
    jq = jnp.asarray(q)
    if dtype == "bf16":
        tq, jq = tq.to(torch.bfloat16), jq.astype(jnp.bfloat16)
    got = dist_tiles(tq, torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (45, banks)
    modes = ("xla",) if banks % 128 else ("xla", "interpret")
    for mode in modes:
        want = np.asarray(jax_dist_tiles(jq, jnp.asarray(b), mode=mode))
        assert scaled_err(got, want) <= 1e-5, mode
    assert dist_tiles.launches == 0  # the CPU runs the plain twin
    from fedmse_tpu_torch.knn import score
    assert score._library.cache_info().currsize == 0  # nothing was built


def test_routed_dist_tiles_match_jax_per_gateway_loop():
    rng = np.random.default_rng(1)
    banks = rng.normal(size=(4, 40, L)).astype(np.float32)
    q = rng.normal(size=(33, L)).astype(np.float32)
    gw = rng.integers(0, 4, 33).astype(np.int32)
    got = dist_tiles(torch.from_numpy(q), torch.from_numpy(banks),
                     torch.from_numpy(gw)).numpy()
    want = np.stack([np.asarray(jax_pairwise(jnp.asarray(q[i:i + 1]),
                                             jnp.asarray(banks[gw[i]])))[0]
                     for i in range(33)])
    assert scaled_err(got, want) <= 1e-5
    # gw=None is bank 0 for every row; a row outside [0, N) gets NaN
    np.testing.assert_array_equal(
        dist_tiles(torch.from_numpy(q), torch.from_numpy(banks)).numpy(),
        dist_tiles(torch.from_numpy(q), torch.from_numpy(banks),
                   torch.zeros(33, dtype=torch.int32)).numpy())
    bad = torch.from_numpy(gw).clone()
    bad[[0, 5]] = torch.tensor([-1, 4], dtype=torch.int32)
    out = dist_tiles_plain(torch.from_numpy(q), torch.from_numpy(banks), bad)
    assert torch.isnan(out[[0, 5]]).all() and torch.isfinite(out[1]).all()
    with pytest.raises(ValueError, match="int32"):
        dist_tiles(torch.from_numpy(q), torch.from_numpy(banks),
                   torch.from_numpy(gw).long())
    with pytest.raises(ValueError, match="latent_dim"):
        dist_tiles(torch.from_numpy(q[:, :3]), torch.from_numpy(banks))


# --------------------------------- top-k ---------------------------------- #

@pytest.mark.parametrize("topk", ["exact", "approx"])
@pytest.mark.parametrize("bank_size,k,count", [
    (512, 8, 512), (512, 8, 0), (512, 8, 3), (512, 8, 5), (256, 8, 200),
    (4, 8, 4), (16, 8, 10)])
def test_smallest_and_kth_match_jax(topk, bank_size, k, count):
    rng = np.random.default_rng(bank_size + count)
    bank = rng.normal(size=(bank_size, L)).astype(np.float32)
    q = rng.normal(size=(29, L)).astype(np.float32)
    got_s = knn_smallest_k(torch.from_numpy(q), torch.from_numpy(bank),
                           count, k, topk=topk).numpy()
    want_s = np.asarray(jax_smallest(jnp.asarray(q), jnp.asarray(bank),
                                     count, k, topk=topk, dist_mode="xla"))
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=1e-4,
                               atol=1e-5)
    got = knn_kth_distance(torch.from_numpy(q), torch.from_numpy(bank),
                           torch.tensor(count, dtype=torch.int32), k,
                           topk=topk).numpy()
    want = np.asarray(jax_kth(jnp.asarray(q), jnp.asarray(bank), count, k,
                              topk=topk, dist_mode="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if count == 0:
        assert (got == 0).all()


def _jax_bank(latents, count):
    return JaxBank(latents=jnp.asarray(latents), count=jnp.asarray(count))


@pytest.mark.parametrize("topk", ["exact", "approx"])
@pytest.mark.parametrize("n,bank_size", [(3, 512), (600, 16)])
def test_routed_kth_matches_jax_onehot_and_gather_branches(topk, n,
                                                           bank_size):
    """N * L = 21 takes JAX's one-hot branch, 4200 (> 4096) its gather
    branch; the port's one routed launch matches both. The N = 3 bank is
    one JAX built; the N = 600 bank is random with ragged counts."""
    rng = np.random.default_rng(n)
    if n == 3:
        jm = jax_make_model("hybrid", DIM, shrink_lambda=1.0)
        jp = jax_init_params(jm, jax.random.key(3), n)
        train = rng.normal(size=(n, 700, DIM)).astype(np.float32)
        mask = (rng.random((n, 700)) < 0.9).astype(np.float32)
        mask[2, 4:] = 0.0  # one gateway with 4 valid rows (< k)
        jbank = jax_build_banks(jm, jp, train, mask, bank_size=bank_size)
        latents = np.array(jbank.latents)
        count = np.array(jbank.count)
    else:
        latents = rng.normal(size=(n, bank_size, L)).astype(np.float32)
        count = rng.integers(0, bank_size + 1, n).astype(np.int32)
        latents[np.arange(bank_size)[None, :] >= count[:, None]] = 0.0
        jbank = _jax_bank(latents, count)
    q = rng.normal(size=(64, L)).astype(np.float32)
    gw = rng.integers(0, n, 64).astype(np.int32)
    got = routed_kth_distance(
        torch.from_numpy(q), torch.from_numpy(gw),
        ReferenceBank(torch.from_numpy(latents), torch.from_numpy(count)),
        8, topk=topk).numpy()
    want = np.asarray(jax_routed(jnp.asarray(q), jnp.asarray(gw), jbank, 8,
                                 topk=topk))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------- bank lifecycle ----------------------------- #

def test_downsample_layout_and_multiset_equal_to_jax():
    rng = np.random.default_rng(6)
    lat = rng.normal(size=(300, L)).astype(np.float32)
    mask = (np.arange(300) < 200).astype(np.float32)
    bank, count = downsample_latents(torch.from_numpy(lat),
                                     torch.from_numpy(mask), 128,
                                     bank_generator(0, 0))
    assert int(count) == 128 and bank.shape == (128, L)
    # every slot is a valid row (a sample, not an aggregate)
    d = np.abs(bank.numpy()[:, None, :] - lat[None, :200, :]).sum(-1)
    assert (d.min(axis=1) == 0).all()
    # capacity above the valid rows: valid rows lead, padding is zero, and
    # the bank is JAX's as a multiset of rows (the draw only orders them)
    for rows in (200, 300):
        sub, msub = torch.from_numpy(lat[:rows]), torch.from_numpy(
            mask[:rows])
        bank2, count2 = downsample_latents(sub, msub, 512,
                                           bank_generator(0, 0))
        jb, jc = jax_downsample(jnp.asarray(lat[:rows]),
                                jnp.asarray(mask[:rows]), 512,
                                jax.random.key(1))
        assert int(count2) == int(jc) == 200
        assert np.abs(bank2.numpy()[200:]).max() == 0.0
        a, b = bank2.numpy()[:200], np.asarray(jb)[:200]
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
        np.testing.assert_array_equal(
            np.sort(a, axis=0), np.sort(lat[:200], axis=0))
    # reproducible per generator seed, different across seeds
    again, _ = downsample_latents(torch.from_numpy(lat),
                                  torch.from_numpy(mask), 128,
                                  bank_generator(0, 0))
    other, _ = downsample_latents(torch.from_numpy(lat),
                                  torch.from_numpy(mask), 128,
                                  bank_generator(0, 1))
    torch.testing.assert_close(bank, again, rtol=0, atol=0)
    assert not torch.equal(bank, other)
    assert pow2_bank_size(100) == 128 and pow2_bank_size(128) == 128
    with pytest.raises(ValueError, match="bank_size"):
        pow2_bank_size(0)


def _model_and_params(model_type="hybrid", n=N, seed=0):
    jm = jax_make_model(model_type, DIM, shrink_lambda=1.0)
    params = jax.tree.map(np.asarray,
                          jax_init_params(jm, jax.random.key(seed), n))
    model = make_model(model_type, DIM, shrink_lambda=1.0, device="cpu")
    return jm, params, model, params_from_numpy(params, device="cpu")


def test_build_banks_padding_invariant_and_persistence(tmp_path):
    _, params, model, tparams = _model_and_params(n=N + 3)
    rng = np.random.default_rng(2)
    train = rng.normal(size=(N + 3, 6, 10, DIM)).astype(np.float32)
    mask = (rng.random((N + 3, 6, 10)) < 0.8).astype(np.float32)
    mask[N:] = 0.0
    first = {c: {k: {leaf: v[:N] for leaf, v in layer.items()}
                 for k, layer in coder.items()} for c, coder in tparams.items()}
    b1 = build_banks(model, first, train[:N], mask[:N], bank_size=32)
    b2 = build_banks(model, tparams, train, mask, bank_size=32)
    torch.testing.assert_close(b1.latents, b2.latents[:N], rtol=0, atol=0)
    torch.testing.assert_close(b1.count, b2.count[:N], rtol=0, atol=0)
    assert b2.count[N:].tolist() == [0, 0, 0]
    assert (b1.num_gateways, b1.bank_size, b1.latent_dim) == (N, 32, L)
    # own round trip, and each package reads the other's file
    path = save_bank(str(tmp_path / "port.npz"), b1)
    back = load_bank(path, device="cpu")
    torch.testing.assert_close(back.latents, b1.latents, rtol=0, atol=0)
    torch.testing.assert_close(back.count, b1.count, rtol=0, atol=0)
    jback = jax_load_bank(path)
    np.testing.assert_array_equal(np.asarray(jback.latents),
                                  b1.latents.numpy())
    np.testing.assert_array_equal(np.asarray(jback.count), b1.count.numpy())
    jpath = jax_save_bank(str(tmp_path / "jax.npz"), jback)
    again = load_bank(jpath, device="cpu")
    torch.testing.assert_close(again.latents, b1.latents, rtol=0, atol=0)
    assert again.count.dtype == torch.int32


def test_build_banks_equals_evaluator_in_program_bank():
    """The persisted bank is the evaluator's: scoring the test latents
    against build_banks' bank reproduces the evaluator's kNN scores, with
    more train rows than the bank holds (so the draw decides the bank)."""
    _, _, model, tparams = _model_and_params()
    rng = np.random.default_rng(4)
    test_x = torch.from_numpy(rng.normal(size=(N, 20, DIM)).astype(
        np.float32))
    train = torch.from_numpy(rng.normal(size=(N, 5, 12, DIM)).astype(
        np.float32))
    train_m = torch.from_numpy((rng.random((N, 5, 12)) < 0.9).astype(
        np.float32))
    for topk in ("exact", "approx"):
        oracle = make_evaluate_all(
            model, "hybrid", metric="scores", score_kind="knn",
            knn_bank_size=16, knn_k=4, knn_topk=topk, knn_seed=5)(
                tparams, test_x, torch.ones((N, 20)), torch.zeros((N, 20)),
                train, train_m)
        bank = build_banks(model, tparams, train, train_m, bank_size=16,
                           seed=5)
        lat = encode_rows(model, tparams, test_x).reshape(N * 20, -1)
        want = routed_kth_distance(lat, client_index(N, 20, "cpu"), bank, 4,
                                   topk=topk).view(N, 20)
        torch.testing.assert_close(oracle, want, rtol=0, atol=0)


def test_existing_refresh_draws_only_from_valid_slots():
    _, _, model, tparams = _model_and_params()
    rng = np.random.default_rng(8)
    new_x = rng.normal(size=(N, 30, DIM)).astype(np.float32)
    new_m = (rng.random((N, 30)) < 0.7).astype(np.float32)
    new_m[1] = 0.0  # gateway 1 brings no valid new rows
    old_lat = np.full((N, 16, L), 1e6, np.float32)  # padding sentinel
    old_cnt = np.array([5, 16, 0], np.int32)
    for g in range(N):
        old_lat[g, :old_cnt[g]] = rng.normal(size=(old_cnt[g], L))
    existing = ReferenceBank(torch.from_numpy(old_lat),
                             torch.from_numpy(old_cnt))
    fresh = build_banks(model, tparams, new_x, new_m, existing=existing,
                        seed=3)
    assert fresh.bank_size == 16
    enc = encode_rows(model, tparams, torch.from_numpy(new_x)).numpy()
    for g in range(N):
        pool = np.concatenate([old_lat[g, :old_cnt[g]],
                               enc[g][new_m[g] > 0]])
        c = int(fresh.count[g])
        assert c == min(len(pool), 16)
        rows = fresh.latents[g].numpy()
        assert np.abs(rows[c:]).max(initial=0.0) == 0.0
        for r in rows[:c]:  # every kept slot comes from the valid pool
            assert np.abs(pool - r).sum(axis=1).min() == 0.0
    # gateway 1 keeps its full old bank (no valid new rows to draw)
    np.testing.assert_array_equal(np.sort(fresh.latents[1].numpy(), axis=0),
                                  np.sort(old_lat[1], axis=0))
    with pytest.raises(ValueError, match="gateways"):
        build_banks(model, tparams, new_x[:2], existing=existing)


# ------------------------- evaluator vs the JAX one ------------------------- #

def _clients(mod):
    return mod(n_clients=N, dim=DIM, n_normal=100, n_abnormal=40, seed=3)


@pytest.fixture(scope="module")
def fed():
    dev_x = np.zeros((4, DIM), np.float32)
    data = stack_clients(_clients(synthetic_clients), dev_x, BATCH,
                         device="cpu")
    jdata = jax_stack_clients(_clients(jax_synthetic), dev_x, BATCH)
    return data, jdata


@pytest.mark.parametrize("topk", ["exact", "approx"])
@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
def test_knn_evaluator_matches_jax(model_type, topk, fed):
    """At most 200 train rows per gateway and a 256-slot bank: every valid
    row is in the bank and each slot is its own approximate bin, so the
    draw cannot change either result."""
    data, jdata = fed
    assert data.train_xb.shape[1] * data.train_xb.shape[2] <= 200
    jm, params, model, tparams = _model_and_params(model_type, seed=7)
    kw = dict(score_kind="knn", knn_bank_size=256, knn_k=8, knn_topk=topk)
    args = (data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb)
    jargs = tuple(np.asarray(t) for t in (jdata.test_x, jdata.test_m,
                                          jdata.test_y, jdata.train_xb,
                                          jdata.train_mb))
    scores = make_evaluate_all(model, model_type, metric="scores", **kw)(
        tparams, *args)
    want = jax_evaluate_all(jm, model_type, metric="scores", **kw)(
        params, *jargs)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    auc = make_evaluate_all(model, model_type, **kw)(tparams, *args)
    jauc = jax_evaluate_all(jm, model_type, **kw)(params, *jargs)
    assert np.isfinite(auc.numpy()).all()
    np.testing.assert_allclose(auc.numpy(), np.asarray(jauc), atol=2e-3)


def test_knn_latency_metric_scores_each_client(fed):
    data, _ = fed
    _, _, model, tparams = _model_and_params()
    lat = make_evaluate_all(model, "hybrid", metric="time", score_kind="knn",
                            knn_bank_size=64, latency_reps=1)(
        tparams, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb)
    assert lat.shape == (N,) and (lat > 0).all()


def test_knn_latency_block_draws_its_clients_banks(fed, monkeypatch):
    """On a block of clients [lo, hi) (a rank's), the latency metric scores
    client i on the bank drawn for client lo + i, whether the block's
    first id or the fleet's priorities' rows are given."""
    from fedmse_tpu_torch.evaluation import evaluator
    from fedmse_tpu_torch.knn.bank import bank_priorities
    data, _ = fed
    _, _, model, tparams = _model_and_params()
    lo, hi = 1, N
    rows = data.train_xb.shape[1] * data.train_xb.shape[2]
    want = bank_priorities(0, N, rows)
    seen = []
    draw = evaluator.downsample_stacked

    def record(latent, valid, priority, bank_size):
        seen.append(priority)
        return draw(latent, valid, priority, bank_size)

    monkeypatch.setattr(evaluator, "downsample_stacked", record)
    lat = make_evaluate_all(model, "hybrid", metric="time", score_kind="knn",
                            knn_bank_size=16, latency_reps=1)
    block = {c: {k: {leaf: v[lo:hi] for leaf, v in layer.items()}
                 for k, layer in coder.items()}
             for c, coder in tparams.items()}
    args = (data.test_x[lo:hi], data.test_m[lo:hi], data.test_y[lo:hi],
            data.train_xb[lo:hi], data.train_mb[lo:hi])
    for kw in ({"first": lo}, {"priorities": want[lo:hi]}):
        seen.clear()
        out = lat(block, *args, **kw)
        assert out.shape == (hi - lo,) and (out > 0).all()
        # the warm-up (client lo), then one call per client
        for got, i in zip(seen, [lo] + list(range(lo, hi)), strict=True):
            assert torch.equal(got[0], want[i]), (kw, i)
