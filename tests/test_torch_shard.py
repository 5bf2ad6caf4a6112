"""The port's client mesh, its codec and its merges (fedmse_tpu_torch/
parallel/), against the JAX package's (tests/test_shard_native.py and
tests/test_clustermerge.py are the counterparts).

The JAX side runs here, on the conftest's 8 virtual CPU devices
(`client_mesh(W)`); the port's side in W gloo ranks on the CPU that import
no jax (tests/torch_mesh_jobs.py, one launch per world size per session:
tests/torch_mesh_common.py). Held:

  * the int8 codec: the JAX package's codes and scales bit for bit, the
    round trip within `quantization_error_bound`;
  * the pure arithmetic (host groups, client rows, tier blocks, the
    merge's byte formulas) equal to the JAX package's;
  * the merges at W = 2 and 4 from one set of stacked params: every rank
    the same bits; shard_map within 1e-6 (scale-normalized) of the port's
    dense merge and of the JAX shard_map merge, its weights the dense
    merge's bits; quantized within its codec bound, and with one group the
    shard_map merge bit for bit; the clustered twins likewise, K = 1 the
    flat merge's bits and an empty cluster inert; the divergence within
    1e-6 of the dense value;
  * the sharded round per backend (final AUC within 2e-3 of 'einsum', the
    backend recorded in every result) and the engine's rules on a mesh
    (compact off, unknown backends refused, a one-rank mesh degrades).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_jobs as jobs
from torch_mesh_common import assert_tree_equal, close, rank_session
from fedmse_tpu.cluster.merge import \
    make_clustered_aggregate_fn as jax_clustered_fn
from fedmse_tpu.federation.state import \
    tree_client_divergence as jax_divergence
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.parallel import client_mesh as jax_client_mesh
from fedmse_tpu.parallel import host_groups as jax_host_groups
from fedmse_tpu.parallel import make_shardmap_aggregate as jax_shardmap
from fedmse_tpu.parallel import shard_clients as jax_shard_clients
from fedmse_tpu.parallel.costmodel import merge_profile as jax_profile
from fedmse_tpu.parallel.quantize import (
    clustered_quantization_error_bound as jax_cbound,
    quantization_error_bound as jax_bound, quantize_blockwise as jax_qb,
    quantize_blockwise_k as jax_qbk)
from fedmse_tpu_torch.cluster.merge import make_clustered_aggregate_fn
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data import stack_clients
from fedmse_tpu_torch.data.stacking import pad_federated_data, stack_dims
from fedmse_tpu_torch.federation import RoundEngine, init_client_states
from fedmse_tpu_torch.federation.aggregation import make_aggregate_fn
from fedmse_tpu_torch.federation.state import tree_client_divergence
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.parallel import (ClientMesh, host_groups,
                                       process_client_rows,
                                       process_tier_blocks, shard_federation)
from fedmse_tpu_torch.parallel.costmodel import merge_profile
from fedmse_tpu_torch.parallel.quantize import (
    clustered_quantization_error_bound, dequantize_blockwise,
    dequantize_sum_k, quantization_error_bound, quantize_blockwise,
    quantize_blockwise_k)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(1)

WORLDS = (2, 4)
UPDATES = ("avg", "mse_avg")
DIMS = jobs.DIMS


@pytest.fixture(scope="session")
def sessions(tmp_path_factory):
    return {w: rank_session(tmp_path_factory, w) for w in WORLDS}


def _ranks(sessions, w):
    return sessions[w][0]


def _model():
    return make_model("hybrid", *DIMS, 3.0, device="cpu")


def _jax_model():
    return jax_make_model("hybrid", *DIMS, 3.0)


def _tree_np(flat):
    return jax.tree.map(np.asarray, jobs.LAYOUT.tree(torch.from_numpy(flat)))


def _dense(update_type, n=8):
    params, sel, dev, cluster = jobs.merge_inputs(n)
    fn = make_aggregate_fn(_model(), update_type)
    m, w = fn(torch.from_numpy(params), torch.from_numpy(sel),
              torch.from_numpy(dev))
    return m.numpy(), w.numpy()


def _gathered_weights(ranks, key):
    return np.concatenate([r["merges"][key][1] for r in ranks])


def _flat_jax(tree, stacked=False):
    """A JAX param tree as flat numpy: [P] of one model, [K, P] stacked."""
    flat = jobs.LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)).reshape(
            (-1,) + tuple(np.shape(t)[1 if stacked else 0:])), tree)).numpy()
    return flat if stacked else flat[0]


def _fake_mesh(world, rank):
    """A mesh's arithmetic without a process group (placement only)."""
    return ClientMesh(world, rank, torch.device("cpu"), "gloo")


# ---- the codec ---- #

def test_quantize_roundtrip_error_bound(rng):
    x = (rng.normal(size=(3, 700)) * rng.uniform(0.01, 10, (3, 1))).astype(
        np.float32)
    for block in (64, 256):
        q, s = quantize_blockwise(torch.from_numpy(x), block)
        jq, js = jax_qb(jnp.asarray(x), block)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = dequantize_blockwise(q, s, x.shape).numpy()
        bound = quantization_error_bound(x, block)
        assert bound == jax_bound(x, block)
        assert np.abs(back - x).max() <= bound + 1e-7


def test_quantize_zero_block_is_exact():
    x = np.zeros(512, np.float32)
    x[300:] = np.linspace(-1, 1, 212, dtype=np.float32)
    q, s = quantize_blockwise(torch.from_numpy(x), 256)
    jq, js = jax_qb(jnp.asarray(x), 256)
    assert float(s[0]) == 1.0 and not q[0].any()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_blockwise(q, s, x.shape).numpy()[:256], 0.0)


def test_codec_k1_degenerates_to_blockwise(rng):
    x = rng.normal(size=(1, 37, 9)).astype(np.float32)
    qk, sk = quantize_blockwise_k(torch.from_numpy(x), 64)
    q, s = quantize_blockwise(torch.from_numpy(x[0]), 64)
    np.testing.assert_array_equal(qk[0].numpy(), q.numpy())
    np.testing.assert_array_equal(sk[0].numpy(), s.numpy())
    jq, js = jax_qbk(jnp.asarray(x), 64)
    np.testing.assert_array_equal(qk.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(js))


def test_codec_k_roundtrip_within_per_row_bound(rng):
    x = (rng.normal(size=(3, 50, 7)) * np.array([1e-3, 1.0, 50.0])[:, None,
                                                                    None]
         ).astype(np.float32)
    q, s = quantize_blockwise_k(torch.from_numpy(x), 64)
    back = dequantize_sum_k(q[None], s[None], x.shape).numpy()
    bound = clustered_quantization_error_bound(x, 64)
    np.testing.assert_array_equal(bound, jax_cbound(x, 64))
    for k in range(3):
        assert np.abs(back[k] - x[k]).max() <= bound[k] + 1e-9


# ---- the pure arithmetic ---- #

def test_host_groups_topologies(mesh8):
    for g in (1, 2, 4, 8):
        assert host_groups(_fake_mesh(8, 0), g) == jax_host_groups(mesh8, g)
    # the real topology: one group per host
    assert host_groups(_fake_mesh(8, 0), 0) == jax_host_groups(mesh8, 0)
    two_hosts = ClientMesh(4, 0, torch.device("cpu"), "gloo",
                           hosts=["a", "a", "b", "b"])
    assert host_groups(two_hosts, 0) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="divide"):
        host_groups(_fake_mesh(8, 0), 3)
    uneven = ClientMesh(3, 0, torch.device("cpu"), "gloo",
                        hosts=["a", "a", "b"])
    with pytest.raises(ValueError, match="equal-sized"):
        host_groups(uneven, 0)


def test_process_client_rows_single_process(mesh8):
    from fedmse_tpu.parallel import process_client_rows as jax_rows
    from fedmse_tpu.parallel import process_tier_blocks as jax_blocks
    assert process_client_rows(16, 1, 0) == jax_rows(16, mesh8)
    assert [process_client_rows(16, 8, r) for r in range(8)] == [
        (2 * r, 2 * r + 2) for r in range(8)]
    assert process_tier_blocks(11, 1) == jax_blocks(11, mesh8)
    assert process_tier_blocks(11, 3) == [(0, 4), (4, 8), (8, 11)]
    with pytest.raises(ValueError, match="multiple"):
        process_client_rows(10, 4, 0)
    with pytest.raises(ValueError, match="cannot shard"):
        process_tier_blocks(2, 3)


def test_merge_profile_formulas():
    for kw in (dict(backend="shard_map", elem_counts=[1000, 37], k=1,
                    n_devices=8, n_groups=2),
               dict(backend="quantized", elem_counts=[6764], k=3,
                    n_devices=8, n_groups=2, per_group=4, block_size=256),
               dict(backend="quantized", elem_counts=[10, 300], k=1,
                    n_devices=4, n_groups=4, per_group=1, block_size=64),
               dict(backend="einsum", elem_counts=[5], k=2, n_devices=2)):
        assert merge_profile(**kw) == jax_profile(**kw)


# ---- the merges across ranks ---- #

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("update_type", UPDATES)
def test_shardmap_merge_bitwise_einsum(sessions, world, update_type,
                                       mesh8):
    """Every rank merges the same bits; the weights are the dense merge's
    bits (normalized by its own ops), the merge within 1e-6 of the dense
    one and of the JAX shard_map merge on client_mesh(W)."""
    ranks = _ranks(sessions, world)
    key = f"shard_map/{update_type}"
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["merges"][key][0],
                                      ranks[0]["merges"][key][0])
    merged = ranks[0]["merges"][key][0]
    dense_m, dense_w = _dense(update_type)
    np.testing.assert_array_equal(_gathered_weights(ranks, key), dense_w)
    close(merged, dense_m, 1e-6)
    params, sel, dev, _ = jobs.merge_inputs(8)
    mesh = jax_client_mesh(world)
    jm, jw = jax_shardmap(_jax_model(), update_type, mesh)(
        jax_shard_clients(_tree_np(params), mesh),
        jax_shard_clients(jnp.asarray(sel), mesh), jnp.asarray(dev))
    close(merged, _flat_jax(jm), 1e-6)
    close(_gathered_weights(ranks, key), np.asarray(jw), 1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("update_type", UPDATES)
def test_quantized_merge_within_bound(sessions, world, update_type):
    """Two groups: within the sum over groups of each group partial's
    codec bound of the exact merge; the weights stay exact."""
    ranks = _ranks(sessions, world)
    exact = ranks[0]["merges"][f"shard_map/{update_type}"][0]
    q = ranks[0]["merges"][f"quantized2/{update_type}"][0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(
            r["merges"][f"quantized2/{update_type}"][0], q)
    w = _gathered_weights(ranks, f"quantized2/{update_type}")
    np.testing.assert_array_equal(
        w, _gathered_weights(ranks, f"shard_map/{update_type}"))
    params = jobs.merge_inputs(8)[0]
    half = len(params) // 2
    bound = sum(quantization_error_bound(
        w[g * half:(g + 1) * half] @ params[g * half:(g + 1) * half],
        jobs.BLOCK) for g in range(2))
    assert 0 < np.abs(q - exact).max() <= bound + 1e-7


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_single_group_is_exact_shardmap(sessions, world):
    for r in _ranks(sessions, world):
        for ut in UPDATES:
            np.testing.assert_array_equal(r["merges"][f"quantized1/{ut}"],
                                          r["merges"][f"shard_map/{ut}"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_shardmap_divergence_matches_dense(sessions, world):
    params = jobs.merge_inputs(8)[0]
    mask = (np.arange(8) < 6).astype(np.float32)
    dense = tree_client_divergence(torch.from_numpy(params),
                                   torch.from_numpy(mask)).numpy()
    got = np.concatenate([r["merges"]["divergence"]
                          for r in _ranks(sessions, world)])
    close(got, dense, 1e-6)
    want = np.asarray(jax_divergence(_tree_np(params), jnp.asarray(mask)))
    close(got, want, 1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("update_type", UPDATES)
def test_clustered_shardmap_bitwise_einsum(sessions, world, update_type):
    """K = 3: the cluster rows within 1e-6 of the dense clustered merge and
    of the JAX one, the weights and has_update their bits."""
    ranks = _ranks(sessions, world)
    key = f"cshard_map3/{update_type}"
    cp, _, has = ranks[0]["merges"][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["merges"][key][0], cp)
    params, sel, dev, cluster = jobs.merge_inputs(8)
    dcp, dw, dhas = make_clustered_aggregate_fn(_model(), update_type, 3)(
        torch.from_numpy(params), torch.from_numpy(sel),
        torch.from_numpy(dev), torch.from_numpy(cluster))
    close(cp, dcp.numpy(), 1e-6)
    np.testing.assert_array_equal(
        np.concatenate([r["merges"][key][1] for r in ranks]), dw.numpy())
    np.testing.assert_array_equal(has, dhas.numpy())
    jcp, jw, jhas = jax_clustered_fn(_jax_model(), update_type, 3)(
        _tree_np(params), jnp.asarray(sel), jnp.asarray(dev),
        jnp.asarray(cluster, jnp.int32))
    close(cp, _flat_jax(jcp, stacked=True), 1e-6)
    np.testing.assert_array_equal(has, np.asarray(jhas))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("update_type", UPDATES)
def test_k1_clustered_pins_bitwise_to_single_global(sessions, world,
                                                    update_type):
    for r in _ranks(sessions, world):
        m = r["merges"]
        cp, w, has = m[f"cshard_map1/{update_type}"]
        np.testing.assert_array_equal(cp[0],
                                      m[f"shard_map/{update_type}"][0])
        np.testing.assert_array_equal(w, m[f"shard_map/{update_type}"][1])
        assert has.tolist() == [True]
        qcp = m[f"cquantized1k/{update_type}"][0]
        np.testing.assert_array_equal(qcp[0],
                                      m[f"quantized2/{update_type}"][0])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("update_type", UPDATES)
def test_clustered_quantized_within_bound_from_host_partials(
        sessions, world, update_type):
    ranks = _ranks(sessions, world)
    exact = ranks[0]["merges"][f"cshard_map3/{update_type}"][0]
    q, w, has = ranks[0]["merges"][f"cquantized2/{update_type}"]
    np.testing.assert_array_equal(
        has, ranks[0]["merges"][f"cshard_map3/{update_type}"][2])
    params, _, _, cluster = jobs.merge_inputs(8)
    w_all = np.concatenate([r["merges"][f"cquantized2/{update_type}"][1]
                            for r in ranks])
    sheet = (cluster[None, :] == np.arange(3)[:, None]) * w_all[None, :]
    half = len(params) // 2
    bound = sum(clustered_quantization_error_bound(
        sheet[:, g * half:(g + 1) * half] @ params[g * half:(g + 1) * half],
        jobs.BLOCK) for g in range(2))
    for k in range(3):
        assert np.abs(q[k] - exact[k]).max() <= bound[k] + 1e-7


@pytest.mark.parametrize("world", WORLDS)
def test_empty_cluster_rows_inert(sessions, world):
    for r in _ranks(sessions, world):
        for ut in UPDATES:
            for name in ("cshard_map3", "cquantized2"):
                cp, _, has = r["merges"][f"{name}/{ut}"]
                assert has.tolist() == [True, True, False]
                assert not cp[2].any()


def test_seam_records_clustered_quantized_profile(sessions):
    prof = _ranks(sessions, 2)[0]["merges"]["seam/mse_avg"][
        "merge_profiles"]["quantized"]
    assert prof == jax_profile(backend="quantized",
                               elem_counts=[jobs.LAYOUT.size], k=3,
                               n_devices=2, n_groups=2, per_group=1,
                               block_size=jobs.BLOCK)


def test_sharded_adam_update_bitwise_vs_replicated(sessions):
    for r in _ranks(sessions, 2):
        lo, hi = r["adam"]["block"]
        for full, mine in zip(r["adam"]["full"], r["adam"]["mine"]):
            np.testing.assert_array_equal(full[lo:hi], mine)


# ---- placement ---- #

def _federation():
    return jobs.federation(6, pad_to=8)


def test_hostlocal_slices_tile_full_stack():
    """stack_clients(client_range=) stacks the rows a rank owns, bit for bit
    the rank's block that shard_federation cuts from the full stack."""
    _, clients, dev_x = jobs.federation_clients(6)
    full = stack_clients(clients, dev_x, 12, pad_clients_to=8, device="cpu")
    dims = stack_dims(clients, 12, pad_clients_to=8)
    for rank in range(4):
        mesh = _fake_mesh(4, rank)
        part = stack_clients(clients, dev_x, 12, client_range=mesh.block(8),
                             dims=dims, device="cpu")
        block, _ = shard_federation(full, None, mesh)
        for name in ("train_xb", "valid_x", "test_y", "client_mask"):
            assert torch.equal(getattr(part, name), getattr(block, name))
        assert torch.equal(block.dev_x, full.dev_x)


def test_shard_federation_host_local_single_process():
    data = _federation()
    states = init_client_states(_model(), 8, torch.Generator(), device="cpu")
    d1, s1 = shard_federation(data, states, ClientMesh())
    assert torch.equal(d1.train_xb, data.train_xb)
    assert torch.equal(s1.params, states.params)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        shard_federation(jobs.federation(6), None, _fake_mesh(4, 0))


def test_pad_federated_data():
    data = jobs.federation(6)
    grown = pad_federated_data(data, 8)
    assert grown.client_mask.tolist() == [1] * 6 + [0, 0]
    assert not grown.train_mb[6:].any() and not grown.test_m[6:].any()
    assert torch.equal(grown.train_xb[:6], data.train_xb)


def test_init_client_states_mesh_layout():
    """A sharded engine's init is its rank's block of the dense init, bit
    for bit (every rank draws the whole fleet and keeps its block)."""
    cfg = jobs.config()
    dense = RoundEngine(_model(), cfg, jobs.federation(10, 12), n_real=10,
                        rngs=ExperimentRngs(run=0), model_type="hybrid",
                        update_type="mse_avg", fused=True)
    for rank in range(4):
        eng = RoundEngine(_model(), cfg, jobs.federation(10, 12), n_real=10,
                          rngs=ExperimentRngs(run=0), model_type="hybrid",
                          update_type="mse_avg", fused=True,
                          mesh=_fake_mesh(4, rank))
        lo, hi = eng.mesh.block(12)
        for a, b in zip(eng.states.tensors(), dense.states.tensors()):
            assert torch.equal(a, b[lo:hi])
        assert eng.data.train_xb.shape[0] == 3 and not eng.compact


# ---- the sharded round per backend ---- #

@pytest.mark.parametrize("world", WORLDS)
def test_full_round_per_backend_quality(sessions, world):
    """A round per backend on the sharded mesh (the JAX test's bar): the
    same aggregator; 'shard_map' is 'einsum''s program, bit for bit; the
    quantized backend's round metrics within 2e-3 of 'einsum''s."""
    rounds = _ranks(sessions, world)[0]["rounds"]
    first = {name: run["results"][0] for name, run in rounds.items()}
    for name, res in first.items():
        assert np.all(np.isfinite(res["client_metrics"])), name
        assert res["aggregator"] == first["einsum"]["aggregator"], name
    np.testing.assert_array_equal(first["einsum"]["client_metrics"],
                                  first["shard_map"]["client_metrics"])
    np.testing.assert_allclose(first["quantized"]["client_metrics"],
                               first["einsum"]["client_metrics"], atol=2e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_on_mesh_backend_recorded_in_result(sessions, world):
    rounds = _ranks(sessions, world)[0]["rounds"]
    for name in ("einsum", "shard_map", "quantized"):
        assert {r["backend"] for r in rounds[name]["results"]} == {name}


@pytest.mark.parametrize("world", WORLDS)
def test_auto_backend_resolves_via_plan(sessions, world):
    auto = _ranks(sessions, world)[0]["rounds"]["auto"]
    assert auto["plan"]["backend"] in ("shard_map", "quantized")
    assert {r["backend"] for r in auto["results"]} == {auto["plan"][
        "backend"]}
    # every rank adopted rank 0's plan
    for r in _ranks(sessions, world):
        assert r["rounds"]["auto"]["plan"] == auto["plan"]


@pytest.mark.parametrize("world", WORLDS)
def test_second_auto_engine_takes_rank0_cached_plan(sessions, world):
    """A second 'auto' engine in the same rank processes hits rank 0's
    cached plan (kept in memory: the cache is not writable there) and
    every rank takes that hit with it: the same plan, no rank left in the
    planner's gathers, every rank's results the same bits."""
    ranks = _ranks(sessions, world)
    first = ranks[0]["rounds"]["auto"]
    assert first["plan_cached"] is False
    again = ranks[0]["auto_again"]
    assert again["plan_cached"] is True and again["plan"] == first["plan"]
    assert {r["backend"] for r in again["results"]} == {first["plan"][
        "backend"]}
    for r in ranks[1:]:
        assert_tree_equal(r["auto_again"], again)


def test_compact_reevaluated_after_resharding(sessions):
    for w in WORLDS:
        for run in _ranks(sessions, w)[0]["rounds"].values():
            assert run["compact"] is False
    plain = RoundEngine(_model(), jobs.config(), jobs.federation(), 10,
                        ExperimentRngs(run=0), "hybrid", "mse_avg",
                        fused=True, mesh=ClientMesh())
    assert plain.compact is True


def test_auto_pad_in_run_combination(sessions):
    """10 clients on 4 ranks run padded to 12: two zero-weight pad clients,
    never selected, aggregating or reported."""
    run = _ranks(sessions, 4)[0]["rounds"]["einsum"]
    assert run["params"].shape[0] == 12
    for r in run["results"]:
        assert r["client_metrics"].shape == (10,)
        assert max(r["selected"]) < 10
        assert not np.asarray(r["agg_weights"])[10:].any()


def _pkg_warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if "inert" in r.getMessage()]


def test_backend_inert_off_mesh(caplog):
    """A one-rank mesh leaves the axis unsharded: 'quantized' degrades to
    'einsum' with one warning, and the run is the plain run's bits."""
    caplog.set_level(logging.WARNING)
    cfg = jobs.config(aggregation_backend="quantized")
    one = jobs.run_engine(ClientMesh(), cfg)
    assert len(_pkg_warnings(caplog)) == 1
    plain = jobs.run_engine(None, jobs.config())
    assert {r["backend"] for r in one["results"]} == {"einsum"}
    for a, b in zip(one["results"], plain["results"]):
        a = {k: v for k, v in a.items() if k != "backend"}
        b = {k: v for k, v in b.items() if k != "backend"}
        assert_tree_equal(a, b)
    np.testing.assert_array_equal(one["params"], plain["params"])


def test_off_mesh_degrade_warns_and_records(caplog):
    caplog.set_level(logging.WARNING)
    out = jobs.run_engine(None, jobs.config(aggregation_backend="shard_map"),
                          rounds=2)
    assert {r["backend"] for r in out["results"]} == {"einsum"}
    assert len(_pkg_warnings(caplog)) == 1


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="aggregation_backend"):
        RoundEngine(_model(), ExperimentConfig(aggregation_backend="psum"),
                    jobs.federation(), 10, ExperimentRngs(run=0), "hybrid",
                    "mse_avg", fused=True)
    with pytest.raises(ValueError, match="fused round"):
        RoundEngine(_model(), jobs.config(), jobs.federation(10, 12), 10,
                    ExperimentRngs(run=0), "hybrid", "mse_avg",
                    fused=False, mesh=_fake_mesh(4, 0))
