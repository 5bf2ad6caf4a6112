"""The port's measured autotuner (fedmse_tpu_torch/tune/) against the JAX
package's (fedmse_tpu/tune/): the cache's exact-signature rule, a stale
signature that re-measures, the FEDMSE_TUNE write gate, a corrupt file
read as empty, the argmin with its table, the ladder helpers (equal to
the JAX package's for every max_bucket in 1..4096), the serving engine's
explicit and tuned ladders (the same scores as pow2), the tier chunk read
by the tiered engine (the dense init's bits whatever the chunk), and the
file format shared both ways: the port reads what the JAX package's
TuningCache wrote, and neither package's entries match the other's
lookups.
"""

import json

import numpy as np
import pytest
import torch

from fedmse_tpu.tune import TuningCache as JaxCache
from fedmse_tpu.tune import sites as jax_sites
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import init_client_states
from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
from fedmse_tpu_torch.models import init_stacked_params, make_model
from fedmse_tpu_torch.serving import ServingEngine
from fedmse_tpu_torch.tune import TuningCache, measure_candidates, sites
from fedmse_tpu_torch.tune.cache import default_cache
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

pytestmark = pytest.mark.tune

torch.set_num_threads(1)

DIM = 115


@pytest.fixture(autouse=True)
def private_cache(tmp_path, monkeypatch):
    """Every test reads and writes its own cache file, never the tree's."""
    monkeypatch.setenv("FEDMSE_TUNE_CACHE", str(tmp_path / "default.json"))
    monkeypatch.delenv("FEDMSE_TUNE", raising=False)


# ------------------------------ cache ------------------------------------ #

def test_cache_roundtrip_exact_signature(tmp_path):
    path = tmp_path / "tc.json"
    c = TuningCache(path, writable=True)
    sig = {"backend": "cuda", "probe": 8, "candidates": [1, 2]}
    c.store("site", sig, 42, wall_s=0.5)
    assert c.lookup("site", sig)["choice"] == 42
    # equality is over the JSON image: key order and tuple vs list do not
    # matter, any value drift does
    reordered = {"candidates": (1, 2), "probe": 8, "backend": "cuda"}
    assert c.lookup("site", reordered)["choice"] == 42
    assert c.lookup("site", {**sig, "probe": 9}) is None
    assert c.lookup("site", {**sig, "candidates": [1, 2, 4]}) is None
    assert c.lookup("other_site", sig) is None
    assert TuningCache(path).lookup("site", sig)["choice"] == 42
    on_disk = json.loads(path.read_text())
    assert on_disk["version"] == 1 and "site" in on_disk["sites"]


def test_stale_signature_provably_remeasures(tmp_path):
    c = TuningCache(tmp_path / "tc.json", writable=True)
    calls = []

    def measure():
        calls.append(1)
        return {"choice": 10 * len(calls), "wall_s": 0.1}

    sig_a = {"backend": "cuda", "candidates": [1, 2]}
    e1 = c.get_or_measure("s", sig_a, measure)
    assert (e1["choice"], e1["cached"], len(calls)) == (10, False, 1)
    e2 = c.get_or_measure("s", sig_a, measure)
    assert (e2["choice"], e2["cached"], len(calls)) == (10, True, 1)
    sig_b = {"backend": "cuda", "candidates": [1, 2, 3]}
    e3 = c.get_or_measure("s", sig_b, measure)
    assert (e3["choice"], e3["cached"], len(calls)) == (20, False, 2)
    c.store("s", sig_a, 99)  # replaces, never duplicates
    rows = json.loads((tmp_path / "tc.json").read_text())["sites"]["s"]
    assert len(rows) == 2
    assert c.lookup("s", sig_a)["choice"] == 99


def test_writes_are_env_gated(tmp_path, monkeypatch):
    path = tmp_path / "tc.json"
    c = TuningCache(path)  # writable=None -> the FEDMSE_TUNE gate
    c.store("s", {"a": 1}, 7)
    assert not path.exists()
    assert c.lookup("s", {"a": 1})["choice"] == 7  # the process reuses it
    monkeypatch.setenv("FEDMSE_TUNE", "1")
    c.store("s", {"a": 2}, 8)
    sigs = [e["signature"] for e in
            json.loads(path.read_text())["sites"]["s"]]
    assert {"a": 1} in sigs and {"a": 2} in sigs


def test_default_path_is_the_ports_own_file():
    """The port's default file is TUNE_CACHE_TORCH.json beside the JAX
    package's TUNE_CACHE.json, never that file."""
    from fedmse_tpu.tune.cache import DEFAULT_PATH as JAX_PATH
    from fedmse_tpu_torch.tune.cache import DEFAULT_PATH
    assert DEFAULT_PATH.name == "TUNE_CACHE_TORCH.json"
    assert DEFAULT_PATH.parent == JAX_PATH.parent
    assert DEFAULT_PATH != JAX_PATH


@pytest.mark.parametrize("content", ["{not json", "[1, 2]",
                                     '{"version": 2, "sites": {}}',
                                     '{"version": 1, "sites": []}'])
def test_corrupt_cache_reads_as_empty(tmp_path, monkeypatch, content):
    path = tmp_path / "tc.json"
    path.write_text(content)
    c = TuningCache(path, writable=True)
    assert c.lookup("s", {"a": 1}) is None
    c.store("s", {"a": 1}, 5)  # and a store repairs the file
    assert TuningCache(path).lookup("s", {"a": 1})["choice"] == 5
    # an engine asking for the tuned ladder over a corrupt file gets pow2
    path.write_text(content)
    monkeypatch.setenv("FEDMSE_TUNE_CACHE", str(path))
    assert _engine(bucket_ladder="auto").buckets == [1, 2, 4, 8, 16]


class FakeClock:
    """A perf_counter that moves only when a candidate advances it."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_measure_candidates_argmin_and_table(monkeypatch):
    from fedmse_tpu_torch.tune import measure
    clock = FakeClock()
    monkeypatch.setattr(measure, "time", clock)

    def run(delay):
        clock.now += delay
        return delay

    out = measure_candidates([0.004, 0.0, 0.002], run, repeats=1)
    assert out["choice"] == 0.0
    assert [r["value"] for r in out["candidates"]] == [0.004, 0.0, 0.002]
    assert all(r["wall_s"] >= 0.0 for r in out["candidates"])
    assert out["wall_s"] == min(r["wall_s"] for r in out["candidates"])


# ------------------------------ ladders ----------------------------------- #

def test_ladder_helpers():
    assert sites.pow2_ladder(16) == [1, 2, 4, 8, 16]
    lc = sites.ladder_candidates(16)
    assert lc["pow2"] == [1, 2, 4, 8, 16]
    assert lc["pow2_mid"] == [1, 2, 3, 4, 6, 8, 12, 16]
    assert sites.ladder_bucket_for(5, lc["pow2"]) == 8
    assert sites.ladder_bucket_for(5, lc["pow2_mid"]) == 6
    assert sites.ladder_bucket_for(0, lc["pow2_mid"]) == 1
    assert sites.ladder_bucket_for(16, lc["pow2_mid"]) == 16
    with pytest.raises(ValueError):
        sites.ladder_bucket_for(17, lc["pow2"])


@pytest.mark.parametrize("start", [1, 1025, 2049, 3073])
def test_ladder_helpers_equal_the_jax_packages(start):
    """Every max_bucket in 1..4096 (in four cases): the same ladders, the
    same probe sizes and the same rung for each of them."""
    for mb in range(start, start + 1024):
        ours, theirs = (sites.ladder_candidates(mb),
                        jax_sites.ladder_candidates(mb))
        assert ours == theirs, mb
        assert sites.pow2_ladder(mb) == jax_sites.pow2_ladder(mb)
        sizes = sites.probe_sizes(mb)
        assert sizes == [int(((i * 0.6180339887) % 1.0) * mb) + 1
                         for i in range(1, jax_sites._LADDER_PROBE_DRAWS
                                        + 1)]
        for lad in ours.values():
            if lad[-1] < max(sizes):
                continue  # a non-pow2 max_bucket: the rung would raise
            assert [sites.ladder_bucket_for(n, lad) for n in sizes] == \
                [jax_sites.ladder_bucket_for(n, lad) for n in sizes]


def _engine(max_bucket=16, **kw):
    model = make_model("autoencoder", DIM, device="cpu")
    params = init_stacked_params(model, 1, torch.Generator().manual_seed(0),
                                 device="cpu")
    return ServingEngine(model, "autoencoder", params, None,
                         multi_tenant=False, max_bucket=max_bucket,
                         device="cpu", **kw)


def test_engine_explicit_ladder_same_scores_less_padding():
    e_mid = _engine(bucket_ladder=[1, 2, 3, 4, 6, 8, 12, 16])
    e_p2 = _engine(bucket_ladder="pow2")
    assert e_mid.buckets == [1, 2, 3, 4, 6, 8, 12, 16]
    assert e_p2.buckets == [1, 2, 4, 8, 16]
    assert (e_mid.bucket_for(5), e_p2.bucket_for(5)) == (6, 8)
    rows = np.random.default_rng(0).normal(size=(5, DIM)).astype(np.float32)
    # the ladder changes PADDING only: the same scores, bit for bit
    np.testing.assert_array_equal(e_mid.score(rows), e_p2.score(rows))
    with pytest.raises(ValueError):
        _engine(bucket_ladder=[1, 2, 3])       # last rung != max_bucket
    with pytest.raises(ValueError):
        _engine(bucket_ladder=[0, 2, 16])      # non-positive rung
    assert _engine(bucket_ladder=[2, 4, 16]).bucket_for(1) == 2


def test_engine_auto_ladder_reads_cache_keyed_on_max_bucket(monkeypatch):
    monkeypatch.setenv("FEDMSE_TUNE", "1")
    tuned = [1, 2, 3, 4, 6, 8, 12, 16]
    default_cache().store("serve_bucket_ladder",
                          sites._serve_signature(16, DIM, "cpu"), tuned,
                          ladder_name="pow2_mid")
    assert _engine(bucket_ladder="auto").buckets == tuned
    assert sites.lookup_serve_ladder(16, DIM, device="cpu") == tuned
    # another max_bucket, width or device name misses -> pow2
    assert _engine(max_bucket=8).buckets == [1, 2, 4, 8]
    assert sites.lookup_serve_ladder(8, DIM, device="cpu") is None
    assert sites.lookup_serve_ladder(16, DIM - 1, device="cpu") is None
    other = {**sites._serve_signature(16, DIM, "cpu"),
             "device": "NVIDIA H100 80GB HBM3"}
    assert default_cache().lookup("serve_bucket_ladder", other) is None


def test_tune_serve_ladder_roundtrip_and_scores(tmp_path, monkeypatch):
    """tune -> store -> an 'auto' engine serves the chosen ladder, its
    scores the pow2 engine's bits per row."""
    cache = TuningCache(tmp_path / "tc.json", writable=True)
    entry = sites.tune_serve_ladder(max_bucket=16, dim=DIM, repeats=1,
                                    cache=cache, device="cpu")
    assert entry["ladder_name"] in ("pow2", "pow2_mid")
    assert set(entry["expected_wall_s"]) == {"pow2", "pow2_mid"}
    assert entry["choice"] == sites.ladder_candidates(16)[
        entry["ladder_name"]]
    assert sites.lookup_serve_ladder(16, DIM, cache=cache,
                                     device="cpu") == entry["choice"]
    assert _engine(bucket_ladder="auto").buckets == [1, 2, 4, 8, 16]
    cache.store("serve_bucket_ladder", entry["signature"],
                sites.ladder_candidates(16)["pow2_mid"])
    monkeypatch.setenv("FEDMSE_TUNE_CACHE", str(tmp_path / "tc.json"))
    e_auto = _engine(bucket_ladder="auto")
    assert e_auto.buckets == [1, 2, 3, 4, 6, 8, 12, 16]
    rows = np.random.default_rng(1).normal(size=(53, DIM)).astype(np.float32)
    np.testing.assert_array_equal(e_auto.score(rows),
                                  _engine(bucket_ladder="pow2").score(rows))


# ------------------------------ tier chunk -------------------------------- #

def test_tune_tier_chunk_roundtrip_and_tier_bits(tmp_path, monkeypatch):
    """tune -> lookup under one signature; a probe drift hides the entry;
    a tiered engine with init_chunk=None reads the tuned chunk and its
    tier is the dense init's bits."""
    monkeypatch.setattr(sites, "_TIER_PROBE_CLIENTS", 64)
    cache = TuningCache(tmp_path / "tc.json", writable=True)
    assert sites.lookup_tier_chunk(cache, device="cpu") is None
    entry = sites.tune_tier_chunk(cache, repeats=1, candidates=(7, 64),
                                  device="cpu")
    assert entry["choice"] in (7, 64)
    assert entry["signature"]["probe_clients"] == 64
    assert len(entry["candidates"]) == 2
    # the default candidate grid is another signature
    assert sites.lookup_tier_chunk(cache, device="cpu") is None
    cache.store("tier_init_chunk", sites._tier_signature(device="cpu"), 7)
    assert sites.lookup_tier_chunk(cache, device="cpu") == 7
    monkeypatch.setattr(sites, "_TIER_PROBE_CLIENTS", 128)   # probe drift
    assert sites.lookup_tier_chunk(cache, device="cpu") is None
    monkeypatch.setattr(sites, "_TIER_PROBE_CLIENTS", 64)

    monkeypatch.setenv("FEDMSE_TUNE_CACHE", str(tmp_path / "tc.json"))
    n, dim = 11, 6
    clients = synthetic_clients(n_clients=n, dim=dim, n_normal=40,
                                n_abnormal=10, seed=2)
    data = stack_clients(clients, np.zeros((4, dim), np.float32), 4,
                         device="cpu")
    model = make_model("autoencoder", dim, 4, 2, device="cpu")
    cfg = ExperimentConfig(dim_features=dim, hidden_neus=4, latent_dim=2,
                           network_size=n, state_layout="tiered")
    eng = TieredRoundEngine(model, cfg, data, n, ExperimentRngs(run=0),
                            "autoencoder", "avg", device="cpu")
    assert eng.init_chunk == 7
    dense = init_client_states(model, n, ExperimentRngs(run=0).generator,
                               device="cpu")
    assert torch.equal(eng.store.host.params, dense.params)
    monkeypatch.setenv("FEDMSE_TUNE_CACHE", str(tmp_path / "none.json"))
    assert TieredRoundEngine(model, cfg, data, n, ExperimentRngs(run=0),
                             "autoencoder", "avg",
                             device="cpu").init_chunk == 4096


# ---------------------- one file, both packages --------------------------- #

def test_port_reads_a_file_the_jax_package_wrote(tmp_path):
    """The JAX package's TuningCache writes; the port reads the same file,
    sees its entries by their exact signatures, and none of them answers
    a lookup of the port (their backends are the JAX package's). A port
    entry stored into the file is read back by the JAX package."""
    path = tmp_path / "shared.json"
    jc = JaxCache(path, writable=True)
    jax_sig = jax_sites._serve_signature(16, DIM)
    jc.store("serve_bucket_ladder", jax_sig, [1, 2, 3, 4, 6, 8, 12, 16],
             ladder_name="pow2_mid")
    jc.store("tier_init_chunk", jax_sites._tier_signature(), 2048)
    ours = TuningCache(path, writable=True)
    assert ours.lookup("serve_bucket_ladder", jax_sig)["choice"] == \
        [1, 2, 3, 4, 6, 8, 12, 16]
    assert jax_sig["backend"] == "cpu" and jax_sig["device"] == "cpu"
    assert sites.lookup_serve_ladder(16, DIM, cache=ours,
                                     device="cpu") is None
    assert sites.lookup_tier_chunk(ours, device="cpu") is None
    ours.store("tier_init_chunk", sites._tier_signature(device="cpu"), 1024)
    assert sites.lookup_tier_chunk(ours, device="cpu") == 1024
    assert JaxCache(path).lookup(
        "tier_init_chunk", sites._tier_signature(device="cpu"))["choice"] \
        == 1024
    assert jax_sites.lookup_tier_chunk(JaxCache(path)) == 2048
