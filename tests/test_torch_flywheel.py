"""The port's flywheel control loop (fedmse_tpu_torch/flywheel/, the intake
tap of serving/continuous.py, redteam/traffic.py) against the JAX
package's (fedmse_tpu/flywheel/), on the CPU at small size (DIM 10, 3-4
gateways).

Tolerances (PARITY.md §7): reservoirs, decay reservoirs, the fine-tune
arrays and the slow-drift adversary's draws are numpy on both sides and
equal BIT for bit; scores 1e-5 (the same kernels' plain twins against
XLA); the calibration refit and the swap's splice 1e-5; one fine-tune
round from the same warm params, tie-break off, 1e-5 scale-normalized.
The end-to-end loop holds the JAX test's own thresholds, and its FIRST
swap fires at the same poll with the same trigger gateways as the JAX
loop fed the same trained params (later events are reported, not pinned:
training on a loss plateau is chaotic).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.flywheel import FlywheelBuffer as JaxBuffer
from fedmse_tpu.flywheel import FlywheelController as JaxController
from fedmse_tpu.flywheel import build_and_apply_swap as jax_swap
from fedmse_tpu.flywheel import refit_calibration as jax_refit
from fedmse_tpu.flywheel.harness import \
    stream_with_polling as jax_stream_with_polling
from fedmse_tpu.models import init_stacked_params as jax_init_params
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.redteam.traffic import SlowDriftAdversary as JaxAdversary
from fedmse_tpu.redteam.traffic import normal_fraction as jax_normal_fraction
from fedmse_tpu.serving import ContinuousBatcher as JaxFront
from fedmse_tpu.serving import DriftMonitor as JaxDrift
from fedmse_tpu.serving import ServingEngine as JaxEngine
from fedmse_tpu.serving import fit_calibration as jax_fit_calibration
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.flywheel import (FinetuneRunner, FlywheelBuffer,
                                       FlywheelController,
                                       build_and_apply_swap, finetune_config,
                                       refit_calibration, stack_ragged_rows,
                                       stream_with_polling, ticket_integrity)
from fedmse_tpu_torch.flywheel.harness import host_auc
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.redteam import SlowDriftAdversary, normal_fraction
from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                      ServingEngine, fit_calibration)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

pytestmark = pytest.mark.flywheel

torch.set_num_threads(1)

DIM = 10
N = 4


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32), tree)


def _tensors_np(tree):
    if isinstance(tree, dict):
        return {k: _tensors_np(v) for k, v in tree.items()}
    return torch.as_tensor(tree).detach().to(torch.float32).cpu().numpy()


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _tree_err(got, want):
    return max(_scaled_err(a, b) for a, b in zip(jax.tree.leaves(got),
                                                 jax.tree.leaves(want)))


def _setup(score_kind="auto", seed=0, max_bucket=64, model_type="autoencoder"):
    """The JAX engine and the port's engine on one set of params and train
    rows, each calibrated on the same valid rows; a stream of rows."""
    rng = np.random.default_rng(seed)
    jm = jax_make_model(model_type, DIM)
    params = _np(jax_init_params(jm, jax.random.key(seed), N))
    train_x = rng.normal(size=(N, 80, DIM)).astype(np.float32)
    valid_x = rng.normal(size=(N, 120, DIM)).astype(np.float32)
    kw = dict(score_kind=score_kind, knn_bank_size=32,
              max_bucket=max_bucket)
    jeng = JaxEngine.from_federation(jm, model_type, params,
                                     train_x=train_x, **kw)
    model = make_model(model_type, DIM, device="cpu")
    eng = ServingEngine.from_federation(model, model_type, params,
                                        train_x=train_x, device="cpu", **kw)
    jcal = jax_fit_calibration(jeng, valid_x, percentile=99.0)
    cal = fit_calibration(eng, valid_x, percentile=99.0)
    rows = rng.normal(size=(500, DIM)).astype(np.float32)
    gws = rng.integers(0, N, 500).astype(np.int32)
    return dict(jm=jm, model=model, params=params, train_x=train_x,
                jeng=jeng, eng=eng, jcal=jcal, cal=cal, rows=rows, gws=gws)


# ------------------------------ reservoirs ------------------------------ #

def _admit_both(a, b, rng, batches=30):
    """The same admits into both buffers: interleaved gateways, verdict
    filters, scores for the margin floor."""
    for _ in range(batches):
        n = int(rng.integers(1, 40))
        rows = rng.normal(size=(n, DIM)).astype(np.float32)
        gw = rng.integers(0, a.num_gateways, n).astype(np.int32)
        verdicts = rng.random(n) < 0.2
        scores = rng.random(n)
        assert a.admit(rows, gw, verdicts=verdicts, scores=scores) == \
            b.admit(rows, gw, verdicts=verdicts, scores=scores)


@pytest.mark.parametrize("kw", [
    {}, {"decay": 0.9}, {"decay": 0.5}, {"decay": 1.0},
    {"margin_frac": 0.6}, {"influence_cap": 0.3},
    {"decay": 0.95, "margin_frac": 0.8, "influence_cap": 0.5}],
    ids=["uniform", "decay0.9", "decay0.5", "decay1", "margin", "cap",
         "all"])
def test_reservoirs_and_finetune_arrays_equal_jax_bit_for_bit(kw):
    thr = np.linspace(0.4, 1.0, N)
    extra = {"thresholds_fn": lambda: thr} if "margin_frac" in kw else {}
    ours = FlywheelBuffer(N, DIM, capacity=24, seed=5, **kw, **extra)
    theirs = JaxBuffer(N, DIM, capacity=24, seed=5, **kw, **extra)
    _admit_both(ours, theirs, np.random.default_rng(1))
    np.testing.assert_array_equal(ours.count, theirs.count)
    np.testing.assert_array_equal(ours.seen, theirs.seen)
    np.testing.assert_array_equal(ours._pri, theirs._pri)
    for g in range(N):
        np.testing.assert_array_equal(ours.rows_for(g), theirs.rows_for(g))
    assert ours.occupancy() == theirs.occupancy()
    dev_x = np.random.default_rng(2).normal(size=(7, DIM)).astype(np.float32)
    member = np.asarray([True, True, False, True])
    a = ours.build_finetune_data(5, dev_x, valid_frac=0.3, min_rows=6,
                                 member=member)
    b = theirs.build_finetune_data(5, dev_x, valid_frac=0.3, min_rows=6,
                                   member=member)
    np.testing.assert_array_equal(a.eligible, b.eligible)
    for name, arr in a.arrays.items():
        want = np.asarray(getattr(b.data, name))
        assert arr.dtype == want.dtype and arr.shape == want.shape, name
        np.testing.assert_array_equal(arr, want, err_msg=name)
    for x, y in zip(a.train_rows + a.valid_rows, b.train_rows + b.valid_rows):
        np.testing.assert_array_equal(x, y)
    # the placed FederatedData carries the same numbers
    fed = a.federated("cpu")
    np.testing.assert_array_equal(fed.train_xb.numpy(), a.arrays["train_xb"])
    assert fed.client_mask.tolist() == a.eligible.astype(float).tolist()
    # a clear drops the rows but not the streams, as in the JAX package
    ours.clear([0])
    theirs.clear([0])
    _admit_both(ours, theirs, np.random.default_rng(3), batches=5)
    for g in range(N):
        np.testing.assert_array_equal(ours.rows_for(g), theirs.rows_for(g))


def test_buffer_padding_and_layout_invariant():
    """Gateway g's reservoir depends only on (seed, g, its own arrivals):
    a wider axis and another interleaving keep its rows."""
    rng = np.random.default_rng(3)
    per_g = {g: rng.normal(size=(60, DIM)).astype(np.float32)
             for g in range(3)}
    a = FlywheelBuffer(3, DIM, capacity=16, seed=5, decay=0.9)
    b = FlywheelBuffer(9, DIM, capacity=16, seed=5, decay=0.9)
    for g in range(3):
        a.admit(per_g[g], np.full(60, g, np.int32))
    for start in range(0, 60, 10):
        for g in (2, 0, 1):
            b.admit(per_g[g][start:start + 10], np.full(10, g, np.int32))
    for g in range(3):
        np.testing.assert_array_equal(a.rows_for(g), b.rows_for(g))


def test_buffer_validation_and_stack_helper():
    with pytest.raises(ValueError, match="decay"):
        FlywheelBuffer(1, DIM, decay=0.0)
    with pytest.raises(ValueError, match="thresholds_fn"):
        FlywheelBuffer(1, DIM, margin_frac=0.5)
    with pytest.raises(ValueError, match="min_rows"):
        FlywheelBuffer(2, DIM).build_finetune_data(4, np.zeros((2, DIM)),
                                                   min_rows=1)
    rows = [np.ones((3, DIM), np.float32), np.zeros((0, DIM), np.float32)]
    x, m = stack_ragged_rows(rows, DIM)
    assert x.shape == (2, 3, DIM) and m.tolist() == [[1, 1, 1], [0, 0, 0]]


# ------------------------------ the front ------------------------------- #

def test_intake_receives_the_jax_fronts_rows():
    """Both fronts, tapped, over the same stream: the same rows, gateways
    and verdicts per batch, the scores within 1e-5."""
    s = _setup()
    seen, jseen = [], []
    front = ContinuousBatcher(s["eng"], max_batch=32, latency_budget_ms=1e9,
                              calibration=s["cal"],
                              intake=lambda *a: seen.append(a))
    jfront = JaxFront(s["jeng"], max_batch=32, latency_budget_ms=1e9,
                      calibration=s["jcal"],
                      intake=lambda *a: jseen.append(a))
    for f in (front, jfront):
        f.submit_many(s["rows"][:150], s["gws"][:150])
        for i in range(150, 300):
            f.submit(s["rows"][i], s["gws"][i])
        f.drain()
    assert len(seen) == len(jseen) > 1
    for (r, g, sc, v), (jr, jg, jsc, jv) in zip(seen, jseen):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_allclose(sc, jsc, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(v, jv)


def test_flywheel_off_bit_identical_to_plain_front():
    """No intake: the front keeps no rows; an attached tap that never
    triggers changes no score or verdict byte."""
    s = _setup()
    plain = ContinuousBatcher(s["eng"], max_batch=32, latency_budget_ms=1e9,
                              calibration=s["cal"])
    t_plain = [plain.submit(s["rows"][i], s["gws"][i]) for i in range(300)]
    assert plain._hot[2] is not None and plain._hot[2].rows is None
    plain.drain()
    buf = FlywheelBuffer(N, DIM, capacity=64, seed=0)
    tapped = ContinuousBatcher(s["eng"], max_batch=32,
                               latency_budget_ms=1e9, calibration=s["cal"],
                               intake=buf.tap())
    t_tap = [tapped.submit(s["rows"][i], s["gws"][i]) for i in range(300)]
    tapped.drain()
    np.testing.assert_array_equal([t.score for t in t_plain],
                                  [t.score for t in t_tap])
    assert [t.verdict for t in t_plain] == [t.verdict for t in t_tap]
    assert plain.stats()["dispatches"] == tapped.stats()["dispatches"]
    assert buf.seen.sum() > 0
    # a harvested record keeps neither the rows nor the tap
    assert all(t[0].rows is None and t[0].intake is None for t in t_tap)


# ------------------------------ the swap -------------------------------- #

def test_refit_calibration_matches_jax_and_chained_refit():
    s = _setup()
    rng = np.random.default_rng(1)
    scores = {0: rng.normal(size=40), 2: rng.normal(size=25)}
    vec = refit_calibration(s["cal"], scores)
    chained = s["cal"].refit(0, scores[0]).refit(2, scores[2])
    theirs = jax_refit(s["jcal"], scores)
    for f in ("thresholds", "mean", "std", "count"):
        np.testing.assert_array_equal(getattr(vec, f), getattr(chained, f))
        np.testing.assert_allclose(getattr(vec, f), getattr(theirs, f),
                                   rtol=1e-5, atol=1e-5)
    assert vec.thresholds[1] == s["cal"].thresholds[1]


def _buffers(s, seed=3, min_fill=40):
    """The same admits into a port and a JAX buffer (every gateway but 3
    over min_rows)."""
    ours = FlywheelBuffer(N, DIM, capacity=64, seed=seed)
    theirs = JaxBuffer(N, DIM, capacity=64, seed=seed)
    rng = np.random.default_rng(seed)
    for g in range(N - 1):
        rows = (rng.normal(size=(min_fill, DIM)) + 0.5).astype(np.float32)
        ours.admit(rows, np.full(min_fill, g, np.int32))
        theirs.admit(rows, np.full(min_fill, g, np.int32))
    return ours, theirs


@pytest.mark.parametrize("score_kind", ["mse", "centroid", "knn"])
def test_swap_payload_matches_jax(score_kind):
    """build_and_apply_swap on both sides with the same fine-tuned params:
    installed params and refit thresholds within 1e-5, the ineligible
    gateway's params, bank or centroid and threshold bit for bit. The kNN
    refresh draws its priorities from the port's own stream, so its bank
    is held by properties: the ineligible bank unchanged, the eligible
    counts the JAX bank's, and thresholds the port's own candidate scores'
    percentile."""
    mt = "hybrid" if score_kind == "centroid" else "autoencoder"
    s = _setup(score_kind=score_kind, model_type=mt)
    ours, theirs = _buffers(s)
    dev_x = np.zeros((4, DIM), np.float32)
    ft = ours.build_finetune_data(12, dev_x, min_rows=16)
    jft = theirs.build_finetune_data(12, dev_x, min_rows=16)
    assert ft.eligible.tolist() == [True, True, True, False]
    new = _np(jax_init_params(s["jm"], jax.random.key(9), N))
    front = ContinuousBatcher(s["eng"], max_batch=16, calibration=s["cal"],
                              drift=DriftMonitor(s["cal"]))
    jfront = JaxFront(s["jeng"], max_batch=16, calibration=s["jcal"],
                      drift=JaxDrift(s["jcal"]))
    old_params = _tensors_np(s["eng"].params)
    old_banks = None if s["eng"].banks is None else (
        s["eng"].banks.latents.clone(), s["eng"].banks.count.clone())
    old_cen = s["eng"].centroids
    event = build_and_apply_swap(front, s["model"], ft, new)
    jevent = jax_swap(jfront, s["jm"], jft, new)
    assert event["kinds"] == jevent["kinds"]
    assert event["flywheel"]["eligible_gateways"] == [0, 1, 2]
    got = _tensors_np(s["eng"].params)
    want = _np(jax.device_get(s["jeng"].params))
    assert _tree_err(got, want) <= 1e-5
    for leaf_new, leaf_old in zip(jax.tree.leaves(got),
                                  jax.tree.leaves(old_params)):
        np.testing.assert_array_equal(leaf_new[3], leaf_old[3])
    assert front.calibration.thresholds[3] == s["cal"].thresholds[3]
    if score_kind == "knn":
        banks = s["eng"].banks
        assert torch.equal(banks.latents[3], old_banks[0][3])
        assert banks.count[3] == old_banks[1][3]
        np.testing.assert_array_equal(
            banks.count.numpy(), np.asarray(s["jeng"].banks.count))
        # the refit is the candidate scores' percentile, and the candidate
        # is what the installed engine now serves
        for g in (0, 1, 2):
            sc = s["eng"].score(ft.valid_rows[g],
                                np.full(len(ft.valid_rows[g]), g, np.int32))
            assert np.isclose(front.calibration.thresholds[g],
                              np.percentile(sc.astype(np.float64), 99.0),
                              rtol=1e-6)
    else:
        np.testing.assert_allclose(front.calibration.thresholds,
                                   jfront.calibration.thresholds,
                                   rtol=1e-5, atol=1e-5)
    if score_kind == "centroid":
        cen = s["eng"].centroids
        for f in ("mean", "scale", "abs_threshold"):
            assert torch.equal(getattr(cen, f)[3], getattr(old_cen, f)[3])
            assert _scaled_err(getattr(cen, f).numpy(),
                               np.asarray(getattr(s["jeng"].centroids,
                                                  f))) <= 1e-5
    with pytest.raises(ValueError, match="no eligible"):
        build_and_apply_swap(front, s["model"], dataclasses.replace(
            ft, eligible=np.zeros(N, bool)), new)


# --------------------------- slow-drift walk ---------------------------- #

def test_slow_drift_adversary_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    start, target = rng.normal(size=DIM), rng.normal(size=DIM) + 3.0
    ours = SlowDriftAdversary(start, target, seed=4, step=0.1)
    theirs = JaxAdversary(start, target, seed=4, step=0.1)
    feedback = rng.random(40)
    for fb in feedback:
        np.testing.assert_array_equal(ours.next_batch(17),
                                      theirs.next_batch(17))
        ours.observe(fb)
        theirs.observe(fb)
        assert ours.position == theirs.position
        np.testing.assert_array_equal(ours.mu(), theirs.mu())
    np.testing.assert_array_equal(ours.target_rows(9), theirs.target_rows(9))
    np.testing.assert_array_equal(ours.target_rows(9, seed=2),
                                  theirs.target_rows(9, seed=2))
    for v in (np.zeros(0, bool), np.asarray([True, False, False]),
              np.asarray([0, 1, 1, 1])):
        assert normal_fraction(v) == jax_normal_fraction(v)
    with pytest.raises(ValueError, match="step"):
        SlowDriftAdversary(start, target, step=0.0)


# ------------------------------ fine-tune ------------------------------- #

def test_finetune_round_matches_jax():
    """One fine-tune round from the same exported warm params and the
    same buffered data, tie-break off: 1e-5 scale-normalized."""
    s = _setup()
    ours, theirs = _buffers(s)
    dev_x = np.random.default_rng(4).normal(size=(40, DIM)).astype(
        np.float32)
    compat = dict(vote_tie_break=False)
    cfg = ExperimentConfig(network_size=N, dim_features=DIM, epochs=3,
                           compat=CompatConfig(**compat))
    jcfg = JaxConfig(network_size=N, dim_features=DIM, epochs=3,
                     compat=JaxCompat(**compat))
    front = ContinuousBatcher(s["eng"], max_batch=16, calibration=s["cal"])
    jfront = JaxFront(s["jeng"], max_batch=16, calibration=s["jcal"])
    ctl = FlywheelController(front, DriftMonitor(s["cal"]), ours,
                             s["model"], "autoencoder", "mse_avg", cfg,
                             dev_x=dev_x, rounds=1, min_rows=16)
    jctl = JaxController(jfront, JaxDrift(s["jcal"]), theirs, s["jm"],
                         "autoencoder", "mse_avg", jcfg, dev_x=dev_x,
                         rounds=1, min_rows=16)
    ft = ours.build_finetune_data(12, dev_x, min_rows=16)
    jft = theirs.build_finetune_data(12, dev_x, min_rows=16)
    before = _tensors_np(s["eng"].params)
    got, metrics = ctl._finetune(ft)
    want, jmetrics = jctl._finetune(jft)
    assert _tree_err(_tensors_np(got), _np(want)) <= 1e-5
    assert metrics[0]["aggregator"] == jmetrics[0]["aggregator"]
    # the served params did not move: the fine-tune trained on clones
    for a, b in zip(jax.tree.leaves(_tensors_np(s["eng"].params)),
                    jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    # the ineligible gateway kept its warm params through the round
    for a, b in zip(jax.tree.leaves(_tensors_np(got)),
                    jax.tree.leaves(before)):
        np.testing.assert_array_equal(a[3], b[3])


def test_captured_engine_reused_per_shape_is_a_new_engine():
    """A second fine-tune of the same shapes copies into the first one's
    engine: its result equals a fresh runner's bit for bit, and another
    shape builds another engine."""
    s = _setup()
    ours, _ = _buffers(s)
    cfg = finetune_config(ExperimentConfig(network_size=N, dim_features=DIM,
                                           epochs=2), rounds=2)
    dev_x = np.zeros((8, DIM), np.float32)
    layout = ParamLayout.of(s["model"])
    warm = layout.flatten(s["eng"].params)
    ft1 = ours.build_finetune_data(12, dev_x, min_rows=16)
    rng = np.random.default_rng(8)
    ours.clear()
    for g in range(N - 1):
        rows = rng.normal(size=(40, DIM)).astype(np.float32)
        ours.admit(rows, np.full(40, g, np.int32))
    ft2 = ours.build_finetune_data(12, dev_x, min_rows=16)
    assert all(a.shape == b.shape for a, b in zip(ft1.arrays.values(),
                                                  ft2.arrays.values()))

    def runner():
        return FinetuneRunner(s["model"], cfg, "autoencoder", "mse_avg", N,
                              torch.device("cpu"))

    r = runner()
    r.run(ft1, warm.clone(), ExperimentRngs(run=90_000), 2)
    got, _, reused = r.run(ft2, warm.clone(), ExperimentRngs(run=90_001), 2)
    want, _, fresh = runner().run(ft2, warm.clone(),
                                  ExperimentRngs(run=90_001), 2)
    assert reused and not fresh and r.engines_built == 1
    for a, b in zip(jax.tree.leaves(_tensors_np(got)),
                    jax.tree.leaves(_tensors_np(want))):
        np.testing.assert_array_equal(a, b)
    ours.admit(rng.normal(size=(30, DIM)).astype(np.float32),
               np.zeros(30, np.int32))
    ft3 = ours.build_finetune_data(12, dev_x, min_rows=16)
    r.run(ft3, warm.clone(), ExperimentRngs(run=90_002), 1)
    assert r.engines_built == 2


def test_controller_backs_off_on_empty_buffer():
    s = _setup()
    mon = DriftMonitor(s["cal"], z_threshold=0.5, min_count=10,
                       min_batches=1)
    buf = FlywheelBuffer(N, DIM, capacity=32, seed=0)
    front = ContinuousBatcher(s["eng"], max_batch=16, latency_budget_ms=1e9,
                              calibration=s["cal"], drift=mon)
    cfg = ExperimentConfig(network_size=N, dim_features=DIM)
    ctl = FlywheelController(front, mon, buf, s["model"], "autoencoder",
                             "mse_avg", cfg, dev_x=np.zeros((4, DIM)),
                             quorum=1, cooldown_polls=3, min_rows=16)
    hot = s["cal"].mean + 50 * (s["cal"].std + 1.0)
    for g in range(N):
        mon.update(np.full(20, hot[g]), np.full(20, g, np.int32))
    assert mon.swap_recommended().any()
    assert ctl.poll() is None
    assert not ctl.events and s["eng"].swap_count == 0
    assert ctl._cooldown == 3
    with pytest.raises(ValueError, match="rounds"):
        FlywheelController(front, mon, buf, s["model"], "autoencoder",
                           "mse_avg", cfg, dev_x=np.zeros((4, DIM)),
                           rounds=0)


# ------------------------------ background ------------------------------ #

def _async_setup(drift_z=1e9, intake=True):
    s = _setup()
    mon = DriftMonitor(s["cal"], z_threshold=drift_z, min_count=10,
                       min_batches=1)
    buf = FlywheelBuffer(N, DIM, capacity=64, seed=0)
    front = ContinuousBatcher(s["eng"], max_batch=16, latency_budget_ms=1e9,
                              calibration=s["cal"], drift=mon,
                              intake=buf.tap() if intake else None)
    cfg = ExperimentConfig(network_size=N, dim_features=DIM, epochs=2)
    ctl = FlywheelController(front, mon, buf, s["model"], "autoencoder",
                             "mse_avg", cfg, dev_x=np.zeros((4, DIM)),
                             quorum=1, min_rows=16, rounds=1,
                             background=True)
    buf.admit(s["rows"][:200], s["gws"][:200])
    return s, mon, buf, front, ctl


def test_async_finetune_serves_while_training_and_installs_atomically():
    s, mon, buf, front, ctl = _async_setup()
    gate, started = threading.Event(), threading.Event()
    incumbent = _tensors_np(s["eng"].params)

    def slow_finetune(finetune):
        started.set()
        assert gate.wait(30.0), "test gate never opened"
        return incumbent, [{"round": 0}]

    ctl._finetune = slow_finetune
    assert ctl.trigger(np.asarray([0])) is None
    assert ctl.finetune_pending and started.wait(30.0)
    blk = front.submit_many(s["rows"][:48], s["gws"][:48])
    front.drain()
    assert ctl.poll() is None and ctl.finetune_pending
    assert blk.done
    np.testing.assert_array_equal(blk.scores,
                                  s["eng"].score(s["rows"][:48],
                                                 s["gws"][:48]))
    assert s["eng"].swap_count == 0
    gate.set()
    event = ctl.wait(30.0)
    assert event is not None and not ctl.finetune_pending
    assert event["flywheel"]["finetune_async"] is True
    assert "params" in event["kinds"] and "thresholds" in event["kinds"]
    assert s["eng"].swap_count == 1 and ctl.events == [event]
    assert ctl._cooldown == ctl.cooldown_polls and buf.count.sum() == 0
    blk2 = front.submit_many(s["rows"][48:80], s["gws"][48:80])
    front.drain()
    st = front.stats()
    assert blk2.done and st["rows_served"] == st["rows_submitted"]


def test_async_finetune_blocks_second_trigger_and_failure_clears():
    s, mon, buf, front, ctl = _async_setup(drift_z=0.5)
    gate, calls = threading.Event(), []
    incumbent = _tensors_np(s["eng"].params)

    def slow_finetune(finetune):
        calls.append(1)
        gate.wait(30.0)
        return incumbent, []

    ctl._finetune = slow_finetune
    hot = s["cal"].mean + 50 * (s["cal"].std + 1.0)
    for g in range(N):
        mon.update(np.full(20, hot[g]), np.full(20, g, np.int32))
    assert ctl.poll() is None and ctl.finetune_pending
    for _ in range(3):
        mon.update(np.full(20, hot[0]), np.zeros(20, np.int32))
        assert ctl.poll() is None
    assert ctl.trigger(np.asarray([0])) is None
    gate.set()
    assert ctl.wait(30.0) is not None
    assert len(calls) == 1 and s["eng"].swap_count == 1

    def broken(finetune):
        raise RuntimeError("synthetic fine-tune failure")

    ctl._finetune = broken
    buf.admit(s["rows"][:200], s["gws"][:200])
    assert ctl.trigger(np.asarray([0])) is None
    with pytest.raises(RuntimeError, match="synthetic"):
        ctl.wait(30.0)
    assert not ctl.finetune_pending and s["eng"].swap_count == 1


def test_background_finetune_equals_the_synchronous_bits():
    """The real fine-tune on the executor while the front serves: the
    same params as the synchronous fine-tune from the same snapshot, and
    the served params unchanged until the install."""
    s, mon, buf, front, ctl = _async_setup()
    ft = buf.build_finetune_data(12, ctl.dev_x, min_rows=16)
    sync_params, _ = ctl._finetune(ft)
    before = _tensors_np(s["eng"].params)
    got = {}
    real = ctl._finetune

    def spy(finetune):
        got["params"], metrics = real(finetune)
        return got["params"], metrics

    ctl._finetune = spy
    assert ctl.trigger(np.asarray([0])) is None
    while ctl.finetune_pending:
        front.submit_many(s["rows"][:32], s["gws"][:32])
        front.drain()
        for a, b in zip(jax.tree.leaves(_tensors_np(s["eng"].params)),
                        jax.tree.leaves(before)):
            np.testing.assert_array_equal(a, b)
        ctl.poll()
    assert s["eng"].swap_count == 1
    for a, b in zip(jax.tree.leaves(_tensors_np(got["params"])),
                    jax.tree.leaves(_tensors_np(sync_params))):
        np.testing.assert_array_equal(a, b)


# ------------------------------ end to end ------------------------------ #

def _manifold_regime(seed, dim, rank=2, noise=0.2):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rank, dim))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    q, _ = np.linalg.qr(w.T)
    u = rng.normal(size=dim)
    u -= q @ (q.T @ u)
    u /= np.linalg.norm(u)

    def normals(rng_, n, shift=0.0):
        x = rng_.normal(size=(n, rank)) @ w \
            + noise * rng_.normal(size=(n, dim))
        return (x + shift * u).astype(np.float32)

    return normals


@pytest.fixture(scope="module")
def trained():
    """The JAX package's test federation, trained by the JAX fused engine:
    the params both loops serve."""
    import pandas as pd

    from fedmse_tpu.data import build_dev_dataset, stack_clients
    from fedmse_tpu.data.loader import ClientData
    from fedmse_tpu.federation import RoundEngine
    from fedmse_tpu.parallel import host_fetch
    from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs

    dim, n_clients = 10, 3
    normals = _manifold_regime(0, dim)
    rng = np.random.default_rng(1)
    cfg = JaxConfig(network_size=n_clients, dim_features=dim, epochs=4,
                    num_rounds=2, batch_size=12)
    clients = [ClientData(
        name=f"fw-{i}", train_x=normals(rng, 160),
        valid_x=normals(rng, 48),
        test_x=normals(rng, 24), test_y=np.zeros(24, np.float32),
        dev_raw=pd.DataFrame(normals(rng, 60)), scaler=None)
        for i in range(n_clients)]
    data = stack_clients(clients,
                         build_dev_dataset(clients, JaxRngs(run=0).data_rng),
                         cfg.batch_size)
    model = jax_make_model("autoencoder", dim)
    trainer = RoundEngine(model, cfg, data, n_real=n_clients,
                          rngs=JaxRngs(run=0), model_type="autoencoder",
                          update_type="mse_avg", fused=True)
    trainer.run_rounds(0, cfg.num_rounds)
    params = _np(host_fetch(trainer.states.params))
    return dict(params=params, data=data, normals=normals, rng_state=rng,
                n=n_clients, dim=dim, jm=model)


def _loop(trained, port: bool):
    """One flywheel loop over the ramp of the JAX test (its thresholds):
    returns (controller, front, engine, frozen engine, blocks, the polls
    at which events fired)."""
    d, n, dim = trained["data"], trained["n"], trained["dim"]
    args = dict(train_x=np.asarray(d.train_xb), train_m=np.asarray(d.train_mb),
                max_bucket=64)
    if port:
        model = make_model("autoencoder", dim, device="cpu")
        build = lambda: ServingEngine.from_federation(  # noqa: E731
            model, "autoencoder", trained["params"], device="cpu", **args)
        cfg = ExperimentConfig(network_size=n, dim_features=dim, epochs=4,
                               num_rounds=2, batch_size=12)
        mods = (fit_calibration, DriftMonitor, FlywheelBuffer,
                ContinuousBatcher, FlywheelController, stream_with_polling)
    else:
        model = trained["jm"]
        build = lambda: JaxEngine.from_federation(  # noqa: E731
            model, "autoencoder", trained["params"], **args)
        cfg = JaxConfig(network_size=n, dim_features=dim, epochs=4,
                        num_rounds=2, batch_size=12)
        mods = (jax_fit_calibration, JaxDrift, JaxBuffer, JaxFront,
                JaxController, jax_stream_with_polling)
    fit, Drift, Buffer, Front, Controller, stream = mods
    engine, frozen = build(), build()
    calib = fit(engine, np.asarray(d.valid_x), np.asarray(d.valid_m),
                percentile=99.0)
    monitor = Drift(calib, z_threshold=0.5, min_batches=2,
                    cooldown_updates=2)
    buf = Buffer(n, dim, capacity=128, seed=0)
    front = Front(engine, max_batch=32, latency_budget_ms=1e9,
                  calibration=calib, drift=monitor, intake=buf.tap())
    ctl = Controller(front, monitor, buf, model, "autoencoder", "mse_avg",
                     cfg, dev_x=np.asarray(d.dev_x), rounds=2, quorum=2,
                     cooldown_polls=2, min_rows=48)
    fired = []
    poll = ctl.poll

    def counted():
        event = poll()
        if event is not None:
            fired.append((ctl.polls, event["flywheel"]["trigger_gateways"],
                          event["at_rows_submitted"]))
        return event

    ctl.poll = counted
    rng = np.random.default_rng(1234)
    gws = np.tile(np.arange(n, dtype=np.int32), 96)
    blocks = []
    for shift in (0.0, 0.6, 1.2, 1.8, 1.8):  # ramp, then hold
        fresh = trained["normals"](rng, 96 * n, shift)
        bs, _ = stream(front, ctl, fresh, gws, chunk=32)
        blocks.extend(bs)
    return ctl, front, engine, frozen, blocks, fired, monitor


def test_flywheel_end_to_end_recovery_and_first_swap_equals_jax(trained):
    """The loop: serve -> shift -> buffer -> fine-tune -> swap -> the
    detector recovers while a frozen engine degrades, at the JAX test's
    thresholds; the first swap fires at the JAX loop's poll with its
    trigger gateways."""
    ctl, front, engine, frozen, blocks, fired, monitor = _loop(trained, True)
    jctl, _, _, _, _, jfired, _ = _loop(trained, False)
    assert len(ctl.events) >= 1, "fine-tune never fired"
    assert fired and jfired
    assert fired[0] == jfired[0], (fired, jfired)
    for event in ctl.events:
        assert "params" in event["kinds"] and "thresholds" in event["kinds"]
    integ = ticket_integrity(blocks)
    assert integ["zero_dropped"], integ
    st = front.stats()
    assert st["rows_served"] == st["rows_submitted"]
    normals, behind, n = trained["normals"], 1.25, trained["n"]

    def eval_auc(score_fn, shift):
        r = np.random.default_rng(99)
        xs = np.concatenate([normals(r, 96, shift), normals(r, 96, -behind)])
        ys = np.concatenate([np.zeros(96), np.ones(96)])
        g = np.tile(np.arange(n, dtype=np.int32), -(-len(xs) // n))[:len(xs)]
        return host_auc(ys, score_fn(xs, g))

    auc_pre = eval_auc(frozen.score, 0.0)
    auc_live = eval_auc(engine.score, 1.8)
    auc_frozen = eval_auc(frozen.score, 1.8)
    assert auc_frozen < auc_pre - 0.1, (auc_pre, auc_frozen)
    assert auc_live > auc_frozen + 0.2, (auc_live, auc_frozen)
    assert auc_live > 0.85, auc_live
    assert monitor.report()["last_rebaseline"] is not None


def test_cli_flywheel_pass(tmp_path):
    """`python -m fedmse_tpu_torch.main ... --flywheel` on generated shards
    with the permissive knobs of tiny data: at least one swap, no ticket
    dropped, the report's keys."""
    import json

    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.main import main as port_main
    from tests.test_data import _write_client_csvs

    _write_client_csvs(str(tmp_path), 4, dim=DIM)
    cfg_path = tmp_path / "ds.json"
    cfg_path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(tmp_path), 4).to_json()))
    out = port_main([
        "--device", "cpu", "--dataset-config", str(cfg_path),
        "--network-size", "4", "--dim-features", str(DIM),
        "--model-types", "hybrid", "--update-types", "mse_avg",
        "--num-rounds", "2", "--checkpoint-dir", str(tmp_path / "ck"),
        "--flywheel", "--flywheel-min-rows", "24",
        "--flywheel-buffer-size", "64", "--flywheel-rounds", "2",
        "--flywheel-z", "0.5", "--flywheel-shift", "2.5"])
    rep = out["flywheel_smoke"]
    assert rep["swap_events"] >= 1 and rep["tickets"]["zero_dropped"]
    assert rep["batcher"]["rows_served"] == rep["batcher"]["rows_submitted"]
    assert rep["score_kind"] == "centroid"
    event = rep["events"][0]["flywheel"]
    assert event["finetune_engines_built"] >= 1
    assert event["install_seconds"] >= 0.0
    assert all(np.isfinite([rep["auc_pre_shift"],
                            rep["auc_post_shift_stale"],
                            rep["auc_post_shift_adapted"]]))
