"""Padding the client axis leaves the port's federation as it is
(fedmse_tpu_torch/utils/seeding.py, federation/state.init_client_states):
the port's counterpart of tests/test_federation.py
`test_round_with_padded_clients_matches_unpadded`, from the port's OWN
init, at width 16 / 8 / 3 on 4 clients.

The run's generator draws the real clients' init and the tie-break
uniforms at the real width whatever the padding, and the pad clients'
init comes from a keyed stream of its own, so a padded run draws what
the unpadded run draws:

  * the real init rows and the real tie-break columns bit for bit, pad
    columns 0.5; three rounds' results and the real clients' states bit
    for bit (fused and per-phase, the tie-break on and off: the dense
    engines merge the real rows only, aggregation.real_rows_merge, as a
    matrix-vector product sums 4 rows and 8 rows in different orders),
    the JAX test's own bar (2e-3, the same aggregator) beside them;
  * the batched runs (R = 3) padded against unpadded, likewise;
  * the tier on a one-host 2-rank mesh whose cohort of 3 pads to 4 lanes
    against the tier at world 1 (tests/torch_mesh_jobs.py `tier_odd`),
    also above the tie-break's size rule (`tier_odd_keyed`);
  * an unpadded run draws what it always drew: its init is
    init_stacked_params(model, n, gen) and its draws torch.rand((R, S, n),
    generator=gen), so runs recorded before padding stopped mattering stay
    the port's output;
  * pad rows are finite, not zero, keyed by absolute client id and taken
    from no draw of the generator.
"""

import numpy as np
import pytest
import torch

from torch_mesh_common import close, rank_session
import torch_mesh_jobs as jobs
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.federation.state import (init_batched_client_states,
                                               init_client_states)
from fedmse_tpu_torch.federation.voting import make_mse_scores_fn
from fedmse_tpu_torch.models import init_stacked_params, make_model
from fedmse_tpu_torch.models.autoencoder import init_pad_params
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import (ExperimentRngs, make_run_rngs,
                                            pad_draws)

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N, PAD = 4, 8
BASE = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=N,
            epochs=3)
RUNS = 3


def _cfg(tie_break):
    return ExperimentConfig(**BASE,
                            compat=CompatConfig(vote_tie_break=tie_break))


def _data(pad_to=None):
    clients = synthetic_clients(n_clients=N, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         device="cpu")


def _model(cfg=None):
    return make_model("hybrid", *DIMS, 10.0 if cfg is None
                      else cfg.shrink_lambda, device="cpu")


def _engine(cfg, pad_to, fused):
    return RoundEngine(_model(cfg), cfg, _data(pad_to), n_real=N,
                       rngs=ExperimentRngs(run=0), model_type="hybrid",
                       update_type="mse_avg", fused=fused)


def _round(eng, r, selected=None):
    """One round and the tie-break draws it used ([S, N_pad]; None on the
    per-phase path, which draws inside its voter calls)."""
    if not eng.fused:
        return eng.run_round(r, selected=selected), None
    chunk = eng.dispatch_schedule_chunk(
        r, 1, schedule=None if selected is None else [list(selected)])
    return eng.harvest_schedule_chunk(chunk)[0][0], chunk.draws


def _same_round_bits(got, want):
    """A padded round's RoundResult against the unpadded one's: equal bit
    for bit on the real clients (NaN where NaN)."""
    assert got.selected == want.selected
    assert got.aggregator == want.aggregator
    assert got.verification_results == want.verification_results
    for field in ("client_metrics", "mse_scores", "tracking", "min_valid",
                  "metrics_full"):
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(a[:N], b, err_msg=field)
    if want.agg_weights is not None:
        np.testing.assert_array_equal(got.agg_weights[:N], want.agg_weights)
        assert not got.agg_weights[N:].any()


def _same_real_states(padded, plain, n=N):
    """The first n rows of every state tensor: the unpadded one's bits."""
    for a, b in zip(padded.tensors(), plain.tensors()):
        assert torch.equal(a[:n], b)


def _assert_pad_draws(padded, plain):
    """The padded draw's real columns are the unpadded draw's bits, its
    pad columns 0.5."""
    assert padded.shape[:-1] == plain.shape[:-1]
    assert torch.equal(padded[..., :plain.shape[-1]], plain)
    assert bool((padded[..., plain.shape[-1]:] == 0.5).all())


# ------------------------------------------- padded = unpadded, dense ----

@pytest.mark.parametrize("tie_break", [False, True], ids=["tie0", "tie1"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phase"])
def test_round_with_padded_clients_matches_unpadded(fused, tie_break):
    """4 clients padded to 8 from the port's own init: the unpadded
    federation's init rows, tie-break columns, round results and real
    states bit for bit over 3 rounds; the JAX test's bar beside them."""
    cfg = _cfg(tie_break)
    plain, padded = _engine(cfg, None, fused), _engine(cfg, PAD, fused)
    assert padded.states.params.shape[0] == PAD
    assert torch.equal(padded.states.params[:N], plain.states.params)
    want, want_draws = _round(plain, 0, selected=[0, 2])
    got, got_draws = _round(padded, 0, selected=[0, 2])
    _same_round_bits(got, want)
    np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                               atol=2e-3)
    assert got.aggregator == want.aggregator is not None
    if tie_break and fused:
        _assert_pad_draws(got_draws, want_draws)
    # the generators drew the same numbers (the per-phase voter calls too)
    assert torch.equal(padded.rngs.generator.get_state(),
                       plain.rngs.generator.get_state())
    _same_real_states(padded.states, plain.states)
    for r in (1, 2):
        got, got_draws = _round(padded, r)
        want, want_draws = _round(plain, r)
        _same_round_bits(got, want)
        if tie_break and fused:
            _assert_pad_draws(got_draws, want_draws)
    _same_real_states(padded.states, plain.states)
    np.testing.assert_array_equal(padded.evaluate(), plain.evaluate())


def test_batched_runs_padded_match_unpadded():
    """--batch-runs, R = 3 federations of 4 clients padded to 8 against
    unpadded (the tie-break on): each run's init rows, draw columns,
    round results and real states bit for bit over 3 rounds."""
    cfg = _cfg(True)

    def engine(pad_to):
        return BatchedRunEngine(_model(cfg), cfg, _data(pad_to), n_real=N,
                                runs=RUNS, model_type="hybrid",
                                update_type="mse_avg")

    plain, padded = engine(None), engine(PAD)
    for r in range(RUNS):
        assert torch.equal(padded.states.params.chunk(RUNS)[r][:N],
                           plain.states.params.chunk(RUNS)[r])
    active = np.ones(RUNS, bool)
    p_outs, p_sched, p_draws = plain.run_schedule_chunk(0, 3, active)
    g_outs, g_sched, g_draws = padded.run_schedule_chunk(0, 3, active)
    assert g_sched == p_sched
    _assert_pad_draws(g_draws, p_draws)
    for r in range(RUNS):
        for i in range(3):
            _same_round_bits(
                padded.process_round(r, i, g_sched[i][r], g_outs, i),
                plain.process_round(r, i, p_sched[i][r], p_outs, i))
        _same_real_states(
            padded.states.apply(lambda t: t.chunk(RUNS)[r]),
            plain.states.apply(lambda t: t.chunk(RUNS)[r]))


def test_per_phase_scores_draw_the_real_fleet():
    """make_mse_scores_fn(fleet=(lo, n_real)) jitters every block of a
    padded axis with its rows of the REAL fleet's draw (0.5 on pads):
    the blocks of 8 rows put together are the 4 real rows' unpadded
    scores bit for bit."""
    fn = make_mse_scores_fn(_model(), tie_break=True)
    params = init_client_states(_model(), N, torch.Generator().manual_seed(1),
                                n_pad=PAD, pad_key=(1, 2),
                                device="cpu").params
    x = torch.randn((30, DIMS[0]), generator=torch.Generator().manual_seed(2))
    m = torch.ones(30)
    want = fn(params[:N], x, m, torch.Generator().manual_seed(3))
    blocks = [fn(params[lo:lo + 2], x, m, torch.Generator().manual_seed(3),
                 fleet=(lo, N)) for lo in range(0, PAD, 2)]
    got = torch.cat(blocks)
    assert torch.equal(got[:N], want)
    base = make_mse_scores_fn(_model(), tie_break=False)(params, x, m)
    assert torch.equal(got[N:], base[N:])  # a factor of exactly 1


# ------------------------------------------------ the tier on 2 ranks ----

@pytest.fixture(scope="session")
def sessions(tmp_path_factory):
    return {2: rank_session(tmp_path_factory, 2)}


def test_tier_odd_cohort_on_two_ranks_matches_world_one(sessions):
    """12 clients, a cohort of 3 (ratio 0.25) and the tie-break on: on 2
    ranks the cohort pads to 4 lanes. The same selections, elections and
    verification rows as the tier at world 1, round 1's winning scores
    bit for bit (the real lanes' draws are world 1's), params within 1e-6
    scale-normalized, the final AUC within 2e-3."""
    ranks, _ = sessions[2]
    got = ranks[0]["tier_odd"]
    want = jobs.run_tier(None, ratio=0.25, tie_break=True)
    assert got["cohort"] == 4 and want["cohort"] == 3
    for a, b in zip(got["results"], want["results"], strict=True):
        assert a["selected"] == b["selected"]
        assert a["aggregator"] == b["aggregator"]
        assert a["verification_results"] == b["verification_results"]
    np.testing.assert_array_equal(got["results"][0]["mse_scores"],
                                  want["results"][0]["mse_scores"])
    close(got["params"], want["params"], 1e-6)
    assert abs(np.nanmean(got["final"]) - np.nanmean(want["final"])) <= 2e-3
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tier_odd"]["params"], got["params"])


def test_keyed_tier_odd_cohort_on_two_ranks_matches_world_one(sessions):
    """The same above the tie-break's size rule (lowered to 0): keyed rows
    read absolute client ids, so the cohort of 3 padded to 4 lanes on 2
    ranks elects what world 1 elects, round 1's winning scores bit for
    bit, with no [S, C] draws on either side."""
    ranks, _ = sessions[2]
    got = ranks[0]["tier_odd_keyed"]
    want = jobs.run_tier(None, ratio=0.25, tie_break=True, sheet_bytes=0)
    assert got["keyed"] and want["keyed"]
    assert got["cohort"] == 4 and want["cohort"] == 3
    for a, b in zip(got["results"], want["results"], strict=True):
        assert a["selected"] == b["selected"]
        assert a["aggregator"] == b["aggregator"]
        assert a["verification_results"] == b["verification_results"]
    np.testing.assert_array_equal(got["results"][0]["mse_scores"],
                                  want["results"][0]["mse_scores"])
    close(got["params"], want["params"], 1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tier_odd_keyed"]["params"],
                                      got["params"])


# ------------------------------------- an unpadded run's draws, pinned ----

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phase"])
def test_unpadded_run_draws_as_before(fused):
    """An unpadded engine's init is init_stacked_params(model, n, gen)
    and its tie-break draws the generator's next uniforms: a fused chunk
    torch.rand((R, S, n)), a per-phase voter call torch.rand(n)."""
    cfg = _cfg(True)
    eng = _engine(cfg, None, fused)
    gen = ExperimentRngs(run=0).generator
    init = LAYOUT.flatten(init_stacked_params(_model(cfg), N, gen,
                                              device="cpu"))
    assert torch.equal(eng.states.params, init)
    if fused:
        chunk = eng.dispatch_schedule_chunk(0, 2)
        eng.harvest_schedule_chunk(chunk)
        S = eng.cohort_size()
        assert torch.equal(chunk.draws, torch.rand((2, S, N), generator=gen))
    else:
        calls = []
        scores_fn = eng.scores_fn

        def counted(*args, **kw):
            calls.append(1)
            return scores_fn(*args, **kw)
        eng.scores_fn = counted
        eng.run_round(0, selected=[0, 2])
        for _ in calls:
            torch.rand(N, generator=gen)
    assert torch.equal(eng.rngs.generator.get_state(), gen.get_state())


def test_unpadded_batched_init_is_each_runs_own():
    model = _model()
    rngs = make_run_rngs(RUNS)
    states = init_batched_client_states(model, [r.generator for r in rngs],
                                        N, device="cpu")
    for r in range(RUNS):
        gen = ExperimentRngs(run=r).generator
        want = LAYOUT.flatten(init_stacked_params(model, N, gen,
                                                  device="cpu"))
        assert torch.equal(states.params.chunk(RUNS)[r], want)


def test_vote_draws_pad_columns():
    a, b = ExperimentRngs(run=0), ExperimentRngs(run=0)
    got = a.vote_draws(3, 2, N, width=PAD)
    want = torch.rand((3, 2, N), generator=b.generator)
    _assert_pad_draws(got, want)
    assert torch.equal(a.vote_draws(1, 2, N), b.vote_draws(1, 2, N))
    assert pad_draws(want, N) is want


# ---------------------------------------------------------- pad rows ----

def test_pad_rows_finite_keyed_and_drawn_from_no_generator():
    model = _model()
    key = ExperimentRngs(run=0).init_pad_key()
    gen, twin = torch.Generator().manual_seed(4), \
        torch.Generator().manual_seed(4)
    states = init_client_states(model, N, gen, n_pad=PAD, pad_key=key,
                                device="cpu")
    init_stacked_params(model, N, twin, device="cpu")
    assert torch.equal(gen.get_state(), twin.get_state())
    pads = states.params[N:]
    assert bool(torch.isfinite(pads).all())
    for name, off, shape in LAYOUT.leaves():
        leaf = pads[:, off:off + int(np.prod(shape))]
        if len(shape) == 2:  # a kernel [fan_in, fan_out]
            assert bool((leaf != 0).any(dim=1).all()), name
            assert float(leaf.abs().max()) <= 1.0 / shape[0] ** 0.5, name
        else:
            assert not leaf.any(), name
    # keyed by absolute client id: the same rows whatever the padding
    wider = init_client_states(model, N, torch.Generator().manual_seed(4),
                               n_pad=PAD + 3, pad_key=key, device="cpu")
    assert torch.equal(wider.params[:PAD], states.params)
    alone = LAYOUT.flatten(init_pad_params(model, [5], key, device="cpu"))
    assert torch.equal(alone[0], states.params[5])
    assert not torch.equal(states.params[4], states.params[5])
    with pytest.raises(ValueError, match="pad_key"):
        init_client_states(model, N, gen, n_pad=PAD, device="cpu")
