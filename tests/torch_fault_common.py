"""Shared set-up of the fault-path tests of the port (test_torch_attack.py,
test_torch_chaos.py, test_torch_elastic.py, test_torch_resume.py).

Both packages start from ONE init (the JAX init exported as numpy) with
the vote tie-break off, at width 16 / 8 / 3 on 4 clients, 2 epochs. The
fault streams of the two packages differ (jax.random against the port's
numpy streams), so a pair feeds the JAX engine's chaos masks to the port
by replacing the port engine's mask source, and its membership timeline
through `elastic_masks=`, which both engines take.
"""

import numpy as np
import torch

import jax

from fedmse_tpu.chaos import ChaosSpec as JaxChaosSpec
from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.federation import AttackSpec as JaxAttackSpec
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec
from fedmse_tpu.federation import RoundEngine as JaxEngine
from fedmse_tpu.federation import make_poison_fn as jax_make_poison_fn
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.chaos import ChaosMasks, ChaosSpec
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine, client_states_from_numpy
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.elastic import ElasticSpec, MembershipMasks
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N = 4
BASE = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=N,
            epochs=2)
DATA = dict(n_clients=N, dim=16, n_normal=240, n_abnormal=120, seed=0)


def flat(tree) -> torch.Tensor:
    """A JAX param tree as the port's flat [N, P] f32."""
    return LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)), tree))


def port_cfg(tie_break=False, **kw) -> ExperimentConfig:
    return ExperimentConfig(**{**BASE, **kw},
                            compat=CompatConfig(vote_tie_break=tie_break))


def port_data(cfg, seed=0, pad_to=None):
    clients = synthetic_clients(**{**DATA, "seed": seed})
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         device="cpu")


def port_engine(cfg=None, model_type="hybrid", update_type="mse_avg",
                states=None, fused=True, data=None, run=0, **hooks):
    """A port engine on the CPU with its own streams; `hooks` are the
    RoundEngine's poison_fn / chaos / elastic / elastic_masks / profile."""
    cfg = cfg or port_cfg()
    return RoundEngine(
        make_model(model_type, *DIMS, cfg.shrink_lambda, device="cpu"), cfg,
        data if data is not None else port_data(cfg), n_real=N,
        rngs=ExperimentRngs(run=run), model_type=model_type,
        update_type=update_type, states=states, fused=fused, **hooks)


def pair(model_type="hybrid", update_type="mse_avg", *, attack=None,
         chaos=None, elastic=None, horizon=6, fused=True, **kw):
    """(JAX engine, port engine) from one init and data, with the same
    specs (given as keyword dicts) and the JAX engine's chaos masks and
    membership timeline over `horizon` rounds fed to the port."""
    cfg_kw = {**BASE, **kw}
    jcfg = JaxConfig(**cfg_kw, compat=JaxCompat(vote_tie_break=False))
    tcfg = port_cfg(**kw)
    jclients = jax_synthetic(**DATA)
    tclients = synthetic_clients(**DATA)
    dev_x = np.concatenate([c.dev_raw for c in tclients])[:200].astype(
        np.float32)
    jhooks, thooks = {}, {}
    if attack is not None:
        jhooks["poison_fn"] = jax_make_poison_fn(JaxAttackSpec(**attack))
        thooks["poison_fn"] = make_poison_fn(AttackSpec(**attack))
    if chaos is not None:
        jhooks["chaos"] = JaxChaosSpec(**chaos)
        thooks["chaos"] = ChaosSpec(**chaos)
    if elastic is not None:
        jhooks["elastic"] = JaxElasticSpec(**elastic)
        thooks["elastic"] = ElasticSpec(**elastic)
    jeng = JaxEngine(jax_make_model(model_type, *DIMS, jcfg.shrink_lambda),
                     jcfg, jax_stack(jclients, dev_x, 12), n_real=N,
                     rngs=JaxRngs(run=0), model_type=model_type,
                     update_type=update_type, fused=fused, **jhooks)
    if elastic is not None:
        thooks["elastic_masks"] = MembershipMasks(*(
            np.asarray(m) for m in jeng._elastic_masks(0, horizon)))
    init = client_states_from_numpy(
        jax.tree.map(np.array, jeng.states), LAYOUT, device="cpu")
    teng = port_engine(tcfg, model_type, update_type, states=init,
                       fused=fused,
                       data=stack_clients(tclients, dev_x, 12, device="cpu"),
                       **thooks)
    if chaos is not None:
        feed_chaos(teng, jeng._chaos_masks(0, horizon))
    return jeng, teng


def feed_chaos(engine, masks) -> None:
    """Replace the port engine's chaos-mask source with `masks` (any
    [T, ...] four-field masks, e.g. the JAX engine's)."""
    held = ChaosMasks(*(np.asarray(m) for m in masks))
    engine._chaos_masks = lambda start, n: ChaosMasks(
        *(m[start:start + n] for m in held))


def leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst scale-normalized error over the layout's leaves."""
    return max(float((got[:, sl] - want[:, sl]).abs().max()
                     / want[:, sl].abs().max().clamp_min(1e-30))
               for sl in LAYOUT.slices())


def assert_matches_jax(jres, tres, jeng, teng, tol=1e-5):
    """The JAX-fed port rounds against the JAX engine's: the same
    selections, aggregators, crashed aggregators, effective cohorts,
    members, generations and verification rows; metrics, divergence and
    every state leaf within `tol` scale-normalized."""
    for want, got in zip(jres, tres):
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.crashed_aggregator == want.crashed_aggregator
        assert got.effective == want.effective
        assert got.members == want.members
        assert got.verification_results == want.verification_results
        if want.generations is None:
            assert got.generations is None
        else:
            np.testing.assert_array_equal(got.generations, want.generations)
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        if want.divergence is None:
            assert got.divergence is None
        else:
            scale = max(float(np.abs(want.divergence).max()), 1e-30)
            assert float(np.abs(got.divergence - want.divergence).max()) \
                <= tol * scale
    for name in ("params", "prev_global", "hist_params"):
        assert leaf_err(getattr(teng.states, name),
                        flat(getattr(jeng.states, name))) <= tol, name
    np.testing.assert_array_equal(teng.states.rejected.numpy(),
                                  np.asarray(jeng.states.rejected))
    np.testing.assert_array_equal(teng.host.aggregation_count,
                                  jeng.host.aggregation_count)


def assert_same_round(got, want, observables=True):
    """Two port RoundResults equal bit for bit (NaN where NaN);
    `observables=False` skips the fault observables, which the per-phase
    path does not report."""
    hooks = ("effective", "crashed_aggregator", "members", "divergence",
             "generations") if observables else ()
    for field in ("selected", "aggregator", "verification_results",
                  *hooks[:3]):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("client_metrics", "mse_scores", "agg_weights", "tracking",
                  "min_valid", "metrics_full", *hooks[3:]):
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def assert_same_states(a, b):
    for name in ("params", "prev_global", "hist_params", "hist_perf",
                 "hist_seen", "rejected", "waived"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(x, y)
