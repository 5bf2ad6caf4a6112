"""Shared set-up of the network and gateway planes' port tests: the JAX
plane of tests/test_net.py and the port's plane over the SAME federation
(the JAX init exported as numpy, the same numpy train, calibration and
traffic rows), each a Router over replicas of its own package."""

import time

import numpy as np
import torch

import jax

from fedmse_tpu.models import init_stacked_params as jax_init_params
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.net.admission import AdmissionController as JaxAdmission
from fedmse_tpu.net.router import Router as JaxRouter
from fedmse_tpu.net.router import make_local_replicas as jax_replicas
from fedmse_tpu.serving import ServingEngine as JaxEngine
from fedmse_tpu.serving import fit_calibration as jax_fit_calibration
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.net.admission import AdmissionController
from fedmse_tpu_torch.net.router import Router, make_local_replicas
from fedmse_tpu_torch.serving import ServingEngine, fit_calibration

torch.set_num_threads(1)

DIM = 12
N = 4


def jax_params(model_type, seed, n=N, dim=DIM):
    """The JAX package's stacked init, as numpy."""
    jm = jax_make_model(model_type, dim, shrink_lambda=1.0)
    return jax.tree.map(np.asarray,
                        jax_init_params(jm, jax.random.key(seed), n))


def port_engine(model_type, params, train_x, max_batch, **kw):
    model = make_model(model_type, DIM, shrink_lambda=1.0, device="cpu")
    return ServingEngine.from_federation(
        model, model_type, params, train_x=train_x, max_bucket=max_batch,
        device="cpu", **kw)


def planes(n_replicas=2, max_batch=32, seed=0, tiers=3, capacity=None,
           clock=None, roster=None, model_type="hybrid", budget_ms=1e9,
           jax_plane=True):
    """(port router, JAX router or None, port calibration, rows, gws,
    numpy params, train_x): tests/test_net.py's `_plane` built twice from
    one init. `clock` (frozen, injected) drives admission and both
    routers; the replica batchers keep the real clock (the loopback
    tests need budget-expiry flushes: pass a finite `budget_ms`)."""
    rng = np.random.default_rng(seed)
    params = jax_params(model_type, seed)
    train_x = rng.normal(size=(N, 60, DIM)).astype(np.float32)
    valid = rng.normal(size=(N, 120, DIM)).astype(np.float32)
    rows = rng.normal(size=(600, DIM)).astype(np.float32)
    gws = rng.integers(0, N, 600).astype(np.int32)
    kw = {} if clock is None else {"clock": clock}

    engines = [port_engine(model_type, params, train_x, max_batch)
               for _ in range(n_replicas)]
    cal = fit_calibration(engines[0], valid)
    adm = AdmissionController(tiers=tiers, headroom=1.0, burst_s=1.0, **kw)
    if capacity is not None:
        adm.set_capacity(capacity)
    router = Router(make_local_replicas(
        lambda i: engines[i], n_replicas, max_batch=max_batch,
        latency_budget_ms=budget_ms, calibration=cal),
        admission=adm, roster=roster, **kw)

    jrouter = None
    if jax_plane:
        jm = jax_make_model(model_type, DIM, shrink_lambda=1.0)
        jengines = [JaxEngine.from_federation(
            jm, model_type, params, train_x=train_x, max_bucket=max_batch)
            for _ in range(n_replicas)]
        jcal = jax_fit_calibration(jengines[0], valid)
        jadm = JaxAdmission(tiers=tiers, headroom=1.0, burst_s=1.0, **kw)
        if capacity is not None:
            jadm.set_capacity(capacity)
        jrouter = JaxRouter(jax_replicas(
            lambda i: jengines[i], n_replicas, max_batch=max_batch,
            latency_budget_ms=budget_ms, calibration=jcal),
            admission=jadm, roster=roster, **kw)
    return router, jrouter, cal, rows, gws, params, train_x


def wait_for(pred, timeout_s=20.0, tick=0.005):
    """Poll `pred` until true; raise after `timeout_s` (every socket test
    bounds its waits)."""
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            raise TimeoutError("condition not met in time")
        time.sleep(tick)
