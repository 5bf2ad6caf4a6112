"""The port stands alone: no module of fedmse_tpu_torch (nor chip_smoke.py)
imports jax or anything of the JAX package, and its entry points refuse to
drop to the CPU when CUDA is absent."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fedmse_tpu_torch
from fedmse_tpu_torch.checkpointing import (CheckpointManager, ResultsWriter,
                                            load_client_models)
from fedmse_tpu_torch.cluster import fit_assignments, nearest_cluster
from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.models import (init_stacked_params, make_model,
                                     params_from_numpy)
from fedmse_tpu_torch.federation import init_client_states
from fedmse_tpu_torch.federation.tiered import (TieredRoundEngine,
                                                run_tiered_combination)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.gateway.frontend import build_synthetic_frontend
from fedmse_tpu_torch.main import prepare_federation, run_experiment
from fedmse_tpu_torch.net.server import build_synthetic_replicas
from fedmse_tpu_torch.net.server import main as net_server_main
from fedmse_tpu_torch.parallel import launch as parallel_launch
from fedmse_tpu_torch.parallel.mesh import client_mesh
from fedmse_tpu_torch.parallel.multihost import initialize
from fedmse_tpu_torch.serving import ServingEngine
from fedmse_tpu_torch.tune import sites as tune_sites

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        fedmse_tpu_torch.__path__, prefix="fedmse_tpu_torch."))


# the red team's round half, the batched runs, the tiered layout, the
# flywheel with its slow-drift adversary, the autotuner, the network
# serving plane, the gateway ingest plane, the red team's ingest half, the
# client mesh with its rank entry, the real-data pipeline (the host
# CSV reader, the shard builder, the host utilities and the plots), and
# KitNET (its model, its kernels' wrappers and its plain reference)
NEW_MODULES = ("redteam", "redteam.spec", "redteam.masks",
               "redteam.adversary", "redteam.mimicry", "federation.batched",
               "federation.tiered", "flywheel", "flywheel.buffer",
               "flywheel.swap", "flywheel.controller", "flywheel.harness",
               "redteam.traffic", "tune", "tune.cache", "tune.measure",
               "tune.sites", "net", "net.wire", "net.admission",
               "net.autoscale", "net.router", "net.client", "net.server",
               "net.smoke", "gateway", "gateway.mux", "gateway.auth",
               "gateway.session", "gateway.stripe", "gateway.tls",
               "gateway.frontend", "gateway.client", "redteam.ingest",
               "parallel", "parallel.quantize", "parallel.mesh",
               "parallel.multihost", "parallel.costmodel",
               "parallel.collectives", "parallel.launch",
               "data.fast_csv", "data.prep", "utils.similarity",
               "utils.profiling", "utils.platform", "visualization",
               "models.kitnet", "ops.kitnet", "models.kitnet_reference")
EXAMPLES = ("minimal_federation_torch", "real_data_federation_torch",
            "serving_demo_torch", "flywheel_demo_torch")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_alone_without_jax(module):
    """Each module imported alone, in a fresh process, loads no jax and no
    module of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('fedmse_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas', "
        "'sklearn', 'matplotlib')) or "
        "m == 'fedmse_tpu' or m.startswith('fedmse_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for m in ("ops.fused_ae", "ops.fused_train", "serving.engine",
              "models.flat", "utils.seeding", "federation.optim",
              "federation.state", "federation.local_training",
              "federation.voting", "federation.aggregation",
              "federation.verification", "federation.rounds", "main",
              "federation.attack", "federation.elastic", "chaos",
              "chaos.spec", "chaos.masks", "chaos.metrics",
              "checkpointing.io", "cluster", "cluster.spec",
              "cluster.similarity", "cluster.assign", "cluster.merge",
              "data.synthetic", "data.stacking", *NEW_MODULES):
        assert "fedmse_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas')) or "
        "m == 'fedmse_tpu' or m.startswith('fedmse_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_training_driver_runs_as_a_module_without_jax(tmp_path):
    """`python -m fedmse_tpu_torch.main` parses its CLI, and the package's
    import graph (the module run as __main__ included) pulls in no jax,
    flax, optax, pandas or JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['fedmse_tpu_torch.main', '--help']\n"
        "try:\n"
        "    runpy.run_module('fedmse_tpu_torch.main', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas', "
        "'sklearn')) or m == 'fedmse_tpu' or m.startswith('fedmse_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--dataset-config" in out.stdout and "--device" in out.stdout


@pytest.mark.parametrize("entry", ["fedmse_tpu_torch.net.server",
                                   "fedmse_tpu_torch.gateway.frontend"])
def test_worker_entries_run_as_modules_without_jax(entry):
    """`python -m` of the network plane's worker and of the gateway
    frontend parses its CLI (with --device) and pulls in no jax, flax,
    optax, pandas or JAX package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{entry!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({entry!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas', "
        "'sklearn')) or m == 'fedmse_tpu' or m.startswith('fedmse_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device" in out.stdout and "--seed" in out.stdout


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


def _forbidden(name):
    return (name in ("jax", "fedmse_tpu")
            or name.startswith(("jax.", "jaxlib", "fedmse_tpu.")))


def test_chip_smoke_and_port_sources_import_neither_jax_nor_reference():
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                              "profile_dist.py")]
    paths += [os.path.join(REPO, "examples", f"{e}.py") for e in EXAMPLES]
    pkg = os.path.join(REPO, "fedmse_tpu_torch")
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        bad = sorted(n for n in _imported_roots(path) if _forbidden(n))
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_kitnet_reference_imports_nothing_of_the_port():
    """The plain reference the KitNET tests hold the port to imports
    torch, numpy and scipy only: no kernel, op or model of the port."""
    path = os.path.join(REPO, "fedmse_tpu_torch", "models",
                        "kitnet_reference.py")
    roots = {n.split(".")[0] for n in _imported_roots(path)}
    assert roots <= {"__future__", "math", "typing", "numpy", "torch",
                     "scipy"}, roots


def test_entry_points_refuse_cpu_fallback(no_cuda, tmp_path):
    clients = synthetic_clients(n_clients=2, dim=6, n_normal=20,
                                n_abnormal=5)
    model = make_model("autoencoder", 6, 4, 2, device="cpu")
    params = init_stacked_params(model, 2, device="cpu")
    cpu_data = stack_clients(clients, np.zeros((2, 6), np.float32), 4,
                             device="cpu")
    tiny = ExperimentConfig(dim_features=6, hidden_neus=4, latent_dim=2,
                            state_layout="tiered")
    calls = [
        lambda: make_model("autoencoder", 6, 4, 2),
        lambda: init_stacked_params(model, 2),
        lambda: params_from_numpy(params),
        lambda: stack_clients(clients, np.zeros((2, 6), np.float32), 4),
        lambda: ServingEngine(model, "autoencoder", params),
        lambda: ServingEngine.from_federation(model, "autoencoder", params),
        lambda: load_client_models(ResultsWriter(str(tmp_path), 2, "e", "s",
                                                 "AUC", 1.0),
                                   0, "autoencoder", "avg", ["a", "b"]),
        lambda: init_client_states(model, 2, torch.Generator()),
        lambda: CheckpointManager(str(tmp_path)).restore(
            "t", layout=ParamLayout.of(model)),
        lambda: prepare_federation(ExperimentConfig(dim_features=6),
                                   DatasetConfig.for_client_dirs(
                                       str(tmp_path), 2)),
        lambda: run_experiment(ExperimentConfig(dim_features=6),
                               DatasetConfig.for_client_dirs(
                                   str(tmp_path), 2)),
        lambda: fit_assignments(np.zeros((2, 3)),
                                np.tile(np.eye(3), (2, 1, 1)), 1),
        lambda: nearest_cluster(np.zeros((2, 3)),
                                np.tile(np.eye(3), (2, 1, 1)),
                                np.zeros((1, 3)), np.eye(3)[None], [2]),
        lambda: TieredRoundEngine(model, tiny, cpu_data, 2,
                                  ExperimentRngs(run=0), "autoencoder",
                                  "avg"),
        lambda: run_tiered_combination(tiny, cpu_data, 2, "autoencoder",
                                       "avg", 0),
        lambda: tune_sites.tune_serve_ladder(max_bucket=4),
        lambda: tune_sites.tune_tier_chunk(probe_clients=4),
        lambda: tune_sites.lookup_serve_ladder(4),
        lambda: build_synthetic_replicas(n_gateways=2, dim=6, replicas=1,
                                         max_batch=4),
        lambda: build_synthetic_frontend(n_gateways=2, dim=6, max_batch=4),
        lambda: net_server_main(["--gateways", "2", "--dim", "6",
                                 "--max-batch", "4"]),
        lambda: client_mesh(),
        lambda: initialize(store=object(), world_size=1, rank=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_rank_entry_runs_on_the_card_unless_asked(tmp_path):
    """`spawn` and `python -m fedmse_tpu_torch.parallel.launch` default to
    the card: a rank that sees none raises, naming device='cpu'."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(parallel_launch.RankJobError, match="device='cpu'"):
        parallel_launch.spawn(1, "json:dumps", workdir=str(tmp_path),
                              timeout_s=120, env=env)


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_and_shard_builder_refuse_cpu_fallback(no_cuda, tmp_path):
    """The examples and `python -m fedmse_tpu_torch.data.prep` run on the
    card unless told --device cpu: without one they raise, naming it."""
    from fedmse_tpu_torch.data import prep
    calls = [lambda e=e: _example(e).main(
        [str(tmp_path / "ds.json")] if e.startswith("real_data") else [])
        for e in EXAMPLES]
    calls.append(lambda: prep.main(["--source", str(tmp_path), "--out",
                                    str(tmp_path / "out"), "--n-clients",
                                    "2"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "out").exists()


def test_examples_import_only_the_port():
    """Each example, run as a script in a fresh process up to its argument
    parsing, loads no jax, JAX package, pandas, sklearn or matplotlib."""
    for e in EXAMPLES:
        code = (
            "import runpy, sys\n"
            f"sys.argv = [{e!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path('examples/{e}.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas', "
            "'sklearn', 'matplotlib')) or m == 'fedmse_tpu' or "
            "m.startswith('fedmse_tpu.'))\n"
            "assert not bad, bad\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, (e, out.stderr[-2000:])
        assert "--device" in out.stdout, e


SWEEPS = ("attack_sweep_torch", "chaos_sweep_torch", "churn_sweep_torch",
          "redteam_sweep_torch", "cluster_sweep_torch",
          "drift_recovery_sweep_torch", "paper_check_torch",
          "quirk_ablation_torch", "parity_probe_torch")


@pytest.mark.parametrize("script", SWEEPS + ("sweep_data_torch",))
def test_sweep_scripts_import_only_the_port(script):
    """Each sweep and study driver, run as a script in a fresh process
    up to its argument parsing (the shared sweep_data_torch.py imported),
    loads no jax, JAX package, bench harness, pandas or sklearn; nor does
    its source name one."""
    bad = sorted(n for n in _imported_roots(os.path.join(REPO,
                                                         f"{script}.py"))
                 if _forbidden(n) or n == "bench" or n.startswith("bench."))
    assert not bad, f"{script}.py imports {bad}"
    run = (f"runpy.run_path('{script}.py', run_name='__main__')"
           if script != "sweep_data_torch" else "import sweep_data_torch")
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}, '--help']\n"
        "try:\n"
        f"    {run}\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench') or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'pandas', "
        "'sklearn')) or m == 'fedmse_tpu' or m.startswith('fedmse_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    if script != "sweep_data_torch":
        assert "--device" in out.stdout and "--out" in out.stdout


def _sweep(name):
    import importlib
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module(name)


@pytest.mark.parametrize("argv", [
    ("attack_sweep_torch", []), ("chaos_sweep_torch", []),
    ("churn_sweep_torch", []), ("churn_sweep_torch", ["--podscale"]),
    ("redteam_sweep_torch", []), ("cluster_sweep_torch", []),
    ("cluster_sweep_torch", ["--podscale"]),
    ("drift_recovery_sweep_torch", []),
    ("drift_recovery_sweep_torch", ["--quick"]),
    ("paper_check_torch", ["no-such-tree"]),
    ("quirk_ablation_torch", []), ("quirk_ablation_torch", ["--paper-scale"]),
    ("parity_probe_torch", []), ("parity_probe_torch", ["--solo", "2"])],
    ids=lambda a: " ".join([a[0], *a[1]]))
def test_sweep_drivers_refuse_cpu_fallback(no_cuda, tmp_path, argv):
    """Without a card each driver raises before it builds anything or
    writes its artifact, naming device='cpu'."""
    script, args = argv
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _sweep(script).main([*args, "--out", str(out)])
    assert not out.exists()
