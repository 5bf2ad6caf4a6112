"""Serving demo on the PyTorch port: train -> checkpoint -> calibrate ->
serve -> drift report, on synthetic data.

  1. train a small federation for a few rounds (RoundEngine);
  2. checkpoint it in the ClientModel layout (save_client_models);
  3. load it back as a serving process would
     (ServingEngine.from_checkpoint: only the files cross over);
  4. calibrate per-gateway verdict thresholds on validation normals;
  5. serve interleaved test traffic through the micro-batcher, with
     per-request latency accounting;
  6. stream a drifted gateway's traffic and watch the drift monitor flag
     it.

Runs on the card; pass `--device cpu` for the plain PyTorch versions:

    PYTHONPATH=. python examples/serving_demo_torch.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from fedmse_tpu_torch.checkpointing import ResultsWriter, save_client_models
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                   synthetic_clients)
from fedmse_tpu_torch.device import resolve_device
from fedmse_tpu_torch.federation import RoundEngine
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.serving import (DriftMonitor, MicroBatcher,
                                      ServingEngine, fit_calibration)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = resolve_device(p.parse_args(argv).device)
    n_clients, dim = 6, 16
    cfg = ExperimentConfig(network_size=n_clients, dim_features=dim,
                           hidden_neus=16, latent_dim=4, epochs=5,
                           num_rounds=3)
    rngs = ExperimentRngs(run=0)

    # 1. train
    clients = synthetic_clients(n_clients=n_clients, dim=dim, seed=0)
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=dev)
    model = make_model("hybrid", dim, cfg.hidden_neus, cfg.latent_dim,
                       cfg.shrink_lambda, device=dev)
    engine = RoundEngine(model, cfg, data, n_real=n_clients, rngs=rngs,
                         model_type="hybrid", update_type="mse_avg")
    results = engine.run_rounds(0, cfg.num_rounds)
    print(f"trained {cfg.num_rounds} rounds, final mean AUC "
          f"{float(np.nanmean(results[-1].client_metrics)):.4f}")

    def host(t):
        return t.cpu().numpy()

    with tempfile.TemporaryDirectory() as ckpt_root:
        # 2. checkpoint (the ClientModel layout)
        writer = ResultsWriter(ckpt_root, n_clients, "serving-demo",
                               cfg.scen_name, cfg.metric,
                               cfg.num_participants)
        names = [c.name for c in clients]
        save_client_models(writer, 0, "hybrid", "mse_avg", names,
                           engine.layout.tree(engine.states.params))

        # 3. a multi-tenant serving engine: every gateway's model at
        # once, rows routed by gateway id
        serving = ServingEngine.from_checkpoint(
            writer, model, "hybrid", "mse_avg", names, run=0,
            train_x=host(data.train_xb), train_m=host(data.train_mb),
            max_bucket=256, device=dev)

        # 4. verdict thresholds on validation normals
        calib = fit_calibration(serving, host(data.valid_x),
                                host(data.valid_m), percentile=95.0)
        calib.save(f"{ckpt_root}/calibration.json")
        print("thresholds:", np.round(calib.thresholds, 3).tolist())

        # 5. interleaved test traffic through the micro-batcher
        batcher = MicroBatcher(serving, max_batch=128, max_wait_ms=2.0,
                               calibration=calib)
        serving.warmup()
        test_x, test_y = host(data.test_x), host(data.test_y)
        test_m = host(data.test_m) > 0
        tickets, labels, stream_gws = [], [], []
        for r in range(test_m.shape[1]):
            for g in range(n_clients):
                if test_m[g, r] and len(tickets) < 1024:
                    tickets.append(batcher.submit(test_x[g, r], g))
                    labels.append(float(test_y[g, r]))
                    stream_gws.append(g)
        batcher.drain()
        stats = batcher.stats()
        verdicts = np.asarray([t.verdict for t in tickets])
        normal = ~(np.asarray(labels) > 0)
        agree = float(np.mean(verdicts == ~normal))
        print(f"served {stats['rows_served']} rows in "
              f"{stats['dispatches']} dispatches: "
              f"{stats['rows_per_sec_service']:.0f} rows/s (service), "
              f"p50 {stats['latency_p50_ms']:.2f} ms / "
              f"p99 {stats['latency_p99_ms']:.2f} ms")
        print(f"verdict/label agreement: {agree:.3f}")

        # drift baseline: the served normal rows' scores
        drift = DriftMonitor(calib, min_count=20)
        drift.update(np.asarray([t.score for t in tickets])[normal],
                     np.asarray(stream_gws)[normal])
        before = drift.report()["drifted_gateways"]
        print("drifted gateways after normal traffic:", before)

        # 6. gateway 0's traffic shifts: the monitor flags it
        batcher.drift = drift
        rng = np.random.default_rng(7)
        rows = test_x[0, test_m[0]][:128]
        shifted = rows + rng.normal(3.0, 0.5, size=rows.shape).astype(
            np.float32)
        for row in shifted:
            batcher.submit(row, 0)
        batcher.drain()
        report = drift.report()
        print("drifted gateways after gateway-0 traffic shift:",
              report["drifted_gateways"])
        return {"agreement": agree, "drifted_before": before,
                "drifted_after": report["drifted_gateways"],
                "rows_served": stats["rows_served"]}


if __name__ == "__main__":
    main()
