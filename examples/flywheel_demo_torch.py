"""Flywheel demo on the PyTorch port: train -> checkpoint -> serve a
drifting stream -> watch the fine-tune and the hot swap land.

examples/serving_demo_torch.py ends where the drift monitor flags a
shifted gateway; this closes the loop (fedmse_tpu_torch/flywheel/):

  1. train a small federation on synthetic normals and checkpoint it;
  2. rebuild the serving front from the checkpoint with the flywheel
     attached: a per-gateway reservoir of fresh normals fed by the
     continuous front, a drift monitor with a post-swap cooldown, and the
     controller that turns a sustained drift verdict into a federated
     fine-tune;
  3. stream normal traffic, then walk its distribution away from the
     calibration in stages;
  4. watch the monitor flag the walk, the controller fine-tune on the
     buffered normals (warm-started from the live weights), and one
     atomic swap install params and refit thresholds mid-stream, with no
     ticket dropped.

Runs on the card; pass `--device cpu` for the plain PyTorch versions:

    PYTHONPATH=. python examples/flywheel_demo_torch.py [--device cpu]
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
from fedmse_tpu_torch.flywheel import FlywheelBuffer, FlywheelController
from fedmse_tpu_torch.flywheel.harness import (stream_with_polling,
                                               ticket_integrity)
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                      ServingEngine, fit_calibration)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = resolve_device(p.parse_args(argv).device)
    n_clients, dim = 6, 16
    cfg = ExperimentConfig(network_size=n_clients, dim_features=dim,
                           hidden_neus=16, latent_dim=4, epochs=5,
                           num_rounds=3, flywheel_rounds=3,
                           flywheel_quorum=2, flywheel_cooldown=4,
                           flywheel_min_rows=48, flywheel_buffer_size=128)
    rngs = ExperimentRngs(run=0)

    # 1. train + checkpoint (the ClientModel layout)
    clients = synthetic_clients(n_clients=n_clients, dim=dim, seed=0)
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=dev)
    model = make_model("autoencoder", dim, cfg.hidden_neus, cfg.latent_dim,
                       device=dev)
    trainer = RoundEngine(model, cfg, data, n_real=n_clients, rngs=rngs,
                          model_type="autoencoder", update_type="mse_avg")
    trainer.run_rounds(0, cfg.num_rounds)
    print(f"trained {cfg.num_rounds} rounds")

    with tempfile.TemporaryDirectory() as ckpt_root:
        writer = ResultsWriter(ckpt_root, n_clients, "flywheel-demo",
                               cfg.scen_name, cfg.metric,
                               cfg.num_participants)
        names = [c.name for c in clients]
        save_client_models(writer, 0, "autoencoder", "mse_avg", names,
                           trainer.layout.tree(trainer.states.params))

        # 2. serving front + flywheel, everything reloaded from the files
        engine = ServingEngine.from_checkpoint(
            writer, model, "autoencoder", "mse_avg", names, run=0,
            max_bucket=64, device=dev)
        calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                                data.valid_m.cpu().numpy(), percentile=99.0)
        monitor = DriftMonitor(calib, z_threshold=0.5, min_batches=2,
                               cooldown_updates=cfg.flywheel_cooldown)
        buffer = FlywheelBuffer(n_clients, dim,
                                capacity=cfg.flywheel_buffer_size, seed=0)
        front = ContinuousBatcher(engine, max_batch=32,
                                  latency_budget_ms=1e9, calibration=calib,
                                  drift=monitor, intake=buffer.tap())
        controller = FlywheelController(
            front, monitor, buffer, model, "autoencoder", "mse_avg", cfg,
            dev_x=data.dev_x.cpu().numpy(), rounds=cfg.flywheel_rounds,
            quorum=cfg.flywheel_quorum, min_rows=cfg.flywheel_min_rows,
            cooldown_polls=4)

        # 3.-4. normal traffic, then the regime walks +1.2 and +2.4
        # feature-stds along a fixed direction
        rng = np.random.default_rng(7)
        u = rng.normal(size=dim)
        u /= np.linalg.norm(u)
        gws = np.tile(np.arange(n_clients, dtype=np.int32), 96)
        blocks = []
        for shift in (0.0, 1.2, 2.4, 2.4):
            rows = (rng.normal(size=(96 * n_clients, dim)) + shift * u
                    ).astype(np.float32)
            bs, events = stream_with_polling(front, controller, rows, gws,
                                             chunk=32)
            blocks.extend(bs)
            print(f"shift {shift:+.1f} std: {len(events)} swap(s), "
                  f"drifted gateways {monitor.report()['drifted_gateways']}"
                  f", buffer fill "
                  f"{buffer.occupancy()['fill_fraction']:.2f}")

        integ = ticket_integrity(blocks)
        print(f"swaps installed: {len(controller.events)} "
              f"(engine.swap_count={engine.swap_count})")
        print(f"tickets: {integ['rows_resolved']}/{integ['rows_submitted']} "
              f"resolved exactly once (zero_dropped="
              f"{integ['zero_dropped']})")
        return {"swaps": len(controller.events), **integ}


if __name__ == "__main__":
    main()
