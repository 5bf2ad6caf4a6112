"""Minimal programmatic federation on the PyTorch port: the library API.

`python -m fedmse_tpu_torch.main` is the CLI; this is the library surface,
for embedding the federation in your own code. It uses synthetic data so
it needs no dataset; swap `synthetic_clients` for
`prepare_clients(DatasetConfig...)` to run on real shards
(examples/real_data_federation_torch.py).

Runs on the card; pass `--device cpu` to run the plain PyTorch versions of
the kernels on the CPU:

    PYTHONPATH=. python examples/minimal_federation_torch.py [--device cpu]
"""

import argparse

import numpy as np

from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                   synthetic_clients)
from fedmse_tpu_torch.device import resolve_device
from fedmse_tpu_torch.federation import RoundEngine
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import ExperimentRngs


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = resolve_device(p.parse_args(argv).device)
    n_clients, dim = 6, 16
    cfg = ExperimentConfig(network_size=n_clients, dim_features=dim,
                           hidden_neus=16, latent_dim=4, epochs=5,
                           num_rounds=3)
    rngs = ExperimentRngs(run=0)

    # per-client splits -> one set of stacked tensors with a leading
    # client axis, on the device
    clients = synthetic_clients(n_clients=n_clients, dim=dim, seed=0)
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=dev)

    # 'hybrid' = Shrink-AE with the centroid head; 'mse_avg' = FedMSE
    model = make_model("hybrid", dim, cfg.hidden_neus, cfg.latent_dim,
                       cfg.shrink_lambda, device=dev)
    engine = RoundEngine(model, cfg, data, n_real=n_clients, rngs=rngs,
                         model_type="hybrid", update_type="mse_avg")

    # one call per round: select -> local-train -> vote -> aggregate ->
    # verify -> evaluate (on the card one replay of the captured round)
    for r in range(cfg.num_rounds):
        res = engine.run_round(r)
        n_rejected = sum(1 for v in res.verification_results
                         if not v["is_verified"])
        print(f"round {r}: aggregator={res.aggregator} "
              f"selected={res.selected} "
              f"mean AUC={np.nanmean(res.client_metrics):.4f} "
              f"rejected={n_rejected}")

    # or a block of rounds in one call, as the CLI's chunked schedule does
    engine.reset_federation()
    results = engine.run_rounds(0, cfg.num_rounds)
    final = float(np.nanmean(results[-1].client_metrics))
    print("block of rounds, final mean AUC:", round(final, 4))
    return final


if __name__ == "__main__":
    main()
