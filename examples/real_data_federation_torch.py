"""Programmatic federation on dataset shards, on the PyTorch port.

The flow of examples/minimal_federation_torch.py fed from a DatasetConfig
JSON (every file under configs/ works, or the JSON beside shards that
`python -m fedmse_tpu_torch.data.prep` wrote). The CLI equivalent is
`python -m fedmse_tpu_torch.main --dataset-config <json>`; use this form
to get the per-round RoundResult objects in your own code.

    PYTHONPATH=. python examples/real_data_federation_torch.py \\
        configs/nbaiot-10clients-iid.json [--data-root DIR] [--device cpu]
"""

import argparse
import dataclasses

import numpy as np

from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
from fedmse_tpu_torch.data import (build_dev_dataset, prepare_clients,
                                   stack_clients)
from fedmse_tpu_torch.device import resolve_device
from fedmse_tpu_torch.federation import RoundEngine
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import ExperimentRngs


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", help="DatasetConfig JSON")
    p.add_argument("--data-root", default=None)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    dataset = DatasetConfig.from_json(args.config, args.data_root)
    # network_size must match the config's device count: prepare_clients
    # draws a network_size subset when the config lists more
    cfg = ExperimentConfig(num_rounds=args.rounds, epochs=args.epochs,
                           network_size=len(dataset.devices_list))
    rngs = ExperimentRngs(run=0)

    clients = prepare_clients(dataset, cfg, rngs.data_rng)
    # the model's width is the shards' (115 for N-BaIoT)
    cfg = dataclasses.replace(cfg, dim_features=clients[0].train_x.shape[1])
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=dev)
    model = make_model("hybrid", cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda, device=dev)
    engine = RoundEngine(model, cfg, data, n_real=len(clients), rngs=rngs,
                         model_type="hybrid", update_type="mse_avg")

    final = float("nan")
    for r in range(cfg.num_rounds):
        res = engine.run_round(r)
        final = float(np.nanmean(res.client_metrics))
        print(f"round {r}: aggregator={res.aggregator} "
              f"mean AUC={final:.4f}")
    return final


if __name__ == "__main__":
    main()
