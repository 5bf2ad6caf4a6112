"""The random streams of one (model_type, update_type, run) combination
(port of fedmse_tpu/utils/seeding.py::ExperimentRngs).

  * `data_rng`   numpy Generator seeded with data_seed: device sampling,
                 row shuffles and dev-set sampling, run-independent;
  * `select_rng` python Random(data_seed + 7919 (run + 1)): the per-round
                 client selection;
  * `generator`  a CPU torch.Generator seeded with run * run_seed_stride
                 (987654321 for run 0): model init and vote tie-breaks.

The first two are the JAX package's streams exactly, so data splits and
client selections are the same draws there and here. The third replaces
the JAX key stream; its numbers differ from jax.random's by design.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch


@dataclasses.dataclass
class ExperimentRngs:
    run: int
    data_seed: int = 1234
    run_seed_stride: int = 10000

    def __post_init__(self):
        run_seed = self.run * self.run_seed_stride
        self.data_rng = np.random.default_rng(self.data_seed)
        self.select_rng = random.Random(self.data_seed + 7919 * (self.run + 1))
        self.generator = torch.Generator().manual_seed(
            run_seed if run_seed != 0 else 987654321)
