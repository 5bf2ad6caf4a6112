"""Cells of BENCHMARK.json cut to the sizes their driver's TINY gives, for
rehearsals on the CPU."""

import json
import logging

from benchmark.harness import BENCH, Cell

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 12345


def tiny_cell(name: str) -> Cell:
    logging.getLogger("fedmse_tpu_torch").setLevel(logging.CRITICAL)
    cell = Cell(SPEC, name)
    cell.config.update(cell.driver.TINY["config"])
    cell.traffic.update(cell.driver.TINY["traffic"])
    cell.dims = (cell.config["dim_features"], cell.config["hidden_neus"],
                 cell.config["latent_dim"])
    return cell
