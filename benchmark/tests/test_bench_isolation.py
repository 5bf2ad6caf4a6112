"""No process of the benchmark loads JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import subprocess
import sys

from benchmark.harness import BENCH, FORBIDDEN

ROOT = BENCH.parent


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_rehearsal_loads_no_jax_module():
    last = _run(
        "import time, torch\n"
        "from benchmark.harness import run_cell, forbidden_modules\n"
        "from benchmark.tests.tiny import CELLS, SEED, tiny_cell\n"
        "torch.set_num_threads(2)\n"
        "run_cell(tiny_cell(CELLS[0]), SEED, 0.3, False,\n"
        "         torch.device('cpu'), time.perf_counter())\n"
        "import sys\n"
        "assert 'fedmse_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    assert last == "[]"


def test_the_reference_loads_nothing_of_the_program():
    last = _run(
        "import sys\n"
        "import benchmark.reference.fedmse, benchmark.reference.compare\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'fedmse_tpu_torch', *%r}))\n" % (FORBIDDEN,))
    assert last == "[]"
