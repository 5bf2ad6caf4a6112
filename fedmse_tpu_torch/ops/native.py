"""Build and load the port's CUDA kernels.

Each source `fedmse_tpu_torch/csrc/<name>.cu` compiles with nvcc into its
own shared library with a plain C interface, loaded through ctypes. The
library lands in `build/fedmse_tpu_torch/` at the repository root, named by a
hash of its source and flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing builds at import: the first CUDA tensor that
reaches a kernel's wrapper builds it, and `build()` compiles several sources
at once, one nvcc process each (chip_smoke.py does this up front). nvcc's
register and shared-memory report (-Xptxas -v) is kept beside each library
as `<name>.log`.

`count_launch` is where each kernel wrapper counts: a call on a stream
that is being captured into a CUDA graph records its kernel without
launching it, so it counts in the wrapper's `captured` and not in its
`launches`; the graph adds its recorded kernels to `launches` at each
replay (ops/graphs.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fedmse_tpu_torch"
KERNEL_SOURCES = ("fused_ae", "fused_train", "dist_tiles")
# an earlier design kept as the yardstick of its successor: chip_smoke.py
# times it beside csrc/dist_tiles.cu; nothing in the package calls it
BASELINE_SOURCES = ("dist_tiles_baseline",)
# sm_90a keeps wgmma/setmaxnreg available to later kernels; no
# --use_fast_math: the kernels' sqrt and divisions must stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def count_launch(wrapper) -> None:
    """One kernel of `wrapper` went onto the current stream: a launch, or a
    recorded node when the stream is capturing a CUDA graph."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def find_nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns the build seconds per name (0.0
    where the library was already built)."""
    seconds = {name: 0.0 for name in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        seconds[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output from the last build of `name` ('' if none)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
