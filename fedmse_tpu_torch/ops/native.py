"""Build and load the port's CUDA kernels and its host library.

Each source `fedmse_tpu_torch/csrc/<name>.cu` compiles with nvcc into its
own shared library with a plain C interface, loaded through ctypes. The
library lands in `build/fedmse_tpu_torch/` at the repository root, named by a
hash of its source and flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing builds at import: the first CUDA tensor that
reaches a kernel's wrapper builds it, and `build()` compiles several sources
at once, one compiler process each (chip_smoke.py does this up front).
nvcc's register and shared-memory report (-Xptxas -v) is kept beside each
library as `<name>.log`.

The host library `csrc/<name>.cpp` (the CSV reader, `HOST_SOURCES`) takes
the same route with the host's C++ compiler ($CXX, else g++) in place of
nvcc: built at its first use, which is a read, so it builds and runs on a
machine without a card too. A missing compiler or a failed build raises.

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
KERNEL_SOURCES = ("fused_ae", "fused_train", "dist_tiles", "adam_update",
                  "kitnet")
# an earlier design kept as the yardstick of its successor: chip_smoke.py
# times it beside csrc/dist_tiles.cu; nothing in the package calls it
BASELINE_SOURCES = ("dist_tiles_baseline",)
# host C++ (csrc/<name>.cpp): the data layer's CSV reader
HOST_SOURCES = ("fedmse_io",)
# portable code (no -march=native): strtod parsing is not bound by vector
# width, and the library must load on any host of the architecture
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
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


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} ($CXX, else g++ on "
                           "PATH); the host library cannot build")
    return path


def _source(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES
                       else f"{name}.cu")


def _flags(name: str) -> Sequence[str]:
    return CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes() + " ".join(
        _flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all compiler
    processes started together (nvcc for a kernel, the host compiler for
    a HOST_SOURCES library). Returns the build seconds per name (0.0
    where the library was already built)."""
    seconds = {name: 0.0 for name in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return seconds
    compilers = {n: find_cxx() if n in HOST_SOURCES else find_nvcc()
                 for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compilers[name], *_flags(name), "-o", str(tmp),
               str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(compilers[name])} failed "
                            f"for csrc/{_source(name).name} "
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
    """The loaded library for csrc/<name>.cu (or .cpp), built first if
    needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
