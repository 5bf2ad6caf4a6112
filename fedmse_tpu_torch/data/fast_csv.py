"""ctypes binding of the port's host CSV reader (csrc/fedmse_io.cpp; port of
fedmse_tpu/data/fast_csv.py).

The data layer parses every client's shards before round 0 (~70 MB of
numeric CSV at the 10-client N-BaIoT scale). The reader is a single-pass
strtod scan to float64, correctly rounded; ctypes releases the GIL for the
call, so `read_dir_f64` parses a directory's files on a thread pool.

The library builds with the host's C++ compiler at its first use
(ops/native.py, into build/fedmse_tpu_torch/). Nothing falls back: a
missing compiler or library, a malformed field, a short or wide row, or a
header where none is allowed raises RuntimeError naming the file.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from fedmse_tpu_torch.ops import native

_LOCK = threading.Lock()
_LIB = None

# fedmse_csv_parse's error codes
_PARSE_ERRORS = {-1: "cannot be read", -2: "has a malformed field",
                 -3: "has a short or wide row"}


def library() -> ctypes.CDLL:
    """The reader's library, built and its signatures set at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = native.load("fedmse_io")
            lib.fedmse_csv_dims.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
            lib.fedmse_csv_dims.restype = ctypes.c_int
            lib.fedmse_csv_parse.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
                ctypes.c_long, ctypes.c_long, ctypes.c_int]
            lib.fedmse_csv_parse.restype = ctypes.c_long
            _LIB = lib
    return _LIB


def csv_files(path: str) -> List[str]:
    """Every file of directory `path` whose name contains '.csv', sorted
    ([] when `path` is not a directory)."""
    if not os.path.isdir(path):
        return []
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if ".csv" in f]


def read_csv_f64(path: str, allow_header: bool = True) -> np.ndarray:
    """One numeric CSV as a [rows, cols] float64 array. A header line
    (a first field that is not a number) is skipped when `allow_header`,
    else refused."""
    lib = library()
    rows, cols, has_header = ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    rc = lib.fedmse_csv_dims(os.fsencode(path), ctypes.byref(rows),
                             ctypes.byref(cols), ctypes.byref(has_header))
    if rc != 0:
        raise RuntimeError(f"{path} cannot be read (fedmse_csv_dims {rc})")
    if has_header.value and not allow_header:
        raise RuntimeError(f"{path} has a header line")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    got = lib.fedmse_csv_parse(os.fsencode(path), out, rows.value,
                               cols.value, has_header.value)
    if got < 0:
        raise RuntimeError(f"{path} {_PARSE_ERRORS.get(got, 'is malformed')}"
                           f" (fedmse_csv_parse {got})")
    if got != rows.value:
        raise RuntimeError(f"{path}: parsed {got} of {rows.value} rows")
    return out


def read_dir_f64(path: str, max_workers: int = 8,
                 allow_header: bool = True) -> np.ndarray:
    """Every *.csv of a directory, parsed in parallel and concatenated in
    sorted file order."""
    files = csv_files(path)
    if not files:
        raise FileNotFoundError(f"no CSV files in {path}")
    library()  # build once, before the threads

    def read(f):
        return read_csv_f64(f, allow_header=allow_header)

    if len(files) == 1:
        return read(files[0])
    with ThreadPoolExecutor(max_workers=min(max_workers, len(files))) as pool:
        parts = list(pool.map(read, files))
    return np.concatenate(parts, axis=0)
