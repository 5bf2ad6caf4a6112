"""The port's host CSV reader (fedmse_tpu_torch/csrc/fedmse_io.cpp through
data/fast_csv.py) against the JAX package's native reader and pandas'
round-trip parser, bit for bit, on the cases of tests/test_native_io.py;
the port's `load_data` against the JAX package's `load_data`.

Where the two packages differ on purpose, the port's behaviour has its own
assertions: the port has no pandas fallback, so a header where none is
allowed, a ragged or wide row and a malformed field raise RuntimeError
naming the file, and a missing compiler raises."""

import os

import numpy as np
import pandas as pd
import pytest

from fedmse_tpu.data.fast_csv import native_available
from fedmse_tpu.data.fast_csv import read_csv_f64 as ref_read_csv
from fedmse_tpu.data.fast_csv import read_dir_f64 as ref_read_dir
from fedmse_tpu.data.loader import load_data as ref_load_data
from fedmse_tpu_torch.data.fast_csv import read_csv_f64, read_dir_f64
from fedmse_tpu_torch.data.loader import load_data
from fedmse_tpu_torch.ops import native

needs_ref = pytest.mark.skipif(not native_available(),
                               reason="the JAX package's reader did not build")


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _scientific(rng):
    vals = rng.standard_normal((50, 7)) * 10.0 ** rng.integers(-12, 12,
                                                               (50, 7))
    return pd.DataFrame(vals).to_csv(header=False, index=False)


# the cases of tests/test_native_io.py: {file name: text}, and whether the
# first line is a header for pandas
CASES = {
    "basic": ({"a.csv": "1.5,2.0,-3.25\n4.0,5e-3,6.0\n"}, False),
    "header": ({"a.csv": "col_a,col_b,col_c\n1.0,2.0,3.0\n"}, True),
    "crlf_no_trailing_newline": ({"a.csv": "1.0,2.0\r\n3.0,4.0"}, False),
    "scientific": ({"a.csv": _scientific(np.random.default_rng(0))}, False),
    "sorted_dir": ({"b.csv": "3.0,4.0\n", "a.csv": "1.0,2.0\n"}, False),
    "blank_lines": ({"a.csv": "1.0,2.0\n\n3.0,4.0\n\n"}, False),
}


def _pandas(path, header):
    return np.concatenate([
        pd.read_csv(os.path.join(path, f), header=0 if header else None,
                    float_precision="round_trip").values.astype(np.float64)
        for f in sorted(os.listdir(path))])


@needs_ref
@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_reference_and_pandas_bits(tmp_path, case):
    files, header = CASES[case]
    for name, text in files.items():
        write(tmp_path / name, text)
    got = read_dir_f64(str(tmp_path))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref_read_dir(str(tmp_path)))
    np.testing.assert_array_equal(got, _pandas(str(tmp_path), header))
    for name in files:
        one = str(tmp_path / name)
        np.testing.assert_array_equal(read_csv_f64(one), ref_read_csv(one))


def test_read_dir_threads_match_one_file_at_a_time(tmp_path, rng):
    parts = [rng.normal(size=(int(rng.integers(1, 40)), 9)) * 1e3
             for _ in range(12)]
    for i, p in enumerate(parts):
        pd.DataFrame(p).to_csv(tmp_path / f"part{i:02d}.csv", header=False,
                               index=False)
    got = read_dir_f64(str(tmp_path), max_workers=4)
    np.testing.assert_array_equal(got, np.concatenate(parts))
    np.testing.assert_array_equal(got, np.concatenate([
        read_csv_f64(str(tmp_path / f"part{i:02d}.csv"))
        for i in range(12)]))


@needs_ref
@pytest.mark.parametrize("dtype", [np.float32, None])
def test_load_data_matches_reference_bits(tmp_path, rng, dtype):
    vals = rng.standard_normal((30, 5)) * 10.0 ** rng.integers(-6, 6, (30, 5))
    pd.DataFrame(vals[:17]).to_csv(tmp_path / "a.csv", header=False,
                                   index=False)
    pd.DataFrame(vals[17:]).to_csv(tmp_path / "b.csv", header=False,
                                   index=False)
    got = load_data(str(tmp_path), dtype=dtype)
    want = ref_load_data(str(tmp_path), dtype=dtype).values
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        load_data(str(tmp_path), dtype=None),
        np.concatenate([np.loadtxt(tmp_path / f, delimiter=",", ndmin=2)
                        for f in ("a.csv", "b.csv")]))


def test_header_line_raises_in_load_data(tmp_path):
    """Where the JAX loader falls back to pandas and keeps the header as a
    row of NaN, the port refuses the file by name."""
    write(tmp_path / "data.csv", "h1,h2\n1.0,2.0\n")
    with pytest.raises(RuntimeError, match="data.csv has a header line"):
        load_data(str(tmp_path))
    np.testing.assert_array_equal(read_csv_f64(str(tmp_path / "data.csv")),
                                  [[1.0, 2.0]])
    with pytest.raises(RuntimeError, match="has a header line"):
        read_csv_f64(str(tmp_path / "data.csv"), allow_header=False)


def test_numeric_first_row_is_data(tmp_path):
    """tests/test_native_io.py's explicit-header case: the port has no
    header index, so a numeric first row is data, as in the JAX package's
    default load."""
    write(tmp_path / "data.csv", "9.0,9.0\n1.0,2.0\n")
    np.testing.assert_array_equal(load_data(str(tmp_path), dtype=None),
                                  [[9.0, 9.0], [1.0, 2.0]])


@pytest.mark.parametrize("text, what", [
    ("1.0,2.0\n3.0\n", "short or wide row"),       # short (the JAX
    ("1.0,2.0\n3.0,4.0,5.0\n", "short or wide row"),  # loader falls back)
    ("1.0,abc\n", "malformed field"),
])
def test_ragged_wide_and_malformed_files_raise(tmp_path, text, what):
    write(tmp_path / "a.csv", text)
    with pytest.raises(RuntimeError, match=f"a.csv has a {what}"):
        read_csv_f64(str(tmp_path / "a.csv"))
    with pytest.raises(RuntimeError, match=what):
        load_data(str(tmp_path))


def test_missing_directory_and_empty_directory_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_data(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        read_dir_f64(str(tmp_path))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: without the library and without a compiler the build
    raises, naming $CXX."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler-fedmse")
    with pytest.raises(RuntimeError, match="no-such-compiler-fedmse"):
        native.build(native.HOST_SOURCES)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DFEDMSE_NO_SUCH=1", "-x",
                                            "no-such-language"))
    with pytest.raises(RuntimeError, match="failed for csrc/fedmse_io.cpp"):
        native.build(native.HOST_SOURCES)


def test_host_library_is_hash_named_in_the_build_dir():
    path = native.library_path("fedmse_io")
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libfedmse_io-") and path.suffix == ".so"
