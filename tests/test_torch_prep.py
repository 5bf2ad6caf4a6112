"""The port's shard builder (fedmse_tpu_torch/data/prep.py) against the JAX
package's (fedmse_tpu/data/prep.py) on the CSV trees of tests/test_aux.py:
every shard the port writes parses to the reference's float64 bits, the
JS distances agree to 1e-12. Raw ingest picks the reference's rows; the
reference parses raw files with pandas' default parser, which is not
correctly rounded, so its values are held bit for bit with pandas'
round-trip parser patched in, and to relative 1e-12 without. The port's
k-means stands in for sklearn's KMeans, so cluster labels are held up to
a permutation on separated modes."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from fedmse_tpu.data import prep as ref
from fedmse_tpu_torch.data import prep
from fedmse_tpu_torch.data.fast_csv import read_csv_f64
from tests.test_aux import _write_raw_device_tree
from tests.test_data import _write_client_csvs


def _tree(root):
    """{relative shard path: float64 rows} of a shard tree."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = read_csv_f64(
                os.path.join(d, f), allow_header=False)
    return out


def _assert_same_trees(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    assert got, "no shards written"
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _both(tmp_path, src=None, **kw):
    """The two packages' create_federated_shards on one source; returns
    (port JS, reference JS) after holding the trees equal bit for bit."""
    js = prep.create_federated_shards(src, str(tmp_path / "port"),
                                      device="cpu", **kw)
    want = ref.create_federated_shards(src, str(tmp_path / "ref"), **kw)
    _assert_same_trees(str(tmp_path / "port"), str(tmp_path / "ref"))
    assert sorted(js) == sorted(want)
    for split in want:
        assert abs(js[split] - want[split]) <= 1e-12, split
    return js, want


@pytest.fixture
def round_trip_pandas(monkeypatch):
    """pandas' reader with its correctly rounded parser: the reference's
    raw ingest (`pd.read_csv(path)`, pandas' default parser) then reads
    the values the port's strtod reader does, with the same draws."""
    import functools
    monkeypatch.setattr(pd, "read_csv", functools.partial(
        pd.read_csv, float_precision="round_trip"))


def _two_mode_source(root, n_normal=200, n_abnormal=60, n_test=60,
                     by_client=False):
    """Two source clients of two separated modes (tests/test_aux.py's
    cluster-label trees). `by_client`: client k holds only mode k, so the
    origin labels are the modes; else each client is an even mixture."""
    rng = np.random.default_rng(0)
    for k in (1, 2):
        for split, n in (("normal", n_normal), ("abnormal", n_abnormal),
                         ("test_normal", n_test)):
            d = os.path.join(root, f"Client-{k}", split)
            os.makedirs(d)
            a = rng.normal(0.0, 0.1, size=(n // 2, 5))
            b = rng.normal(8.0, 0.1, size=(n // 2, 5))
            rows = (np.concatenate([a, b]) if not by_client
                    else (a if k == 1 else b))
            np.savetxt(os.path.join(d, "data.csv"), rows, delimiter=",")


def test_iid_shards_match_reference(tmp_path):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 3, dim=5, n_normal=60, n_abnormal=21)
    _both(tmp_path, src, n_clients=6, mode="iid", seed=0)


@pytest.mark.parametrize("correlated", [True, False])
def test_noniid_shards_match_reference(tmp_path, correlated):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 3, dim=4, n_normal=600, n_abnormal=600)
    js, _ = _both(tmp_path, src, n_clients=3, mode="noniid", alpha=0.3,
                  seed=7, correlated_splits=correlated)
    assert js["normal"] > 0.0


@pytest.mark.parametrize("alpha", [0.1, 0.2, 1000.0])
def test_noniid_alpha_sweep_matches_reference(tmp_path, alpha):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 6, dim=5, n_normal=200, n_abnormal=30)
    _both(tmp_path, src, n_clients=6, mode="noniid", alpha=alpha, seed=0)


def test_sample_frac_matches_reference(tmp_path):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 4, dim=5, n_normal=100, n_abnormal=20)
    _both(tmp_path, src, n_clients=4, mode="noniid", alpha=0.5, seed=3,
          sample_frac=0.6)


@pytest.mark.parametrize("matrix_tests", ["correlated", "uniform"])
def test_target_matrix_matches_reference(tmp_path, matrix_tests):
    """The matrix reconstruction over origin labels that are the modes
    (no clustering): cell for cell, bit for bit, both test splits."""
    src = str(tmp_path / "src")
    _two_mode_source(src, n_normal=200, n_abnormal=80, n_test=100,
                     by_client=True)
    m = np.array([[120, 0], [30, 60], [50, 100]])  # 3 clients x 2 modes
    _both(tmp_path, src, n_clients=3, mode="noniid", seed=0,
          target_matrix=m, matrix_tests=matrix_tests)


def test_target_matrix_resamples_short_modes_as_reference(tmp_path):
    src = str(tmp_path / "src")
    _two_mode_source(src, n_normal=120, n_abnormal=40, n_test=40,
                     by_client=True)
    m = np.array([[70, 0], [30, 60], [50, 20]])  # mode 0 needs 150 of 60
    _both(tmp_path, src, n_clients=3, mode="noniid", seed=1,
          target_matrix=m)


def test_pool_source_shards_matches_reference(tmp_path):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 3, dim=5, n_normal=40, n_abnormal=10)
    got, want = prep.pool_source_shards(src), ref.pool_source_shards(src)
    for split in prep.SPLITS:
        np.testing.assert_array_equal(got[split][0], want[split][0].values)
        np.testing.assert_array_equal(got[split][1], want[split][1])
        assert got[split][0].dtype == np.float64


RAW_KW = dict(benign_frac=0.2, abnormal_frac=0.1, holdout_frac=0.4, seed=42)


def test_raw_ingest_picks_the_reference_rows(tmp_path):
    """The same rows in the same order; the values within pandas' default
    parser's error of the correctly rounded ones (relative 1e-12: it drops
    digits past the 17th, up to ~2,400 ulp on these values)."""
    raw = str(tmp_path / "raw")
    _write_raw_device_tree(raw, 4, n_benign=500, n_attack=400)
    got = prep.pool_raw_devices(raw, **RAW_KW)
    want = ref.pool_raw_devices(raw, **RAW_KW)
    for split in prep.SPLITS:
        np.testing.assert_array_equal(got[split][1], want[split][1])
        np.testing.assert_allclose(got[split][0], want[split][0].values,
                                   rtol=1e-12, atol=0)


def test_raw_ingest_matches_round_trip_reference_bits(tmp_path,
                                                      round_trip_pandas):
    raw = str(tmp_path / "raw")
    _write_raw_device_tree(raw, 4, n_benign=500, n_attack=400)
    got = prep.pool_raw_devices(raw, **RAW_KW)
    want = ref.pool_raw_devices(raw, **RAW_KW)
    for split in prep.SPLITS:
        np.testing.assert_array_equal(got[split][0], want[split][0].values)
        np.testing.assert_array_equal(got[split][1], want[split][1])
    _both(tmp_path, None, n_clients=5, mode="noniid", alpha=0.5, seed=42,
          raw_dir=raw, benign_frac=0.2, abnormal_frac=0.1)


@pytest.mark.parametrize("seed", range(6))
def test_apportion_matches_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 20, 9).astype(float)
    w[rng.integers(0, 9)] = 0.0
    total = int(rng.integers(0, 500))
    np.testing.assert_array_equal(prep._apportion(w, total),
                                  ref._apportion(w, total))
    assert prep._apportion(np.zeros(3), 5).sum() == 0


@pytest.mark.parametrize("how", ["exact", "proportions", "row_share",
                                 "uniform"])
def test_matrix_partition_matches_reference(how):
    rng = np.random.default_rng(11)
    origins = rng.integers(0, 9, 20_000)
    col = ref.match_modes_to_columns(origins, ref.PUBLISHED_NONIID_MATRIX)
    np.testing.assert_array_equal(
        prep.match_modes_to_columns(origins, prep.PUBLISHED_NONIID_MATRIX),
        col)
    got = prep.matrix_partition(origins, prep.PUBLISHED_NONIID_MATRIX, col,
                                np.random.default_rng(3), how)
    want = ref.matrix_partition(origins, ref.PUBLISHED_NONIID_MATRIX, col,
                                np.random.default_rng(3), how)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert prep.js_distance(origins, got) == ref.js_distance(origins, want)


def test_match_modes_refuses_unpopulated_labels():
    with pytest.raises(ValueError, match="--cluster-labels 9"):
        prep.match_modes_to_columns(np.arange(7) % 7,
                                    prep.PUBLISHED_NONIID_MATRIX)


def test_filter_and_iid_partition_match_reference():
    rng = np.random.default_rng(2)
    origins = rng.integers(0, 5, 400)
    for idx in (rng.permutation(400)[:150], np.empty(0, dtype=int)):
        np.testing.assert_array_equal(
            prep.filter_small_classes(origins, idx, 40),
            ref.filter_small_classes(origins, idx, 40))
    for g, w in zip(prep.iid_partition(101, 7, np.random.default_rng(4)),
                    ref.iid_partition(101, 7, np.random.default_rng(4))):
        np.testing.assert_array_equal(g, w)


def test_cluster_labels_recover_the_reference_partition(tmp_path):
    """k-means over two separated modes: the port's labels are sklearn's
    up to a permutation, split by split."""
    src = str(tmp_path / "src")
    _two_mode_source(src)
    pooled = prep.pool_source_shards(src)
    got = prep.relabel_by_clusters(pooled, 2, seed=0, device="cpu")
    want = ref.relabel_by_clusters(ref.pool_source_shards(src), 2, seed=0)
    for split in prep.SPLITS:
        g, w = got[split][1], want[split][1]
        assert set(zip(g.tolist(), w.tolist())) in (
            {(0, 0), (1, 1)}, {(0, 1), (1, 0)}), split
        np.testing.assert_array_equal(got[split][0], pooled[split][0])


def test_cluster_labels_skew_and_matrix_cell_for_cell(tmp_path):
    """tests/test_aux.py's clustered runs on the port: strong skew over
    the recovered modes, and the matrix realized cell for cell."""
    src = str(tmp_path / "src")
    _two_mode_source(src)
    js = prep.create_federated_shards(src, str(tmp_path / "out"),
                                      n_clients=4, mode="noniid", alpha=0.2,
                                      seed=0, cluster_labels=2, device="cpu")
    assert js["normal"] > 0.4
    m = np.array([[120, 0], [30, 60], [50, 100]])
    prep.create_federated_shards(src, str(tmp_path / "mat"), n_clients=3,
                                 mode="noniid", seed=0, cluster_labels=2,
                                 target_matrix=m, device="cpu")
    low = [int((read_csv_f64(str(tmp_path / "mat" / f"Client-{k}" /
                                 "normal" / "data.csv")).mean(1) < 4).sum())
           for k in (1, 2, 3)]
    assert low in (m[:, 0].tolist(), m[:, 1].tolist())


def test_cli_matches_reference_cli(tmp_path, capsys):
    src = str(tmp_path / "src")
    _write_client_csvs(src, 3, dim=5, n_normal=80, n_abnormal=20)
    argv = ["--source", src, "--n-clients", "4", "--mode", "noniid",
            "--alpha", "0.4", "--seed", "9"]
    js = prep.main(argv + ["--out", str(tmp_path / "port"), "--device",
                           "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "js_distance": js}
    ref.main(argv + ["--out", str(tmp_path / "ref")])
    _assert_same_trees(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_shards_feed_the_port_pipeline(tmp_path):
    from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
    from fedmse_tpu_torch.data import prepare_clients
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    _write_client_csvs(src, 2, dim=5, n_normal=80, n_abnormal=30)
    prep.create_federated_shards(src, out, n_clients=3, mode="iid", seed=1,
                                 device="cpu")
    clients = prepare_clients(DatasetConfig.for_client_dirs(out, 3),
                              ExperimentConfig(dim_features=5,
                                               network_size=3),
                              np.random.default_rng(0))
    assert len(clients) == 3
    assert all(c.train_x.shape[1] == 5 for c in clients)
