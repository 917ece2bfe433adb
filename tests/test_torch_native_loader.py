"""The port's copy of the native C++ prefetcher (`tcdiff_torch/data/native_loader.py`):
`tests/test_native_loader.py`'s cases against the library the port builds
into its own directory, `tcdiff_torch/build/`, from `native/prefetch.cc`;
and the fallback to numpy loading where no toolchain exists."""

import numpy as np
import pytest

from tcdiff_torch.data import native_loader  # noqa: E402
from tcdiff_torch.data.dataset import AIOZDataset
from tcdiff_torch.parallel.mesh import Rows
from tcdiff_torch.data.native_loader import (
    NativePrefetcher,
    PrefetchingBatches,
    native_available,
    read_npy_f32,
)



@pytest.fixture(autouse=True)
def _toolchain():
    if not native_available():
        pytest.skip("g++ toolchain unavailable")


def _write_files(tmp_path, n=6, shape=(7, 5), dtype=np.float32):
    files, arrays = [], []
    for i in range(n):
        a = (np.arange(np.prod(shape)).reshape(shape) * (i + 1)).astype(dtype)
        p = str(tmp_path / f"f{i}.npy")
        np.save(p, a)
        files.append(p)
        arrays.append(a.astype(np.float32))
    return files, arrays


def test_read_npy_f32_single(tmp_path):
    files, arrays = _write_files(tmp_path, n=1)
    out = read_npy_f32(files[0], (7, 5))
    np.testing.assert_array_equal(out, arrays[0])


def test_read_npy_f64_converts(tmp_path):
    files, arrays = _write_files(tmp_path, n=1, dtype=np.float64)
    out = read_npy_f32(files[0], (7, 5))
    np.testing.assert_allclose(out, arrays[0])


def test_prefetcher_batches_in_submit_order(tmp_path):
    files, arrays = _write_files(tmp_path, n=6)
    pf = NativePrefetcher(files, (7, 5), n_threads=3)
    pf.submit([0, 2, 4])
    pf.submit([5, 1])
    b1 = pf.next()
    b2 = pf.next()
    pf.close()
    np.testing.assert_array_equal(b1, np.stack([arrays[0], arrays[2], arrays[4]]))
    np.testing.assert_array_equal(b2, np.stack([arrays[5], arrays[1]]))


def test_prefetcher_bad_file_raises(tmp_path):
    p = tmp_path / "bad.npy"
    p.write_bytes(b"not a numpy file at all")
    pf = NativePrefetcher([str(p)], (4,), n_threads=1)
    pf.submit([0])
    with pytest.raises(IOError):
        pf.next()
    pf.close()


class _FakeDataset:
    def __init__(self, files, n, item_shape):
        self.feature_files = files
        self.wav_files = [f + ".wav" for f in files]
        self.poses = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        self._shape = item_shape

    def __len__(self):
        return len(self.feature_files)

    def batches(self, batch_size, rng=None, rows=None):
        raise AssertionError("fallback path should not be used when native exists")


def test_prefetching_batches_iterator(tmp_path):
    files, arrays = _write_files(tmp_path, n=6)
    ds = _FakeDataset(files, 6, (7, 5))
    it = PrefetchingBatches(ds, batch_size=2, depth=2, item_shape=(7, 5))
    out = list(it)
    assert it.loader == "native" and len(out) == 3
    np.testing.assert_array_equal(out[0]["cond"], np.stack(arrays[0:2]))
    np.testing.assert_array_equal(out[2]["cond"], np.stack(arrays[4:6]))
    assert out[1]["filename"] == files[2:4]
    np.testing.assert_array_equal(out[1]["x"], ds.poses[[2, 3]])


def test_prefetcher_order_under_contention(tmp_path):
    """Delivery must follow submit order even when completion is reordered:
    many single-item batches with a large thread pool."""
    files, arrays = _write_files(tmp_path, n=24, shape=(64, 32))
    pf = NativePrefetcher(files, (64, 32), n_threads=12)
    for i in range(24):
        pf.submit([i])
    for i in range(24):
        out = pf.next()
        np.testing.assert_array_equal(out[0], arrays[i], err_msg=str(i))
    pf.close()


def test_library_is_built_in_the_port_directory():
    lib = native_loader._lib_path()
    assert lib.exists() and lib.parent.name == "build" and lib.parent.parent.name == "tcdiff_torch"


def test_submit_rejects_an_index_out_of_range(tmp_path):
    files, _ = _write_files(tmp_path, n=2)
    pf = NativePrefetcher(files, (7, 5), n_threads=1)
    with pytest.raises(IndexError):
        pf.submit([0, 2])
    pf.close()


def test_prefetching_batches_falls_back_without_a_toolchain(tmp_path, monkeypatch):
    files, arrays = _write_files(tmp_path, n=4)

    class _Synchronous(_FakeDataset):
        def batches(self, batch_size, rng=None, rows=None):
            for i in range(0, len(self) - len(self) % batch_size, batch_size):
                yield {"x": self.poses[i:i + batch_size], "cond": np.stack(arrays[i:i + batch_size])}

    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    it = PrefetchingBatches(_Synchronous(files, 4, (7, 5)), batch_size=2, item_shape=(7, 5))
    out = list(it)
    assert it.loader == "numpy" and len(out) == 2
    np.testing.assert_array_equal(out[1]["cond"], np.stack(arrays[2:4]))


def _other_ranks_unreadable(files, rows: Rows):
    """Overwrite the files of every row but `rows`' in each global batch, so
    that reading one raises."""
    for i, f in enumerate(files):
        if not rows.start <= i % rows.total < rows.stop:
            with open(f, "wb") as fh:
                fh.write(b"another rank's file")


def test_prefetching_batches_read_only_their_rows(tmp_path):
    """A data-parallel rank's prefetcher walks the global order and reads
    only its rows' files: rank 1 of 2, global batches of 2, gets rows 1, 3
    and 5, and never opens the others."""
    files, arrays = _write_files(tmp_path, n=6)
    rows = Rows(1, 2, 2)
    _other_ranks_unreadable(files, rows)
    out = list(PrefetchingBatches(_FakeDataset(files, 6, (7, 5)), batch_size=2, item_shape=(7, 5), rows=rows))
    assert len(out) == 3
    for k, b in enumerate(out):
        np.testing.assert_array_equal(b["cond"], arrays[2 * k + 1][None])
        assert b["filename"] == [files[2 * k + 1]]


@pytest.mark.parametrize("native", [True, False])
def test_dataset_batches_read_only_their_rows(tmp_path, monkeypatch, native):
    """AIOZDataset's batches (the numpy fallback too) under a shuffled
    order: each rank's rows are its share of the global batch one process
    reads, and the other ranks' files are not read."""
    files, arrays = _write_files(tmp_path, n=8)
    ds = AIOZDataset.__new__(AIOZDataset)
    ds.poses = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    ds.feature_files, ds.wav_files, ds._feature_cache = files, [f + ".wav" for f in files], {}
    whole = list(ds.batches(4, rng=np.random.default_rng(3)))
    ds._feature_cache = {}
    order = [files.index(f) for b in whole for f in b["filename"]]
    rows = Rows(2, 4, 4)
    for pos, i in enumerate(order):  # break the files of rows 0 and 1 of each global batch
        if pos % 4 < 2:
            with open(files[i], "wb") as fh:
                fh.write(b"another rank's file")
    if not native:
        monkeypatch.setattr(native_loader, "native_available", lambda: False)
    out = list(PrefetchingBatches(ds, 4, rng=np.random.default_rng(3), item_shape=(7, 5), rows=rows))
    assert len(out) == len(whole) == 2
    for b, w in zip(out, whole):
        assert b["filename"] == w["filename"][2:4]
        np.testing.assert_array_equal(b["cond"], w["cond"][2:4])
        np.testing.assert_array_equal(b["x"], w["x"][2:4])
