"""The port's native ``.npz`` decoder (``maunet_tpu_torch/data/native.py``)
against numpy and the JAX package's binding, on one synthetic split of 32²,
T = 64.  Decoded arrays and dataset samples are held bit for bit: both
decoders copy the stored bytes, and the cast to f32 is the same numpy call."""

import os
import threading
from pathlib import Path

import numpy as np
import pytest

from maunet_tpu.data import native as jax_native
from maunet_tpu.data.dataset import NpzDataset as JaxNpzDataset
from maunet_tpu.data.synthetic import generate_dataset

from maunet_tpu_torch.data import native
from maunet_tpu_torch.data.dataset import NpzDataset, make_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, T = 32, 64


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = generate_dataset(str(tmp_path_factory.mktemp("native")),
                            {"train": 6, "val": 1, "test": 1}, hw=HW, temporal_len=T)
    return os.path.join(root, "train")


def _files(split):
    return sorted(os.path.join(split, f) for f in os.listdir(split) if f.endswith(".npz"))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_npz_equals_np_load(split):
    for path in _files(split):
        got = native.load_npz(path)
        with np.load(path) as ref:
            assert list(got) == list(ref.files)
            for name in ref.files:
                _same(got[name], ref[name])
        picked = native.load_npz(path, ["metadata", "input"])
        assert list(picked) == ["metadata", "input"]
        _same(picked["input"], got["input"])


def test_load_batch_equals_the_stacked_arrays(split):
    files = _files(split)
    for name, shape, dtype in [("input", (23, HW, HW), np.float32),
                               ("target", (2, HW, HW), np.float32)]:
        for threads in (None, 1, 3):
            got = native.load_batch(files, name, shape, dtype, threads=threads)
            with_numpy = []
            for path in files:
                with np.load(path) as ref:
                    with_numpy.append(ref[name])
            _same(got, np.stack(with_numpy))


def test_errors_are_the_jax_bindings(split, tmp_path):
    bad = tmp_path / "not_a_zip.npz"
    bad.write_bytes(b"garbage" * 10)
    good = _files(split)[0]
    for module in (native, jax_native):
        with pytest.raises(IOError, match="npz_open"):
            module.load_npz(str(bad))
        with pytest.raises(IOError, match="missing_entry"):
            module.load_npz(good, ["missing_entry"])
        with pytest.raises(IOError, match="1/2 files failed"):
            module.load_batch([good, str(bad)], "input", (23, HW, HW))


def test_unavailable_decoder(split, monkeypatch):
    """Without the decoder, 'native' raises, 'auto' reads with numpy and the
    decode calls raise RuntimeError, as in the JAX package."""
    monkeypatch.setattr(native, "_library", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        NpzDataset(split, T, backend="native")
    with pytest.raises(RuntimeError, match="unavailable"):
        native.load_npz(_files(split)[0])
    with pytest.raises(RuntimeError, match="unavailable"):
        native.load_batch(_files(split), "input", (23, HW, HW))
    auto = NpzDataset(split, T)
    assert not auto._native
    _same(auto[0]["maps"], NpzDataset(split, T, backend="numpy")[0]["maps"])
    with pytest.raises(ValueError, match="backend"):
        NpzDataset(split, T, backend="zip")


def test_every_backend_gives_the_jax_samples(split):
    want = JaxNpzDataset(split, temporal_length=T, backend="native")
    assert want._native
    datasets = {b: NpzDataset(split, T, backend=b) for b in ("native", "numpy", "auto")}
    assert [ds._native for ds in datasets.values()] == [True, False, True]
    for i in range(len(want)):
        ref = want[i]
        for backend, ds in datasets.items():
            got = ds[i]
            assert list(got) == list(ref), backend
            for k in ref:
                _same(np.asarray(got[k]), np.asarray(ref[k]))
    # Batches from the default backend are the numpy path's, bit for bit.
    for a, b in zip(make_batches(datasets["auto"], 4), make_batches(datasets["numpy"], 4)):
        for k, v in b.as_dict().items():
            _same(getattr(a, k), v)


def test_the_library_is_the_ports_own():
    """The port builds into ``build/maunet_tpu_torch/`` and loads that file,
    never the JAX package's ``maunet_tpu/data/_npz_native.so``."""
    assert native.available()
    path = native.library_path()
    assert path.parent == Path(REPO, "build", "maunet_tpu_torch")
    assert path.name.startswith("libnpz_native_") and path.exists()
    assert native._library()._name == str(path)
    assert os.path.realpath(path) != os.path.realpath(jax_native._LIB_PATH)


def test_concurrent_builds_agree_on_one_file(tmp_path, monkeypatch):
    """Processes that build at once (xdist workers) each compile in a
    temporary directory and land the same file with ``os.replace``."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    results, errors = [], []

    def run():
        try:
            results.append(native.build())
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(results)) == 1 and results[0].parent == tmp_path / "build"
    assert os.listdir(tmp_path / "build") == [results[0].name]
