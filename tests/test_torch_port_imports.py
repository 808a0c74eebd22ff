"""The PyTorch port stands on torch and numpy alone (pandas, scipy, PIL,
cv2, matplotlib, seaborn, streamlit, xarray and cdsapi are imported inside
the functions that use them, rasterio where it is present), and never
computes a CUDA call on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
from maunet_tpu_torch.ops.kernels import _build, lstm, masked_stats, packed_vgg, resize_pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "yaml", "pandas", "matplotlib", "seaborn",
             "scipy", "PIL", "cv2", "streamlit", "xarray", "cdsapi", "rasterio"):
    sys.modules[name] = None          # any import of them raises ImportError
import maunet_tpu_torch
for mod in pkgutil.walk_packages(maunet_tpu_torch.__path__, "maunet_tpu_torch."):
    importlib.import_module(mod.name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] == "maunet_tpu")
assert not leaked, leaked
print(" ".join(sorted(m for m in sys.modules if m.startswith("maunet_tpu_torch"))))
"""

# The training path's modules, each of which must be among those imported.
TRAINING_MODULES = [
    "maunet_tpu_torch.losses.basic", "maunet_tpu_torch.losses.ssim",
    "maunet_tpu_torch.losses.combined", "maunet_tpu_torch.train.config",
    "maunet_tpu_torch.train.optimizers", "maunet_tpu_torch.train.state",
    "maunet_tpu_torch.train.steps", "maunet_tpu_torch.train.checkpoint",
    "maunet_tpu_torch.train.metrics", "maunet_tpu_torch.train.loop",
    "maunet_tpu_torch.data.dataset", "maunet_tpu_torch.data.transforms",
    "maunet_tpu_torch.data.synthetic", "maunet_tpu_torch.data.pipeline",
    "maunet_tpu_torch.data.shards",
]


# The evaluation path's and U-Net++'s modules, likewise.
EVALUATION_MODULES = [
    "maunet_tpu_torch.ops.kernels.masked_stats", "maunet_tpu_torch.evaluate.metrics",
    "maunet_tpu_torch.evaluate.evaluator", "maunet_tpu_torch.evaluate.visualize",
    "maunet_tpu_torch.evaluate.checkpoint", "maunet_tpu_torch.models.unetpp",
    "maunet_tpu_torch.models.fuse", "maunet_tpu_torch.utils.dw",
]


# The research command line's modules, likewise.
RESEARCH_MODULES = [
    "maunet_tpu_torch.cli", "maunet_tpu_torch.benchmarks",
    "maunet_tpu_torch.analysis.sensitivity", "maunet_tpu_torch.analysis.gt_sensitivity",
    "maunet_tpu_torch.analysis.plots", "maunet_tpu_torch.analysis.compare",
    "maunet_tpu_torch.train.hpo", "maunet_tpu_torch.train.optuna_storage",
    "maunet_tpu_torch.utils.tracking",
]


# The planner apps' and the science loop's modules, likewise.
APP_MODULES = [
    "maunet_tpu_torch.data.tiles", "maunet_tpu_torch.apps.planner_core",
    "maunet_tpu_torch.apps.gee_fetch", "maunet_tpu_torch.apps.headless",
    "maunet_tpu_torch.apps.planner", "maunet_tpu_torch.analysis.stats",
    "maunet_tpu_torch.analysis.science",
]


# The training features ported since (train_fused_conv, remat, prediction
# plots) and the data preparation (process, process-temperature), likewise.
TRAINING_FEATURE_MODULES = [
    "maunet_tpu_torch.ops.train_conv", "maunet_tpu_torch.train.visualize",
    "maunet_tpu_torch.data.split", "maunet_tpu_torch.data.temperature",
    "maunet_tpu_torch.data.processing",
]


# The research app, the EDA tools and figures, the interactive diagram, the
# native decoder's binding and the logger, likewise.
RESEARCH_APP_MODULES = [
    "maunet_tpu_torch.apps.research", "maunet_tpu_torch.analysis.diagram_html",
    "maunet_tpu_torch.analysis.figures", "maunet_tpu_torch.analysis.eda",
    "maunet_tpu_torch.analysis.tile_viz", "maunet_tpu_torch.data.native",
    "maunet_tpu_torch.utils.logging",
]


# Data parallelism: the mesh, the process group and sharded inference, likewise.
PARALLEL_MODULES = [
    "maunet_tpu_torch.parallel", "maunet_tpu_torch.parallel.mesh",
    "maunet_tpu_torch.parallel.multihost", "maunet_tpu_torch.parallel.infer",
]


def test_port_imports_without_jax_or_yaml():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 75
    assert not set(TRAINING_MODULES + EVALUATION_MODULES + RESEARCH_MODULES
                   + APP_MODULES + TRAINING_FEATURE_MODULES + RESEARCH_APP_MODULES
                   + PARALLEL_MODULES) - imported


def test_parallel_entry_points_default_to_the_card():
    """Without CUDA a mesh of the visible cards, a rank's default device and
    a sharded evaluation on the card raise; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    from maunet_tpu_torch.parallel.mesh import make_mesh
    from maunet_tpu_torch.parallel.multihost import initialize_multihost

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_cuda_call_without_cuda_raises(tmp_path):
    """A CUDA-device request fails; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises((RuntimeError, AssertionError)):
        resize_pack.resize_pack(torch.zeros(1, 2, 2, 1, device="cuda"), (3, 3))
    with pytest.raises((RuntimeError, AssertionError)):
        masked_stats.masked_class_sums(torch.zeros(1, 2, 2, 2, device="cuda"),
                                       torch.zeros(1, 2, 2, 2, device="cuda"),
                                       torch.zeros(1, 2, 2, dtype=torch.int32, device="cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        packed_vgg.conv3x3_pair_fused(
            [torch.zeros(1, 2, 2, 2, dtype=torch.bfloat16, device="cuda")],
            [torch.zeros(2, 2, 3, 3)], torch.zeros(2, 2, 3, 3))
    from maunet_tpu_torch.models.factory import build_model
    path = str(tmp_path / "m.pth")
    model = build_model({"base_filters": 4, "temporal_dim": 4, "meta_dim": 4,
                         "lstm_hidden": 4})
    torch.save({"model_state_dict": model.state_dict(),
                "hyperparameters": {"base_filters": 4}}, path)
    with pytest.raises((RuntimeError, AssertionError)):
        load_any_checkpoint(path, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        load_any_checkpoint(path)       # the card is the default
    from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
    with pytest.raises((RuntimeError, AssertionError)):
        evaluate_checkpoint(path, data_dir=str(tmp_path), output_dir=str(tmp_path))


@pytest.mark.parametrize("call", [
    lambda x: resize_pack.resize_pack(x, (4, 4)),
    lambda x: packed_vgg.conv3x3_fused([x], [torch.zeros(2, 2, 3, 3)]),
    lambda x: lstm.lstm_last_hidden(x.reshape(1, 1, 8), torch.zeros(2, 8),
                                    torch.ones(1, dtype=torch.int32)),
    lambda x: masked_stats.masked_class_sums(x, x, torch.zeros(1, 2, 2, dtype=torch.int32)),
    lambda x: packed_vgg.conv3x3_pair_fused([x], [torch.zeros(2, 2, 3, 3)],
                                            torch.zeros(2, 2, 3, 3)),
])
def test_wrappers_refuse_non_cpu_non_cuda_tensors(call):
    """The wrappers take the plain version only for CPU tensors."""
    x = torch.zeros(1, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(x)


def test_plain_versions_only_for_cpu():
    x = torch.ones(1, 2, 2, 1)
    assert _build.on_cpu(x, "t")
    np.testing.assert_allclose(resize_pack.resize_pack(x, (3, 3)).numpy(), 1.0)


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_any_checkpoint(str(tmp_path))


def test_kernel_branches_marshal_arguments(monkeypatch):
    """The CUDA branch of each wrapper, run on CPU tensors against a
    recording stand-in for the C entry points: validation, weight layout and
    argument marshalling are Python that the CPU suite can reach."""
    calls = []

    def fake_function(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, args)
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    bf = torch.bfloat16
    launches = [f.launches for f in (packed_vgg.conv3x3_fused, lstm.lstm_last_hidden,
                                     resize_pack.resize_pack)]

    parts = [torch.zeros(2, 5, 7, 3, dtype=bf), torch.zeros(2, 5, 7, 16, dtype=bf)]
    weights = [torch.zeros(12, 3, 3, 3), torch.zeros(12, 16, 3, 3)]
    out = packed_vgg.conv3x3_fused(parts, weights, scale=torch.ones(12),
                                   bias=torch.zeros(12), add=torch.zeros(2, 3, 7, 12),
                                   relu=True)
    assert out.shape == (2, 5, 7, 12) and out.dtype == bf
    name, args = calls[-1]
    assert name == "maunet_conv3x3_fused" and args[3] == 2 and args[7:12] == (2, 5, 7, 12, 1)
    # f32 parts go to A's f32 entry, with weights prepared in f32, and count
    # there; a dtype neither entry takes raises, naming it.
    n_f32 = packed_vgg.conv3x3_fused_f32.launches
    out = packed_vgg.conv3x3_fused([p.float() for p in parts], weights)
    assert out.dtype == torch.float32 and calls[-1][0] == "maunet_conv3x3_fused_f32"
    assert packed_vgg.conv3x3_fused_f32.launches == n_f32 + 1
    with pytest.raises(ValueError, match="bf16 or f32 parts, got torch.float16"):
        packed_vgg.conv3x3_fused([p.half() for p in parts], weights)
    with pytest.raises(ValueError, match="does not match"):
        packed_vgg.conv3x3_fused(parts, weights[::-1])

    h = lstm.lstm_last_hidden(torch.zeros(3, 10, 32), torch.zeros(8, 32),
                              torch.full((3,), 10, dtype=torch.int32))
    assert h.shape == (3, 8) and calls[-1][1][4:7] == (3, 10, 8)
    with pytest.raises(ValueError, match="int32"):
        lstm.lstm_last_hidden(torch.zeros(3, 10, 32), torch.zeros(8, 32),
                              torch.full((3,), 10))

    y = resize_pack.resize_pack(torch.zeros(2, 15, 15, 8, dtype=bf), (30, 31))
    assert y.shape == (2, 30, 31, 8) and calls[-1][1][2:9] == (1, 2, 15, 15, 8, 30, 31)
    with pytest.raises(ValueError, match="contiguous"):
        resize_pack.resize_pack(torch.zeros(2, 8, 15, 15).permute(0, 2, 3, 1), (30, 30))

    assert [f.launches for f in (packed_vgg.conv3x3_fused, lstm.lstm_last_hidden,
                                 resize_pack.resize_pack)] == [n + 1 for n in launches]

    # D: one launch into one (B, 9 (2C + 1)) output, of which the three
    # sums are views; the class map must be int32.
    n_d = masked_stats.masked_class_sums.launches
    pred = torch.zeros(3, 50, 50, 2)
    sums = masked_stats.masked_class_sums(pred, pred, torch.zeros(3, 50, 50, dtype=torch.int32))
    assert [tuple(t.shape) for t in sums] == [(3, 2, 9), (3, 2, 9), (3, 9)]
    name, args = calls[-1]
    assert name == "maunet_masked_class_sums" and args[4:8] == (3, 2500, 2, 0)
    assert args[3] == sums[0].data_ptr() and sums[0]._base is sums[2]._base is not None
    assert masked_stats.masked_class_sums(pred.bfloat16(), pred.bfloat16(), torch.zeros(
        3, 50, 50, dtype=torch.int32))[0].dtype == torch.float32 and calls[-1][1][7] == 1
    with pytest.raises(ValueError, match="int32"):
        masked_stats.masked_class_sums(pred, pred, torch.zeros(3, 50, 50, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-4 channels"):
        masked_stats.masked_class_sums(torch.zeros(3, 50, 50, 5), torch.zeros(3, 50, 50, 5),
                                       torch.zeros(3, 50, 50, dtype=torch.int32))
    with pytest.raises(ValueError, match="share f32"):
        masked_stats.masked_class_sums(pred, pred.bfloat16(),
                                       torch.zeros(3, 50, 50, dtype=torch.int32))
    assert masked_stats.masked_class_sums.launches == n_d + 2

    # G: both convs' weights go over in the kernel's layout, widths capped at 64.
    n_g = packed_vgg.conv3x3_pair_fused.launches
    out = packed_vgg.conv3x3_pair_fused(
        parts, weights, torch.zeros(20, 12, 3, 3), scale1=torch.ones(12),
        bias1=torch.zeros(12), scale2=torch.ones(20), bias2=torch.zeros(20),
        add=torch.zeros(2, 3, 7, 12))
    assert out.shape == (2, 5, 7, 20) and out.dtype == bf
    name, args = calls[-1]
    assert name == "maunet_conv3x3_pair" and args[3] == 2 and args[9:14] == (2, 5, 7, 12, 20)
    with pytest.raises(ValueError, match="up to 64"):
        packed_vgg.conv3x3_pair_fused(parts, weights, torch.zeros(65, 12, 3, 3))
    with pytest.raises(ValueError, match="does not follow"):
        packed_vgg.conv3x3_pair_fused(parts, weights, torch.zeros(20, 13, 3, 3))
    with pytest.raises(ValueError, match="needs a gradient"):
        packed_vgg.conv3x3_pair_fused(parts, weights,
                                      torch.zeros(20, 12, 3, 3, requires_grad=True))
    assert packed_vgg.conv3x3_pair_fused.launches == n_g + 1


def test_entry_points_are_looked_up_once(monkeypatch):
    """``_build.function`` declares an entry point's argument types once and
    hands the same function back on every later call: a launch costs the
    host one dictionary lookup, not a library lookup."""
    import ctypes

    class FakeLibrary:
        looked_up = 0

        def __getattr__(self, name):
            FakeLibrary.looked_up += 1
            return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_build, "_library", lambda: FakeLibrary())
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    first = _build.function("maunet_example", argtypes)
    assert _build.function("maunet_example", list(argtypes)) is first
    assert first.argtypes == argtypes and first.restype is ctypes.c_int
    assert FakeLibrary.looked_up == 1
    assert _build.function("maunet_example", [ctypes.c_int]) is not first
    assert FakeLibrary.looked_up == 2


def test_require_formats_its_message_only_on_failure():
    calls = []

    def message():
        calls.append(1)
        return "formatted"

    _build.require(True, "what", message)
    assert calls == []
    with pytest.raises(ValueError, match="what: formatted"):
        _build.require(False, "what", message)
    with pytest.raises(ValueError, match="what: plain"):
        _build.require(False, "what", "plain")
    assert calls == [1]
