"""The trace reduction of ``profile_port.py``: device-busy time as the union
of kernel intervals, and the split by kernel family."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def profile_port():
    spec = importlib.util.spec_from_file_location(
        "profile_port", os.path.join(REPO, "profile_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, want", [
    ("(anonymous namespace)::conv3x3_fused_kernel((anonymous namespace)::ConvArgs)",
     "A conv3x3_fused"),
    ("void (anonymous namespace)::lstm_last_hidden_kernel(float const*, float const*)",
     "B lstm_last_hidden"),
    ("void (anonymous namespace)::resize_align_corners_kernel<__nv_bfloat16, 8>()",
     "C resize_align_corners"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "cuDNN convs (>= 128 channels)"),
    ("void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel<>()",
     "cuDNN convs (>= 128 channels)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3", "GEMMs (encoders' dense layers)"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda>",
     "other torch ops (epilogues, BN fold, casts, cat, pool)"),
])
def test_family(profile_port, name, want):
    assert profile_port.family(name) == want


def test_trace_breakdown_counts_overlap_once(profile_port):
    events = [
        {"cat": "kernel", "name": "conv3x3_fused_kernel", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "elementwise", "ts": 50, "dur": 100},    # overlaps: 0..150
        {"cat": "kernel", "name": "lstm_last_hidden_kernel", "ts": 150, "dur": 50},  # touches
        {"cat": "kernel", "name": "resize_align_corners_kernel", "ts": 400, "dur": 200},
        {"cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 1000},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700, "dur": 100},
    ]
    br = profile_port.trace_breakdown(events, n_forwards=2)
    assert br["busy_ms"] == pytest.approx((200 + 200) / 1e3 / 2)
    assert br["kernels"] == 2
    assert br["families"] == pytest.approx({
        "A conv3x3_fused": 0.05, "B lstm_last_hidden": 0.025,
        "C resize_align_corners": 0.1,
        "other torch ops (epilogues, BN fold, casts, cat, pool)": 0.05})


def test_trace_breakdown_empty(profile_port):
    assert profile_port.trace_breakdown([], 3) == {"busy_ms": 0.0, "families": {}, "kernels": 0.0}


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::lstm_last_hidden_kernel<true>(float const*, float const*)",
     "E lstm stash forward"),
    ("_ZN12_GLOBAL__N_123lstm_last_hidden_kernelILb1EEEvPKfS2_", "E lstm stash forward"),
    ("void (anonymous namespace)::lstm_last_hidden_kernel<false>(float const*, float const*)",
     "B lstm_last_hidden"),
    ("void (anonymous namespace)::lstm_backward_kernel(float const*)", "F lstm backward"),
    ("void (anonymous namespace)::lstm_backward_kernel<24>(float const*)", "F lstm backward"),
    ("void (anonymous namespace)::lstm_gate_terms_kernel(float const*)", "F lstm backward"),
    ("void (anonymous namespace)::lstm_dw_partial_kernel(float const*)", "dW lstm_dw"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cuDNN convs, forward and backward"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>()",
     "optimizer (multi-tensor apply)"),
    ("void at::native::reduce_kernel<512, 1>()", "other torch ops (BN, casts, cat, pool, losses)"),
])
def test_train_family(profile_port, name, want):
    assert profile_port.family(name, profile_port.TRAIN_FAMILIES,
                               profile_port.TRAIN_OTHER) == want


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::masked_stats_partial_kernel<float, 2>(float const*)",
     "D masked_class_sums"),
    ("(anonymous namespace)::masked_stats_reduce_kernel(float const*, float*)",
     "D masked_class_sums"),
    ("(anonymous namespace)::conv3x3_fused_kernel((anonymous namespace)::ConvArgs)",
     "A conv3x3_fused"),
    ("void at::native::reduce_kernel<512, 1>()",
     "other torch ops (epilogues, BN fold, cat, pool, means, Laplacian, argmax)"),
])
def test_eval_family(profile_port, name, want):
    assert profile_port.family(name, profile_port.EVAL_FAMILIES,
                               profile_port.EVAL_OTHER) == want


@pytest.mark.parametrize("argv, mode", [
    ([], None), (["--lstm"], "lstm"), (["--conv"], "conv"),
    (["--train", "--trace", "t.json"], "train"), (["--eval"], "eval"),
    (["--resize"], "resize"), (["--resize", "--parent", "x.cu"], "resize")])
def test_parse_args_modes(profile_port, argv, mode):
    args = profile_port.parse_args(argv)
    modes = [m for m in ("train", "eval", "conv", "lstm", "resize") if getattr(args, m)]
    assert modes == ([mode] if mode else [])
    assert args.trace == ("t.json" if "--trace" in argv else None)
    assert args.parent == ("x.cu" if "--parent" in argv else None)


@pytest.mark.parametrize("argv", [
    ["--lstm", "--conv"], ["--lstm", "--train"], ["--lstm", "x"], ["--resize", "--lstm"],
    ["--resize", "--conv"], ["--parent", "x.cu"], ["--lstm", "--parent", "x.cu"],
    ["--resize", "x.cu"]])
def test_lstm_mode_refuses_other_modes_and_arguments(profile_port, argv):
    with pytest.raises(SystemExit):
        profile_port.parse_args(argv)


@pytest.mark.parametrize("mode", ["--lstm", "--resize"])
def test_lstm_mode_needs_a_card(profile_port, capsys, mode):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    assert profile_port.main([mode]) == 1
    assert "cuda" in capsys.readouterr().err


@pytest.mark.parametrize("entry, want", [
    ("'_ZN12_GLOBAL__N_123lstm_last_hidden_kernelILb1ELi24EEEvPKfS2_PKiPfS5_S5_ii'",
     "lstm_last_hidden_kernel<true, KS = 24>"),
    ("'_ZN12_GLOBAL__N_123lstm_last_hidden_kernelILb0ELi16EEEvPKfS2_PKiPfS5_S5_ii'",
     "lstm_last_hidden_kernel<false, KS = 16>"),
    ("'_ZN12_GLOBAL__N_120lstm_backward_kernelEPKfS1_PKiS1_S1_S1_Pfii'", "lstm_backward_kernel"),
    ("'_ZN12_GLOBAL__N_120lstm_backward_kernelILi24EEEvPKfS2_PKiS2_Pfii'",
     "lstm_backward_kernel<KS = 24>"),
    ("'_ZN12_GLOBAL__N_122lstm_gate_terms_kernelEPKfS1_PKiS1_S1_Pfii'", "lstm_gate_terms_kernel"),
])
def test_lstm_kernel_label(profile_port, entry, want):
    assert profile_port.lstm_kernel_label(f"ptxas info    : Compiling entry function {entry}") == want


@pytest.mark.parametrize("entry, want", [
    ("'_ZN12_GLOBAL__N_127resize_align_corners_kernelI13__nv_bfloat16Li8EEEvPKT_PS2_iiiiiiii'",
     "resize_align_corners_kernel<bf16, V = 8>"),
    ("'_ZN12_GLOBAL__N_127resize_align_corners_kernelIfLi4EEEvPKT_PS1_iiiiiiii'",
     "resize_align_corners_kernel<f32, V = 4>"),
    ("'_ZN12_GLOBAL__N_127resize_align_corners_kernelI13__nv_bfloat16Li1EEEvPKT_PS2_iiiiiii'",
     "resize_align_corners_kernel<bf16, V = 1>"),
])
def test_resize_kernel_label(profile_port, entry, want):
    assert profile_port.resize_kernel_label(
        f"ptxas info    : Compiling entry function {entry}") == want


def test_resize_parent_arguments_follow_its_signature(profile_port):
    """``--parent`` calls another version of ``resize_pack.cu`` with the
    arguments its entry point names: the tree's, with or without a strip
    height, in any order."""
    import torch

    with open(os.path.join(REPO, "maunet_tpu_torch", "csrc", "resize_pack.cu")) as f:
        tree = profile_port.resize_entry_params(f.read())
    assert tree == [("x", True), ("y", True), ("dtype", False), ("B", False), ("h", False),
                    ("w", False), ("C", False), ("oh", False), ("ow", False), ("rows", False),
                    ("stream", True)]
    old = profile_port.resize_entry_params(
        'extern "C" int maunet_resize_align_corners(const void* x, void* y, int dtype,\n'
        "    int B, int h, int w, int C, int oh,\n    int ow, void* stream) {")
    assert [name for name, _ in old] == ["x", "y", "dtype", "B", "h", "w", "C", "oh", "ow",
                                         "stream"]
    x = torch.zeros(2, 3, 5, 8, dtype=torch.bfloat16)
    y = torch.zeros(2, 6, 9, 8, dtype=torch.bfloat16)
    assert profile_port.resize_arguments(old, x, y, 4, 7) == [
        x.data_ptr(), y.data_ptr(), 1, 2, 3, 5, 8, 6, 9, 7]
    assert profile_port.resize_arguments(tree, x.float(), y.float(), 4, 7)[2:] == [
        0, 2, 3, 5, 8, 6, 9, 4, 7]
    with pytest.raises(ValueError, match="unknown parameters"):
        profile_port.resize_arguments([("x", True), ("flags", False)], x, y, 4, 7)
    with pytest.raises(ValueError, match="no maunet_resize_align_corners"):
        profile_port.resize_entry_params("int main() {}")


def test_kernel_sum_counts_device_work_only(profile_port):
    events = [
        {"cat": "kernel", "name": "resize_align_corners_kernel", "ts": 0, "dur": 30},
        {"cat": "gpu_memset", "name": "Memset (Device)", "ts": 40, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 500},
        {"cat": "kernel", "name": "resize_align_corners_kernel", "ts": 100, "dur": 50},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 200, "dur": 100},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 190, "dur": 400},
    ]
    assert profile_port.kernel_sum_ms(events, 2) == pytest.approx(0.095)
    assert profile_port.kernel_sum_ms([], 5) == 0.0
