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
    ("void (anonymous namespace)::lstm_dw_partial_kernel(float const*)", "dW lstm_dw"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cuDNN convs, forward and backward"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>()",
     "optimizer (multi-tensor apply)"),
    ("void at::native::reduce_kernel<512, 1>()", "other torch ops (BN, casts, cat, pool, losses)"),
])
def test_train_family(profile_port, name, want):
    assert profile_port.family(name, profile_port.TRAIN_FAMILIES,
                               profile_port.TRAIN_OTHER) == want
