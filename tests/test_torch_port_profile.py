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
    (["--resize"], "resize"), (["--resize", "--parent", "x.cu"], "resize"),
    (["--masked"], "masked"), (["--masked", "--parent", "x.cu"], "masked"),
    (["--lstm", "--parent", "x.cu"], "lstm"),
    (["--lstm", "--parent", "x.cu", "y.cu"], "lstm"),
    (["--masked", "--parent", "x.cu", "y.cu"], "masked"),
    (["--conv", "--f32"], "conv"), (["--conv", "--f32", "--parent", "x.cu", "y.cu"], "conv")])
def test_parse_args_modes(profile_port, argv, mode):
    args = profile_port.parse_args(argv)
    modes = [m for m in ("train", "eval", "conv", "lstm", "resize", "masked")
             if getattr(args, m)]
    assert modes == ([mode] if mode else [])
    assert args.trace == ("t.json" if "--trace" in argv else None)
    assert args.parent == (argv[argv.index("--parent") + 1:] if "--parent" in argv else None)
    assert args.f32 == ("--f32" in argv)


@pytest.mark.parametrize("argv", [
    ["--lstm", "--conv"], ["--lstm", "--train"], ["--lstm", "x"], ["--resize", "--lstm"],
    ["--resize", "--conv"], ["--parent", "x.cu"], ["--conv", "--parent", "x.cu"],
    ["--resize", "x.cu"], ["--masked", "--lstm"], ["--masked", "--resize"],
    ["--masked", "x.cu"], ["--train", "--parent", "x.cu"],
    ["--resize", "--parent", "x.cu", "y.cu"], ["--lstm", "--parent"], ["--f32"],
    ["--lstm", "--f32"], ["--f32", "--parent", "x.cu"], ["--eval", "--f32"]])
def test_lstm_mode_refuses_other_modes_and_arguments(profile_port, argv):
    with pytest.raises(SystemExit):
        profile_port.parse_args(argv)


@pytest.mark.parametrize("mode", ["--lstm", "--resize", "--masked"])
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
    ("'_ZN12_GLOBAL__N_122lstm_gate_terms_kernelILb1EEEvPKfS2_PKiS2_S2_Pfiii'",
     "lstm_gate_terms_kernel<true>"),
    ("'_ZN12_GLOBAL__N_122lstm_dw_partial_kernelILb0EEEvPKfS2_PKiPfiiii'",
     "lstm_dw_partial_kernel<false>"),
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


@pytest.mark.parametrize("entry, want", [
    ("'_ZN12_GLOBAL__N_127masked_stats_partial_kernelIfLi2EEEvPKT_S3_PKiPfxi'",
     "masked_stats_partial_kernel<f32, C = 2>"),
    ("'_ZN12_GLOBAL__N_127masked_stats_partial_kernelI6__halfLi3EEEvPKT_S4_PKiPfxi'",
     "masked_stats_partial_kernel<f16, C = 3>"),
    ("'_ZN12_GLOBAL__N_126masked_stats_reduce_kernelEPKfPfS2_S2_ii'", "masked_stats_reduce_kernel"),
    ("'_ZN12_GLOBAL__N_119masked_stats_kernelI13__nv_bfloat16Li1ELb1EEEvPKT_S4_PKiPfxi'",
     "masked_stats_kernel<bf16, C = 1, VEC = true>"),
    ("'_ZN12_GLOBAL__N_119masked_stats_kernelIfLi4ELb0EEEvPKT_S3_PKiPfxi'",
     "masked_stats_kernel<f32, C = 4, VEC = false>"),
])
def test_masked_kernel_label(profile_port, entry, want):
    assert profile_port.masked_kernel_label(
        f"ptxas info    : Compiling entry function {entry}") == want


# maunet_masked_class_sums while D was two launches, with its scratch.
TWO_LAUNCH_MASKED = (
    'extern "C" int maunet_masked_class_sums(const void* pred, const void* target,\n'
    "    const void* dw, void* partial, void* sum_abs,\n    void* sum_sq, void* counts, int B,\n"
    "    long long hw, int nchunks, int C, int dtype,\n    void* stream) {")
ONE_LAUNCH_MASKED = (
    'extern "C" int maunet_masked_class_sums(const void* pred, const void* target,\n'
    "    const void* dw, void* out, int B, long long hw, int C, int dtype, void* stream) {")


@pytest.mark.parametrize("source", [TWO_LAUNCH_MASKED, ONE_LAUNCH_MASKED, "tree"])
def test_masked_parent_arguments_follow_its_signature(profile_port, source):
    """``--masked --parent`` calls another ``masked_stats.cu`` with the
    buffers and sizes its entry point names: the two-launch signature (with
    scratch sized by its 2,048-pixel chunk, a ``long long`` pixel count and
    three outputs) or one output row per sample, whose views are the sums."""
    import ctypes

    import torch

    if source == "tree":
        with open(os.path.join(REPO, "maunet_tpu_torch", "csrc", "masked_stats.cu")) as f:
            source = f.read()
    params = profile_port.entry_params(source, "maunet_masked_class_sums")
    kinds = dict(params)
    assert kinds["hw"] is ctypes.c_longlong and kinds["B"] is ctypes.c_int
    assert kinds["pred"] is kinds["stream"] is ctypes.c_void_p
    pred = torch.zeros(3, 50, 50, 2)
    dw = torch.zeros(3, 50, 50, dtype=torch.int32)
    bufs, sums = profile_port.masked_outputs(params, pred)
    assert [tuple(t.shape) for t in sums] == [(3, 2, 9), (3, 2, 9), (3, 9)]
    args = profile_port.masked_arguments(params, pred, pred.bfloat16(), dw, bufs, 9)
    values = dict(zip((name for name, _ in params), args))
    assert values["B"] == 3 and values["hw"] == 2500 and values["C"] == 2
    assert values["dtype"] == 0 and values["stream"] == 9 and values["dw"] == dw.data_ptr()
    if "out" in values:
        out = bufs["out"]
        assert set(bufs) == {"out"} and out.shape == (3, 45)
        assert all(t.data_ptr() >= out.data_ptr() for t in sums)
        out.copy_(torch.arange(135.0).view(3, 45))
        assert float(sums[1][1, 0, 0]) == 45 + 18 and float(sums[2][2, 8]) == 134
    else:
        assert values["nchunks"] == 2 and bufs["partial"].shape == (3, 2, 45)
        assert values["sum_abs"] == sums[0].data_ptr() and values["counts"] == sums[2].data_ptr()
    with pytest.raises(ValueError, match="unknown parameters"):
        profile_port.masked_arguments([("pred", ctypes.c_void_p), ("flags", ctypes.c_int)],
                                      pred, pred, dw, bufs, 0)


@pytest.mark.parametrize("source", ["tree", "reordered"])
def test_gate_terms_parent_arguments_follow_its_signature(profile_port, source):
    """``--lstm --parent`` calls another ``lstm.cu``'s
    ``maunet_lstm_gate_terms`` with the arguments its signature names."""
    import ctypes

    import torch

    if source == "tree":
        with open(os.path.join(REPO, "maunet_tpu_torch", "csrc", "lstm.cu")) as f:
            source = f.read()
    else:
        source = ('extern "C" int maunet_lstm_gate_terms(const void* h_all, const void* c_all,\n'
                  "    const void* x_proj, const void* w_hh, const void* lengths, void* terms,\n"
                  "    int H, int T, int B, void* stream) {")
    params = profile_port.entry_params(source, "maunet_lstm_gate_terms")
    assert sorted(name for name, _ in params) == sorted(
        ["x_proj", "w_hh", "lengths", "h_all", "c_all", "terms", "B", "T", "H", "stream"])
    assert all((kind is ctypes.c_void_p) == (name in ("x_proj", "w_hh", "lengths", "h_all",
                                                      "c_all", "terms", "stream"))
               for name, kind in params)
    x, w = torch.zeros(2, 7, 40), torch.zeros(10, 40)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    h, c, terms = torch.zeros(2, 7, 10), torch.ones(2, 7, 10), torch.zeros(2, 7, 60)
    values = dict(zip((name for name, _ in params),
                      profile_port.gate_arguments(params, x, w, lens, h, c, terms, 4)))
    assert (values["B"], values["T"], values["H"], values["stream"]) == (2, 7, 10, 4)
    assert values["x_proj"] == x.data_ptr() and values["c_all"] == c.data_ptr()
    assert values["terms"] == terms.data_ptr() and values["lengths"] == lens.data_ptr()


def test_same_gate_bits_reads_only_rows_the_kernel_writes(profile_port):
    import torch

    lens = torch.tensor([3, 0, 5], dtype=torch.int32)
    got = torch.randn(3, 5, 12)
    want = got.clone()
    want[0, 3:] = float("nan")          # rows t >= length are never written
    want[1] = 7.0
    profile_port.same_gate_bits("case", lens, got, want)
    want[2, 4, 11] = torch.nextafter(want[2, 4, 11], torch.tensor(1e9))
    with pytest.raises(AssertionError, match="other bits"):
        profile_port.same_gate_bits("case", lens, got, want)


@pytest.mark.parametrize("shape, dtype, outside", [
    ((2, 16, 16, 2), "float32", False), ((3, 5, 7, 1), "float32", True),
    ((2, 9, 9, 3), "bfloat16", True)])
def test_masked_bincount_gives_the_plain_sums(profile_port, shape, dtype, outside):
    """The bincount yardstick of ``--masked`` computes D's three outputs,
    out-of-range classes counting nowhere."""
    import torch

    from maunet_tpu_torch.ops.kernels import masked_stats

    g = torch.Generator().manual_seed(0)
    pred = torch.randn(shape, generator=g).to(getattr(torch, dtype))
    target = torch.randn(shape, generator=g).to(getattr(torch, dtype))
    dw = torch.randint(0, 9, shape[:3], generator=g, dtype=torch.int32)
    if outside:
        dw[0, 0] = 11
        dw[-1, -1] = -3
    got = profile_port.masked_bincount(pred, target, dw)
    want = masked_stats.masked_class_sums_plain(pred, target, dw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_parent_names_are_distinct(profile_port):
    """Each ``--parent`` file gets its own library and row: its stem, with
    its position where two stems are alike."""
    assert profile_port.parent_names(["build/parent/lstm.cu", "v/lstm_draft.cu"]) == [
        "lstm", "lstm_draft"]
    assert profile_port.parent_names(["a/lstm.cu", "b/lstm.cu", "c/x.cu"]) == [
        "lstm_0", "lstm_1", "x"]
    assert profile_port.parent_names([]) == []


@pytest.mark.parametrize("entry, want", [
    ("'_ZN12_GLOBAL__N_118conv3x3_f32_kernelILi8EEEvN12_GLOBAL__N_17F32ConvE'",
     "conv3x3_f32_kernel<8>"),
    ("'_ZN12_GLOBAL__N_118conv3x3_f32_kernelILi4ELi3EEEvN12_GLOBAL__N_17F32ConvE'",
     "conv3x3_f32_kernel<4, 3>"),
    ("'_ZN12_GLOBAL__N_123conv3x3_pair_f32_kernelILi8ELi4EEEvN12_GLOBAL__N_17F32PairE'",
     "conv3x3_pair_f32_kernel<8, 4>"),
    ("'_ZN12_GLOBAL__N_123conv3x3_pair_f32_kernelILi4ELi4ELi2EEEvN12_GLOBAL__N_17F32PairE'",
     "conv3x3_pair_f32_kernel<4, 4, 2>"),
])
def test_f32_kernel_label(profile_port, entry, want):
    assert profile_port.f32_kernel_label(
        f"ptxas info    : Compiling entry function {entry}") == want


def test_f32_kernel_label_leaves_other_kernels_named_as_given(profile_port):
    entry = "'_ZN12_GLOBAL__N_120conv3x3_fused_kernelILi8ELi3EEEvNS_8ConvArgsE'"
    assert profile_port.f32_kernel_label(entry) == entry


def test_f32_k_width_reads_the_source(profile_port):
    """``--conv --f32 --parent`` lays each file's weights out for its own K
    step: the tree's, and a file with another."""
    from maunet_tpu_torch.ops.kernels import packed_vgg

    with open(os.path.join(REPO, "maunet_tpu_torch", "csrc", "conv3x3_f32.cu")) as f:
        assert profile_port.f32_k_width(f.read()) == packed_vgg.TILE_K_F32
    assert profile_port.f32_k_width("constexpr int TH = 16;\nconstexpr int BK = 16;  // K") == 16
    with pytest.raises(ValueError, match="BK"):
        profile_port.f32_k_width("int main() {}")
    width = packed_vgg.TILE_K_F32
    with profile_port.f32_tile_k(width + 8):
        assert packed_vgg.TILE_K_F32 == width + 8
    assert packed_vgg.TILE_K_F32 == width


def test_f32_parent_arguments_follow_its_signature(profile_port):
    """A parent's A and G entries get the arguments their signatures name,
    with weights prepared at the parent's K step."""
    import torch

    from maunet_tpu_torch.ops.kernels import packed_vgg

    with open(os.path.join(REPO, "maunet_tpu_torch", "csrc", "conv3x3_f32.cu")) as f:
        source = f.read()
    fused, pair = (profile_port.entry_params(source, e) for e in profile_port.F32_ENTRIES)
    parts = [torch.zeros(2, 5, 7, c) for c in (3, 9)]
    weights = [torch.ones(6, c, 3, 3) for c in (3, 9)]
    with profile_port.f32_tile_k(16):
        p1 = packed_vgg.prepare_conv3x3(weights, torch.ones(6), torch.zeros(6), torch.float32)
    assert p1.packed.numel() == 2 * 9 * 16 * 32
    p2 = packed_vgg.prepare_conv3x3([torch.ones(4, 6, 3, 3)], None, torch.zeros(4),
                                    torch.float32)
    out, add = torch.empty(2, 5, 7, 6), torch.zeros(2, 3, 7, 6)
    args, keep = profile_port.f32_arguments(profile_port.F32_ENTRIES[0], fused, parts, p1,
                                            out, add, 11)
    named = dict(zip([n for n, _ in fused], args))
    assert named["wpk"] == p1.packed.data_ptr() and named["scale"] == p1.scale.data_ptr()
    assert [named[k] for k in ("nparts", "B", "H", "W", "cout", "relu", "stream")] == [
        2, 2, 5, 7, 6, 1, 11]
    assert list(keep[1]) == [3, 9] and list(keep[0]) == [p.data_ptr() for p in parts]
    out2 = torch.empty(2, 5, 7, 4)
    args, _ = profile_port.f32_arguments(profile_port.F32_ENTRIES[1], pair, parts, p1, out2,
                                         None, 11, p2)
    named = dict(zip([n for n, _ in pair], args))
    assert named["w2pk"] == p2.packed.data_ptr() and named["add"] is None
    assert [named[k] for k in ("cmid", "cout", "out")] == [6, 4, out2.data_ptr()]
    assert named["bias2"] == p2.bias.data_ptr() and named["scale1"] == p1.scale.data_ptr()
