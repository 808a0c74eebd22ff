"""The trace and count arithmetic of the benchmark."""

import json

import pytest

from portbench import counts
from portbench import trace as tr
from portbench.tests import tiny


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_busy_is_the_union_of_kernels_copies_and_memsets_inside_the_window(tmp_path):
    """The window and spans are the host's ``time.time_ns`` readings, placed
    on the trace's clock by its base time."""
    base = 1_790_000_000_000_000_000
    events = [
        ev("kernel", "conv3x3_fused_kernel<64>", 200.0, 100.0),    # 200 .. 300 us
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 250.0, 150.0),  # 250 .. 400
        ev("gpu_memset", "Memset (Device)", 390.0, 20.0),          # 390 .. 410
        ev("kernel", "void at::native::elementwise_kernel<128>", 700.0, 50.0),  # 700 .. 750
        ev("kernel", "before_window", 0.0, 50.0),
        ev("kernel", "straddles_the_end", 1050.0, 100.0),          # 1050 .. 1150
        ev("cuda_runtime", "cudaLaunchKernel", 190.0, 5.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": events}))
    us = lambda t: base + int(t * 1000)
    view = tr.read_file(str(path), [(tr.WINDOW, us(100), us(1100)),
                                    ("portbench.predict", us(150), us(650))])
    assert view.window_s == pytest.approx(1000e-6)
    # 200..410 (210) + 700..750 (50) + 1050..1100 (50, clipped) = 310 us
    assert view.busy_s() == pytest.approx(310e-6)
    assert view.busy_s(150e-6, 650e-6) == pytest.approx(210e-6)
    assert view.kernel_s("conv3x3_fused_kernel") == pytest.approx(100e-6)
    fam = view.family_s(tr.TRAIN_FAMILIES)
    assert fam["A conv3x3_fused"] == pytest.approx(100e-6)
    assert fam[tr.COPIES] == pytest.approx(170e-6)
    gaps = dict(view.idle_gaps())
    # idle gaps, each labelled by the span around its middle: 100..200 and
    # 410..700 in predict (390), 750..1050 outside any span (300)
    assert gaps["portbench.predict"] == pytest.approx(390e-6)
    assert gaps["host"] == pytest.approx(300e-6)
    assert view.device_ops()[0][0] in ("gpu_memcpy", "conv3x3_fused_kernel")


def test_family_matching_follows_profile_port():
    import profile_port

    for name in ("conv3x3_fused_kernel<64, 3>", "lstm_last_hidden_kernelILb1E",
                 "lstm_gate_terms_kernel", "sm90_xmma_fprop_implicit_gemm",
                 "multi_tensor_apply_kernel", "cutlass_80_gemm", "elementwise"):
        assert tr.family(name, tr.TRAIN_FAMILIES).split(" (")[0] == \
            profile_port.family(name, profile_port.TRAIN_FAMILIES, tr.OTHER).split(" (")[0]


def test_a_bound_is_chip_smokes_at_the_serving_shapes():
    import chip_smoke

    cfg = tiny.harness_cfg("unet64")
    launches = counts.a_launches(cfg, 256)
    assert [(c.parts, c.cout) for c in launches] == [((23,), 64), ((64,), 64),
                                                     ((64, 128), 64), ((64,), 64)]
    total = 0.0
    for c in launches:
        nbytes, flops, kind = chip_smoke.conv_work(8, (256, 256), c.parts, c.cout, False)
        assert counts.conv_work(8, 256, c.parts, c.cout, False) == (nbytes, flops)
        total += max(nbytes / chip_smoke.HBM_BYTES_PER_S, flops / chip_smoke.PEAK_FLOPS[kind])
    assert counts.a_bound_s(cfg, 256, 8) == pytest.approx(total, rel=1e-12)
    # U-Net++ at base 32: 18 launches, the first conv of each decoder node
    # with the embedding's compact add.
    pp = counts.a_launches(tiny.harness_cfg("unetpp32"), 256)
    assert len(pp) == 18 and sum(c.emb > 0 for c in pp) == 7


def test_unet64_forward_flops_are_a_hand_count():
    """113.5 GFLOP a 256 x 256 tile: the 18 3x3 convs over all their input
    channels (the 128 embedding channels at the bottleneck included) and the
    1x1 head; the LSTM and the dense layers add about 0.1 percent."""
    hand = 2 * 9 * (
        256 * 256 * (23 * 64 + 64 * 64 + 192 * 64 + 64 * 64)
        + 128 * 128 * (64 * 128 + 128 * 128 + 384 * 128 + 128 * 128)
        + 64 * 64 * (128 * 256 + 256 * 256 + 768 * 256 + 256 * 256)
        + 32 * 32 * (256 * 512 + 512 * 512 + 1536 * 512 + 512 * 512)
        + 16 * 16 * (640 * 1024 + 1024 * 1024)) + 2 * 256 * 256 * 64 * 2
    assert hand == 113_489_477_632
    cfg = tiny.harness_cfg("unet64")
    lstm = 2 * 97 * 384 * 828
    dense = 2 * (96 * 64 + 8 * 32 + 32 * 64)
    assert counts.forward_flops(cfg, 256, 1, 828) == hand + lstm + dense
    assert counts.forward_flops(tiny.harness_cfg("unetpp32"), 256, 1, 0) / 1e9 == \
        pytest.approx(99.33, abs=0.01)
