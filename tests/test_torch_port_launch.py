"""Every kernel launch of the port goes through ``_build.launch``, which
makes the launching tensor's device current for the call: the C entry points
read the SM count and the shared-memory opt-in of the runtime's current
device, and launch on it, so a model replica on ``cuda:1`` needs its own
device current.  On the CPU the CUDA branch of each wrapper is driven with
``_build.on_cpu`` patched to answer False and ``launch`` recording its calls;
``function``, ``check`` and ``stream_of`` raise if a wrapper reaches them
other than through ``launch``."""

import contextlib

import pytest
import torch

from maunet_tpu_torch.ops.kernels import _build, lstm, masked_stats, packed_vgg, resize_pack


def _forbidden(name):
    def fail(*args, **kw):
        raise AssertionError(f"_build.{name} called outside _build.launch")
    return fail


@pytest.fixture
def launches(monkeypatch):
    calls = []

    def launch(what, name, argtypes, t, *args):
        assert len(args) + 1 == len(argtypes), (name, len(args), len(argtypes))
        calls.append((name, t.device))

    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "launch", launch)
    for name in ("function", "check", "stream_of"):
        monkeypatch.setattr(_build, name, _forbidden(name))
    return calls


def test_every_wrapper_launches_through_the_device_helper(launches):
    g = torch.Generator().manual_seed(0)
    bf = dict(dtype=torch.bfloat16)
    x = torch.randn(2, 8, 8, 3, generator=g).to(**bf)
    w1, w2 = torch.randn(4, 3, 3, 3, generator=g), torch.randn(4, 4, 3, 3, generator=g)
    with torch.no_grad():
        packed_vgg.conv3x3_fused([x], [w1], relu=True)
        packed_vgg.conv3x3_pair_fused([x], [w1], w2)
    resize_pack.resize_pack(x, (16, 16))
    b, t, h = 2, 5, 4
    x_proj = torch.randn(b, t, 4 * h, generator=g)
    w_hh = torch.randn(h, 4 * h, generator=g)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    h_all = torch.randn(b, t, h, generator=g)
    lstm.lstm_last_hidden(x_proj, w_hh, lengths)
    lstm.lstm_forward_stash(x_proj, w_hh, lengths)
    lstm.lstm_gate_terms(x_proj, w_hh, lengths, h_all, h_all)
    lstm.lstm_backward(x_proj, w_hh, lengths, h_all, h_all, torch.randn(b, h, generator=g))
    lstm.lstm_dw(h_all, x_proj, lengths)
    pred = torch.randn(2, 8, 8, 2, generator=g)
    masked_stats.masked_class_sums(pred, pred, torch.zeros(2, 8, 8, dtype=torch.int32))
    assert [name for name, _ in launches] == [
        "maunet_conv3x3_fused", "maunet_conv3x3_pair", "maunet_resize_align_corners",
        "maunet_lstm_last_hidden", "maunet_lstm_forward_stash", "maunet_lstm_gate_terms",
        "maunet_lstm_gate_terms", "maunet_lstm_backward", "maunet_lstm_dw",
        "maunet_masked_class_sums"]
    assert {device for _, device in launches} == {torch.device("cpu")}


def test_launch_makes_the_tensors_device_current(monkeypatch):
    current = []

    @contextlib.contextmanager
    def device(d):
        current.append(d)
        yield
        current.pop()

    seen = []

    def entry_point(*args):
        seen.append((list(current), args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "function", lambda name, argtypes: entry_point)
    monkeypatch.setattr(_build, "stream_of", lambda t: 1234)
    class OnSecondCard:
        """A tensor on cuda:1, as far as ``launch`` asks."""

        def get_device(self):
            return 1

    _build.launch("what", "maunet_x", [None] * 3, OnSecondCard(), 7, 8)
    assert seen == [([1], (7, 8, 1234))] and current == []
