"""``maunet_tpu_torch/utils/profiling.py`` against the JAX package's
``utils/profiling.py``, as JAX ``tests/test_export.py:8-30`` holds it: the
step timer's summary (the same for both modules on the same ticks), the
memory statistics (no CUDA device here: an empty list), and a trace
written as a Chrome trace."""

import json
import time

from maunet_tpu.utils.profiling import StepTimer as JaxStepTimer

from maunet_tpu_torch.utils import profiling


def test_step_timer():
    t = profiling.StepTimer(skip_first=1)
    for _ in range(5):
        t.tick()
        time.sleep(0.01)
    s = t.summary()
    assert s["n"] == 3 and t.steps == 3
    assert 0.005 < s["mean_s"] < 0.1
    assert s["steps_per_s"] > 5
    t.reset()
    assert t.summary() == {} and t.steps == 0


def test_step_timer_summary_equals_jax(monkeypatch):
    """The same ticks give the same summary in both packages."""
    clock = iter([0.0, 0.5, 0.75, 1.5, 1.625, 3.0, 3.5] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    port, jax_timer = profiling.StepTimer(skip_first=1), JaxStepTimer(skip_first=1)
    for timer in (port, jax_timer):
        for _ in range(7):
            timer.tick()
    assert port.summary() == jax_timer.summary()


def test_device_memory_stats_without_a_card():
    assert profiling.device_memory_stats() == []


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
