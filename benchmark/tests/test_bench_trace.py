"""The traced run's reduction: busy time as a union of device intervals,
idle gaps named by the host's activity, seconds by family and class."""

import pytest

import _paths  # noqa: F401
from devtrace import LABEL_MIN_US, Timeline


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("ProfilerStep#2", "user_annotation", 0, 100),
    ev("ProfilerStep#3", "user_annotation", 100, 100),
    ev("bench.engine_tick", "user_annotation", 0, 199),
    ev("aten::mm", "cpu_op", 95, 40),
    ev("cudaStreamSynchronize", "cuda_runtime", 160, 39),
    ev("void qmm_wgmma_kernel<true>", "kernel", 10, 20),
    ev("void flash_fwd_kernel<128>", "kernel", 20, 30),  # overlaps
    ev("Memcpy HtoD", "gpu_memcpy", 60, 10),
    ev("void at::native::vectorized_elementwise_kernel", "kernel", 150, 10),
    ev("void at::native::vectorized_elementwise_kernel", "kernel", 250,
       10),  # outside the window
]


def test_union_and_gaps():
    t = Timeline(EVENTS)
    assert t.window_s == pytest.approx(200e-6)
    assert t.steps == 2
    assert t.busy_s == pytest.approx(60e-6)  # [10, 50] + [60, 70] + [150, 160]
    assert t.class_s["linear"] == pytest.approx(20e-6)
    assert t.class_s["attention"] == pytest.approx(30e-6)
    assert t.class_s["torch_ops"] == pytest.approx(20e-6)
    short = f"gaps under {LABEL_MIN_US:g} us between launches"
    assert t.idle[short] == pytest.approx(20e-6)  # [0, 10] and [50, 60]
    assert t.idle["bench.engine_tick / aten::mm"] == pytest.approx(80e-6)
    assert t.idle["bench.engine_tick / cudaStreamSynchronize"] == \
        pytest.approx(40e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["K7 flash_attn", pytest.approx(30e-6)]
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(140e-6)


def test_a_trace_without_steps_is_refused():
    with pytest.raises(RuntimeError):
        Timeline([e for e in EVENTS if "ProfilerStep" not in e["name"]])
