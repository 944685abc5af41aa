"""The readers of the program's spans (``metrics/forward.*_ms.py``,
``metrics/loader.*_s.py``, through ``spans.py``): None from an empty
registry and from a program that keeps no span totals, and the right
numbers from totals filled by hand."""

import types

import pytest

import _paths
import run
from comfyui_gguf_tpu_torch import observability

REGIONS = ("norm_mod", "qk_rope", "gate_res")
PHASES = ("decode", "pack", "copy")


def _reader(name):
    return run._reader(_paths.BENCH, name)


def _inputs(traced_steps, per_tick=None):
    host = {} if per_tick is None else {"denoise_steps_per_tick": per_tick}
    return run.MetricInputs(None, host, [], None, traced_steps)


def _filled(monkeypatch, recs):
    def totals():
        return {k: dict(v) for k, v in recs.items()}

    monkeypatch.setattr(observability, "totals", totals)


NAMES = ([f"forward.{r}_ms.{c}" for r in REGIONS
          for c in ("serve", "video", "image")]
         + [f"loader.{p}_s" for p in PHASES])


@pytest.mark.parametrize("name", NAMES)
def test_an_empty_registry_reads_none(monkeypatch, name):
    _filled(monkeypatch, {})
    assert _reader(name).read(_inputs(3)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_span_totals_reads_none(monkeypatch, name):
    # the parent commit's program: observability has no totals()
    monkeypatch.delattr(observability, "totals")
    assert _reader(name).read(_inputs(3)) is None


@pytest.mark.parametrize("region", REGIONS)
def test_a_region_reads_device_ms_a_denoise_step(monkeypatch, region):
    rec = {"count": 900, "host_s": 2.0, "nbytes": 0, "device_s": 0.6,
           "device_count": 600}
    _filled(monkeypatch, {f"forward.{region}": rec})
    # an engine cell: 3 traced steps, one denoise step each
    assert _reader(f"forward.{region}_ms.serve").read(
        _inputs(3)) == pytest.approx(200.0)
    # a text-to-image cell: one traced image of 20 denoise steps
    assert _reader(f"forward.{region}_ms.image").read(
        _inputs(1, 20)) == pytest.approx(30.0)
    # spans that never ran while the profiler recorded: no reading
    _filled(monkeypatch, {f"forward.{region}": dict(
        rec, device_s=0.0, device_count=0)})
    assert _reader(f"forward.{region}_ms.video").read(_inputs(2)) is None
    # no traced steps: no reading
    _filled(monkeypatch, {f"forward.{region}": rec})
    assert _reader(f"forward.{region}_ms.video").read(_inputs(0)) is None


@pytest.mark.parametrize("phase", PHASES)
def test_a_loader_phase_reads_its_host_seconds(monkeypatch, phase):
    _filled(monkeypatch, {f"loader.{phase}": {
        "count": 4, "host_s": 1.25, "nbytes": 10, "device_s": 0.0,
        "device_count": 0}})
    assert _reader(f"loader.{phase}_s").read(_inputs(0)) == 1.25


def test_the_readers_read_the_live_registry():
    observability.reset()
    try:
        with observability.span("loader.pack"):
            pass
        got = _reader("loader.pack_s").read(types.SimpleNamespace())
        assert got == observability.totals()["loader.pack"]["host_s"] > 0
        assert _reader("loader.copy_s").read(types.SimpleNamespace()) is None
    finally:
        observability.reset()
