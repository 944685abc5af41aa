"""The port's span facility (``observability.span`` / ``totals``) and the
spans the program places: without a profiler a span only counts (no
``record_function``, no CUDA event); under ``torch.profiler`` its name
sits in the exported trace, nested, in the active steps only; the
engine's six spans and their bytes, also with the engine on its own
thread; every tiny flux and Wan block's three torch-op regions, none of
which holds a linear or attention call; the loader's three phases and
their bytes on a tiny GGUF; the pipeline's stage spans beside
``last_timings``; the engine's queue and sync waits. The one test marked
``cuda`` holds a span's device seconds against CUDA events around the
same ops, on the card."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch import _build, observability, serving
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import flux, t5, testing, vae, wan
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule
from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer
from comfyui_gguf_tpu_torch.tokenizer.clip_bpe import CLIPBPETokenizer

torch.set_num_threads(2)

CPU = torch.device("cpu")
F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
REGIONS = ("forward.norm_mod", "forward.qk_rope", "forward.gate_res")
ENGINE = ("engine.tick", "engine.admit", "engine.stack", "engine.dispatch",
          "engine.sync", "engine.retire")


@pytest.fixture(autouse=True)
def fresh_registry():
    observability.reset()
    yield
    observability.reset()


def _counts():
    return {k: v["count"] for k, v in observability.totals().items()}


# -- the facility ----------------------------------------------------------


def test_without_a_profiler_a_span_only_counts(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(observability, "_RF_ENTER", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with observability.span("t.outer", nbytes=10) as s:
            with observability.span("t.inner") as inner:
                inner.nbytes += 7
                sum(range(1000))
    t = observability.totals()
    assert t["t.outer"]["count"] == 3 and t["t.inner"]["count"] == 3
    assert t["t.outer"]["nbytes"] == 30 and t["t.inner"]["nbytes"] == 21
    # nested spans keep their own totals: the outer holds the inner
    assert t["t.outer"]["host_s"] >= t["t.inner"]["host_s"] > 0
    assert s.seconds > 0
    assert t["t.inner"]["device_count"] == 0
    assert t["t.inner"]["device_s"] == 0.0


def test_a_span_counts_when_its_block_raises():
    with pytest.raises(ValueError):
        with observability.span("t.raise", nbytes=3):
            raise ValueError("x")
    assert observability.totals()["t.raise"]["count"] == 1
    assert observability.totals()["t.raise"]["nbytes"] == 3


def test_totals_is_a_copy_and_reset_empties():
    with observability.span("t.a"):
        pass
    t = observability.totals()
    t["t.a"]["count"] = 99
    assert observability.totals()["t.a"]["count"] == 1
    observability.reset()
    assert observability.totals() == {}


class _Stream:
    """Stand-in CUDA events on one stream: event i completes once the
    stream has run past it; waiting on one runs the stream up to it."""

    def __init__(self):
        self.ran = 0

    def event(self, i, ms):
        s = self

        class Ev:
            def query(self):
                return s.ran > i

            def synchronize(self):
                s.ran = max(s.ran, i + 1)

            def elapsed_time(self, end):
                assert end.query(), "read before it completed"
                return ms

        return Ev()


@pytest.mark.parametrize("done", [0, 4, 7])
def test_resolve_reads_the_completed_events_and_totals_waits(done):
    reg = observability._REGISTRY
    st = _Stream()
    with observability.span("t.dev"):
        pass
    for i in range(7):
        ev = st.event(i, float(i + 1))
        reg.pending.append(("t.dev", ev, ev))
    st.ran = done
    observability.resolve()
    assert len(reg.pending) == 7 - done
    if done:
        assert reg.device["t.dev"] == [
            pytest.approx(done * (done + 1) / 2 * 1e-3), done]
    t = observability.totals()  # waits for the rest
    assert not reg.pending and st.ran == 7
    assert t["t.dev"]["device_s"] == pytest.approx(28e-3)
    assert t["t.dev"]["device_count"] == 7


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps a clock on the stream it
    is given; every recorded event has completed."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = self.stream = None

    def record(self, stream=None):
        assert stream == "the stream"
        _FakeEvent.clock += 1.0
        self.stream, self.t = stream, _FakeEvent.clock

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_under_a_profiler_a_span_times_an_event_pair_read_at_the_cap(
        monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(observability, "_current_stream",
                        lambda: "the stream")
    monkeypatch.setattr(observability, "PENDING_CAP", 3)
    reg = observability._REGISTRY
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with observability.span("t.dev"):
                pass
            # the third exit reads the three pairs waiting
            assert len(reg.pending) == (i + 1 if i < 2 else i - 2)
    t = observability.totals()["t.dev"]
    assert t["count"] == 5 and t["device_count"] == 5
    assert t["device_s"] == pytest.approx(5e-3)  # 1 ms between each pair
    assert not reg.pending


def _trace_events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_under_the_profiler_spans_sit_in_the_trace_in_active_steps_only(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile, schedule

    skip, active = 1, 2
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=skip, warmup=1, active=active,
                                     repeat=1))
    x = torch.ones(64, 64)
    with prof:
        for _ in range(skip + 1 + active + 2):
            with observability.span("t.step"):
                with observability.span("t.op"):
                    x = torch.relu(x @ x)
            prof.step()
    evs = _trace_events(prof, tmp_path)
    steps = [e for e in evs if e["name"].startswith("ProfilerStep#")]
    outer = [e for e in evs if e["name"] == "t.step"]
    inner = [e for e in evs if e["name"] == "t.op"]
    assert len(steps) == active and len(outer) == active == len(inner)

    def within(e, box):
        return (box["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= box["ts"] + box["dur"])

    for o in outer:
        assert any(within(o, s) for s in steps)
        assert sum(within(i, o) for i in inner) == 1
    # every step counted on the host, traced or not
    assert observability.totals()["t.step"]["count"] == skip + 1 + active + 2


# -- the engine --------------------------------------------------------------


def _linear_step(x, s_cur, s_next, cond):
    return x + (s_next - s_cur).reshape(-1, 1, 1, 1) * cond["c"].reshape(
        -1, 1, 1, 1)


def _engine(**kw):
    return serving.ContinuousBatchEngine(_linear_step, device="cpu", **kw)


def _lat():
    return np.zeros((4, 4, 2), np.float32)


def test_the_engine_runs_its_six_spans_with_their_bytes():
    eng = _engine(max_batch=2)
    reqs = [eng.submit(_lat(), {"c": np.float32(i)}, linear_schedule(3))
            for i in range(3)]
    ticks = 0
    while eng.active or not eng.queue.empty():
        eng.tick()
        ticks += 1
    t = observability.totals()
    assert set(ENGINE) <= set(t)
    assert t["engine.tick"]["count"] == t["engine.admit"]["count"] == ticks
    st = eng.stats
    assert (t["engine.dispatch"]["count"] == t["engine.stack"]["count"]
            == st.batches_executed)
    assert t["engine.sync"]["count"] == t["engine.retire"]["count"]
    # admitted: a float32 latent and a float32 scalar a request
    assert t["engine.admit"]["nbytes"] == 3 * (4 * 4 * 2 * 4 + 4)
    assert t["engine.retire"]["nbytes"] == sum(r.result.nbytes for r in reqs)
    assert t["engine.tick"]["host_s"] >= t["engine.dispatch"]["host_s"]


def test_engine_stats_carry_queue_and_sync_waits():
    eng = _engine(max_batch=1)
    r1 = eng.submit(_lat(), {"c": np.float32(1)}, linear_schedule(2))
    r2 = eng.submit(_lat(), {"c": np.float32(2)}, linear_schedule(2))
    eng.run_until_drained()
    st = eng.stats
    assert r1.submitted_at <= r1.admitted_at <= r1.completed_at
    # the second waited in the queue while the first took the only lane
    assert r2.admitted_at >= r1.completed_at
    assert st.admitted == 2
    assert st.total_queue_wait_s == pytest.approx(
        (r1.admitted_at - r1.submitted_at) + (r2.admitted_at
                                              - r2.submitted_at))
    snap = st.snapshot()
    assert snap["mean_queue_wait_s"] == round(st.total_queue_wait_s / 2, 4)
    # the wait is the engine.sync spans' host seconds
    assert st.total_wait_s == pytest.approx(
        observability.totals()["engine.sync"]["host_s"])
    assert snap["wait_s"] == round(st.total_wait_s, 4)


def test_an_engine_on_its_own_thread_keeps_consistent_totals():
    eng = _engine(max_batch=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        reqs = [eng.submit(_lat(), {"c": np.float32(i)}, linear_schedule(2))
                for i in range(12)]
        stop = threading.Event()

        def noise():  # spans from a second thread meanwhile
            while not stop.is_set():
                with observability.span("t.other", nbytes=1):
                    pass

        th = threading.Thread(target=noise)
        th.start()
        for r in reqs:
            assert r.done_event.wait(timeout=60)
        stop.set()
        th.join(timeout=60)
        assert not th.is_alive()
        eng.stop()
    finally:
        sys.setswitchinterval(old)
    t = observability.totals()
    assert t["engine.dispatch"]["count"] == eng.stats.batches_executed
    assert t["engine.admit"]["nbytes"] == 12 * (4 * 4 * 2 * 4 + 4)
    assert t["engine.retire"]["nbytes"] == sum(r.result.nbytes for r in reqs)
    assert t["t.other"]["count"] == t["t.other"]["nbytes"] > 0


# -- the model forwards ------------------------------------------------------


class _OpenSpans:
    """Tracks the spans open while a model module runs, and which of them
    a linear or attention call of that module ran under."""

    def __init__(self, monkeypatch, module):
        self.open: list[str] = []
        self.bad: list[tuple[str, str]] = []
        tracker = self

        class Tracked(observability.span):
            __slots__ = ()

            def __enter__(self):
                tracker.open.append(self.name)
                return super().__enter__()

            def __exit__(self, *exc):
                tracker.open.pop()
                return super().__exit__(*exc)

        monkeypatch.setattr(module, "span", Tracked)
        for name in ("linear", "linear_gelu", "dot_product_attention"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, self._tap(
                    getattr(module, name), name))

    def _tap(self, fn, name):
        def tapped(*a, **kw):
            self.bad += [(name, s) for s in self.open if s in REGIONS]
            return fn(*a, **kw)
        return tapped


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
def test_every_flux_block_emits_the_three_regions(monkeypatch, stacked):
    dims = testing.TinyFluxDims(depth_double=2, depth_single=3)
    sp = testing.flux_random_stacked_params(dims, device="cpu")
    spans = _OpenSpans(monkeypatch, flux)
    args = testing.flux_example_inputs(dims, device="cpu")
    with torch.no_grad():
        if stacked:
            flux.forward_stacked(sp, dims.config(), *args)
        else:
            flux.forward(testing.flux_flat_views(sp), dims.config(), *args)
    c = _counts()
    nd, ns = dims.depth_double, dims.depth_single
    assert c["forward.block"] == nd + ns
    assert c["forward.prelude"] == c["forward.final"] == 1
    # double: img+txt modulate, then each stream's MLP norm; single: one;
    # the final layer's one
    assert c["forward.norm_mod"] == 3 * nd + ns + 1
    # before attention (RoPE included), the output merge
    assert c["forward.qk_rope"] == 2 * (nd + ns)
    # double: two gated residuals a stream; single: the concat and one
    assert c["forward.gate_res"] == 4 * nd + 2 * ns
    assert spans.bad == [] and spans.open == []


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
def test_every_wan_block_emits_the_three_regions(monkeypatch, stacked):
    dims = testing.WanDims(n_layers=3)
    sp = testing.wan_random_stacked_params(dims, device="cpu")
    cfg = dims.config()
    spans = _OpenSpans(monkeypatch, wan)
    g = torch.Generator().manual_seed(0)
    lat = torch.randn((1, 2, 4, 4, dims.in_ch), generator=g).to(
        torch.bfloat16)
    ctx = torch.randn((1, 5, dims.text_dim), generator=g).to(torch.bfloat16)
    ts = torch.tensor([0.5])
    with torch.no_grad():
        if stacked:
            wan.forward_stacked(sp, cfg, lat, ctx, ts)
        else:
            flat = {k: v for k, v in sp.items() if k != "blocks"}
            for i in range(cfg.n_layers):
                flat.update({f"blocks.{i}.{k}": v for k, v in
                             flux.block_view(sp["blocks"], i).items()})
            wan.forward(flat, cfg, lat, ctx, ts)
    c = _counts()
    n = cfg.n_layers
    assert c["forward.block"] == n
    assert c["forward.prelude"] == c["forward.final"] == 1
    # modulate + norm3 + the FFN's norm a block, and the head's
    assert c["forward.norm_mod"] == 3 * n + 1
    # self and cross attention: before each, and each output's merge
    assert c["forward.qk_rope"] == 4 * n
    assert c["forward.gate_res"] == 3 * n
    assert spans.bad == [] and spans.open == []


# -- the loader and the builds -----------------------------------------------


def test_the_loader_runs_its_three_phases_with_their_bytes(tmp_path):
    # K = 512: the block linears planarize, the 16-channel ones stay dense
    dims = testing.WanDims(dim=512, ffn_dim=1024, n_heads=4, n_layers=1,
                           text_dim=512)
    sd = testing.random_flat_sd_from_spec(*testing.wan_shape_spec(dims),
                                          seed=0)
    path = str(tmp_path / "wan_Q4_K.gguf")
    testing.write_spec_gguf(sd, path, "wan", Q.Q4_K)
    qsd = gguf_sd_loader(path)
    observability.reset()
    params = to_torch_params(qsd, device="cpu")
    t = observability.totals()
    planar = [v for v in params.values() if isinstance(v, PlanarQuant)]
    assert planar and len(planar) < len(params)
    assert t["loader.decode"]["count"] == len(qsd)
    assert t["loader.decode"]["nbytes"] == sum(q.data.nbytes
                                               for q in qsd.values())
    assert t["loader.pack"]["count"] == len(planar)
    assert t["loader.copy"]["count"] == len(params)
    assert t["loader.copy"]["nbytes"] == sum(
        v.nbytes_packed if isinstance(v, PlanarQuant)
        else v.numel() * v.element_size() for v in params.values())
    assert all(t[k]["host_s"] > 0 for k in
               ("loader.decode", "loader.pack", "loader.copy"))


def test_a_kernel_library_build_runs_under_its_span(monkeypatch):
    # the host codecs: built (or found built) again in this process
    monkeypatch.setattr(_build, "_host_lib", None)
    _build.host_lib()
    assert observability.totals()["build.host"]["count"] == 1


# -- the pipeline ------------------------------------------------------------


def _tiny_flux_pipeline():
    dims = testing.TinyFluxDims(depth_double=1, depth_single=1)
    model = tpipeline.DiffusionModel(
        arch="flux", params=testing.flux_flat_views(
            testing.flux_random_stacked_params(dims, device="cpu")),
        config=dims.config(), qcfg=F32, device=CPU)
    t5_sd = testing.t5_state_dict(
        testing.T5Dims(d_model=dims.ctx, d_kv=16, n_heads=4, d_ff=128,
                       n_layers=1, vocab=64), seed=2)
    enc = tpipeline.TextEncoder(
        "t5", params_from_numpy(t5_sd, device="cpu"),
        t5.T5Config.from_state_dict(t5_sd),
        UnigramTokenizer(testing.unigram_spec(64)), F32, CPU)
    vocab, merges = testing.clip_vocab(600)
    clip_sd = testing.clip_state_dict(
        testing.CLIPDims(hidden=64, n_layers=1, n_heads=1, intermediate=96,
                         vocab=600, max_positions=16, proj=dims.vec), seed=3)
    clip = tpipeline.TextEncoder(
        "clip_l", params_from_numpy(clip_sd, device="cpu"),
        tclip.CLIPTextConfig.from_state_dict(clip_sd),
        CLIPBPETokenizer(vocab, merges), F32, CPU)
    vae_sd = testing.vae_state_dict(
        testing.VAEDims(z_channels=dims.in_ch // 4, base_ch=32), seed=4)
    return tpipeline.FluxPipeline(
        model, enc, clip, params_from_numpy(vae_sd, device="cpu"),
        vae.VAEConfig.from_state_dict(vae_sd))


def test_pipeline_stages_run_as_spans_beside_unchanged_last_timings():
    pipe = _tiny_flux_pipeline()
    pipe.generate("a cat", width=32, height=32, steps=2, max_t5_len=8)
    timings = pipe.last_timings
    assert set(timings) == {"tokenize_s", "t5_s", "clip_s", "denoise_s",
                            "vae_s", "total_s"}
    t = observability.totals()
    for stage in ("tokenize", "t5", "clip", "denoise", "vae"):
        rec = t[f"pipeline.{stage}"]
        assert rec["count"] == 1
        # the span ends at the stage's mark, the mark's clock reads after
        assert 0 < rec["host_s"] <= timings[f"{stage}_s"] + 1e-3
    assert t["forward.block"]["count"] == 2 * 2  # two steps, two blocks


def test_the_stage_clock_refuses_a_mark_out_of_order():
    clock = tpipeline._StageClock(CPU, "encode_s", "denoise_s")
    with pytest.raises(ValueError):
        clock.mark("denoise_s")
    clock2 = tpipeline._StageClock(CPU, "encode_s")
    clock2.mark("encode_s")
    assert set(clock2.timings()) == {"encode_s", "total_s"}
    assert observability.totals()["pipeline.encode"]["count"] == 1


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device seconds come from CUDA "
                    "events on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_device_seconds_match_cuda_events(cuda):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16)

    def ops(x):
        for _ in range(40):
            x = torch.nn.functional.layer_norm(x, x.shape[-1:]) * 1.5 + 0.25
        return x

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with observability.span("t.warm"):  # the first events, timed apart
            ops(x)
        torch.cuda.synchronize()
        # the card runs behind the host, so the host's own time between
        # the events (the span's enter and exit) leaves no gap on it
        for _ in range(20):
            w @ w
        a.record()
        with observability.span("t.cuda"):
            ops(x)
        b.record()
    torch.cuda.synchronize()
    t = observability.totals()["t.cuda"]
    assert t["device_count"] == 1
    want = a.elapsed_time(b) * 1e-3
    assert t["device_s"] == pytest.approx(want, rel=0.05)
