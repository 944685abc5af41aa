"""Closed-loop clients over the program's continuous-batching engine.

``traffic["clients"]`` clients each keep one request in flight: when one
finishes, its client sends the next before the engine's next step. The
first requests go in one per step during set-up, so the lanes of a full
pool sit at mixed steps of their schedules; the window then starts on a
full, steady pool. Requests are made from the seed and their index alone,
so a run's batches do not depend on its timing.

Set-up: weights from the seed -> the program's loader -> the model (as the
configuration's tree says) -> the engine, and the warm-up steps, which fill
the pool and so run every batch shape the window uses.

Window: whole engine steps until ``seconds`` have passed.

Check, once the program is freed (the numbers ``check`` returns):

- ``fwd_gap``: every lane of ``check_steps`` window steps drawn from the
  seed's first ``check_span``: each forward output of the step (both CFG
  branches where the model has them) against the plain float32 reference's
  forward of that lane, from the lane's latent and sigma and the request's
  own inputs: the worst relative L2 gap. It follows the program step by
  step from its own latents; the start and the update are checked apart:
- ``update_miss``: every lane of every step of the window: how many latent
  values are not the nearest value of their type to x + (s_next - s_cur) v
  (the step's velocity from its forward outputs), beyond float32's own
  rounding: the sampler update, exact.
- ``start_gap``: every request's first latent against the noise the
  benchmark made, exact.
- ``op_gap``: layer calls of the checked steps, drawn from the seed (the
  quantized linears and the attention calls, a sample of rows or query rows
  of each), each against the plain float32 reference of that call from the
  same operands, the weights decoded from the stored blocks: the worst
  relative L2 gap.

With ``ctx.control`` set to ``"fp8"`` the reference computed one
precision below (``refops.rounded``) takes the program's place in
``fwd_gap``; the program's own reading is kept beside it.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import program
import refops
import weights
from checks import SetupClock, keep_call, op_gap, rel, update_miss


class Tick:
    """One engine step: its lanes as (request index, step), latents in
    and out, sigmas, the forward outputs, the layer calls kept."""

    __slots__ = ("lanes", "x", "x_next", "s_cur", "s_next", "fwd", "ops",
                 "in_window", "checked")


def _request_gen(seed: int, idx: int, device) -> torch.Generator:
    s = np.random.SeedSequence([seed, idx]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.arch = ctx.arch
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.device = ctx.device
        self.rng = np.random.default_rng([ctx.seed, 7])
        self.inputs = {}  # request index -> its input dict
        self.owner = {}  # id(GenRequest) -> (client, request index)
        self.handles = {}  # request index -> GenRequest
        self.ticks: list[Tick] = []
        self.gaps: list[float] = []
        self.last_done = {}  # request index -> host time of its last step
        self.next_idx = 0
        self.in_window = False
        self.window_ticks = 0
        self.check_at: set[int] = set()  # window steps whose calls are kept
        self.want: dict = {}  # kind -> call indices kept
        self.model = self.engine = None

    # -- requests -------------------------------------------------------

    def submit(self, client: int):
        i = self.next_idx
        self.next_idx += 1
        gen = _request_gen(self.ctx.seed, i, self.device)
        r = self.arch.request(gen, self.cfg, self.traffic, self.device)
        self.inputs[i] = r
        h = self.engine.submit(r["latent"], r["cond"], r["sigmas"])
        self.owner[id(h)] = (client, i)
        self.handles[i] = h

    # -- the tapped step --------------------------------------------------

    def _wrap_step(self):
        eng = self.engine
        inner = eng.step_fn

        def step(x, s_cur, s_next, cond, *aux):
            t = Tick()
            batch = eng.active[: eng.max_batch]
            t.lanes = [(self.owner[id(r)][1], r.step) for r in batch]
            t.in_window = self.in_window
            keep = self.in_window and self.window_ticks in self.check_at
            self.fwd_tap.on = True
            self.op_tap.on = keep or self.op_tap.on
            try:
                with torch.profiler.record_function("bench.step_fn"):
                    out = inner(x, s_cur, s_next, cond, *aux)
            finally:
                self.fwd_tap.on = self.op_tap.on = False
            t.fwd = self.fwd_tap.take()
            t.ops = self.op_tap.take() if keep else []
            t.checked = keep
            t.x, t.s_cur, t.s_next = x, s_cur, s_next
            t.x_next = out[0] if aux else out
            self.ticks.append(t)
            return out

        eng.step_fn = step

    def tick(self):
        """One engine step; then every client whose request finished sends
        its next one. Returns the lanes it advanced."""
        before, failed = len(self.ticks), self.engine.stats.failed
        with torch.profiler.record_function("bench.engine_tick"):
            self.engine.tick()
        if self.engine.stats.failed != failed:
            raise RuntimeError("an engine step failed; see the log above")
        now = time.perf_counter()
        lanes = self.ticks[-1].lanes if len(self.ticks) > before else []
        if self.in_window:
            self.window_ticks += 1
        for i, _ in lanes:
            if self.in_window and i in self.last_done:
                self.gaps.append(now - self.last_done[i])
            self.last_done[i] = now
        for i, _ in lanes:
            h = self.handles[i]
            if h.done_event.is_set():
                if h.error is not None:
                    raise RuntimeError(f"request {i} failed") from h.error
                with torch.profiler.record_function("bench.submit"):
                    self.submit(self.owner[id(h)][0])
        return lanes


def setup(ctx) -> Session:
    clock = SetupClock()
    s = Session(ctx)
    s.setup_marks = clock.marks
    raw = weights.make_raw(ctx.arch.groups(ctx.config), ctx.seed, ctx.device)
    clock.mark("weights", f"weights drawn: "
               f"{weights.stored_bytes(raw) / 2**30:.2f} GiB stored")
    params = program.load_params(raw, ctx.device)
    ctx.sync()
    clock.mark("load", "loaded by the program")
    s.raw = raw
    s.model = ctx.arch.build(params, ctx.config, ctx.device)
    del params
    if ctx.tree_hook is not None:
        ctx.tree_hook(s.model)
    ctx.sync()
    clock.mark("build", "model built")
    s.keys = program.weight_keys(s.model.params)
    s.fwd_tap = program.ForwardTap(*ctx.arch.FORWARD)
    s.op_tap = program.OpTap(ctx.arch.OP_MODULE,
                             lambda kind, i: i in s.want.get(kind, ()),
                             lambda name, args, kw, out: keep_call(
                                 s, name, args, kw, out))
    s.engine = ctx.arch.make_engine(s.model, ctx.config, ctx.traffic)
    s._wrap_step()
    tr = ctx.traffic
    for c in range(tr["clients"]):
        s.submit(c)
        if c < tr["clients"] - 1 and len(s.engine.active) < tr["max_batch"]:
            s.tick()  # one new request a step
    for _ in range(tr["warmup_steps"]):
        # the last warm-up step counts the layer calls a step makes
        s.op_tap.take()
        s.op_tap.on = True
        s.tick()
    calls = dict(s.op_tap.count)
    s.op_tap.take()
    ctx.sync()
    # which window steps, and which of their calls, the check keeps
    span = tr["check_span"]
    s.check_at = set(int(k) for k in s.rng.choice(
        span, size=min(span, tr["check_steps"]), replace=False))
    s.want = {kind: set(int(i) for i in s.rng.choice(
        n, size=min(n, tr["check_calls"][kind]), replace=False))
        for kind, n in calls.items()}
    clock.mark("warmup", f"warmed up: {len(s.ticks)} steps; a step makes "
               f"{calls} layer calls")
    return s


def window(s: Session, seconds: float, on_tick=None,
           min_ticks: int | None = None) -> dict:
    """Engine steps until ``seconds`` have passed and at least
    ``min_ticks`` (by default the check's span) have run; the last step
    ends the window. ``on_tick`` (the profiler's step) runs after each."""
    if min_ticks is None:
        min_ticks = s.traffic["check_span"]
    s.in_window = True
    first = len(s.ticks)
    t0 = time.perf_counter()
    while True:
        s.tick()
        if on_tick is not None:
            on_tick()
        if (time.perf_counter() - t0 >= seconds
                and len(s.ticks) - first >= min_ticks):
            break
    s.ctx.sync()
    wall = time.perf_counter() - t0
    s.in_window = False
    done = s.ticks[first:]
    lane_steps = sum(len(t.lanes) for t in done)
    return {
        "window_s": wall,
        "ticks": len(done),
        "lane_steps": lane_steps,
        "failed": s.engine.stats.failed,
        "images_per_min": lane_steps / s.traffic["steps"] * 60.0 / wall,
        "video_step_s": wall / len(done),
        "lanes_per_tick": [len(t.lanes) for t in done],
        "step_gap_p95_s": (statistics.quantiles(s.gaps, n=20)[18]
                           if len(s.gaps) >= 20 else None),
    }


def _lanes_gap(s: Session, W, t: Tick, control: bool) -> tuple:
    """The worst gap of a checked step's forward outputs, over its lanes,
    to the reference's forward of each lane; with ``control``, also the
    lower-precision reference's."""
    gap = low = 0.0
    for j, (i, _) in enumerate(t.lanes):
        args = (W, s.cfg, s.traffic, [s.inputs[i]], t.x[j:j + 1],
                t.s_cur[j:j + 1])
        want, _ = s.arch.reference(*args)
        gap = max(gap, max(rel(got[j:j + 1], w)
                           for got, w in zip(t.fwd, want)))
        if control:
            with refops.rounded(torch.float8_e4m3fn):
                lower, _ = s.arch.reference(*args)
            low = max(low, max(rel(a, w) for a, w in zip(lower, want)))
    return gap, low


def check(s: Session) -> dict:
    """The numbers compared (see the module's doc). Frees the program
    first."""
    s.fwd_tap.undo()
    s.op_tap.undo()
    s.engine = s.model = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    start = 0.0
    for t in s.ticks:
        for j, (i, k) in enumerate(t.lanes):
            if k == 0:
                noise = s.inputs[i]["latent"]
                start = max(start, float((t.x[j].float() - noise.float())
                                         .abs().max()))
    W = refops.Weights(s.raw, s.device)
    win = [t for t in s.ticks if t.in_window]
    control = s.ctx.control == "fp8"
    miss, gap, n_ops, fwd, low, n_fwd = 0, 0.0, 0, 0.0, 0.0, 0
    with refops.strict_f32(), torch.no_grad():
        for t in win:
            b = len(t.lanes)
            reqs = [s.inputs[i] for i, _ in t.lanes]
            try:
                v, mag = s.arch.mix([o[:b] for o in t.fwd], reqs)
            except IndexError:  # a step without its forwards: all missed
                miss += t.x_next[:b].numel()
                continue
            miss += update_miss(t.x[:b], t.x_next[:b], t.s_cur[:b],
                                t.s_next[:b], v, mag)
            for kind, _, rec in t.ops:
                if kind == "linear" and rec["key"] is None:
                    continue  # a weight the stored file does not hold
                gap = max(gap, op_gap(W, kind, rec))
                n_ops += 1
            if t.checked:
                g, lg = _lanes_gap(s, W, t, control)
                fwd, low = max(fwd, g), max(low, lg)
                n_fwd += b
    # nothing checked reads as a gap no limit admits (JSON has no inf)
    out = {"fwd_gap": fwd if n_fwd else 1e30,
           "op_gap": gap if n_ops else 1e30,
           "update_miss": miss, "start_gap": start,
           "ops_checked": n_ops, "lanes_checked": n_fwd}
    if control:
        out["control"] = {"fwd_gap": low if n_fwd else 1e30}
    return out
