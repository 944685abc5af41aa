"""Serving runtime: request queue + step-level continuous batching (PyTorch
port of comfyui_gguf_tpu/serving.py).

Diffusion requests are iterative (N denoise steps over a latent), so the
continuous-batching unit is the *denoise step*: the engine keeps a pool of
in-flight requests, each with its own sigma cursor, stacks them into a
fixed-size batch bucket (padding with replica lanes), runs ONE step for the
whole batch, retires finished requests and admits queued ones between
steps. Per-sample sigmas make mixed-progress batches exact, not
approximate.

The engine is model-agnostic: it drives a ``step_fn(x, s_cur, s_next,
cond) -> x_next`` supplied by the pipeline layer (``pipeline.flux_engine``).

Latents, conditioning and sampler state stay device tensors across ticks:
one host-to-device copy per request at admission, one device-to-host copy
when it finishes. A tick never waits for the card: the step's launches are
queued, and a CUDA event recorded after them marks the dispatch;
``pipeline_depth`` dispatches may be in flight before the engine waits on
the newest one's event (and it always waits when a request finishes).

Each tick runs under the spans ``engine.tick`` (``engine.admit``: the
host-to-device copies of new requests, their bytes; ``engine.stack``;
``engine.dispatch``: the ``step_fn`` call; ``engine.sync``: the wait on
the step's event; ``engine.retire``: the device-to-host copies of finished
results, their bytes), each over a whole batch; a request's own timeline
is ``submitted_at`` / ``admitted_at`` / ``completed_at`` on its
``GenRequest``.

Results: numpy has no bfloat16, so ``GenRequest.result`` and
``snapshot()`` hold float32 numpy arrays, an exact widening of the bf16
latents; ``restore()`` narrows a snapshot's latent back to its dtype
exactly.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from . import observability
from ._device import resolve_device
from .interop import tensor_from_numpy
from .observability import span

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GenRequest:
    """One generation job (fixed resolution bucket + schedule)."""

    request_id: int
    latent: Any  # (H, W, C) initial noise; a device tensor once admitted
    cond: Any  # conditioning tree (text embeddings, pooled, guidance)
    sigmas: np.ndarray  # (steps+1,) descending to 0
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    admitted_at: float | None = None  # monotonic; into the pool
    step: int = 0
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: np.ndarray | None = None  # float32 (a bf16 latent widened)
    error: Exception | None = None
    cancelled: bool = False
    completed_at: float | None = None  # monotonic; for latency percentiles
    aux: Any = None  # per-request sampler state (multistep engines)
    latent_dtype: torch.dtype | None = None  # restore(): narrow back to it

    @property
    def latency_s(self) -> float | None:
        return (None if self.completed_at is None
                else self.completed_at - self.submitted_at)

    def cancel(self):
        """Drop the request at the next engine tick (no partial result)."""
        self.cancelled = True

    @property
    def finished(self) -> bool:
        return self.step >= len(self.sigmas) - 1


@dataclasses.dataclass
class EngineStats:
    """Observability counters."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    steps_executed: int = 0
    batches_executed: int = 0
    total_padding_lanes: int = 0
    total_step_time_s: float = 0.0
    total_latency_s: float = 0.0
    admitted: int = 0
    total_queue_wait_s: float = 0.0  # submitted -> admitted, summed
    total_wait_s: float = 0.0  # host seconds waiting in ``engine.sync``

    @property
    def mean_batch_occupancy(self) -> float:
        lanes = self.steps_executed + self.total_padding_lanes
        return self.steps_executed / lanes if lanes else 0.0

    @property
    def steps_per_second(self) -> float:
        return (self.steps_executed / self.total_step_time_s
                if self.total_step_time_s else 0.0)

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "steps_executed": self.steps_executed,
            "batches_executed": self.batches_executed,
            "mean_batch_occupancy": round(self.mean_batch_occupancy, 3),
            "steps_per_second": round(self.steps_per_second, 3),
            "mean_latency_s": round(
                self.total_latency_s / self.completed, 4
            ) if self.completed else None,
            "mean_queue_wait_s": round(
                self.total_queue_wait_s / self.admitted, 4
            ) if self.admitted else None,
            "wait_s": round(self.total_wait_s, 4),
        }


def device_fault(e: BaseException) -> bool:
    """Whether ``e`` reports a CUDA error: a sticky fault (illegal address,
    launch failure) poisons the context, so it must end the engine, not
    fail one batch on a dead card. A kernel wrapper's refused launch
    (``_build.check``) and PyTorch's own CUDA errors both name it."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(e, accel))
            or "CUDA error" in str(e))


def _map(tree, fn):
    """``fn`` on every leaf of a dict/tuple/list tree (None stays)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor onto ``device`` without waiting for the card: through
    pinned memory, asynchronously on the current stream."""
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_device(leaf, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return _h2d(leaf, device)
    a = np.asarray(leaf)
    if a.dtype == np.float64:  # the reference's arrays are 32-bit
        a = a.astype(np.float32)
    t = tensor_from_numpy(a.reshape(-1), "cpu").reshape(a.shape)
    return _h2d(t, device)


def _to_host(leaf):
    """A tensor as numpy, bfloat16 widened to float32 (exact)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _stack(ts: list) -> torch.Tensor:
    """torch.stack after promoting to one dtype (a new request's float32
    latent beside bf16 ones that have stepped)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.stack([t.to(dt) for t in ts])


def _stack_cond(conds: list):
    """Stack a list of cond trees along axis 0 (dict/tuple/tensor leaves)."""
    first = conds[0]
    if isinstance(first, dict):
        return {k: _stack_cond([c[k] for c in conds]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_cond([c[i] for c in conds]) for i in range(len(first)))
    if first is None:
        return None
    return _stack(list(conds))


class ContinuousBatchEngine:
    """Step-level continuous batcher over a denoise step.

    step_fn(x (B,H,W,C), s_cur (B,), s_next (B,), cond) -> x_next, every
    argument a tensor on ``device`` (the sigmas float32). The cond tree
    must be stackable along axis 0 (the pipeline pads text to a fixed
    length per bucket). ``device``: where the pool lives, the card unless
    the caller asks for the CPU.
    """

    def __init__(self, step_fn: Callable, max_batch: int = 4,
                 batch_sizes: tuple[int, ...] | None = None,
                 pipeline_depth: int = 1,
                 on_step: Callable | None = None,
                 aux_init: Callable | None = None, device="cuda"):
        self.step_fn = step_fn
        self.device = resolve_device(device)
        # aux_init(latent) -> per-request sampler-state tree. When set,
        # step_fn takes (x, s_cur, s_next, cond, aux) and returns
        # (x_next, aux_next) — aux is stacked/unstacked along axis 0 like
        # the latents and stays on the device (multistep samplers keep
        # per-LANE history, so mixed-progress pools stay exact).
        self.aux_init = aux_init
        # on_step(requests) fires after every dispatched step with the
        # requests it advanced. r.latent is a device tensor whose step may
        # still be running (reading it waits for the card); exceptions are
        # logged and swallowed so a preview bug cannot kill serving.
        self.on_step = on_step
        self.max_batch = max_batch
        # a closed set of batch shapes; max_batch is always a bucket (a
        # non-power-of-two max_batch would otherwise bucket a full pool
        # below itself, with pad = -1)
        self.batch_sizes = tuple(sorted(
            set(batch_sizes) if batch_sizes else
            {b for b in (1, 2, 4, 8, 16, 32) if b <= max_batch}
            | {max_batch}
        ))
        # pipeline_depth > 1: dispatch up to D steps without waiting for
        # the card between them; the engine waits once per window, and
        # whenever a request reaches its final step (its result must come
        # to the host)
        self.pipeline_depth = max(1, pipeline_depth)
        self.queue: "queue.Queue[GenRequest]" = queue.Queue()
        self.active: list[GenRequest] = []
        self.stats = EngineStats()
        self._id = itertools.count()
        self._submit_lock = threading.Lock()  # producers may be threads
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # in-flight (x_next, [requests advanced by it], CUDA event recorded
        # after it or None) since the last wait, oldest first
        self._pending: list[tuple[Any, list[GenRequest], Any]] = []
        self._window_t0: float | None = None

    # -- client API ---------------------------------------------------------

    def submit(self, latent, cond, sigmas) -> GenRequest:
        """Queue a request; ``latent`` and the cond leaves may be numpy
        arrays or tensors (moved to the device at admission)."""
        req = GenRequest(request_id=next(self._id), latent=latent, cond=cond,
                         sigmas=np.asarray(sigmas, np.float32))
        with self._submit_lock:
            self.stats.submitted += 1
        self.queue.put(req)
        return req

    def run_until_drained(self, timeout_s: float = 600.0):
        """Synchronous engine loop: process until queue+pool empty."""
        deadline = time.monotonic() + timeout_s
        while (self.active or not self.queue.empty()):
            if time.monotonic() > deadline:
                raise TimeoutError("engine drain timed out")
            self.tick()

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 600.0):
        self._stop.set()
        if self._thread:
            # running _sync() while the engine thread is still inside tick()
            # would race on _pending/active
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                log.warning("engine thread still running after %.0fs; "
                            "skipping final sync (call stop() again "
                            "after it settles)", timeout_s)
                return
        self._sync()  # flush any in-flight window (engine thread is dead)

    def _loop(self):
        while not self._stop.is_set():
            if not self.active and self.queue.empty():
                time.sleep(0.001)
                continue
            self.tick()

    # -- engine core --------------------------------------------------------

    def _admit(self, sp: span):
        dev = self.device

        def h2d(a):
            t = _to_device(a, dev)
            sp.nbytes += t.numel() * t.element_size()
            return t

        while len(self.active) < self.max_batch:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return
            req.admitted_at = time.monotonic()
            self.stats.admitted += 1
            self.stats.total_queue_wait_s += (req.admitted_at
                                              - req.submitted_at)
            # the request's one host-to-device copy
            req.latent = h2d(req.latent)
            if req.latent_dtype is not None:
                req.latent = req.latent.to(req.latent_dtype)
            req.cond = _map(req.cond, h2d)
            if req.aux is not None:
                req.aux = _map(req.aux, h2d)
            self.active.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def _sigma_lanes(self, values) -> torch.Tensor:
        return _h2d(torch.from_numpy(np.asarray(values, np.float32)),
                    self.device)

    def tick(self):
        """Admit new requests, run ONE denoise step on the stacked pool."""
        with span("engine.tick"):
            self._tick()

    def _tick(self):
        with span("engine.admit") as sp:
            self._admit(sp)
        dropped = [r for r in self.active if r.cancelled]
        if dropped:
            self.active = [r for r in self.active if not r.cancelled]
            for r in dropped:
                self.stats.cancelled += 1
                r.done_event.set()
        if not self.active:
            return
        batch = self.active[: self.max_batch]
        n = len(batch)
        b = self._bucket(n)
        pad = b - n
        lanes = batch + [batch[-1]] * pad

        with span("engine.stack"):
            x = _stack([r.latent for r in lanes])
            s_cur = self._sigma_lanes([r.sigmas[r.step] for r in lanes])
            s_next = self._sigma_lanes([r.sigmas[r.step + 1]
                                        for r in lanes])
            cond = _stack_cond([r.cond for r in lanes])
            if self._window_t0 is None:
                self._window_t0 = time.monotonic()
            if self.aux_init is not None:
                for r in batch:
                    if r.aux is None:
                        r.aux = self.aux_init(r.latent)
                aux = _stack_cond([r.aux for r in lanes])

        try:
            # no wait here: x may still be computing from the previous tick
            with span("engine.dispatch"):
                if self.aux_init is not None:
                    x_next, aux_next = self.step_fn(x, s_cur, s_next, cond,
                                                    aux)
                else:
                    x_next = self.step_fn(x, s_cur, s_next, cond)
        except Exception as e:
            if device_fault(e):
                raise
            # fail the batch, keep the engine alive
            log.exception("denoise step failed; failing %d request(s)", n)
            for r in batch:
                r.error = e
                self.stats.failed += 1
                r.done_event.set()
            self.active = self.active[self.max_batch:]
            self._window_t0 = None if not self._pending else self._window_t0
            return

        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self.stats.batches_executed += 1
        self.stats.steps_executed += n
        self.stats.total_padding_lanes += pad

        finishing = False
        for i, r in enumerate(batch):
            r.latent = x_next[i]  # a view; no transfer
            if self.aux_init is not None:
                r.aux = _map(aux_next, lambda a, i=i: a[i])
            r.step += 1
            finishing |= r.finished
        if self.on_step is not None:
            try:
                self.on_step(batch)
            except Exception:
                log.exception("on_step callback failed (ignored)")
        self._pending.append((x_next, batch, event))
        if finishing or len(self._pending) >= self.pipeline_depth:
            self._sync()

    def snapshot(self) -> list[dict]:
        """Host state of every unfinished request (pool + queue): the
        worker-failure recovery hook.

        Waits for the in-flight window, then copies latent, sigma cursor,
        cond and sampler aux to numpy (bfloat16 widened to float32; the
        latent's dtype is recorded). Feed the list to ``restore()`` on a
        NEW engine (same step_fn shapes) and the pool resumes from the last
        completed step — Euler/dpmpp-2m steps are deterministic, so an
        interrupted+restored run equals the uninterrupted one. Take
        snapshots between ticks; once the card has faulted it is too late.

        The snapshot is plain numpy trees: ``np.save(path, np.asarray(snap,
        dtype=object), allow_pickle=True)`` persists it across processes.
        """
        self._sync()
        snap = []
        for r in self.active + list(self.queue.queue):
            if r.cancelled or r.done_event.is_set():
                continue
            lat = r.latent
            dtype = (str(lat.dtype).removeprefix("torch.")
                     if isinstance(lat, torch.Tensor) else None)
            snap.append({
                "latent": _to_host(lat),
                "latent_dtype": dtype,
                "cond": _map(r.cond, _to_host),
                "sigmas": np.asarray(r.sigmas, np.float32),
                "step": int(r.step),
                "aux": None if r.aux is None else _map(r.aux, _to_host),
            })
        return snap

    def restore(self, snap: list[dict]) -> list[GenRequest]:
        """Re-enqueue snapshot() output (typically on a fresh engine in a
        fresh process); returns the new GenRequest handles in snapshot
        order. A latent recorded as bfloat16 is narrowed back to it at
        admission (exact: the snapshot widened it)."""
        reqs = []
        for s in snap:
            r = GenRequest(request_id=next(self._id), latent=s["latent"],
                           cond=s["cond"],
                           sigmas=np.asarray(s["sigmas"], np.float32))
            r.step = int(s["step"])
            r.aux = s["aux"]
            if s.get("latent_dtype"):
                r.latent_dtype = getattr(torch, s["latent_dtype"])
            self.stats.submitted += 1
            self.queue.put(r)
            reqs.append(r)
        return reqs

    def _sync(self):
        """Wait for the newest in-flight step and retire finished requests.
        A CUDA error raised here is a fault of the card, not of a request:
        it propagates."""
        if not self._pending:
            return
        window = self._pending
        self._pending = []
        event = window[-1][2]
        observability.resolve()  # while the card still runs the step
        with span("engine.sync") as sp:
            if event is not None:
                event.synchronize()
        self.stats.total_wait_s += sp.seconds
        dt = time.monotonic() - (self._window_t0 or time.monotonic())
        self._window_t0 = None
        self.stats.total_step_time_s += dt

        retired = set()
        with span("engine.retire") as sp:
            for _, batch, _ in window:
                for r in batch:
                    if r.finished and id(r) not in retired:
                        retired.add(id(r))
                        # the request's one device-to-host copy
                        r.result = _to_host(r.latent)
                        sp.nbytes += r.result.nbytes
                        r.completed_at = time.monotonic()
                        self.stats.completed += 1
                        self.stats.total_latency_s += (r.completed_at
                                                       - r.submitted_at)
                        r.done_event.set()
        if retired:
            self.active = [r for r in self.active if id(r) not in retired]


class EngineGroup:
    """Multi-resolution serving: routes requests to per-shape engines.

    The group lazily builds an engine per latent shape via
    ``engine_factory(latent_shape)`` and round-robins ticks across engines
    with work — they share the card (and the model params, which live in
    the factory's closure), so the memory cost is one weight set.
    """

    def __init__(self, engine_factory: Callable):
        self._factory = engine_factory
        self._engines: dict[tuple, ContinuousBatchEngine] = {}

    def engine_for(self, latent_shape: tuple) -> "ContinuousBatchEngine":
        key = tuple(latent_shape)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._factory(key)
            self._engines[key] = eng
        return eng

    def submit(self, latent, cond, sigmas) -> GenRequest:
        return self.engine_for(tuple(latent.shape)).submit(
            latent, cond, sigmas)

    def run_until_drained(self, timeout_s: float = 600.0):
        deadline = time.monotonic() + timeout_s
        while any(e.active or not e.queue.empty()
                  for e in self._engines.values()):
            if time.monotonic() > deadline:
                raise TimeoutError("engine group drain timed out")
            for e in self._engines.values():
                if e.active or not e.queue.empty():
                    e.tick()

    @property
    def stats(self) -> dict:
        return {shape: e.stats for shape, e in self._engines.items()}


def lane_dpmpp_2m_update(x, denoised, s_cur, s_next, aux):
    """Per-LANE DPM-Solver++(2M) update for pooled serving (data
    prediction in λ = −log σ): each batch lane carries its own multistep
    history (old denoised, previous sigma, validity), so mixed-progress
    continuous batches integrate their own schedules at 2nd order — one
    model call per lane per tick, the cost of Euler serving.

    aux = (old_denoised float32 like x, s_prev (B,), valid (B,) bool).
    Returns (x_next, aux_next). A lane's first step (valid False) and the
    final σ→0 step take the order-1 exponential step (which lands exactly
    on the denoised output at σ'=0), as
    sampling.kdiffusion.dpmpp_2m_sample_sigma does.
    """
    old_den, s_prev, valid = aux
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    eps = 1e-12
    s = s_cur.to(torch.float32).reshape(bshape)
    sn = s_next.to(torch.float32).reshape(bshape)
    sp = s_prev.to(torch.float32).reshape(bshape)
    xf = x.to(torch.float32)
    den = denoised.to(torch.float32)

    h = (torch.log(torch.clamp_min(s, eps))
         - torch.log(torch.clamp_min(sn, eps)))
    ratio = sn / torch.clamp_min(s, eps)
    expm = torch.expm1(-h)
    base = ratio * xf - expm * den

    h_last = (torch.log(torch.clamp_min(sp, eps))
              - torch.log(torch.clamp_min(s, eps)))
    vb = valid.reshape(bshape)
    r = torch.where(vb, h_last / h, torch.ones_like(h))
    dd = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old_den.to(torch.float32)
    ms = ratio * xf - expm * dd
    out = torch.where(vb & (sn > 0), ms, base)

    aux_next = (den, s_cur.to(torch.float32), torch.ones_like(valid))
    return out.to(x.dtype), aux_next


def flow_multistep_aux_init(latent):
    """aux_init for lane_dpmpp_2m_update-based engines."""
    dev = latent.device
    return (torch.zeros(latent.shape, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


class BucketRouter:
    """Multi-RESOLUTION serving front: one ContinuousBatchEngine per
    shape bucket, created lazily from a factory.

    A pooled batch holds one latent shape; production traffic mixes
    resolutions. The router keys engines by the latent's shape tuple — the
    same model params behind every bucket. Snap incoming requests to a
    fixed bucket list upstream if resolutions are unbounded.

        router = BucketRouter(lambda shape: flux_engine(model,
                              shape[0] // 2, shape[1] // 2, txt_len))
        r = router.submit(latent_1024, cond, sigmas)   # routes by shape
        router.run_until_drained()
    """

    def __init__(self, engine_factory):
        self.engine_factory = engine_factory
        self.engines: dict[tuple, ContinuousBatchEngine] = {}

    def engine_for(self, shape: tuple) -> "ContinuousBatchEngine":
        shape = tuple(int(s) for s in shape)
        eng = self.engines.get(shape)
        if eng is None:
            log.info("BucketRouter: new shape bucket %s", shape)
            eng = self.engine_factory(shape)
            self.engines[shape] = eng
        return eng

    def submit(self, latent, cond, sigmas) -> GenRequest:
        return self.engine_for(tuple(latent.shape)).submit(
            latent, cond, sigmas)

    def run_until_drained(self, timeout_s: float = 600.0) -> None:
        deadline = time.monotonic() + timeout_s
        # round-robin the buckets so no bucket starves while another
        # drains; each tick advances one bucket's whole pool by one step
        while any(e.active or not e.queue.empty()
                  for e in self.engines.values()):
            if time.monotonic() > deadline:
                raise TimeoutError("bucket router drain timed out")
            for eng in list(self.engines.values()):
                if eng.active or not eng.queue.empty():
                    eng.tick()

    @property
    def stats(self) -> dict:
        return {str(shape): eng.stats.snapshot()
                for shape, eng in self.engines.items()}


class ResidentModelServer:
    """Multi-MODEL serving on one card under a device-memory budget.

    Every model's packed params are registered with a
    lifecycle.ResidencyManager (durable host copy + LRU device copy); each
    model gets a persistent engine whose step reads its params through a
    provider (pipeline.make_flow_engine(params_provider=...)) on every
    tick, so an evict→re-place cycle swaps the device tensors under the
    same engine, paying only the host→device copy.

    Draining is grouped BY MODEL (all queued work for one model runs
    before switching), because a model switch can cost a swap.
    """

    def __init__(self, hbm_budget: int | None = None, device="cuda"):
        from .lifecycle import ResidencyManager

        self.manager = ResidencyManager(hbm_budget=hbm_budget,
                                        device=device)
        self._engines: dict[str, ContinuousBatchEngine] = {}

    def register(self, name: str, params, engine_factory,
                 free_source: bool = True) -> None:
        """``engine_factory(params_provider) -> ContinuousBatchEngine``.

        The provider returns the CURRENT device tree for ``name``, loading
        (and LRU-evicting others) as needed. Ticks are single-threaded
        through this object, so residency is stable for the duration of
        each engine call.

        free_source (default True): release the storage of the caller's
        ``params`` once the manager's host copy exists — the engine must
        only ever touch params through the provider, and a still-referenced
        device source would keep its memory outside the budget. Pass False
        only if the caller genuinely keeps using its own tree.
        """
        self.manager.register(name, params, free_source=free_source)

        def provider(_name=name):
            return self.manager.resident_params(_name)

        self._engines[name] = engine_factory(provider)

    def submit(self, name: str, latent, cond, sigmas) -> GenRequest:
        return self._engines[name].submit(latent, cond, sigmas)

    def run_until_drained(self, timeout_s: float = 600.0) -> None:
        deadline = time.monotonic() + timeout_s
        for name, eng in self._engines.items():
            if not (eng.active or not eng.queue.empty()):
                continue
            with self.manager.acquire(name):  # pin across this drain
                while eng.active or not eng.queue.empty():
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"drain timed out (model {name!r})")
                    eng.tick()

    @property
    def stats(self) -> dict:
        return {"models": self.manager.stats(),
                "engines": {n: e.stats.snapshot()
                            for n, e in self._engines.items()}}
