"""The port's continuous-batching engine (``serving.py``) on the CPU.

The reference's engine tests (``tests/test_serving.py``) run here on a toy
torch ``step_fn`` (dx/dσ = a per-request constant, which Euler integrates
exactly): mixed-progress pools, padding buckets, cancellation, a failed
batch, the pipelined window, the threaded loop, the engine group and the
bucket router, snapshot/restore. Beside them: the per-lane DPM-Solver++(2M)
update against the reference's on random lanes (mixed valid/invalid lanes
and the σ' = 0 step, within 1e-6), a bf16 snapshot round trip that is
exact, a CUDA error propagating out of ``tick`` while any other error fails
only its batch, and the engine's admission moving a request to the
device once.
"""

import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import serving as jserving
from comfyui_gguf_tpu_torch.sampling import linear_schedule
from comfyui_gguf_tpu_torch.serving import (BucketRouter,
                                            ContinuousBatchEngine,
                                            EngineGroup, device_fault,
                                            flow_multistep_aux_init,
                                            lane_dpmpp_2m_update)

torch.set_num_threads(2)
CPU = "cpu"


def _linear_step(x, s_cur, s_next, cond):
    """dx/dσ = cond['c'] (constant per-sample velocity) — exact Euler."""
    c = cond["c"][:, None, None, None]
    return x + (s_next - s_cur)[:, None, None, None] * c


def _engine(step=_linear_step, **kw):
    return ContinuousBatchEngine(step, device=CPU, **kw)


def _zeros():
    return np.zeros((2, 2, 1), np.float32)


def test_single_request_exact():
    eng = _engine(max_batch=2)
    x0 = np.ones((4, 4, 1), np.float32) * 2.0
    req = eng.submit(x0, {"c": np.float32(3.0)}, linear_schedule(5))
    eng.run_until_drained()
    assert req.finished
    # integrates σ: 1 → 0 with velocity 3 → x0 - 3
    np.testing.assert_allclose(req.result, 2.0 - 3.0, rtol=1e-6)
    assert isinstance(req.result, np.ndarray) and req.result.shape == x0.shape
    assert eng.stats.completed == 1
    assert eng.stats.steps_executed == 5


def test_mixed_progress_pool_is_exact():
    """Requests with different step counts share batches; each integrates
    its own schedule exactly."""
    eng = _engine(max_batch=4)
    reqs = []
    for i, steps in enumerate((3, 7, 5)):
        x0 = np.full((2, 2, 1), float(i), np.float32)
        reqs.append(eng.submit(x0, {"c": np.float32(i + 1)},
                               linear_schedule(steps)))
    eng.run_until_drained()
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.result, float(i) - (i + 1), rtol=1e-5,
                                   atol=1e-6)
    # pool batching actually happened (fewer batches than total steps)
    assert eng.stats.batches_executed < eng.stats.steps_executed
    assert eng.stats.mean_batch_occupancy > 0.5


def test_late_arrivals_join_pool():
    eng = _engine(max_batch=4)
    r1 = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(4))
    # run two ticks, then a new request arrives mid-flight
    eng.tick()
    eng.tick()
    r2 = eng.submit(_zeros(), {"c": np.float32(2)}, linear_schedule(2))
    eng.run_until_drained()
    np.testing.assert_allclose(r1.result, -1.0, atol=1e-6)
    np.testing.assert_allclose(r2.result, -2.0, atol=1e-6)


def test_padding_buckets_power_of_two():
    eng = _engine(max_batch=8)
    for _ in range(3):
        eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(1))
    eng.tick()
    # 3 live requests pad to bucket 4
    assert eng.stats.total_padding_lanes == 1
    assert eng.stats.steps_executed == 3


def test_stats_snapshot_keys():
    eng = _engine(max_batch=2)
    eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(1))
    eng.run_until_drained()
    snap = eng.stats.snapshot()
    assert snap["completed"] == 1
    assert snap["steps_per_second"] is not None
    assert snap["mean_latency_s"] is not None
    # the reference's keys, and the port's queue and sync waits
    assert set(snap) == set(jserving.EngineStats().snapshot()) | {
        "mean_queue_wait_s", "wait_s"}


def test_failed_batch_does_not_kill_engine():
    calls = {"n": 0}

    def flaky(x, s_cur, s_next, cond):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return _linear_step(x, s_cur, s_next, cond)

    eng = _engine(flaky, max_batch=2)
    bad = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(2))
    eng.tick()  # fails the first batch
    assert bad.error is not None and bad.done_event.is_set()
    ok = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(2))
    eng.run_until_drained()
    assert ok.finished and ok.error is None
    assert eng.stats.failed == 1 and eng.stats.completed == 1


def test_cuda_error_propagates_out_of_tick():
    """A CUDA error (a sticky fault poisons the card) is not a failed
    request: it leaves tick; the batch is not marked failed."""
    def faulty(x, s_cur, s_next, cond):
        raise RuntimeError("i8mm: CUDA error 700 at launch")

    eng = _engine(faulty, max_batch=2)
    req = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(2))
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.tick()
    assert req.error is None and eng.stats.failed == 0
    assert device_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert not device_fault(RuntimeError("shape mismatch"))
    assert not device_fault(torch.cuda.OutOfMemoryError("out of memory"))


def test_cancellation_drops_requests():
    eng = _engine(max_batch=4)
    keep = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(4))
    drop = eng.submit(_zeros(), {"c": np.float32(2)}, linear_schedule(4))
    eng.tick()
    drop.cancel()
    eng.run_until_drained()
    assert keep.finished and keep.error is None
    assert drop.cancelled and not drop.finished and drop.result is None
    assert drop.done_event.is_set()
    assert eng.stats.cancelled == 1 and eng.stats.completed == 1


def test_pipelined_window_is_exact():
    """pipeline_depth > 1 defers waits but must integrate each request's
    schedule exactly — results identical to depth-1."""
    eng = _engine(max_batch=4, pipeline_depth=3)
    reqs = []
    for i, steps in enumerate((3, 7, 5)):
        x0 = np.full((2, 2, 1), float(i), np.float32)
        reqs.append(eng.submit(x0, {"c": np.float32(i + 1)},
                               linear_schedule(steps)))
    eng.run_until_drained()
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.result, float(i) - (i + 1), rtol=1e-5,
                                   atol=1e-6)
    assert eng.stats.completed == 3 and not eng._pending


def test_pipelined_sync_cadence():
    """The engine waits once per window (or at a finish), not per step."""
    eng = _engine(max_batch=2, pipeline_depth=4)
    syncs = {"n": 0}
    orig = eng._sync

    def counting_sync():
        if eng._pending:
            syncs["n"] += 1
        orig()

    eng._sync = counting_sync
    req = eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(8))
    eng.run_until_drained()
    assert req.finished and req.error is None
    # 8 steps at depth 4 → one full-window sync + one finishing sync
    assert syncs["n"] == 2
    assert eng.stats.steps_executed == 8


def test_pipelined_finish_forces_sync():
    """A request hitting its last step is retired on that same tick even
    when the pipeline window is not full."""
    eng = _engine(max_batch=2, pipeline_depth=8)
    req = eng.submit(_zeros(), {"c": np.float32(2)}, linear_schedule(3))
    eng.tick()
    eng.tick()
    assert not req.done_event.is_set()  # mid-flight, window open
    eng.tick()  # final step → forced sync
    assert req.done_event.is_set() and req.result is not None
    np.testing.assert_allclose(req.result, -2.0, atol=1e-6)


def test_pipelined_stop_flushes_window():
    """stop() drains the in-flight window so no dispatched work is lost."""
    eng = _engine(max_batch=2, pipeline_depth=8)
    eng.submit(_zeros(), {"c": np.float32(1)}, linear_schedule(6))
    for _ in range(3):
        eng.tick()
    assert eng._pending  # window open
    eng.stop()
    assert not eng._pending
    assert eng.stats.total_step_time_s > 0


def test_engine_group_multi_resolution():
    """Requests of different latent shapes route to per-shape engines and
    all complete."""
    def factory(shape):
        def step_fn(x, s_cur, s_next, cond):
            return x * 0.5  # trivial contraction per step
        return _engine(step_fn, max_batch=2)

    g = EngineGroup(factory)
    sig = np.array([1.0, 0.5, 0.0], np.float32)
    r1 = g.submit(np.ones((8, 8, 4), np.float32), {}, sig)
    r2 = g.submit(np.ones((16, 16, 4), np.float32), {}, sig)
    r3 = g.submit(np.ones((8, 8, 4), np.float32), {}, sig)
    g.run_until_drained(timeout_s=30)
    for r in (r1, r2, r3):
        assert r.result is not None and r.error is None
    assert r1.result.shape == (8, 8, 4)
    assert r2.result.shape == (16, 16, 4)
    np.testing.assert_allclose(r1.result, 0.25 * np.ones((8, 8, 4)),
                               rtol=1e-6)
    assert len(g.stats) == 2


def test_non_pow2_max_batch_bucket():
    """max_batch=3: the full pool must bucket at 3 (never pad=-1)."""
    eng = _engine(max_batch=3)
    assert eng.batch_sizes == (1, 2, 3)
    reqs = [eng.submit(_zeros(), {"c": np.float32(i + 1)},
                       linear_schedule(3))
            for i in range(3)]
    eng.run_until_drained()
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.result, -(i + 1), atol=1e-6)
    assert eng.stats.total_padding_lanes >= 0


def _submit_three(eng):
    return [eng.submit(np.full((2, 2, 1), float(i), np.float32),
                       {"c": np.float32(i + 1)}, linear_schedule(steps))
            for i, steps in enumerate((4, 6, 3))]


def test_snapshot_restore_resumes_exactly():
    """An engine interrupted mid-pool snapshots its unfinished requests
    (host numpy), a FRESH engine restores them, and the drained results
    equal an uninterrupted run."""
    eng0 = _engine(max_batch=2)
    ref = _submit_three(eng0)
    eng0.run_until_drained()
    want = [r.result for r in ref]

    eng1 = _engine(max_batch=2)
    _submit_three(eng1)
    eng1.tick()
    eng1.tick()  # partial progress; request 2 still queued (max_batch 2)
    snap = eng1.snapshot()
    assert len(snap) == 3 and any(s["step"] > 0 for s in snap)
    assert all(isinstance(s["latent"], np.ndarray) for s in snap)

    # snapshot round-trips through a file (cross-process persistence)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "snap.npy")
        np.save(p, np.asarray(snap, dtype=object), allow_pickle=True)
        snap = list(np.load(p, allow_pickle=True))

    # "new process": a fresh engine picks the pool up mid-denoise
    eng2 = _engine(max_batch=2)
    reqs2 = eng2.restore(snap)
    eng2.run_until_drained()
    assert all(r.finished for r in reqs2)
    for got, ref_r in zip((r.result for r in reqs2), want):
        np.testing.assert_allclose(got, ref_r, rtol=1e-6, atol=1e-6)


def _bf16_step(x, s_cur, s_next, cond):
    """A bf16 latent whose step rounds: exact only if the state carried
    across the snapshot is the same bits."""
    x = x.to(torch.bfloat16)
    v = torch.sin(x.to(torch.float32) * 3.1) + cond["c"][:, None, None, None]
    return (x.to(torch.float32)
            + (s_next - s_cur)[:, None, None, None] * v).to(torch.bfloat16)


def test_bf16_snapshot_roundtrip_is_exact():
    """snapshot() widens bf16 latents to float32 numpy, restore() narrows
    them back: the restored run equals the uninterrupted one bit for bit,
    and every result is a float32 array of bf16 values."""
    rng = np.random.default_rng(3)
    x0s = [rng.standard_normal((3, 3, 2)).astype(np.float32)
           for _ in range(3)]

    def submit(eng):
        return [eng.submit(x, {"c": np.float32(0.1 * i)},
                           linear_schedule(5 + i))
                for i, x in enumerate(x0s)]

    eng0 = _engine(_bf16_step, max_batch=2)
    ref = submit(eng0)
    eng0.run_until_drained()
    eng1 = _engine(_bf16_step, max_batch=2)
    submit(eng1)
    for _ in range(3):
        eng1.tick()
    snap = eng1.snapshot()
    # two stepped bf16 latents; the third request is still queued, its
    # latent the float32 array it was submitted with
    assert [s["latent_dtype"] for s in snap] == ["bfloat16", "bfloat16",
                                                 None]
    assert all(s["latent"].dtype == np.float32 for s in snap)
    eng2 = _engine(_bf16_step, max_batch=2)
    got = eng2.restore(snap)
    eng2.run_until_drained()
    for r, w in zip(got, ref):
        assert r.result.dtype == np.float32
        np.testing.assert_array_equal(r.result, w.result)
        back = torch.from_numpy(r.result).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(back, r.result)


def test_bucket_router_mixed_resolutions():
    """BucketRouter: requests of different latent shapes route to
    per-shape engines, results are exact, and same-shape requests POOL in
    one engine."""
    made = []

    def factory(shape):
        made.append(shape)
        return _engine(max_batch=4)

    router = BucketRouter(factory)
    r_small = [router.submit(np.full((2, 2, 1), float(i), np.float32),
                             {"c": np.float32(i + 1)}, linear_schedule(4))
               for i in range(2)]
    r_big = router.submit(np.zeros((4, 4, 1), np.float32),
                          {"c": np.float32(5)}, linear_schedule(3))
    router.run_until_drained()

    assert made == [(2, 2, 1), (4, 4, 1)]  # lazily created, reused
    for i, r in enumerate(r_small):
        np.testing.assert_allclose(r.result, float(i) - (i + 1),
                                   atol=1e-6)
    np.testing.assert_allclose(r_big.result, -5.0, atol=1e-6)
    small = router.engines[(2, 2, 1)]
    assert small.stats.batches_executed < small.stats.steps_executed
    assert set(router.stats) == {"(2, 2, 1)", "(4, 4, 1)"}


def test_threaded_engine_concurrent_producers():
    """The background-thread mode under real concurrency: four producer
    threads submit interleaved while the engine thread ticks; every request
    completes with the exact integral and stop() flushes cleanly."""
    eng = _engine(max_batch=4)
    eng.start()
    results = {}

    def producer(tid):
        for i in range(8):
            c = float(tid * 8 + i + 1)
            r = eng.submit(_zeros(), {"c": np.float32(c)},
                           linear_schedule(2 + (i % 3)))
            results[(tid, i)] = (r, c)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    for r, _c in results.values():
        assert r.done_event.wait(timeout=60.0)
    eng.stop()

    assert eng.stats.completed == 32 and eng.stats.failed == 0
    assert eng.stats.submitted == 32
    for (tid, i), (r, c) in results.items():
        assert r.finished and r.error is None
        np.testing.assert_allclose(r.result, -c, atol=1e-5)


def test_admission_moves_each_request_once():
    """The request's latent and cond become tensors at admission; after a
    step the latent is the step's output (no host round trip)."""
    seen = []

    def step(x, s_cur, s_next, cond):
        seen.append((type(x), type(cond["c"]), s_cur.dtype))
        return _linear_step(x, s_cur, s_next, cond)

    eng = _engine(step, max_batch=2)
    r = eng.submit(_zeros(), {"c": np.float32(2)}, linear_schedule(3))
    eng.tick()
    assert isinstance(r.latent, torch.Tensor)
    assert isinstance(r.cond["c"], torch.Tensor) and r.cond["c"].ndim == 0
    eng.run_until_drained()
    assert all(s == (torch.Tensor, torch.Tensor, torch.float32)
               for s in seen)


def _rand_lanes(rng, B, shape=(3, 4)):
    x = rng.standard_normal((B, *shape)).astype(np.float32)
    den = rng.standard_normal((B, *shape)).astype(np.float32)
    old = rng.standard_normal((B, *shape)).astype(np.float32)
    s_cur = rng.uniform(0.2, 1.0, B).astype(np.float32)
    s_next = (s_cur * rng.uniform(0.3, 0.9, B)).astype(np.float32)
    s_prev = (s_cur * rng.uniform(1.1, 2.0, B)).astype(np.float32)
    return x, den, old, s_cur, s_next, s_prev


@pytest.mark.parametrize("case", ["all_valid", "mixed", "final_step",
                                  "bf16"])
def test_lane_dpmpp_2m_update_matches_reference(case):
    """The per-lane update against the reference's on random lanes: every
    lane valid, a mix of first steps (invalid) and multistep lanes, lanes
    stepping to σ' = 0, and a bf16 latent; within 1e-6."""
    rng = np.random.default_rng(hash(case) % 2**32)
    B = 5
    x, den, old, s_cur, s_next, s_prev = _rand_lanes(rng, B)
    valid = np.ones(B, bool)
    if case in ("mixed", "final_step"):
        valid = np.array([True, False, True, False, True])
    if case == "final_step":
        s_next[[0, 1]] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if case == "bf16" else jnp.float32)
    want, (jden, js, jvalid) = jserving.lane_dpmpp_2m_update(
        jx, jnp.asarray(den), s_cur, s_next,
        (jnp.asarray(old), jnp.asarray(s_prev), jnp.asarray(valid)))
    tx = torch.from_numpy(x)
    if case == "bf16":
        tx = tx.to(torch.bfloat16)
    got, (tden, ts, tvalid) = lane_dpmpp_2m_update(
        tx, torch.from_numpy(den), torch.from_numpy(s_cur),
        torch.from_numpy(s_next),
        (torch.from_numpy(old), torch.from_numpy(s_prev),
         torch.from_numpy(valid)))
    assert got.dtype == tx.dtype
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    if case == "bf16":  # one bf16 rounding of nearly equal f32 values
        np.testing.assert_allclose(g, w, rtol=8e-3, atol=1e-6)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tden.numpy(), np.asarray(jden))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tvalid.all() and np.asarray(jvalid).all()
    if case == "final_step":  # σ' = 0 lands on the denoised output
        np.testing.assert_allclose(g[:2], den[:2], rtol=1e-6, atol=1e-6)


def test_flow_multistep_aux_init_matches_reference():
    lat = torch.ones((4, 3))
    old, sp, valid = flow_multistep_aux_init(lat)
    jold, jsp, jvalid = jserving.flow_multistep_aux_init(np.ones((4, 3)))
    assert old.shape == tuple(jold.shape) and old.dtype == torch.float32
    assert not bool(old.any()) and float(sp) == float(jsp) == 0.0
    assert bool(valid) == bool(jvalid) is False
