"""Run a function on ``world`` local ranks and return each rank's result.

The port's counterpart of one process seeing ``jax.devices()``: the
caller starts ranks (``spawn`` processes, one per rank), each joins one
``torch.distributed`` process group, and jobs are fed to the live ranks.

    with Ranks(2) as ranks:              # on the card; device="cpu" asks
        outs = ranks.run(fn, *args)      # for the CPU: fn(*args) on every
                                         # rank

``fn`` and its arguments are pickled to the ranks; under ``spawn`` the
child imports ``fn``'s module, so keep it in a module that does not
import JAX. Results come back pickled: return numpy arrays or small
objects, not CUDA tensors.

Rules:
* Rendezvous through a ``file://`` init method in a fresh temporary
  directory, so concurrent launches on one host never collide on a port.
* The backend follows the topology, stated by ``backend_for``: NCCL when
  the ranks run on CUDA and each owns its own card, gloo otherwise (ranks
  on the CPU, or several ranks sharing one card).
* On the CPU each rank runs ``torch.set_num_threads(1)``: the ranks
  share the host's cores.
* A rank that fails fails the launch: its traceback is raised in the
  caller and every rank is torn down. There is no timeout that passes.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

from .._device import resolve_device


class RankError(RuntimeError):
    """A rank raised (or died); the message carries its traceback."""


def backend_for(device: str, world: int) -> str:
    """NCCL when every rank owns its own CUDA device, else gloo."""
    if str(device).startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _worker(rank, world, init, backend, device, ranks_per_host, jobs,
            results):
    import torch.distributed as dist

    os.environ["LOCAL_WORLD_SIZE"] = str(ranks_per_host)
    os.environ["LOCAL_RANK"] = str(rank % ranks_per_host)
    if str(device).startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            try:
                job = jobs.get()
                if job is None:
                    break
                fn, args, kw = job
                results.put((rank, True, fn(*args, **kw)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` live ranks on ``device`` (the card unless the caller asks
    for the CPU); ``run`` feeds them one job. ``ranks_per_host`` groups
    ranks into hosts for ``mesh.make_multihost_mesh`` (``LOCAL_WORLD_SIZE``
    in each rank)."""

    def __init__(self, world: int, *, device: str = "cuda",
                 backend: str | None = None,
                 ranks_per_host: int | None = None):
        device = resolve_device(device).type
        self.world = world
        self.backend = backend or backend_for(device, world)
        self._tmp = tempfile.mkdtemp(prefix="gguf_torch_ranks_")
        init = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(
            target=_worker,
            args=(r, world, init, self.backend, device,
                  ranks_per_host or world, self._jobs[r],
                  self._results),
            daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kw) -> list:
        """``fn(*args, **kw)`` on every rank; the results by rank."""
        if self._procs is None:
            raise RankError("the ranks were torn down by an earlier failure")
        for q in self._jobs:
            q.put((fn, args, kw))
        out: dict = {}
        while len(out) < self.world:
            try:
                rank, ok, val = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(self._procs)
                        if p.exitcode is not None and r not in out}
                if dead:
                    self.close(failed=True)
                    raise RankError(f"rank(s) exited before returning a "
                                    f"result (exit codes {dead})")
                continue
            if not ok:
                self.close(failed=True)
                raise RankError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        return [out[r] for r in range(self.world)]

    def close(self, failed: bool = False) -> None:
        """Stop every rank. After a failure the others are killed: they
        may wait in a collective for the rank that failed."""
        procs, self._procs = self._procs, None
        if procs is None:
            return
        if not failed:
            for q in self._jobs:
                q.put(None)
            for p in procs:
                p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.close(failed=exc_type is not None)


def run(fn, world: int, *args, device: str = "cuda",
        backend: str | None = None, ranks_per_host: int | None = None,
        **kw) -> list:
    """One job on ``world`` fresh ranks: ``fn(*args, **kw)`` on each,
    the results by rank."""
    with Ranks(world, device=device, backend=backend,
               ranks_per_host=ranks_per_host) as ranks:
        return ranks.run(fn, *args, **kw)
