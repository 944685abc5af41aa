"""Profiling, roofline accounting and memory reporting (PyTorch port of
comfyui_gguf_tpu/observability.py).

``trace`` captures a ``torch.profiler`` trace (CPU and, with a card, CUDA
activity) into a Chrome trace file; ``annotate`` names a region of it
(``record_function``). ``MatmulRoofline``/``qmm_roofline`` give the least
time a packed matmul could take on the card and, with a measured time,
its achieved rates; ``memory_report`` counts packed against would-be-dense
bytes; ``StepTimer`` accumulates named phases on the host clock,
synchronising the card around each so a phase holds its device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import torch

from ._device import resolve_device
from .lora import PatchedWeight
from .quant.i8 import I8Planar
from .quant.planar import PlanarQuant

log = logging.getLogger(__name__)

# peaks for roofline normalization: bf16 dense TFLOP/s, memory GB/s. The
# H100 SXM's published peaks (at its 700 W limit); a card set below that
# limit runs slower under load.
CHIP_SPECS = {
    "h100": (989.0, 3350.0),
    "cpu": (1.0, 50.0),
}


def detect_chip() -> str:
    """The CHIP_SPECS entry of the card (``torch.cuda``), or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0)
    if "H100" not in name:
        # another card: CPU peaks would be far off; use the H100's, and
        # say so
        log.warning("unrecognized CUDA device %r; using H100 peaks for "
                    "roofline math", name)
    return "h100"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace; writes ``log_dir/trace.json``
    (Chrome trace format) on exit and yields the profiler, whose
    ``key_averages()`` sums the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


# ---------------------------------------------------------------------------
# roofline accounting for the fused dequant+matmul
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatmulRoofline:
    """Ideal vs measured numbers for x(M,K) @ W(R,K)ᵀ with packed W."""

    m: int
    shape: tuple[int, int]
    flops: int
    weight_bytes: int
    act_bytes: int
    chip: str
    measured_s: float | None = None

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.act_bytes

    @property
    def sol_s(self) -> float:
        """Speed-of-light time: max(tensor-core time, memory time)."""
        tf, gbs = CHIP_SPECS[self.chip]
        return max(self.flops / (tf * 1e12), self.total_bytes / (gbs * 1e9))

    @property
    def achieved_tflops(self) -> float | None:
        if not self.measured_s:
            return None
        return self.flops / self.measured_s / 1e12

    @property
    def achieved_gbs(self) -> float | None:
        if not self.measured_s:
            return None
        return self.total_bytes / self.measured_s / 1e9

    @property
    def sol_fraction(self) -> float | None:
        if not self.measured_s:
            return None
        return self.sol_s / self.measured_s

    def report(self) -> dict:
        out = {
            "shape": f"{self.m}x{self.shape[1]}x{self.shape[0]}",
            "flops": self.flops,
            "bytes": self.total_bytes,
            "sol_ms": round(self.sol_s * 1e3, 4),
            "chip": self.chip,
        }
        if self.measured_s:
            out.update({
                "measured_ms": round(self.measured_s * 1e3, 4),
                "achieved_tflops": round(self.achieved_tflops, 2),
                "achieved_gbs": round(self.achieved_gbs, 2),
                "sol_fraction": round(self.sol_fraction, 4),
            })
        return out


def qmm_roofline(pq, m: int, measured_s: float | None = None,
                 chip: str | None = None,
                 act_bytes_per_elem: int = 2) -> MatmulRoofline:
    """Roofline of x(m, K) @ W(R, K)ᵀ for a packed weight (PlanarQuant or
    I8Planar)."""
    R, K = pq.shape
    return MatmulRoofline(
        m=m, shape=pq.shape,
        flops=2 * m * K * R,
        weight_bytes=pq.nbytes_packed,
        act_bytes=(m * K + m * R) * act_bytes_per_elem,
        chip=chip or detect_chip(),
        measured_s=measured_s,
    )


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def _flat_items(params: dict, prefix: str = ""):
    """(key, leaf) pairs; a nested dict (a depth-stacked group) contributes
    its leaves under ``group.key``."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def memory_report(params: dict) -> dict:
    """Packed vs would-be-dense bytes of a param tree + its largest
    tensor. LoRA-patched leaves count their base weight."""
    packed = dense16 = 0
    largest_key, largest_bytes = None, -1
    n_packed = n_dense = 0
    for k, v in _flat_items(params):
        if isinstance(v, PatchedWeight):
            v = v.base
        if isinstance(v, (PlanarQuant, I8Planar)):
            b = v.nbytes_packed
            depth = v.qs.numel() // (v.qs.shape[-1] * v.qs.shape[-2])
            packed += b
            dense16 += 2 * v.shape[0] * v.shape[1] * depth
            n_packed += 1
        else:
            b = (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                 else int(getattr(v, "nbytes", 0)))
            packed += b
            dense16 += b
            n_dense += 1
        if b > largest_bytes:
            largest_key, largest_bytes = k, b
    return {
        "packed_bytes": packed,
        "dense_bf16_bytes": dense16,
        "compression": round(dense16 / packed, 3) if packed else None,
        "largest_tensor": largest_key,
        "largest_tensor_bytes": largest_bytes,
        "n_packed": n_packed,
        "n_dense": n_dense,
    }


class StepTimer:
    """Host-clock accumulator for named phases. On the card each phase
    starts and ends with a synchronize, so it holds the device work it
    queued (``device``: the card unless the caller asks for the CPU)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def snapshot(self) -> dict:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(v / self.counts[k] * 1e3, 3)}
            for k, v in self.totals.items()
        }
