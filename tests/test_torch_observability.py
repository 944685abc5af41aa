"""The port's roofline and memory accounting (``observability.py``) on the
CPU: the reference's four tests (``tests/test_observability.py``) with the
port's chip table (the H100 SXM's peaks, no TPU entry), plus the memory
report against the reference's on the same tree, a stacked tree, the
device name, and the profiler trace and annotation."""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from comfyui_gguf_tpu import observability as jobs
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.quant import codecs as jcodecs
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch import observability as obs
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.quant.i8 import requantize_i8

torch.set_num_threads(2)


def _w(R=256, K=512):
    return np.random.default_rng(0).standard_normal((R, K), dtype=np.float32)


def _pq(R=256, K=512, qtype=Q.Q4_K):
    return planar.planarize(codecs.quantize(_w(R, K), qtype), qtype, (R, K),
                            device="cpu")


def test_qmm_roofline_math():
    pq = _pq()
    r = obs.qmm_roofline(pq, m=128, measured_s=1e-3, chip="h100")
    assert r.flops == 2 * 128 * 512 * 256
    # Q4_K planar: 4bpw codes + f32 scales + f32 offsets per 32-group
    assert r.weight_bytes == pq.nbytes_packed
    assert r.sol_s > 0 and r.sol_fraction < 1.0
    rep = r.report()
    assert rep["achieved_tflops"] > 0 and rep["achieved_gbs"] > 0
    # the same numbers as the reference's on the same weight and peaks
    jpq = jplanar.planarize(jcodecs.quantize(_w(), JQ.Q4_K), JQ.Q4_K,
                            (256, 512))
    jr = jobs.qmm_roofline(jpq, m=128, measured_s=1e-3, chip="cpu")
    r_cpu = obs.qmm_roofline(pq, m=128, measured_s=1e-3, chip="cpu")
    assert r_cpu.report() == jr.report()


def test_sol_is_max_of_compute_and_bandwidth():
    pq = _pq()
    r = obs.qmm_roofline(pq, m=1, chip="h100")  # tiny m → bandwidth-bound
    tf, gbs = obs.CHIP_SPECS["h100"]
    assert (tf, gbs) == (989.0, 3350.0)
    assert abs(r.sol_s - r.total_bytes / (gbs * 1e9)) < 1e-12
    r2 = obs.qmm_roofline(pq, m=100_000, chip="h100")
    want = max(r2.flops / (tf * 1e12), r2.total_bytes / (gbs * 1e9))
    assert abs(r2.sol_s - want) < 1e-12
    assert set(obs.CHIP_SPECS) == {"h100", "cpu"}


def test_memory_report():
    pq = _pq()
    params = {"w.weight": pq, "b.bias": torch.zeros(256)}
    rep = obs.memory_report(params)
    assert rep["n_packed"] == 1 and rep["n_dense"] == 1
    assert rep["largest_tensor"] == "w.weight"
    assert rep["compression"] > 1.5  # Q4_K planar ≈ 6 bpw vs 16 bpw
    assert rep["packed_bytes"] == pq.nbytes_packed + 256 * 4
    jpq = jplanar.planarize(jcodecs.quantize(_w(), JQ.Q4_K), JQ.Q4_K,
                            (256, 512))
    assert rep == jobs.memory_report({"w.weight": jpq,
                                      "b.bias": jnp.zeros(256, jnp.float32)})


def test_memory_report_stacked_and_int8_trees():
    """A depth-stacked group counts each stacked leaf with its depth (the
    reference's report reads the top level only); int8 leaves are packed."""
    from comfyui_gguf_tpu_torch.models.flux import _stack_leaves

    pq = _pq()
    ip = requantize_i8(pq)
    stacked = {"blocks": {"w": _stack_leaves([pq, pq, pq])}, "i8": ip}
    rep = obs.memory_report(stacked)
    assert rep["n_packed"] == 2 and rep["n_dense"] == 0
    assert rep["packed_bytes"] == 3 * pq.nbytes_packed + ip.nbytes_packed
    assert rep["dense_bf16_bytes"] == 4 * 2 * 256 * 512
    assert rep["largest_tensor"] == "blocks.w"


def test_step_timer():
    t = obs.StepTimer(device="cpu")
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    snap = t.snapshot()
    assert snap["a"]["count"] == 2


def test_detect_chip_names_the_card():
    assert obs.detect_chip() == ("h100" if torch.cuda.is_available()
                                 else "cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with obs.trace(d) as prof:
        with obs.annotate("serving_tick"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "serving_tick" for e in events)
    assert any(e.key == "serving_tick" for e in prof.key_averages())
