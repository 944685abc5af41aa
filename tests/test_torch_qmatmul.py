"""The port's plain fused dequant-matmul against the reference package.

The plain version (dequantize, f32-accumulated matmul, unfused epilogue)
is held against the reference's ``xla_qmm`` + ``_host_epilogue`` and
against its Pallas kernel run in interpret mode, on the same blocks and
inputs: formats Q4_K / Q4_0 (nib4) and Q8_0 (int8), K=512 and a padded
K=2432, M in {1, 37}, with and without bias, GELU on no column, all columns
or a tail. Tolerance: 1e-5 relative L2 with f32 dequant (only the summation
order differs), 1e-2 with bf16 operands and output (bf16 rounding points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.ops import qmatmul as jqmm
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.ops.qmatmul import (plain_quantized_matmul,
                                                quantized_matmul)
from comfyui_gguf_tpu_torch.quant import codecs

torch.set_num_threads(2)

R = 1024  # padded out-features 1024: the Pallas r-tile is 512
EPILOGUES = [(False, None), (True, 0), (True, 512), (False, 512)]


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _case(qtype, K, M, seed=0):
    rng = np.random.default_rng(seed + K + M + int(qtype))
    w = rng.standard_normal((R, K), dtype=np.float32)
    blocks = codecs.quantize(w, qtype)
    jp = jplanar.planarize(blocks, JQ(int(qtype)), (R, K))
    pq = params_from_numpy({"w": jp}, device="cpu")["w"]
    x = rng.standard_normal((M, K), dtype=np.float32)
    bias = (rng.standard_normal(R) * 0.5).astype(np.float32)
    return jp, pq, x, bias


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q8_0],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("K", [512, 2432])
@pytest.mark.parametrize("M", [1, 37])
@pytest.mark.parametrize("has_bias,act", EPILOGUES, ids=str)
def test_plain_matches_reference_xla(qtype, K, M, has_bias, act):
    jp, pq, x, bias = _case(qtype, K, M)
    b = bias if has_bias else None
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 1e-2)):
        want = jqmm._host_epilogue(
            jqmm.xla_qmm(jnp.asarray(x, jdt), jp, dequant_dtype=jdt),
            None if b is None else jnp.asarray(b), act)
        got = plain_quantized_matmul(
            _torch(x, dt), pq, dequant_dtype=dt,
            bias=None if b is None else torch.from_numpy(b),
            act_from_col=act)
        assert got.shape == (M, R) and got.dtype == dt
        assert _rel_l2(got.float(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q8_0],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("K", [512, 2432])
def test_plain_matches_reference_kernel_interpret(qtype, K):
    jp, pq, x, bias = _case(qtype, K, 37, seed=5)
    want = jqmm.pallas_qmm(jnp.asarray(x), jp, dequant_dtype=jnp.float32,
                           interpret=True, bias=jnp.asarray(bias),
                           act_from_col=512)
    got = quantized_matmul(torch.from_numpy(x), pq,
                           dequant_dtype=torch.float32,
                           bias=torch.from_numpy(bias), act_from_col=512)
    assert _rel_l2(got, np.asarray(want)) < 1e-5


def test_cpu_dispatch_is_the_plain_version():
    jp, pq, x, bias = _case(Q.Q4_K, 512, 4)
    xt = _torch(x, torch.bfloat16)
    a = quantized_matmul(xt, pq, bias=torch.from_numpy(bias), act_from_col=0)
    b = plain_quantized_matmul(xt, pq, bias=torch.from_numpy(bias),
                               act_from_col=0)
    assert torch.equal(a, b)
