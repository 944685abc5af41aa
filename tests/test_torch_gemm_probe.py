"""The GEMM probes' plain versions against numpy, on the CPU.

bf16: an f32 product of the bf16-rounded operands, rounded to bf16 — held
to a float64 numpy product within one bf16 step (2^-8 relative); w is (K,
R). int8: w is (R, K), K contiguous (the model's int8 weight layout); the
integer product is exact, so the raw probe equals numpy's int64 product
x @ w.T after the same two casts, and the w8a8 probe equals ``acc·xs·ws``
computed in f32 in the same order, bit for bit. On CPU tensors the probes
take their plain versions; the CUDA kernels are held against them in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch.ops import gemm_probe

torch.set_num_threads(2)

SHAPES = [(128, 64, 256), (256, 320, 512), (128, 3072, 256)]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("M,K,R", SHAPES, ids=str)
def test_plain_bf16_matches_numpy(M, K, R):
    rng = np.random.default_rng(M + K)
    x = _bf16(rng.standard_normal((M, K)).astype(np.float32))
    w = _bf16(rng.standard_normal((K, R)).astype(np.float32))
    want = x.double().numpy() @ w.double().numpy()
    got = gemm_probe.probe_bf16(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (M, R)
    err = np.abs(got.double().numpy() - want)
    assert (err <= np.abs(want) * 2.0 ** -8 + 1e-3).all()


@pytest.mark.parametrize("M,K,R", SHAPES, ids=str)
def test_plain_s8_is_exact(M, K, R):
    rng = np.random.default_rng(K + R)
    x = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (R, K), dtype=np.int8)
    acc = x.astype(np.int64) @ w.astype(np.int64).T
    want = torch.from_numpy(acc.astype(np.float32)).to(torch.bfloat16)
    got = gemm_probe.probe_s8(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 128])
@pytest.mark.parametrize("M,K,R", SHAPES[:2], ids=str)
def test_plain_w8a8_rescale(M, K, R, lanes):
    rng = np.random.default_rng(M + R + lanes)
    x = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (R, K), dtype=np.int8)
    xs = (rng.random((M, lanes)) + 0.5).astype(np.float32)
    ws = (rng.random((1, R)) + 0.5).astype(np.float32)
    acc = (x.astype(np.int64) @ w.astype(np.int64).T).astype(np.float32)
    want = torch.from_numpy(acc * xs[:, :1] * ws).to(torch.bfloat16)
    got = gemm_probe.probe_w8a8(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(xs), torch.from_numpy(ws))
    assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((128, 64), dtype=torch.int8)
    w = torch.zeros((256, 64), dtype=torch.int8)  # (R, K) at s8
    assert gemm_probe._check(x, w, torch.int8, 128) == (128, 64, 256)
    with pytest.raises(ValueError, match="R, K"):
        gemm_probe._check(x, w.t().contiguous(), torch.int8, 128)
    wb = torch.zeros((64, 256), dtype=torch.bfloat16)  # (K, R) at bf16
    assert gemm_probe._check(x.bfloat16(), wb, torch.bfloat16,
                             256) == (128, 64, 256)
    with pytest.raises(TypeError):
        gemm_probe._check(x, wb.to(torch.int8), torch.bfloat16, 128)
    with pytest.raises(ValueError, match="block tile"):
        gemm_probe._check(x, w, torch.int8, 64)
    with pytest.raises(ValueError, match="M % 128"):
        gemm_probe._check(x[:100], w, torch.int8, 128)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_probe._check(x, w.t().contiguous().t(), torch.int8, 128)
