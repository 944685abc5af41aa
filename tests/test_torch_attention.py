"""The port's plain attention against ``jax.nn.dot_product_attention``.

Same inputs in the reference's (B, H, L, D) layout; cases Lq == Lk,
Lq != Lk (cross-attention), D = 64 and 128, a key length that is not a
multiple of 64 (the CUDA kernel's ragged tile), k/v in another dtype than
q. Tolerance 1e-5 in float32 (only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch.nn.attention import dot_product_attention

torch.set_num_threads(2)


def _ref(q, k, v, scale):
    out = jax.nn.dot_product_attention(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), scale=scale)
    return np.asarray(out.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("B,H,Lq,Lk,D", [
    (1, 2, 64, 64, 128),
    (2, 3, 40, 72, 64),
    (1, 2, 100, 100, 64),
    (1, 4, 131, 77, 128),
], ids=str)
def test_plain_matches_jax(B, H, Lq, Lk, D):
    rng = np.random.default_rng(Lq + Lk + D)
    q = rng.standard_normal((B, H, Lq, D), dtype=np.float32)
    k = rng.standard_normal((B, H, Lk, D), dtype=np.float32)
    v = rng.standard_normal((B, H, Lk, D), dtype=np.float32)
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    want = _ref(q, k, v, D ** -0.5)
    assert got.shape == (B, H, Lq, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_custom_scale_and_kv_dtype_follow_q():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, 16, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, 24, 64), dtype=np.float32)
    v = rng.standard_normal((1, 2, 24, 64), dtype=np.float32)
    got = dot_product_attention(torch.from_numpy(q),
                                torch.from_numpy(k).double(),
                                torch.from_numpy(v).double(), scale=1.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, 1.0),
                               rtol=1e-5, atol=1e-5)
