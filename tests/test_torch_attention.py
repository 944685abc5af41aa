"""The port's plain attention against ``jax.nn.dot_product_attention``.

Same inputs in the reference's (B, H, L, D) layout; cases Lq == Lk,
Lq != Lk (cross-attention), D = 64 and 128, a key length that is not a
multiple of 64 (the CUDA kernel's ragged tile), k/v in another dtype than
q. Tolerance 1e-5 in float32 (only the summation order differs).

Then f16 and f32 q/k/v through both packages' dispatchers at every head
dim of the flash kernel (tolerances at ``DT_TOL``), and the table that
picks the card's instance by dtype and head dim, checked without a launch.
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


# -- f16 and f32 attention: the dispatcher against the reference's ---------

from comfyui_gguf_tpu.nn import attention as jattention  # noqa: E402
from comfyui_gguf_tpu_torch.nn.attention import (  # noqa: E402
    FLASH_HEAD_DIMS, flash_instance)
from comfyui_gguf_tpu_torch.ops import i8attn as ti8  # noqa: E402

# relative L2 of the whole output: f32 differs only in summation order
# (found: 7.0e-7 at most); f16 also rounds the probabilities and the output
# to f16 (one f16 step is 2^-11 of a value), at a place the order of the
# sums can move (found: 5.3e-5 at most): about ten times what was found
DT_TOL = {"float16": 5e-4, "float32": 1e-5}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dt", ["float16", "float32"])
@pytest.mark.parametrize("D", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("Lq,Lk", [(70, 70), (33, 131)], ids=str)
def test_f16_f32_dispatcher_matches_reference(dt, D, Lq, Lk):
    """The same f16 / f32 numpy q/k/v through the reference's dispatcher
    (its ``jax.nn`` branch off the TPU) and the port's, at each head dim
    the flash kernel has an instance for, self-attention with a ragged key
    tile and cross-attention with Lq != Lk: the output keeps q's dtype."""
    rng = np.random.default_rng(D * 7 + Lk)
    q, k, v = (rng.standard_normal((2, 2, L, D)).astype(dt)
               for L in (Lq, Lk, Lk))
    want = np.asarray(jattention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    assert got.dtype == getattr(torch, dt) and want.dtype == np.dtype(dt)
    assert got.shape == (2, 2, Lq, D)
    assert _rel(got.float().numpy(), want) <= DT_TOL[dt]


# (dtype, head dim) -> the C entry and launch counters K7 takes on the card
FLASH_TABLE = {
    **{(torch.bfloat16, D): ("flash_attn_launch",
                             ("flash_attn", f"flash_attn_d{D}"))
       for D in FLASH_HEAD_DIMS},
    **{(torch.float16, D): ("flash_attn_f16_launch", ("flash_attn_f16",))
       for D in FLASH_HEAD_DIMS},
    **{(torch.float32, D): ("flash_attn_f32_launch", ("flash_attn_f32",))
       for D in FLASH_HEAD_DIMS},
}
# (dtype, pv_int8) -> the type kind the K6 entries take, the prep's
# counter, K6's counter
I8ATTN_TABLE = {
    (torch.bfloat16, True): (0, "i8attn_prep", "i8attn_pv"),
    (torch.bfloat16, False): (0, "i8attn_prep", "i8attn_qk"),
    (torch.float16, True): (1, "i8attn_prep_f16", "i8attn_pv_f16"),
    (torch.float16, False): (1, "i8attn_prep_f16", "i8attn_qk_f16"),
    (torch.float32, True): (2, "i8attn_prep_f32", "i8attn_pv_f32"),
    (torch.float32, False): (2, "i8attn_prep_f32", "i8attn_qk_f32"),
}


def test_wrappers_pick_their_instance_from_a_table():
    """The host side of the attention wrappers, without a launch: each
    (dtype, head dim) takes the entry and counters of the table, every
    entry is bound, every counter exists; float64 and head dims without an
    instance raise, naming what there is."""
    import ctypes

    from comfyui_gguf_tpu_torch import _build

    for (dt, D), want in FLASH_TABLE.items():
        assert flash_instance(dt, D) == want
        assert want[0] in _build._SIGNATURES
        assert all(c in _build.LAUNCHES for c in want[1])
    for (dt, pv), want in I8ATTN_TABLE.items():
        assert ti8.i8attn_instance(dt, pv) == want
        assert want[1] in _build.LAUNCHES and want[2] in _build.LAUNCHES
    # K6's entries take the type kind as an argument
    assert _build._SIGNATURES["i8attn_launch"][-2] is ctypes.c_int
    assert _build._SIGNATURES["i8attn_prep_launch"][-2] is ctypes.c_int
    for dt in (torch.float64, torch.int8):
        with pytest.raises(NotImplementedError,
                           match="bfloat16, float16, float32"):
            flash_instance(dt, 128)
        with pytest.raises(NotImplementedError,
                           match="bfloat16, float16, float32"):
            ti8.i8attn_instance(dt, True)
    for D in (32, 48, 192):
        with pytest.raises(NotImplementedError, match="40, 64, 80, 96"):
            flash_instance(torch.float32, D)
    # every f16 / f32 counter of the table is a family of its own: none
    # of them is a bf16 counter
    fam = {c for _, cs in FLASH_TABLE.values() for c in cs
           if not c.startswith("flash_attn_d") and c != "flash_attn"}
    assert fam == {"flash_attn_f16", "flash_attn_f32"}
