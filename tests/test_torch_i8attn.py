"""The port's int8 attention against the reference's, on the CPU.

The same numpy q/k/v go through ``comfyui_gguf_tpu.ops.i8attn`` and the
port's ``ops/i8attn.py``:

* the shared prep gives the integers and scales of the reference's JITTED
  prep, which is what its kernel wrapper runs (q and v bit for bit; k after
  its mean-smoothing, where the two frameworks sum the mean in another
  order, may differ by one code on a few elements in ten thousand). The
  reference's eager prep divides by 127 where the jitted one multiplies by
  the reciprocal, so against it scales agree to one ulp and codes to one
  step on a few elements in a thousand;
* the plain version with one global maximum against ``xla_i8_attention``:
  ≤ 2e-3 relative L2 (identical integers; exp and f32 summation order
  differ, which can move a probability code by one step);
* the plain version at ``block_kv`` ∈ {128, 512} (and at head dims 256
  and 384, at 64, the CUDA kernel's tile there, and at 128) against the
  Pallas kernel in interpret mode at the same tile size: the reference's
  own tolerance for kernel vs same-math, atol = rtol = 0.05;
* the kernel's operand layout (``kernel_operands``: padded scales, Vᵀ in
  the permuted key order) round-trips, and the plain version gives the
  same bits on it as on the plain layout;
* an odd key tail, the gate, and the ``attention_i8`` scope inside and
  outside the gate (the JAX side runs as its own test does, forced into
  interpret mode).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.nn import attention as jattention
from comfyui_gguf_tpu.ops import i8attn as ji8
from comfyui_gguf_tpu_torch.nn import attention as tattention
from comfyui_gguf_tpu_torch.ops import i8attn as ti8

torch.set_num_threads(2)

SCALE = 128 ** -0.5


def _qkv(seed, B, H, L, D, Lk=None, shift=0.0):
    rng = np.random.default_rng(seed)
    Lk = Lk or L
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = (rng.standard_normal((B, H, Lk, D)) + shift).astype(np.float32)
    v = rng.standard_normal((B, H, Lk, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ref(q, k, v, scale):
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
def test_prep_integers_match_reference(pv_int8, jit):
    """The reference's kernel wrapper is jitted, its same-math path is
    not. Under jit XLA multiplies by the f32 reciprocal of 127 and folds
    the softmax scale into that constant; the port computes what the
    kernel wrapper computes."""
    q, k, v = _qkv(0, 2, 2, 96, 128, shift=0.7)
    fn = ji8.quantize_attn_inputs
    if jit:
        fn = jax.jit(fn, static_argnames=("scale", "pv_int8"))
    want = [np.asarray(a) for a in fn(*_j(q, k, v), scale=SCALE,
                                      pv_int8=pv_int8)]
    got = [a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
           for a in ti8.quantize_attn_inputs(*_t(q, k, v), SCALE,
                                             pv_int8=pv_int8)]
    qq, qs, kT, ks, vq, vs = want

    def codes_close(a, b, frac):
        d = a.astype(np.int32) - b.astype(np.int32)
        assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= d.size * frac

    # k: the port keeps (BH, L, D); the reference hands (BH, D, L)
    kq = kT.transpose(0, 2, 1)
    if jit:
        np.testing.assert_array_equal(got[0], qq)
        np.testing.assert_array_equal(got[1], qs)
        codes_close(got[2], kq, 1e-4)
        np.testing.assert_array_equal(got[5], vs)
        np.testing.assert_array_equal(
            got[4], vq if pv_int8 else np.asarray(vq, np.float32))
    else:
        codes_close(got[0], qq, 2e-3)
        np.testing.assert_allclose(got[1], qs, rtol=2e-7)
        codes_close(got[2], kq, 2e-3)
        np.testing.assert_allclose(got[5], vs, rtol=2e-7)
        if pv_int8:
            codes_close(got[4], vq, 2e-3)
    np.testing.assert_allclose(got[3], ks, rtol=1e-6)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 128), (2, 2, 100, 128),
                                   (1, 3, 192, 64), (1, 2, 160, 256),
                                   (1, 2, 96, 384)],
                         ids=str)
def test_plain_matches_xla_same_math(shape, pv_int8):
    q, k, v = _qkv(1, *shape)
    scale = shape[-1] ** -0.5
    want = ji8.xla_i8_attention(*_j(q, k, v), scale=scale, pv_int8=pv_int8)
    got = ti8.plain_i8_attention(*_t(q, k, v), scale=scale, pv_int8=pv_int8)
    assert got.shape == tuple(want.shape)
    assert _rel(got.numpy(), want) <= 2e-3


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("block_kv,D", [(128, 128), (512, 128), (64, 256),
                                        (128, 256), (64, 384)],
                         ids=["128", "512", "64-d256", "128-d256",
                              "64-d384"])
def test_plain_tiled_matches_pallas_interpret(block_kv, D, pv_int8):
    q, k, v = _qkv(2, 1, 2, 512, D)
    scale = D ** -0.5
    want = np.asarray(ji8.pallas_i8_attention(
        *_j(q, k, v), scale=scale, interpret=True, pv_int8=pv_int8,
        block_kv=block_kv))
    got = ti8.plain_i8_attention(*_t(q, k, v), scale=scale, pv_int8=pv_int8,
                                 block_kv=block_kv).numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    # the same tiling on both sides agrees far inside that tolerance
    assert _rel(got, want) <= 2e-3


@pytest.mark.parametrize("block_kv", [None, 64, 128])
def test_plain_accuracy_and_odd_key_tail(block_kv):
    """An odd key tail (Lk not a multiple of the tile) and the accuracy
    against exact f32 attention, at the reference's bound."""
    q, k, v = _qkv(3, 1, 2, 200, 128, Lk=330)
    want = _ref(q, k, v, SCALE)
    for pv_int8, limit in ((True, 0.035), (False, 0.03)):
        got = ti8.plain_i8_attention(*_t(q, k, v), scale=SCALE,
                                     pv_int8=pv_int8,
                                     block_kv=block_kv).numpy()
        assert 1e-6 < _rel(got, want) < limit


def test_tile_size_changes_p_quantization_only_slightly():
    q, k, v = _qkv(4, 1, 2, 512, 128)
    a = ti8.plain_i8_attention(*_t(q, k, v), scale=SCALE, block_kv=64)
    b = ti8.plain_i8_attention(*_t(q, k, v), scale=SCALE, block_kv=None)
    assert 0 < _rel(a.numpy(), b.numpy()) < 0.03


def test_key_order_is_the_fragment_permutation():
    """Thread t of a quad holds the scores of keys {2t, 2t+1, 8+2t, 9+2t}
    of every 16-key group (the s32 accumulator layout of Q·Kᵀ); the s8 A
    register it supplies to P·V holds k = 4t..4t+3 (the m16n8k32 layout).
    Position 4t + e of the kernel's Vᵀ must hold the key of byte e."""
    for t in range(4):
        held = [2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t]
        assert list(ti8.KEY_ORDER[4 * t:4 * t + 4]) == held
    assert sorted(ti8.KEY_ORDER) == list(range(16))


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("D,Lk", [(128, 200), (128, 128), (256, 77),
                                  (384, 100)],
                         ids=str)
def test_kernel_operands_round_trip(D, Lk, pv_int8):
    """Un-permuting and un-transposing the kernel's Vᵀ gives back the plain
    prep's V; the scales are the plain prep's, zero-padded to the tile."""
    q, k, v = _qkv(13, 2, 2, 96, D, Lk=Lk, shift=0.3)
    ops = ti8.quantize_attn_inputs(*_t(q, k, v), D ** -0.5, pv_int8=pv_int8)
    qq, qs, kq, ks, vk, vs = ti8.kernel_operands(*ops, pv_int8=pv_int8)
    bkv = ti8.kernel_block_kv(D)
    Lkp = -(-Lk // bkv) * bkv
    assert qs.shape == (4, 96) and ks.shape == (4, Lkp) and vs.shape == (4, D)
    assert torch.equal(ks[:, :Lk], ops[3].reshape(4, Lk))
    assert not bool(ks[:, Lk:].any())
    assert torch.equal(qq, ops[0]) and torch.equal(kq, ops[2])
    if pv_int8:
        assert vk.shape == (4, D, Lkp) and vk.dtype == torch.int8
        order = np.concatenate([np.asarray(ti8.KEY_ORDER) + g
                                for g in range(0, Lkp, 16)])
        plain = np.zeros((4, D, Lkp), np.int8)
        plain[:, :, order] = vk.numpy()
        np.testing.assert_array_equal(plain[:, :, :Lk].transpose(0, 2, 1),
                                      ops[4].numpy())
        assert not plain[:, :, Lk:].any()
    else:
        assert torch.equal(vk, ops[4])
    back = ti8.plain_operands(qq, qs, kq, ks, vk, vs, pv_int8=pv_int8)
    for a, b in zip(back, ops):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("D", [128, 256, 384])
def test_plain_on_kernel_layout_is_the_plain_version(D, pv_int8):
    """The plain version gives the same bits on the kernel's operand layout,
    brought back by ``plain_operands``, as on the plain one, at the kernel's
    tile (128 keys at D = 128, 64 at the others) with a ragged last
    tile."""
    q, k, v = _qkv(14, 1, 2, 150, D, Lk=200, shift=0.5)
    ops = ti8.quantize_attn_inputs(*_t(q, k, v), D ** -0.5, pv_int8=pv_int8)
    bkv = ti8.kernel_block_kv(D)
    want = ti8.plain_i8_attention_q(*ops, pv_int8=pv_int8, block_kv=bkv)
    kops = ti8.kernel_operands(*ops, pv_int8=pv_int8)
    got = ti8.plain_i8_attention_q(*ti8.plain_operands(*kops,
                                                       pv_int8=pv_int8),
                                   pv_int8=pv_int8, block_kv=bkv)
    assert torch.equal(got, want)


def test_kernel_instances_by_head_dim():
    """Every head dim the gate admits (a multiple of 128) has a key tile:
    128 at D = 128, 64 at 256 and in the split instance past it; others
    are refused."""
    assert ti8.kernel_block_kv(128) == 128 and ti8.kernel_block_kv(256) == 64
    for D in (384, 512, 1024):
        assert ti8.kernel_block_kv(D) == 64
    for D in (0, 64, 96, 320):
        with pytest.raises(ValueError, match=str(D)):
            ti8.kernel_block_kv(D)


GATE_SHAPES = [
    # Lq, Lk, D
    (512, 512, 128), (4608, 4608, 128), (4480, 4480, 128), (8192, 8192, 256),
    (384, 384, 128), (512, 640, 128), (520, 520, 128), (512, 512, 64),
    (8320, 8320, 128), (1024, 1024, 96),
]


@pytest.mark.parametrize("Lq,Lk,D", GATE_SHAPES, ids=str)
def test_gate_is_the_reference_gate(Lq, Lk, D):
    q = np.zeros((1, 1, Lq, D), np.float32)
    k = np.zeros((1, 1, Lk, D), np.float32)
    assert ti8.i8_attention_ok(torch.from_numpy(q), torch.from_numpy(k)) \
        == ji8.i8_attention_ok(jnp.asarray(q), jnp.asarray(k))


@pytest.mark.parametrize("mode", ["pv", "qk", "1"])
def test_scope_routes_inside_the_gate(mode):
    q, k, v = _qkv(8, 1, 2, 512, 128)
    os.environ["GGUF_TPU_PALLAS_INTERPRET"] = "1"
    try:
        with jattention.attention_i8(mode):
            want = np.asarray(jattention.dot_product_attention(
                *_j(q, k, v)))
    finally:
        del os.environ["GGUF_TPU_PALLAS_INTERPRET"]
    with tattention.attention_i8(mode):
        got = tattention.dot_product_attention(*_t(q, k, v)).numpy()
    exact = _ref(q, k, v, SCALE)
    assert 1e-6 < _rel(got, exact) < 0.035  # int8 noise: the i8 path ran
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    # outside the scope the same call is exact again
    got2 = tattention.dot_product_attention(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got2, exact, rtol=1e-4, atol=1e-5)


def _scope_routes_wide(mode, D, seed):
    """Under the scope both packages take the int8 path at head dim D."""
    q, k, v = _qkv(seed, 1, 1, 512, D)
    scale = D ** -0.5
    assert ti8.i8_attention_ok(*_t(q, k))
    os.environ["GGUF_TPU_PALLAS_INTERPRET"] = "1"
    try:
        with jattention.attention_i8(mode):
            want = np.asarray(jattention.dot_product_attention(
                *_j(q, k, v)))
    finally:
        del os.environ["GGUF_TPU_PALLAS_INTERPRET"]
    with tattention.attention_i8(mode):
        got = tattention.dot_product_attention(*_t(q, k, v)).numpy()
    exact = _ref(q, k, v, scale)
    assert 1e-6 < _rel(got, exact) < 0.035  # int8 noise: the i8 path ran
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("mode", ["pv", "qk"])
def test_scope_routes_head_dim_256(mode):
    """D = 256 is inside the gate (a multiple of 128): under the scope both
    packages take the int8 path there too."""
    _scope_routes_wide(mode, 256, 15)


@pytest.mark.parametrize("mode", ["pv", "qk"])
def test_scope_routes_head_dim_384(mode):
    """So is D = 384, which the kernel runs in its split instance."""
    _scope_routes_wide(mode, 384, 16)


@pytest.mark.parametrize("mode", ["", "0"])
def test_scope_off_modes_and_bad_mode(mode):
    q, k, v = _qkv(9, 1, 2, 512, 128)
    with tattention.attention_i8(mode):
        got = tattention.dot_product_attention(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, _ref(q, k, v, SCALE), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        with tattention.attention_i8("int4"):
            pass


def test_scope_leaves_calls_outside_the_gate_alone():
    """Cross-attention and short sequences keep the default path under the
    scope, in both packages."""
    for shape, Lk in (((1, 2, 128, 128), None), ((1, 2, 512, 128), 640)):
        q, k, v = _qkv(10, *shape, Lk=Lk)
        with jattention.attention_i8("pv"):
            want = np.asarray(jattention.dot_product_attention(*_j(q, k, v)))
        with tattention.attention_i8("pv"):
            got = tattention.dot_product_attention(*_t(q, k, v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_scope_is_read_at_call_time_and_restored():
    q, k, v = _qkv(11, 1, 1, 512, 128)
    fn = tattention.dot_product_attention
    base = fn(*_t(q, k, v))
    with tattention.attention_i8("pv"):
        inside = fn(*_t(q, k, v))
        with tattention.attention_i8(""):
            nested_off = fn(*_t(q, k, v))
    after = fn(*_t(q, k, v))
    assert torch.equal(base, nested_off) and torch.equal(base, after)
    assert not torch.equal(base, inside)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(12, 1, 1, 64, 128))
    with pytest.raises(ValueError, match="CUDA"):
        ti8.i8_attention_cuda(q, k, v, scale=SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.prep_cuda(q, k, v, scale=SCALE)
    ops = ti8.kernel_operands(*ti8.quantize_attn_inputs(q, k, v, SCALE))
    with pytest.raises(ValueError, match="CUDA"):
        ti8.i8_attention_cuda_q(*ops, B=1, H=1)
