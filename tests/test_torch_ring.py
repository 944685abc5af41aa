"""Ring attention and ``sequence_parallel`` (``parallel/ring.py``,
``nn/attention.py``) on gloo ranks against the JAX package's ring on the
8-device virtual CPU mesh, from the same seed-made inputs.

Tolerances: float32 1e-5 (the reference's own bound: the same streaming
softmax in f32, einsums in another order), bfloat16 3e-2 (its bf16
bound), logits ×30 1e-4, a Wan block under sequence parallelism 2e-5
against the reference's unsharded block (its own SP bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu.parallel.ring import ring_attention as jring
from comfyui_gguf_tpu_torch.parallel import launch


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(2, device="cpu") as r:
        yield r


def _jmesh(n=2):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _qkv(seed, B, L, H, D, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, L, H, D)) * s).astype(np.float32)
                 for s in (scale, scale, 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_matches_reference(ranks, dtype):
    q, k, v = _qkv(0, 2, 64, 4, 16)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ranks.run(jobs.ring, *(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)))
    want = np.asarray(jring(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            _jmesh()), np.float32)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=tol, atol=tol)


def test_ring_custom_scale(ranks):
    q, k, v = _qkv(1, 1, 32, 2, 8)
    got = ranks.run(jobs.ring, *map(torch.from_numpy, (q, k, v)), 0.5)
    want = np.asarray(jring(*map(jnp.asarray, (q, k, v)), _jmesh(),
                            scale=0.5))
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


def test_ring_rejects_indivisible():
    q = torch.zeros(1, 31, 2, 8)
    with pytest.raises(launch.RankError, match="not divisible"):
        launch.run(jobs.ring, 2, q, q, q, device="cpu")


def test_ring_extreme_logits_stable(ranks):
    q, k, v = _qkv(2, 1, 64, 2, 16, scale=30.0)
    got = ranks.run(jobs.ring, *map(torch.from_numpy, (q, k, v)))
    want = np.asarray(jring(*map(jnp.asarray, (q, k, v)), _jmesh()))
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)


def test_sequence_parallel_context_routes_dispatcher(ranks):
    """Inside ``sequence_parallel`` the ordinary dispatcher computes the
    exact attention of the split sequence (the ring), as the reference's
    does inside its shard_map."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
               for _ in range(3))
    got = ranks.run(jobs.sp_attention, *map(torch.from_numpy, (q, k, v)))
    want = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))))
    np.testing.assert_allclose(got[0], want.transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)


def test_wan_block_under_sp(ranks):
    """A Wan block runs unmodified under ``sequence_parallel``: the
    self-attention rings over the split 192 tokens, the cross-attention to
    replicated text runs locally; against the reference's unsharded
    block."""
    from comfyui_gguf_tpu.models import testing as jtesting
    from comfyui_gguf_tpu.models import wan as jwan
    from comfyui_gguf_tpu.models.flux import block_subtree as jsub
    from comfyui_gguf_tpu.nn.layers import QuantConfig as JQ
    from comfyui_gguf_tpu_torch.models import testing, wan
    from comfyui_gguf_tpu_torch.models.flux import block_subtree
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

    d = testing.WanDims()
    sd = testing.random_flat_sd_from_spec(*testing.wan_shape_spec(d), seed=9)
    cfg = d.config()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 192, d.dim)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, d.dim)).astype(np.float32)
    e0 = (rng.standard_normal((1, 6 * d.dim)) * 0.1).astype(np.float32)
    pe = wan.rope_3d(3, 8, 8, cfg.axes_dim)
    bp = block_subtree({k: torch.from_numpy(v) for k, v in sd.items()},
                       "blocks.0.")
    f32 = QuantConfig(dequant_dtype=torch.float32,
                      compute_dtype=torch.float32)
    got = ranks.run(jobs.sp_block, bp, cfg, torch.from_numpy(x),
                    torch.from_numpy(e0), torch.from_numpy(ctx), pe, f32)
    jcfg = jtesting.WanDims().config()
    jbp = jsub({k: jnp.asarray(v) for k, v in sd.items()}, "blocks.0.")
    want = np.asarray(jwan._block(
        jbp, jnp.asarray(x), jnp.asarray(e0), jnp.asarray(ctx),
        jwan.rope_3d(3, 8, 8, jcfg.axes_dim), jcfg,
        JQ(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
           prefer_pallas=False)), np.float32)
    np.testing.assert_allclose(got[0], want, rtol=2e-5, atol=2e-5)
