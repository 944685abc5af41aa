"""Expert parallelism (``parallel/ep.py``, HiDream's "ep" dispatch) on
gloo ranks against the JAX package's ``ep_moe`` on the virtual CPU mesh
and the dense mask-weighted dispatch.

Tolerances: 1e-5 for the toy experts (the reference's own bound),
``F32`` 3e-4 for a tiny HiDream forward against the reference in float32
(``tests/test_torch_hidream.py``'s planar bound) and 1e-5 against the
port's dense dispatch (one all-reduce of the experts' sums in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu.parallel.ep import ep_moe as jep_moe
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import hidream, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch, tp_spec

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(2, device="cpu") as r:
        yield r


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _jffn(w, x):
    return jnp.tanh(x @ w["w"])


@pytest.mark.parametrize("E", [2, 4])
def test_ep_matches_reference_and_dense(ranks, E):
    """E = 2: one expert a rank; E = 4: two, every one of them runs."""
    rng = np.random.default_rng(E)
    D, T = 16, 10
    w = (rng.standard_normal((E, D, D)) * 0.2).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    thresh = np.sort(logits, axis=-1)[:, -2:-1]
    masked = np.where(logits >= thresh, logits, -np.inf)
    probs = np.exp(masked - masked.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    got = ranks.run(jobs.ep_toy, *map(torch.from_numpy, (w, x, probs)))
    want = np.asarray(jep_moe(_jffn, {"w": jnp.asarray(w)}, jnp.asarray(x),
                              jnp.asarray(probs),
                              Mesh(np.array(jax.devices()[:2]), ("ep",))))
    dense = sum(probs[:, e:e + 1] * np.tanh(x @ w[e]) for e in range(E))
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], dense, rtol=1e-5, atol=1e-5)


def test_ep_rejects_mismatch():
    with pytest.raises(launch.RankError, match="not divisible"):
        launch.run(jobs.ep_toy, 2, torch.zeros(3, 4, 4), torch.zeros(2, 4),
                   torch.zeros(2, 3), device="cpu")


def test_hidream_ep_dispatch_matches_dense_and_reference(ranks):
    """``MOE_DISPATCH = "ep"`` over an ("ep",) mesh: each rank runs its
    half of the stacked experts; the forward equals the dense dispatch
    and the reference's dense forward."""
    from comfyui_gguf_tpu.models import hidream as jhd
    from comfyui_gguf_tpu.models import testing as jtesting
    from comfyui_gguf_tpu.nn.layers import QuantConfig as JQ
    from comfyui_gguf_tpu.parallel import tp_spec as jtp_spec

    kw = dict(hidden=256, heads=2, depth_double=1, depth_single=1, ffn=512,
              n_experts=4, top_k=2, t5_dim=64, llama_dim=96, pooled=48)
    d, jd = testing.TinyHiDreamDims(**kw), jtesting.TinyHiDreamDims(**kw)
    sd = testing.random_flat_sd_from_spec(*testing.hidream_shape_spec(d),
                                          seed=41)
    cfg = d.config()
    groups = [("double_stream_blocks", 1), ("single_stream_blocks", 1)]
    rules = tp_spec.hidream_rules(4)
    flat = tp_spec.quantize_unsharded(sd, block_groups=groups, rules=rules,
                                      qtype=Q.Q8_0)
    stacked = hidream.stack_hidream_params(flat, cfg)
    assert "block.ff_i.experts_stacked" in stacked["double_stream_blocks"]
    rng = np.random.default_rng(42)
    x = (rng.standard_normal((1, 8, 8, d.in_ch)).astype(np.float32),
         rng.standard_normal((1, 6, d.t5_dim)).astype(np.float32),
         rng.standard_normal((1, 5, d.llama_dim)).astype(np.float32),
         rng.standard_normal((1, d.pooled)).astype(np.float32),
         np.full((1,), 0.4, np.float32))
    xt = tuple(map(torch.from_numpy, x))
    got = ranks.run(jobs.hidream_ep, stacked, cfg, xt, F32)
    dense = hidream.forward_stacked(stacked, cfg, *xt, qcfg=F32).numpy()
    assert _rel(got[0], dense) < 1e-5
    jflat = jtp_spec.quantize_unsharded(
        sd, block_groups=groups, rules=jtp_spec.hidream_rules(4),
        qtype=Q.Q8_0)
    want = np.asarray(jhd.forward(jflat, jd.config(),
                                  *map(jnp.asarray, x),
                                  qcfg=JQ(dequant_dtype=jnp.float32,
                                          compute_dtype=jnp.float32,
                                          prefer_pallas=False)))
    assert _rel(got[0], want) < 3e-4
