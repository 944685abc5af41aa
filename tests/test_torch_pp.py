"""Pipeline parallelism (``parallel/pp.py``) on gloo ranks against the
JAX package's ``pp`` on the virtual CPU mesh (two stages), from the same
seed-made inputs and codec blocks.

Tolerances: the toy trunk 1e-5 and the real trunks 1e-4 (the reference's
own bounds against its sequential scan; float32 sums in another order).
The ranks' results are bit-equal (the last stage's, made replicated).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.parallel import pp as jpp
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import flux, qwen_image, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch
from comfyui_gguf_tpu_torch.quant import codecs, planar

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(2, device="cpu") as r:
        yield r


def _jmesh():
    return Mesh(np.array(jax.devices()[:2]), ("pp",))


def _jblock(w, x):
    return x + jnp.tanh(x @ w)


@pytest.mark.parametrize("B,n_micro", [(8, 4), (2, 1)])
def test_pp_matches_reference(ranks, B, n_micro):
    rng = np.random.default_rng(B)
    ws = (rng.standard_normal((2, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, 6, 16)).astype(np.float32)
    got = ranks.run(jobs.pp_toy, torch.from_numpy(ws), torch.from_numpy(x),
                    n_micro)
    want = np.asarray(jpp.pp_trunk(_jblock, jnp.asarray(ws), jnp.asarray(x),
                                   _jmesh(), n_micro=n_micro))
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


def test_pp_rejects_indivisible():
    with pytest.raises(launch.RankError, match="not divisible"):
        launch.run(jobs.pp_toy, 2, torch.zeros(2, 4, 4), torch.zeros(5, 4),
                   2, device="cpu")


def _both_planar(sd, is_packed):
    """The same codec blocks planarized by each package."""
    port, ref = {}, {}
    for k, v in sd.items():
        if is_packed(k, v):
            b = codecs.quantize(np.asarray(v, np.float32), Q.Q8_0)
            port[k] = planar.planarize(b, Q.Q8_0, v.shape)
            ref[k] = jplanar.planarize(b, Q.Q8_0, v.shape)
        else:
            port[k] = torch.from_numpy(np.asarray(v, np.float32))
            ref[k] = jnp.asarray(v, jnp.float32)
    return port, ref


def test_pp_flux_single_trunk_matches_reference(ranks):
    from comfyui_gguf_tpu.models import flux as jflux
    from comfyui_gguf_tpu.models import testing as jtesting

    dims = testing.TinyFluxDims(depth_double=0, depth_single=4)
    sd = testing.flux_state_dict(dims, seed=5)
    port, ref = _both_planar(sd, lambda k, v: k.startswith("single_blocks")
                             and v.ndim == 2)
    cfg = dims.config()
    sp = flux.stack_flux_params(port, cfg)
    jsp = jflux.stack_flux_params(ref, jtesting.TinyFluxDims(
        depth_double=0, depth_single=4).config())
    rng = np.random.default_rng(6)
    B, L = 4, 16
    x = rng.standard_normal((B, L, dims.hidden)).astype(np.float32)
    vec = rng.standard_normal((B, dims.hidden)).astype(np.float32)
    pe = rng.standard_normal((B, L, sum(dims.axes_dim) // 2, 2)).astype(
        np.float32)
    got = ranks.run(jobs.pp, "flux", sp["single_blocks"],
                    tuple(map(torch.from_numpy, (x, vec, pe))), cfg, F32, 2)
    want = np.asarray(jpp.pp_flux_single_trunk(
        jsp["single_blocks"], *map(jnp.asarray, (x, vec, pe)), cfg, JF32,
        _jmesh(), n_micro=2))
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)


def test_pp_qwen_image_trunk_matches_reference(ranks):
    from comfyui_gguf_tpu.models import flux as jflux
    from comfyui_gguf_tpu.models import qwen_image as jqi

    d = testing.QwenImageDims(n_layers=4)
    sd = testing.random_flat_sd_from_spec(*testing.qwen_image_shape_spec(d),
                                          seed=8)
    cfg = d.config()
    port = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    sp = qwen_image.stack_qwen_params(port, cfg)
    jsp = jqi.stack_qwen_params({k: jnp.asarray(v) for k, v in sd.items()},
                                cfg)
    rng = np.random.default_rng(9)
    B, Li, Lt = 4, 12, 4
    img = (rng.standard_normal((B, Li, d.hidden)) * 0.3).astype(np.float32)
    txt = (rng.standard_normal((B, Lt, d.hidden)) * 0.3).astype(np.float32)
    vec = (rng.standard_normal((B, d.hidden)) * 0.3).astype(np.float32)
    ids = np.zeros((B, Lt + Li, 3), np.int32)
    ids[:, Lt:, 1] = 1
    pe = flux.rope_freqs(torch.from_numpy(ids), cfg.axes_dim, cfg.theta)
    jpe = jflux.rope_freqs(jnp.asarray(ids), cfg.axes_dim, cfg.theta)
    got = ranks.run(jobs.pp, "qwen_image", sp["transformer_blocks"],
                    (*map(torch.from_numpy, (img, txt, vec)), pe), cfg, F32,
                    2)
    wi, wt = jpp.pp_qwen_image_trunk(
        jsp["transformer_blocks"], *map(jnp.asarray, (img, txt, vec)), jpe,
        cfg, JF32, _jmesh(), n_micro=2)
    np.testing.assert_allclose(got[0][0], np.asarray(wi), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[0][1], np.asarray(wt), rtol=1e-4,
                               atol=1e-4)
