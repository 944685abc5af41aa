"""The port's Cosmos Predict2 DiT (``models/cosmos.py``) and
``cosmos_engine`` against the reference, on the CPU; mirrors the cosmos
cases of ``tests/test_cosmos_qwen.py``.

A tiny Cosmos (dim 512: four heads of 128, the published head dim; 2
blocks, MLP 2048, text width 512, 16 latent channels; the loader keeps a
linear with K < 1024 float unless K is a multiple of 512) is written as a
Q4_K GGUF by the port's writer, quantized the way a published file is (the
embedders, ``t_embedding_norm`` and the final layer float), and loaded by
both packages. Checked: config detection; ``forward`` in float32 and
bfloat16 over a video latent (3 frames) and ``forward_stacked`` (the port's
stacking, and the reference's stacked tree carried across with
``interop.params_from_numpy``); the w8a8 tree, whose
``adaln_modulation_*`` keys stay planar (modulation keys: the split-K body
at M = batch on the card); the engine against the reference's engine and
against the direct sampler, flat and stacked.

Tolerances (relative L2): 1e-4 with float32 compute (the sums run in
another order); 2e-2 with bfloat16 compute (bf16 rounding points differ
between the packages, the flux parity tests' limit); 3e-4 for the w8a8
tree's linear calls in float32 (``W8A8_TOL``, ROADMAP queue 3: an
activation code may land on the other side of a rounding boundary), 2e-2
for its whole forward (``W8A8_FWD_TOL``: those flips compound from block to
block, see the test); 1.5e-2 · max(1, cfg) for
CFG latents against the reference; 1e-2 for a served request against the
direct sampler in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import cosmos as jcos
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import cosmos, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.CosmosDims(dim=512, n_heads=4, n_layers=2, in_ch=16,
                          text_dim=512)
B, FR, H_LAT, CTX_LEN = 1, 3, 8, 9
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 3e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg_tol(cfg):
    return 1.5e-2 * max(1.0, cfg)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    sd = testing.random_flat_sd_from_spec(*testing.cosmos_shape_spec(DIMS),
                                          seed=0)
    p = str(tmp_path_factory.mktemp("cosmos") / "cosmos_Q4_K.gguf")
    testing.write_spec_gguf(sd, p, "cosmos", Q.Q4_K)
    return p


def _trees(path):
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    model = tpipeline.load_diffusion_model(path, device="cpu")
    return jp, model


def _inputs(np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, FR, H_LAT, H_LAT, DIMS.in_ch))
    ctx = rng.standard_normal((B, CTX_LEN, DIMS.text_dim))
    t = np.asarray([0.7], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, np_dtype) for a in (lat, ctx)] + [jnp.asarray(t)]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (lat, ctx)] + [torch.from_numpy(t)]
    return jx, tx


def test_config_and_published_quantization(path):
    jp, model = _trees(path)
    assert model.arch == "cosmos" and not model.is_stacked
    jc = dataclasses.asdict(jcos.CosmosConfig.from_state_dict(jp))
    tc = dataclasses.asdict(model.config)
    assert tc == {k: jc[k] for k in tc}
    assert model.config == DIMS.config()
    p = model.params
    for k in ("blocks.0.self_attn.q_proj.weight",
              "blocks.1.cross_attn.k_proj.weight", "blocks.0.mlp.layer2.weight",
              "blocks.0.adaln_modulation_mlp.1.weight"):
        assert isinstance(p[k], PlanarQuant), k
    for k in ("x_embedder.proj.1.weight", "t_embedder.1.linear_2.weight",
              "t_embedding_norm.weight", "final_layer.linear.weight"):
        assert isinstance(p[k], torch.Tensor), k


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
def test_forward_and_stacked_match_reference(path, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(path)
    jcfg = jcos.CosmosConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jcos.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = cosmos.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, FR, H_LAT, H_LAT, DIMS.in_ch)
    assert _rel(got.float(), want) < tol
    sp = cosmos.stack_cosmos_params(model.params, model.config)
    assert torch.equal(cosmos.forward_stacked(sp, model.config, *tx, qcfg=qcfg),
                       got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray, jcos.stack_cosmos_params(jp, jcfg))
        got_c = cosmos.forward_stacked(params_from_numpy(jsp, "cpu"),
                                    model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < tol


W8A8_FWD_TOL = 2e-2


def test_w8a8_forward_matches_reference(path, monkeypatch):
    """requantize_i8 on the port, convert_tree_i8 with the reference's
    ``is_modulation_key`` predicate on the reference: the block linears
    convert, the adaLN modulations stay planar.

    Each linear call of the port, fed the reference's input of that call,
    gives the reference's output within ``W8A8_TOL``. A whole forward
    compounds the activations' int8 rounding flips: the time embedding's
    dense f32 sums differ in the last bits between the packages (2e-6),
    and every w8a8 linear after it rounds some codes the other way (4e-3
    a block here, 7.9e-3 after two), so the forward holds
    ``W8A8_FWD_TOL``; a conversion that also makes the adaLN modulations
    int8, or one that skips the activations' rounding, reads 1.4e-2 and
    9.1e-3 there, which is why the per-call check is the gate."""
    import comfyui_gguf_tpu.models.cosmos as jmod
    import comfyui_gguf_tpu_torch.models.cosmos as tmod
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    qcfg, jqcfg, np_dtype, _ = F32
    jp, model = _trees(path)
    jcfg = jcos.CosmosConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6)
    calls = []
    jlin = jmod.linear

    def jrecord(x, w, b=None, cfg=None):
        y = jlin(x, w, b, cfg=cfg)
        calls.append((np.asarray(x, np.float32), np.asarray(y, np.float32)))
        return y

    monkeypatch.setattr(jmod, "linear", jrecord)
    want = np.asarray(jcos.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    model.requantize_i8()
    p = model.params
    assert isinstance(p["blocks.0.self_attn.q_proj.weight"], I8Planar)
    assert isinstance(p["blocks.0.adaln_modulation_self_attn.1.weight"],
                      PlanarQuant)
    tlin = tmod.linear
    errs = []

    def treplay(x, w, b=None, cfg=None):
        jx_, jy = calls[len(errs)]
        y = tlin(torch.from_numpy(np.array(jx_)), w, b, cfg=cfg)
        errs.append(_rel(y, jy))
        return tlin(x, w, b, cfg=cfg)

    monkeypatch.setattr(tmod, "linear", treplay)
    got = cosmos.forward(p, model.config, *tx, qcfg=qcfg)
    assert len(errs) == len(calls) and max(errs) < W8A8_TOL
    assert _rel(got, want) < W8A8_FWD_TOL
    monkeypatch.setattr(tmod, "linear", tlin)
    sm = model.stack()
    assert torch.equal(cosmos.forward_stacked(sm.params, sm.config, *tx,
                                              qcfg=qcfg),
                       cosmos.forward(p, model.config, *tx, qcfg=qcfg))


def _requests(seeds_scales, sig_steps=(3, 3)):
    reqs = []
    for (seed, scale), n in zip(seeds_scales, sig_steps):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((FR, H_LAT, H_LAT, DIMS.in_ch))
                     .astype(np.float32),
                     {"ctx": r.standard_normal((CTX_LEN, DIMS.text_dim))
                      .astype(np.float32),
                      "nctx": r.standard_normal((CTX_LEN, DIMS.text_dim))
                      .astype(np.float32),
                      "cfg_scale": np.float32(scale)},
                     linear_schedule(n)))
    return reqs


def _serve(mk, model, reqs, sampler="euler"):
    eng = mk(model, max_batch=2, sampler=sampler)
    hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(h.finished and h.error is None for h in hs)
    return [np.asarray(h.result, np.float32) for h in hs]


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_engine_matches_reference_and_direct(path, stacked):
    """Two pooled requests at CFG 4.0 and 1.0 (different lengths): the
    port's engine against the reference's engine on the same tree, and each
    request against the port's direct sampler at batch 1."""
    jp, model = _trees(path)
    jmodel = jpipeline.DiffusionModel(
        arch="cosmos", params=jp, config=jcos.CosmosConfig.from_state_dict(jp),
        qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    reqs = _requests([(10, 4.0), (11, 1.0)], (3, 4))
    got = _serve(tpipeline.cosmos_engine, model, reqs)
    want = _serve(jpipeline.cosmos_engine, jmodel, reqs)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (FR, H_LAT, H_LAT, DIMS.in_ch)
        assert np.isfinite(g).all()
        assert _rel(g, w) < _cfg_tol(float(c["cfg_scale"]))

        def vel(xc, s, c=c):
            t = s.to(torch.float32).expand(1)
            v_c = model.forward(xc, torch.as_tensor(c["ctx"])[None].to(
                torch.bfloat16), t)
            v_u = model.forward(xc, torch.as_tensor(c["nctx"])[None].to(
                torch.bfloat16), t)
            return v_u.float() + float(c["cfg_scale"]) * (v_c.float()
                                                          - v_u.float())

        x0 = torch.as_tensor(x)[None].to(torch.bfloat16)
        with torch.no_grad():
            direct = sample_flow(vel, x0, sig, sampler="euler")
        assert _rel(g, direct[0].float()) < 1e-2


def test_engine_refuses_dp_mesh(path):
    _, model = _trees(path)
    with pytest.raises(ValueError, match="axis"):
        tpipeline.cosmos_engine(model, dp_mesh=object())


def test_seed_made_stacked_tree():
    """``cosmos_random_stacked_params``: the stacked layout forward_stacked
    reads, packed block linears, the no-quant keys dense; a forward of it is
    finite."""
    dims = dataclasses.replace(DIMS, n_layers=1)
    p = testing.cosmos_random_stacked_params(dims, seed=3, device="cpu")
    assert isinstance(p["blocks"]["self_attn.q_proj.weight"], PlanarQuant)
    assert p["blocks"]["self_attn.q_proj.weight"].qs.shape[0] == 1
    assert isinstance(p["t_embedder.1.linear_1.weight"], torch.Tensor)
    _, tx = _inputs(np.float32)
    out = cosmos.forward_stacked(p, dims.config(), *tx)
    assert out.shape == (B, FR, H_LAT, H_LAT, DIMS.in_ch)
    assert torch.isfinite(out).all()
