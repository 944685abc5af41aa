"""The port's HunyuanVideo DiT (``models/hyvid.py``) and ``hyvid_engine``
against the reference, on the CPU; mirrors ``tests/test_hyvid.py``.

A tiny HunyuanVideo (hidden 512: four heads of 128, the published head
dim; 2 double and 2 single blocks, 2 token-refiner blocks, text width 512,
16 latent channels) is written as a Q4_K GGUF by the port's writer,
quantized the way a published file is (the patch embed stored 4-D with its
5-D shape in ``comfy.gguf.orig_shape`` metadata; the refiner, the time,
guidance and input embedders and the final layer float), and loaded by both
packages. Checked: config detection and the restored 5-D kernel; the RoPE
axes; ``forward`` in float32 and bfloat16, with and without the guidance
embed, and ``forward_stacked`` (the port's stacking, and the reference's
stacked tree carried across with ``interop.params_from_numpy``); the w8a8
tree (the single block's q|k|v boundary read from the int8 weights'
logical sizes); the engine against the reference's engine and against the
direct sampler, flat and stacked.

Tolerances (relative L2): 1e-4 with float32 compute (the sums run in
another order); 1e-3 with float32 compute and the guidance embed at the
pipelines' guidance 6.0 (``GUIDED_TOL``: the embedded guidance is 6000 and
``timestep_embedding`` scales it by 1000 again, so its angles reach 6e6
rad, where one float32 ulp is 0.5 rad, and the two packages' exp and cos
round them apart; measured 4.8e-4, ROADMAP queue 3); 2e-2 with bfloat16
compute (bf16 rounding points differ between the packages, the flux parity
tests' limit); 3e-4 for the w8a8 tree in float32 (ROADMAP queue 3: an
activation code may land on the other side of a rounding boundary), 2e-3
with the guidance embed on top (measured 9.7e-4); 1.5e-2 for a served
request against the reference's engine (bf16 latents between steps); 1e-2
for a served request against the direct sampler in the port.
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
from comfyui_gguf_tpu.models import hyvid as jhyvid
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import hyvid, testing
from comfyui_gguf_tpu_torch.nn.layers import (QuantConfig, in_features,
                                              out_features)
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.HyVidDims(hidden=512, n_heads=4, depth_double=2,
                         depth_single=2, refiner_depth=2, in_ch=16,
                         text_dim=512)
B, FR, H_LAT, TXT_LEN = 1, 3, 8, 11
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 3e-4
GUIDED_TOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    sd = testing.random_flat_sd_from_spec(*testing.hyvid_shape_spec(DIMS),
                                          seed=0)
    p = str(tmp_path_factory.mktemp("hyvid") / "hyvid_Q4_K.gguf")
    testing.write_spec_gguf(sd, p, "hyvid", Q.Q4_K)
    return p


def _trees(path):
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    model = tpipeline.load_diffusion_model(path, device="cpu")
    return jp, model


def _inputs(np_dtype, seed=5, guidance=6.0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, FR, H_LAT, H_LAT, DIMS.in_ch))
    txt = rng.standard_normal((B, TXT_LEN, DIMS.text_dim))
    t = np.asarray([0.6], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, np_dtype) for a in (lat, txt)] + [jnp.asarray(t)]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (lat, txt)] + [torch.from_numpy(t)]
    if guidance is not None:
        g = np.asarray([guidance * 1000.0], np.float32)
        jx.append(jnp.asarray(g))
        tx.append(torch.from_numpy(g))
    return jx, tx


def test_config_and_published_quantization(path):
    jp, model = _trees(path)
    assert model.arch == "hyvid" and not model.is_stacked
    jc = dataclasses.asdict(jhyvid.HyVidConfig.from_state_dict(jp))
    tc = dataclasses.asdict(model.config)
    assert tc == {k: jc[k] for k in tc}
    assert model.config == DIMS.config()
    assert model.config.guidance_embed
    assert model.config.axes_dim == jhyvid.HyVidConfig(
        hidden=512, n_heads=4, depth_double=2, depth_single=2).axes_dim \
        == (16, 56, 56)
    p = model.params
    # the 5-D kernel comes back from its orig_shape metadata
    assert tuple(p["img_in.proj.weight"].shape) == (512, 16, 1, 2, 2)
    for k in ("double_blocks.0.img_attn_qkv.weight",
              "double_blocks.1.txt_mlp.fc2.weight",
              "double_blocks.0.img_mod.linear.weight",
              "single_blocks.1.linear1.weight",
              "single_blocks.0.linear2.weight"):
        assert isinstance(p[k], PlanarQuant), k
    for k in ("txt_in.individual_token_refiner.blocks.1.mlp.fc1.weight",
              "time_in.in_layer.weight", "guidance_in.out_layer.weight",
              "final_layer.linear.weight"):
        assert isinstance(p[k], torch.Tensor), k


def test_rope_axes_match_reference():
    for hd in (64, 128, 96):
        cfg = hyvid.HyVidConfig(hidden=4 * hd, n_heads=4, depth_double=1,
                                depth_single=1)
        jcfg = jhyvid.HyVidConfig(hidden=4 * hd, n_heads=4, depth_double=1,
                                  depth_single=1)
        assert cfg.axes_dim == jcfg.axes_dim and sum(cfg.axes_dim) == hd
    over = hyvid.HyVidConfig(hidden=512, n_heads=2, depth_double=1,
                             depth_single=1, head_dim_override=128)
    assert over.head_dim == 128 and over.axes_dim == (16, 56, 56)


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
def test_forward_and_stacked_match_reference(path, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(path)
    jcfg = jhyvid.HyVidConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jhyvid.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = hyvid.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, FR, H_LAT, H_LAT, DIMS.in_ch)
    assert _rel(got.float(), want) < max(tol, GUIDED_TOL)
    sp = hyvid.stack_hyvid_params(model.params, model.config)
    assert torch.equal(hyvid.forward_stacked(sp, model.config, *tx,
                                             qcfg=qcfg), got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray, jhyvid.stack_hyvid_params(jp, jcfg))
        got_c = hyvid.forward_stacked(params_from_numpy(jsp, "cpu"),
                                      model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < GUIDED_TOL


def test_forward_without_guidance_matches_reference(path):
    """guidance None skips the guidance embed in both packages."""
    qcfg, jqcfg, np_dtype, tol = F32
    jp, model = _trees(path)
    jx, tx = _inputs(np_dtype, seed=9, guidance=None)
    want = np.asarray(jhyvid.forward(
        jp, jhyvid.HyVidConfig.from_state_dict(jp), *jx, qcfg=jqcfg))
    got = hyvid.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < tol
    _, tx_g = _inputs(np_dtype, seed=9)
    assert _rel(hyvid.forward(model.params, model.config, *tx_g,
                              qcfg=qcfg), want) > 1e-3


@pytest.mark.parametrize("guidance,tol", [(None, W8A8_TOL), (6.0, 2e-3)],
                         ids=["unguided", "guided"])
def test_w8a8_forward_matches_reference(path, guidance, tol):
    """requantize_i8 on the port, convert_tree_i8 with the reference's
    ``is_modulation_key`` predicate on the reference: the block linears
    convert, img_mod / txt_mod / modulation stay planar; the single
    block's boundary reads the int8 weights' logical sizes."""
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    qcfg, jqcfg, np_dtype, _ = F32
    jp, model = _trees(path)
    jcfg = jhyvid.HyVidConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6, guidance=guidance)
    want = np.asarray(jhyvid.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    model.requantize_i8()
    p = model.params
    l1 = p["single_blocks.0.linear1.weight"]
    assert isinstance(l1, I8Planar)
    H, M = DIMS.hidden, DIMS.mlp
    assert (out_features(l1), in_features(l1)) == (3 * H + M, H)
    assert in_features(p["single_blocks.0.linear2.weight"]) == H + M
    for k in ("double_blocks.0.img_mod.linear.weight",
              "double_blocks.0.txt_mod.linear.weight",
              "single_blocks.0.modulation.linear.weight"):
        assert isinstance(p[k], PlanarQuant), k
    got = hyvid.forward(p, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < tol
    sm = model.stack()
    assert torch.equal(hyvid.forward_stacked(sm.params, sm.config, *tx,
                                             qcfg=qcfg), got)



@pytest.mark.parametrize("tree", ["planar", "w8a8"])
def test_interop_carries_the_flat_tree(path, tree):
    """``interop.params_from_numpy`` of the reference's flat tree (its
    planar leaves, or its int8 leaves, transposed once) is the port's own
    tree: every leaf equal to the one the port loads (and converts), so
    the forwards are equal bit for bit."""
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    qcfg, _, np_dtype, _ = F32
    jp, model = _trees(path)
    if tree == "w8a8":
        jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
        model.requantize_i8()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == set(model.params)
    for k, v in tp.items():
        w = model.params[k]
        assert type(v) is type(w), k
        for f in ("qs", "scales", "offsets"):
            if hasattr(v, f) and getattr(v, f) is not None:
                assert torch.equal(getattr(v, f), getattr(w, f)), k
        if isinstance(v, torch.Tensor):
            assert torch.equal(v.to(w.dtype), w), k
    _, tx = _inputs(np_dtype, seed=7)
    assert torch.equal(hyvid.forward(tp, model.config, *tx, qcfg=qcfg),
                       hyvid.forward(model.params, model.config, *tx,
                                     qcfg=qcfg))

def _requests():
    reqs = []
    for seed, g, n in ((10, 6.0, 3), (11, 1.0, 4)):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((FR, H_LAT, H_LAT, DIMS.in_ch))
                     .astype(np.float32),
                     {"txt": r.standard_normal((TXT_LEN, DIMS.text_dim))
                      .astype(np.float32),
                      "guidance": np.float32(g)},
                     linear_schedule(n)))
    return reqs


def _serve(mk, model, reqs):
    eng = mk(model, max_batch=2)
    hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(h.finished and h.error is None for h in hs)
    return [np.asarray(h.result, np.float32) for h in hs]


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_engine_matches_reference_and_direct(path, stacked):
    """Two pooled requests at embedded guidance 6.0 and 1.0 (different
    lengths): the port's engine against the reference's engine on the same
    tree, and each request against the port's direct sampler at batch 1."""
    jp, model = _trees(path)
    jmodel = jpipeline.DiffusionModel(
        arch="hyvid", params=jp,
        config=jhyvid.HyVidConfig.from_state_dict(jp), qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    reqs = _requests()
    got = _serve(tpipeline.hyvid_engine, model, reqs)
    want = _serve(jpipeline.hyvid_engine, jmodel, reqs)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (FR, H_LAT, H_LAT, DIMS.in_ch)
        assert np.isfinite(g).all()
        assert _rel(g, w) < 1.5e-2
        gd = torch.full((1,), float(c["guidance"]) * 1000.0)
        txt = torch.as_tensor(c["txt"])[None].to(torch.bfloat16)

        def vel(xc, s, txt=txt, gd=gd):
            return model.forward(xc, txt, s.to(torch.float32).expand(1), gd)

        x0 = torch.as_tensor(x)[None].to(torch.bfloat16)
        with torch.no_grad():
            direct = sample_flow(vel, x0, sig, sampler="euler")
        assert _rel(g, direct[0].float()) < 1e-2


def test_engine_refuses_meshes(path):
    _, model = _trees(path)
    for kw in ({"mesh": object()}, {"dp_mesh": object()}):
        with pytest.raises(ValueError, match="axis"):
            tpipeline.hyvid_engine(model, **kw)


def test_seed_made_stacked_tree():
    """``hyvid_random_stacked_params``: the stacked layout forward_stacked
    reads, packed block linears, the no-quant keys dense; a forward of it is
    finite."""
    dims = dataclasses.replace(DIMS, depth_double=1, depth_single=1)
    p = testing.hyvid_random_stacked_params(dims, seed=3, device="cpu")
    assert isinstance(p["double_blocks"]["img_attn_qkv.weight"], PlanarQuant)
    assert p["single_blocks"]["linear1.weight"].qs.shape[0] == 1
    assert isinstance(p["txt_in.input_embedder.weight"], torch.Tensor)
    _, tx = _inputs(np.float32)
    out = hyvid.forward_stacked(p, dims.config(), *tx)
    assert out.shape == (B, FR, H_LAT, H_LAT, DIMS.in_ch)
    assert torch.isfinite(out).all()
