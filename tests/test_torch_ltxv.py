"""The port's LTX-Video DiT (``models/ltxv.py``) and ``ltxv_engine``
against the reference, on the CPU; mirrors ``tests/test_ltxv.py``.

A tiny LTX-Video (dim 512: eight heads of 64, the published head dim; 2
blocks, 128-channel voxels, caption width 512) is written as a Q4_K GGUF by
the port's writer, quantized the way a published file is (the block
linears packed; ``adaln_single``, ``caption_projection``,
``patchify_proj``, ``proj_out`` and the ``scale_shift_table``s float), and
loaded by both packages. Checked: config detection; ``forward`` in float32
and bfloat16 and ``forward_stacked`` (the port's stacking, and the
reference's stacked tree carried across with ``interop.params_from_numpy``)
with per-head qk-norm weights; the across-heads qk-norm (weights of length
dim, the published layout) on a dense tree; the w8a8 tree; the engine
against the reference's engine and against the direct sampler, flat and
stacked, with per-request positions and CFG scales.

Tolerances (relative L2): 1e-4 with float32 compute (the sums run in
another order); 2e-2 with bfloat16 compute (bf16 rounding points differ
between the packages, the flux parity tests' limit); 3e-4 for the w8a8
tree in float32 (ROADMAP queue 3: an activation code may land on the other
side of a rounding boundary); 1.5e-2 · max(1, cfg) for a served request
against the reference's engine; 1e-2 for a served request against the
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
from comfyui_gguf_tpu.models import ltxv as jltxv
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import ltxv, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.LTXVDims(dim=512, n_layers=2, in_ch=128, caption_dim=512)
B, L, CTX_LEN = 2, 24, 9
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 3e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    sd = testing.random_flat_sd_from_spec(*testing.ltxv_shape_spec(DIMS),
                                          seed=0)
    p = str(tmp_path_factory.mktemp("ltxv") / "ltxv_Q4_K.gguf")
    testing.write_spec_gguf(sd, p, "ltxv", Q.Q4_K)
    return p


def _trees(path):
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    model = tpipeline.load_diffusion_model(path, device="cpu")
    return jp, model


def _inputs(np_dtype, seed=5, dims=DIMS):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((B, L, dims.in_ch))
    ids = rng.integers(0, 8, (B, L, 3)).astype(np.int32)
    ctx = rng.standard_normal((B, CTX_LEN, dims.caption_dim))
    t = np.asarray([0.9, 0.3], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(tok, np_dtype), jnp.asarray(ids),
          jnp.asarray(ctx, np_dtype), jnp.asarray(t)]
    tx = [torch.as_tensor(tok.astype(np.float32)).to(tdt),
          torch.from_numpy(ids),
          torch.as_tensor(ctx.astype(np.float32)).to(tdt),
          torch.from_numpy(t)]
    return jx, tx


def test_config_and_published_quantization(path):
    jp, model = _trees(path)
    assert model.arch == "ltxv" and not model.is_stacked
    jc = dataclasses.asdict(jltxv.LTXVConfig.from_state_dict(jp))
    assert dataclasses.asdict(model.config) == jc
    assert model.config == DIMS.config()
    assert model.config.n_heads == 8 and model.config.axes_dim == (24, 20, 20)
    p = model.params
    for k in ("transformer_blocks.0.attn1.to_q.weight",
              "transformer_blocks.1.attn2.to_out.0.weight",
              "transformer_blocks.0.ff.net.2.weight"):
        assert isinstance(p[k], PlanarQuant), k
    for k in ("adaln_single.linear.weight", "caption_projection.linear_1."
              "weight", "patchify_proj.weight", "proj_out.weight",
              "scale_shift_table", "transformer_blocks.1.scale_shift_table"):
        assert isinstance(p[k], torch.Tensor), k
    assert p["scale_shift_table"].dtype == torch.float32


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
def test_forward_and_stacked_match_reference(path, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(path)
    jcfg = jltxv.LTXVConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jltxv.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = ltxv.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, L, DIMS.in_ch)
    assert _rel(got.float(), want) < tol
    sp = ltxv.stack_ltxv_params(model.params, model.config)
    assert torch.equal(ltxv.forward_stacked(sp, model.config, *tx,
                                            qcfg=qcfg), got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray, jltxv.stack_ltxv_params(jp, jcfg))
        got_c = ltxv.forward_stacked(params_from_numpy(jsp, "cpu"),
                                     model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < tol


@pytest.mark.parametrize("norm_len", [128, 64], ids=["across", "per_head"])
def test_qk_norm_layouts_match_reference(norm_len):
    """A weight of length dim normalizes across heads before the split (the
    published layout), one of length head_dim per head after it; a dense
    float32 tree in both packages. The two layouts give different
    results."""
    dims = testing.LTXVDims(dim=128, n_layers=1, in_ch=32, caption_dim=64)
    nonblock, groups = testing.ltxv_shape_spec(dims)
    depth, block = groups["transformer_blocks"]
    for a in ("attn1", "attn2"):
        block[f"{a}.q_norm.weight"] = block[f"{a}.k_norm.weight"] = (
            norm_len,)
    sd = testing.random_flat_sd_from_spec(nonblock, groups, seed=3)
    cfg = ltxv.LTXVConfig.from_state_dict(sd)
    jx, tx = _inputs(np.float32, seed=4, dims=dims)
    qcfg, jqcfg = F32[0], F32[1]
    want = np.asarray(jltxv.forward({k: jnp.asarray(v) for k, v in
                                     sd.items()},
                                    jltxv.LTXVConfig.from_state_dict(sd),
                                    *jx, qcfg=jqcfg))
    tp = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = ltxv.forward(tp, cfg, *tx, qcfg=qcfg)
    assert _rel(got, want) < 1e-4
    # one attention alone, against the same gains read the other way: the
    # two layouts normalize over other spans
    pre = "transformer_blocks.0."
    blk = {k[len(pre):]: v for k, v in tp.items() if k.startswith(pre)}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 16, 128)).astype(np.float32))
    a = ltxv._attention(blk, "attn1", x, x, 2, qcfg)
    ja = jltxv._attention({k: jnp.asarray(v.numpy()) for k, v in
                           blk.items()}, "attn1", jnp.asarray(x.numpy()),
                          jnp.asarray(x.numpy()), 2, jqcfg)
    assert _rel(a, np.asarray(ja)) < 1e-4
    other = 64 if norm_len == 128 else 128
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        128).astype(np.float32))
    blk2 = dict(blk, **{f"attn1.{n}.weight": 1 + g[:other] for n in
                        ("q_norm", "k_norm")})
    blk = dict(blk, **{f"attn1.{n}.weight": 1 + g[:norm_len] for n in
                       ("q_norm", "k_norm")})
    assert _rel(ltxv._attention(blk2, "attn1", x, x, 2, qcfg),
                ltxv._attention(blk, "attn1", x, x, 2, qcfg)) > 1e-2


def test_w8a8_forward_matches_reference(path):
    """requantize_i8 on the port, convert_tree_i8 with the reference's
    ``is_modulation_key`` predicate on the reference: the block linears
    convert; the float adaLN and projections stay as they are."""
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    qcfg, jqcfg, np_dtype, _ = F32
    jp, model = _trees(path)
    jcfg = jltxv.LTXVConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6)
    want = np.asarray(jltxv.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    model.requantize_i8()
    p = model.params
    assert isinstance(p["transformer_blocks.0.attn2.to_k.weight"], I8Planar)
    assert isinstance(p["adaln_single.linear.weight"], torch.Tensor)
    got = ltxv.forward(p, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < W8A8_TOL
    sm = model.stack()
    assert torch.equal(ltxv.forward_stacked(sm.params, sm.config, *tx,
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
    assert torch.equal(ltxv.forward(tp, model.config, *tx, qcfg=qcfg),
                       ltxv.forward(model.params, model.config, *tx,
                                     qcfg=qcfg))

def _requests():
    reqs = []
    for seed, scale, n in ((10, 3.0, 3), (11, 1.0, 4)):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((L, DIMS.in_ch)).astype(np.float32),
                     {"ids": r.integers(0, 8, (L, 3)).astype(np.int32),
                      "ctx": r.standard_normal((CTX_LEN, DIMS.caption_dim))
                      .astype(np.float32),
                      "nctx": r.standard_normal((CTX_LEN, DIMS.caption_dim))
                      .astype(np.float32),
                      "cfg_scale": np.float32(scale)},
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
    """Two pooled requests at CFG 3.0 and 1.0 with their own voxel
    positions (different lengths of schedule): the port's engine against
    the reference's engine on the same tree, and each request against the
    port's direct sampler at batch 1."""
    jp, model = _trees(path)
    jmodel = jpipeline.DiffusionModel(
        arch="ltxv", params=jp, config=jltxv.LTXVConfig.from_state_dict(jp),
        qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    reqs = _requests()
    got = _serve(tpipeline.ltxv_engine, model, reqs)
    want = _serve(jpipeline.ltxv_engine, jmodel, reqs)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (L, DIMS.in_ch) and np.isfinite(g).all()
        assert _rel(g, w) < 1.5e-2 * max(1.0, float(c["cfg_scale"]))
        ids = torch.as_tensor(c["ids"])[None]
        ctx, nctx = (torch.as_tensor(c[k])[None].to(torch.bfloat16)
                     for k in ("ctx", "nctx"))

        def vel(xc, s, ids=ids, ctx=ctx, nctx=nctx, c=c):
            t = s.to(torch.float32).expand(1)
            v_c = model.forward(xc, ids, ctx, t)
            v_u = model.forward(xc, ids, nctx, t)
            return v_u.float() + float(c["cfg_scale"]) * (v_c.float()
                                                          - v_u.float())

        x0 = torch.as_tensor(x)[None].to(torch.bfloat16)
        with torch.no_grad():
            direct = sample_flow(vel, x0, sig, sampler="euler")
        assert _rel(g, direct[0].float()) < 1e-2


def test_engine_refuses_dp_mesh(path):
    _, model = _trees(path)
    with pytest.raises(ValueError, match="axis"):
        tpipeline.ltxv_engine(model, dp_mesh=object())


def test_seed_made_stacked_tree():
    """``ltxv_random_stacked_params``: the stacked layout forward_stacked
    reads, packed block linears, the no-quant keys dense; a forward of it is
    finite."""
    dims = dataclasses.replace(DIMS, n_layers=1)
    p = testing.ltxv_random_stacked_params(dims, seed=3, device="cpu")
    blocks = p["transformer_blocks"]
    assert isinstance(blocks["attn1.to_q.weight"], PlanarQuant)
    assert blocks["attn1.to_q.weight"].qs.shape[0] == 1
    assert isinstance(p["adaln_single.linear.weight"], torch.Tensor)
    _, tx = _inputs(np.float32)
    out = ltxv.forward_stacked(p, dims.config(), *tx)
    assert out.shape == (B, L, DIMS.in_ch) and torch.isfinite(out).all()
