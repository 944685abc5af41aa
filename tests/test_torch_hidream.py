"""The port's HiDream-I1 MoE DiT (``models/hidream.py``), ``HiDreamPipeline``
and ``hidream_engine`` against the reference, on the CPU.

A tiny HiDream (hidden 512, 4 heads of 128, 2 double + 2 single blocks,
SwiGLU FFN 1024, 4 routed experts top-2 plus the shared one) is written as
Q4_K and Q8_0 GGUFs by the port's writer, quantized the way a published
file is (the embedders, the caption projections, the final layer and the
f32 router stay float), and loaded by both packages. Checked: config
detection; ``forward`` planar in float32 and bfloat16; the routing (global
softmax, top-k kept, not renormalized; and the renormalizing variant);
"capacity" dispatch against "dense" (no expert overflows) and against the
reference's capacity dispatch where experts do overflow; stacked (experts
leaf-stacked as (depth, E, …)) against unrolled, in both dispatch modes;
the w8a8 tree with the adaLN projections kept planar; the engine against
the reference's engine and the direct Euler sampler; ``generate_from_ids``
(CLIP-L ⊕ CLIP-G pooled, T5 and llama states) with the reference's noise;
the refusals (``dp_mesh`` with ``mesh`` a ``ValueError``, and either
without its axis); the "ep" dispatch without a mesh equal to dense. These
mirror ``tests/test_hidream.py``; its expert-parallel test is mirrored in
``tests/test_torch_ep.py``.

Tolerances (relative L2): 3e-4 for the planar trees in float32, 2e-2 in
bfloat16, 1e-5 for capacity against dense dispatch with no overflow (an
expert's outputs scatter-add in f32 over unique indices: equal sums), 1e-2
for a served request against the direct sampler and 1.5e-2 for latents
against the reference (no CFG), and ``W8A8_TOL`` = 1e-4 for the w8a8 tree
in float32: the port reads 2.8e-6 against the reference's tree converted
with the same predicate (the planar trees 4.5e-7), a conversion that skips
the activation rounding 5.8e-4 and one that converts the adaLN projections
4.1e-4; a control test holds both faults above the limit.
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
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu.models import hidream as jhd
from comfyui_gguf_tpu.models import llama as jllama
from comfyui_gguf_tpu.models import t5 as jt5
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import hidream, testing
from comfyui_gguf_tpu_torch.models import llama as tllama
from comfyui_gguf_tpu_torch.models import t5 as tt5
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.TinyHiDreamDims(hidden=512, heads=4, depth_double=2,
                               depth_single=2, ffn=1024, n_experts=4,
                               top_k=2, t5_dim=128, llama_dim=128, pooled=64)
B, H_LAT, T5_LEN, LL_LEN = 2, 8, 6, 5
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 3e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 1e-4
CAP_TOL = 1e-5
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hidream")
    sd = testing.random_flat_sd_from_spec(*testing.hidream_shape_spec(DIMS),
                                          seed=0)
    out = {}
    for qtype in (Q.Q4_K, Q.Q8_0):
        out[qtype] = str(d / f"hidream_{qtype.name}.gguf")
        testing.write_spec_gguf(sd, out[qtype], "hidream", qtype)
    return out


def _trees(path):
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    return jp, tpipeline.load_diffusion_model(path, device="cpu")


def _inputs(np_dtype, seed=5, batch=B):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((batch, H_LAT, H_LAT, DIMS.in_ch)),
            rng.standard_normal((batch, T5_LEN, DIMS.t5_dim)),
            rng.standard_normal((batch, LL_LEN, DIMS.llama_dim)),
            rng.standard_normal((batch, DIMS.pooled))]
    t = np.linspace(1.0, 0.4, batch).astype(np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, np_dtype) for a in arrs] + [jnp.asarray(t)]
    tx = [torch.as_tensor(a.astype(np.float32)).to(tdt)
          for a in arrs] + [torch.from_numpy(t)]
    return jx, tx


@pytest.fixture
def dispatch(monkeypatch):
    """Set both packages' MoE dispatch mode (and capacity factor)."""
    def set_mode(mode, factor=None):
        for mod in (hidream, jhd):
            monkeypatch.setattr(mod, "MOE_DISPATCH", mode)
            if factor is not None:
                monkeypatch.setattr(mod, "MOE_CAPACITY_FACTOR", factor)
    return set_mode


def test_config_and_published_quantization(files):
    jp, model = _trees(files[Q.Q4_K])
    assert model.arch == "hidream" and not model.is_stacked
    assert dataclasses.asdict(model.config) == dataclasses.asdict(
        jhd.HiDreamConfig.from_state_dict(jp))
    assert model.config == DIMS.config()
    p = model.params
    for k in ("double_stream_blocks.0.block.attn1.to_q_t.weight",
              "double_stream_blocks.1.block.ff_i.experts.3.w2.weight",
              "single_stream_blocks.0.block.adaLN_modulation.1.weight"):
        assert isinstance(p[k], PlanarQuant), k
    gate = p["double_stream_blocks.0.block.ff_i.gate.weight"]
    assert isinstance(gate, torch.Tensor) and gate.dtype == torch.float32
    for k in ("x_embedder.proj.weight", "caption_projection.1.linear.weight",
              "final_layer.linear.weight", "p_embedder.mlp.2.weight"):
        assert isinstance(p[k], torch.Tensor), k


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_forward_matches_reference(files, qtype, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(files[qtype])
    jcfg = jhd.HiDreamConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jhd.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = hidream.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, H_LAT, H_LAT, DIMS.in_ch)
    assert _rel(got.float(), want) < tol


@pytest.mark.parametrize("renorm", [False, True])
def test_routing_matches_reference(files, renorm, monkeypatch):
    """Global softmax over the f32 router's logits, the top k kept: the
    weights sum to < 1 per token unless renormalized."""
    jp, model = _trees(files[Q.Q8_0])
    for mod in (hidream, jhd):
        monkeypatch.setattr(mod, "MOE_RENORM_PROBS", renorm)
    x = np.random.default_rng(2).standard_normal((1, 24, DIMS.hidden))
    p = "double_stream_blocks.0.block.ff_i"
    got, k = hidream._routing_probs(model.params, p, torch.as_tensor(
        x.astype(np.float32)), 4, 2, F32[0])
    want, jk = jhd._routing_probs(jp, p, jnp.asarray(x, jnp.float32), 4, 2,
                                  F32[1])
    assert k == jk == 2
    assert ((got > 0).sum(-1) == 2).all()
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    assert _rel(got, np.asarray(want)) < 1e-6
    sums = got.sum(-1)
    if renorm:
        assert torch.allclose(sums, torch.ones_like(sums))
    else:
        assert bool((sums < 1).all())


def test_capacity_matches_dense(files, dispatch):
    """No expert overflows at 64 tokens (C = 48 of 64): capacity equals
    dense within 1e-5, flat and stacked."""
    _, model = _trees(files[Q.Q8_0])
    _, tx = _inputs(np.float32, seed=3, batch=1)
    qcfg = F32[0]
    assert hidream.capacity(64, 2, 4) == 48
    dense = hidream.forward(model.params, model.config, *tx, qcfg=qcfg)
    sp = hidream.stack_hidream_params(model.params, model.config)
    dense_s = hidream.forward_stacked(sp, model.config, *tx, qcfg=qcfg)
    dispatch("capacity")
    cap = hidream.forward(model.params, model.config, *tx, qcfg=qcfg)
    cap_s = hidream.forward_stacked(sp, model.config, *tx, qcfg=qcfg)
    assert _rel(cap, dense) < CAP_TOL
    assert _rel(cap_s, dense_s) < CAP_TOL
    assert torch.equal(cap_s, cap)


def test_capacity_overflow_matches_reference(files, dispatch):
    """At a capacity factor of 0.5 (C = 16 of 64 tokens, top-2 over 4
    experts) experts overflow and drop tokens: the same result as the
    reference's capacity dispatch, and not the dense one."""
    jp, model = _trees(files[Q.Q8_0])
    jx, tx = _inputs(np.float32, seed=3, batch=1)
    dense = hidream.forward(model.params, model.config, *tx, qcfg=F32[0])
    dispatch("capacity", 0.5)
    assert hidream.capacity(64, 2, 4) == 16
    got = hidream.forward(model.params, model.config, *tx, qcfg=F32[0])
    want = np.asarray(jhd.forward(jp, jhd.HiDreamConfig.from_state_dict(jp),
                                  *jx, qcfg=F32[1]), np.float32)
    assert _rel(got, want) < F32[3]
    assert _rel(got, dense) > 1e-3


@pytest.mark.parametrize("mode", ["dense", "capacity"])
def test_stacked_matches_unrolled(files, mode, dispatch):
    """stack_hidream_params (experts leaf-stacked, (depth, E, …) leaves)
    and forward_stacked over block views equal forward; the reference's
    stacked tree carried across gives the reference's result."""
    jp, model = _trees(files[Q.Q4_K])
    dispatch(mode)
    jx, tx = _inputs(np.float32, seed=4)
    want = hidream.forward(model.params, model.config, *tx, qcfg=F32[0])
    stacked = model.stack()
    assert stacked.is_stacked
    leaf = stacked.params["double_stream_blocks"][
        "block.ff_i.experts_stacked"]["w1"]
    assert isinstance(leaf, PlanarQuant)
    assert tuple(leaf.qs.shape[:2]) == (DIMS.depth_double, DIMS.n_experts)
    assert not any(".experts." in k for k in stacked.params
                   ["double_stream_blocks"])
    got = hidream.forward_stacked(stacked.params, model.config, *tx,
                                  qcfg=F32[0])
    assert torch.equal(got, want)
    jcfg = jhd.HiDreamConfig.from_state_dict(jp)
    jsp = jax.tree.map(np.asarray, jhd.stack_hidream_params(jp, jcfg))
    got_c = hidream.forward_stacked(params_from_numpy(jsp, "cpu"),
                                    model.config, *tx, qcfg=F32[0])
    ref = np.asarray(jhd.forward(jp, jcfg, *jx, qcfg=F32[1]), np.float32)
    assert _rel(got_c, ref) < F32[3]


def test_ep_dispatch_not_ported(files, dispatch):
    """"ep" without an expert mesh (``hidream.EP_MESH`` None) runs the
    dense dispatch, as the reference's does; over a mesh it runs on ranks
    (``tests/test_torch_ep.py``)."""
    _, model = _trees(files[Q.Q8_0])
    _, tx = _inputs(np.float32, batch=1)
    dense = hidream.forward(model.params, model.config, *tx, qcfg=F32[0])
    dispatch("ep")
    assert hidream.EP_MESH is None
    assert torch.equal(hidream.forward(model.params, model.config, *tx,
                                       qcfg=F32[0]), dense)


def _w8a8_reference(files):
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    jp, model = _trees(files[Q.Q4_K])
    jcfg = jhd.HiDreamConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np.float32, seed=6)
    want = np.asarray(jhd.forward(jp, jcfg, *jx, qcfg=F32[1]), np.float32)
    return model, want, tx


def test_w8a8_forward_matches_reference(files):
    """requantize_i8 with the adaLN projections kept planar (experts
    converted), flat and stacked, against the reference's tree converted
    with the same predicate."""
    model, want, tx = _w8a8_reference(files)
    model.requantize_i8()
    p = model.params
    assert isinstance(p["double_stream_blocks.0.block.adaLN_modulation.1"
                        ".weight"], PlanarQuant)
    assert isinstance(p["single_stream_blocks.1.block.ff_i.experts.2.w1"
                        ".weight"], I8Planar)
    got = hidream.forward(p, model.config, *tx, qcfg=F32[0])
    assert _rel(got, want) < W8A8_TOL
    out = hidream.forward_stacked(model.stack().params, model.config, *tx,
                                  qcfg=F32[0])
    assert torch.equal(out, got)


@pytest.mark.parametrize("fault", ["unrounded_activations",
                                   "adaln_converted"])
def test_w8a8_limit_fails_faulted_conversions(files, fault, monkeypatch):
    """The control of ``W8A8_TOL``: activations scaled but not rounded to
    int8 codes, or the adaLN projections converted against the reference's
    rule, read above the limit."""
    from comfyui_gguf_tpu_torch.ops import i8mm

    model, want, tx = _w8a8_reference(files)
    if fault == "unrounded_activations":
        rows = i8mm.quantize_rows

        def unrounded(x2):
            _, xs = rows(x2)
            return x2.float() / xs, xs

        monkeypatch.setattr(i8mm, "quantize_rows", unrounded)
        model.requantize_i8()
    else:
        model.requantize_i8(mod_planar=False)
    got = hidream.forward(model.params, model.config, *tx, qcfg=F32[0])
    assert _rel(got, want) > W8A8_TOL


def _requests():
    reqs = []
    for seed, n in ((30, 3), (31, 2)):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((H_LAT, H_LAT, DIMS.in_ch)).astype(
                         np.float32),
                     {"t5": r.standard_normal((T5_LEN, DIMS.t5_dim)).astype(
                         np.float32),
                      "llama": r.standard_normal(
                          (LL_LEN, DIMS.llama_dim)).astype(np.float32),
                      "pooled": r.standard_normal((DIMS.pooled,)).astype(
                          np.float32)},
                     linear_schedule(n)))
    return reqs


def _serve(eng, reqs):
    hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(h.finished and h.error is None for h in hs)
    return [np.asarray(h.result, np.float32) for h in hs]


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_engine_matches_reference_and_direct(files, stacked):
    jp, model = _trees(files[Q.Q8_0])
    jmodel = jpipeline.DiffusionModel(
        arch="hidream", params=jp,
        config=jhd.HiDreamConfig.from_state_dict(jp), qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
    reqs = _requests()
    got = _serve(tpipeline.hidream_engine(model, max_batch=2), reqs)
    want = _serve(jpipeline.hidream_engine(jmodel, max_batch=2), reqs)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (H_LAT, H_LAT, DIMS.in_ch) and np.isfinite(g).all()
        assert _rel(g, w) < 1.5e-2
        cond = [torch.as_tensor(c[k])[None].to(torch.bfloat16)
                for k in ("t5", "llama", "pooled")]

        def vel(xc, s, cond=cond):
            return model.forward(xc, *cond, s.to(torch.float32).expand(1))

        with torch.no_grad():
            direct = sample_flow(vel, torch.as_tensor(x)[None].to(
                torch.bfloat16), sig)
        assert _rel(g, direct[0].float()) < 1e-2


def test_engine_refuses_meshes(files):
    """Both meshes: the ValueError the reference's engine only reaches when
    it traces (ROADMAP queue 3); either alone without its axis ("dp" /
    "tp"): ValueError before any tick (the parallel engines themselves run
    on ranks in ``tests/test_torch_tp_spec.py``)."""
    _, model = _trees(files[Q.Q8_0])
    with pytest.raises(ValueError, match="not both"):
        tpipeline.hidream_engine(model, dp_mesh=object(), mesh=object())
    for kw in ({"dp_mesh": object()}, {"mesh": object()}):
        with pytest.raises(ValueError, match="axis"):
            tpipeline.hidream_engine(model, **kw)


def _encoder_pairs():
    """(reference, port) TextEncoder pairs of CLIP-L, CLIP-G (pooled 32
    each), T5 and a llama graph, over the same numpy arrays."""
    jf = F32[1]
    out = {}
    for kind, seed in (("clip_l", 3), ("clip_g", 4)):
        sd = testing.clip_state_dict(
            testing.CLIPDims(hidden=64, n_layers=2, n_heads=1,
                             intermediate=96, vocab=600, max_positions=16,
                             proj=DIMS.pooled // 2), seed=seed)
        act = "gelu" if kind == "clip_g" else "quick_gelu"
        out[kind] = (
            jpipeline.TextEncoder(kind, {k: jnp.asarray(v)
                                         for k, v in sd.items()},
                                  dataclasses.replace(
                                      jclip.CLIPTextConfig.from_state_dict(
                                          sd), act=act), None, jf),
            tpipeline.TextEncoder(kind, params_from_numpy(sd, "cpu"),
                                  dataclasses.replace(
                                      tclip.CLIPTextConfig.from_state_dict(
                                          sd), act=act), None, F32[0], CPU))
    sd = testing.t5_state_dict(testing.T5Dims(
        d_model=DIMS.t5_dim, d_kv=16, n_heads=4, d_ff=128, n_layers=2,
        vocab=64), seed=2)
    out["t5"] = (jpipeline.TextEncoder(
        "t5", {k: jnp.asarray(v) for k, v in sd.items()},
        jt5.T5Config.from_state_dict(sd), None, jf),
        tpipeline.TextEncoder("t5", params_from_numpy(sd, "cpu"),
                              tt5.T5Config.from_state_dict(sd), None, F32[0],
                              CPU))
    sd = testing.llama_state_dict(testing.LlamaDims(
        hidden=DIMS.llama_dim, n_layers=2, n_heads=32, n_kv_heads=8,
        head_dim=4, intermediate=256, vocab=120), seed=7)
    out["llama"] = (jpipeline.TextEncoder(
        "llama", {k: jnp.asarray(v) for k, v in sd.items()},
        jllama.LlamaConfig.from_state_dict(sd), None, jf),
        tpipeline.TextEncoder("llama", params_from_numpy(sd, "cpu"),
                              tllama.LlamaConfig.from_state_dict(sd), None,
                              F32[0], CPU))
    return out


def test_generate_from_ids_matches_reference(files):
    """The reference's noise handed to the port: the same latent within
    1.5e-2; shift 3.0, one forward a step."""
    encs = _encoder_pairs()
    jp, model = _trees(files[Q.Q4_K])
    jmodel = jpipeline.DiffusionModel(
        arch="hidream", params=jp,
        config=jhd.HiDreamConfig.from_state_dict(jp), qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    jpipe = jpipeline.HiDreamPipeline(jmodel, *(encs[k][0] for k in (
        "clip_l", "clip_g", "t5", "llama")))
    tpipe = tpipeline.HiDreamPipeline(model, *(encs[k][1] for k in (
        "clip_l", "clip_g", "t5", "llama")))
    assert tpipe.shift == jpipe.shift == 3.0
    rng = np.random.default_rng(12)
    ids = (rng.integers(0, 600, (1, 16)), rng.integers(0, 600, (1, 16)),
           rng.integers(0, 64, (1, 9)), rng.integers(0, 120, (1, 11)))
    kw = dict(width=64, height=64, steps=3, seed=2)
    want = np.asarray(jpipe.generate_from_ids(*(jnp.asarray(i) for i in ids),
                                              **kw), np.float32)
    noise = np.asarray(jax.random.normal(
        jax.random.key(2), (1, 8, 8, DIMS.in_ch), jnp.bfloat16), np.float32)
    calls = []
    fwd = hidream.forward
    hidream.forward = lambda *a, **k: calls.append(1) or fwd(*a, **k)
    try:
        got = tpipe.generate_from_ids(*ids, noise=noise, **kw)
    finally:
        hidream.forward = fwd
    assert len(calls) == 3  # guidance-distilled: one forward a step
    assert got.shape == want.shape == (8, 8, DIMS.in_ch)
    assert _rel(got, want) < 1.5e-2
    assert set(tpipe.last_timings) >= {"encode_s", "denoise_s", "total_s"}


def test_seed_made_stacked_tree():
    """``hidream_random_stacked_params``: the blocks stacked and packed,
    the routed experts as (depth, E, …) leaves, the no-quant keys (router
    included) dense; a forward of it is finite in both dispatch modes."""
    p = testing.hidream_random_stacked_params(DIMS, seed=3, device="cpu")
    d = p["double_stream_blocks"]
    w2 = d["block.ff_i.experts_stacked"]["w2"]
    assert isinstance(w2, PlanarQuant) and w2.shape == (512, 1024)
    assert tuple(w2.qs.shape[:2]) == (2, 4)
    assert isinstance(d["block.ff_i.gate.weight"], torch.Tensor)
    assert isinstance(d["block.attn1.to_q.weight"], PlanarQuant)
    for k in ("x_embedder.proj.weight", "caption_projection.0.linear.weight"):
        assert isinstance(p[k], torch.Tensor), k
    model = tpipeline.DiffusionModel(arch="hidream", params=p,
                                     config=DIMS.config(), qcfg=BF16[0],
                                     device=CPU)
    assert model.is_stacked
    _, tx = _inputs("bfloat16", batch=1)
    out = model.forward(*tx)
    assert out.shape == tx[0].shape and bool(torch.isfinite(out).all())
