"""The port's SD1/SDXL UNet (``models/unet.py``) and its continuous-batching
engine (``pipeline.unet_engine``) against the reference, on the CPU.

The reference's ``tests/test_unet.py`` runs on the port over the same tiny
sgm trees (its ``_res`` / ``_xformer`` builders, numpy weights carried
across): config detection, the forward (SDXL-like: linear proj and
``label_emb``; SD1-like: 1x1-conv proj, 8 heads), the missing-``y`` error,
the engine with per-request CFG against the direct per-request step, and
the seed-made ``sdxl_random_params`` tree. Beside them: both packages load
one tiny UNet GGUF written by the port's writer (Q4_K where K is a multiple
of 256) and agree on the planar and the w8a8 tree; the
port's engine agrees with the reference's engine (Euler and
DPM-Solver++(2M)); and the independent torch derivations of
``tests/test_golden_blocks.py`` (BasicTransformerBlock, ResBlock,
Downsample) are held against the port's blocks, a second oracle.

Tolerances (relative L2): 1e-4 with f32 compute, 2e-2 with bf16 compute.
The engines feed the UNet bf16 latents. Every block of the two packages
gives the same bits on the same bf16 input, but the packages' convolutions
sum in another order, which sometimes rounds an activation to the other
bf16 neighbour, and the network carries that to about 1.7e-2 of eps (found
with f32 compute at t = 999). CFG multiplies the difference of the two
forwards by the request's scale, so a served request is held to 1.5e-2 ·
max(1, cfg) of the reference's (found: 4.5e-2 to 6.1e-2 at cfg 7, 7e-3 to
8e-3 at cfg 1). Within the port a request gives the same bits at every
batch size (the convolutions and group norms run each sample alone:
``nn.layers._each_sample``), so pooled equals solo exactly.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.models import unet as junet
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import testing, unet
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import is_modulation_key
from comfyui_gguf_tpu_torch.sampling import kdiffusion as kd
from tests import test_golden_blocks as golden
from tests.test_unet import ADM, CTX, LAT, MC, _res, _xformer

torch.set_num_threads(2)

F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
CPU = torch.device("cpu")
# the w8a8 tree's limit with f32 compute (test_gguf_through_both_packages
# says why)
W8A8_TOL = 5e-2


def _engine_tol(cfg_scale) -> float:
    return 1.5e-2 * max(1.0, float(cfg_scale))


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _tiny_sd(sdxl: bool) -> dict:
    """The reference test's tiny two-level UNet: SDXL-like (linear proj,
    label_emb) or SD1-like (1x1-conv proj, no label_emb)."""
    rng = np.random.default_rng(0 if sdxl else 1)
    emb = 4 * MC
    c0, c1 = MC, 2 * MC

    def conv(o, i, k=3):
        return (rng.standard_normal((o, i, k, k)) * 0.05).astype(np.float32)

    def lin(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    sd = {
        "input_blocks.0.0.weight": conv(c0, LAT),
        "input_blocks.0.0.bias": np.zeros(c0, np.float32),
        "time_embed.0.weight": lin(emb, MC),
        "time_embed.0.bias": np.zeros(emb, np.float32),
        "time_embed.2.weight": lin(emb, emb),
        "time_embed.2.bias": np.zeros(emb, np.float32),
        "out.0.weight": np.ones(c0, np.float32),
        "out.0.bias": np.zeros(c0, np.float32),
        "out.2.weight": conv(LAT, c0),
        "out.2.bias": np.zeros(LAT, np.float32),
    }
    if sdxl:
        sd.update({"label_emb.0.0.weight": lin(emb, ADM),
                   "label_emb.0.0.bias": np.zeros(emb, np.float32),
                   "label_emb.0.2.weight": lin(emb, emb),
                   "label_emb.0.2.bias": np.zeros(emb, np.float32)})
    sd.update(_res(rng, "input_blocks.1.0", c0, c0, emb))
    sd["input_blocks.2.0.op.weight"] = conv(c0, c0)
    sd["input_blocks.2.0.op.bias"] = np.zeros(c0, np.float32)
    sd.update(_res(rng, "input_blocks.3.0", c0, c1, emb))
    sd.update(_xformer(rng, "input_blocks.3.1", c1, linear_proj=sdxl))
    sd.update(_res(rng, "middle_block.0", c1, c1, emb))
    sd.update(_xformer(rng, "middle_block.1", c1, linear_proj=sdxl))
    sd.update(_res(rng, "middle_block.2", c1, c1, emb))
    sd.update(_res(rng, "output_blocks.0.0", c1 + c1, c1, emb))
    sd.update(_xformer(rng, "output_blocks.0.1", c1, linear_proj=sdxl))
    sd.update(_res(rng, "output_blocks.1.0", c1 + c0, c1, emb))
    sd.update(_xformer(rng, "output_blocks.1.1", c1, linear_proj=sdxl))
    sd["output_blocks.1.2.conv.weight"] = conv(c1, c1)
    sd["output_blocks.1.2.conv.bias"] = np.zeros(c1, np.float32)
    sd.update(_res(rng, "output_blocks.2.0", c1 + c0, c0, emb))
    sd.update(_res(rng, "output_blocks.3.0", c0 + c0, c0, emb))
    return sd


@pytest.fixture(scope="module")
def tiny():
    """kind → (numpy sd, reference tree, port tree, port config, reference
    config); SDXL-like at head dim 16, SD1-like at its 8 heads."""
    out = {}
    for kind in ("sdxl", "sd1"):
        sd = _tiny_sd(kind == "sdxl")
        jp = {k: jnp.asarray(v) for k, v in sd.items()}
        tp = params_from_numpy(sd, "cpu")
        cfg, jcfg = (unet.UNetConfig.from_state_dict(tp),
                     junet.UNetConfig.from_state_dict(jp))
        if kind == "sdxl":
            cfg = dataclasses.replace(cfg, head_dim=16)
            jcfg = dataclasses.replace(jcfg, head_dim=16)
        out[kind] = (sd, jp, tp, cfg, jcfg)
    return out


def _inputs(kind, np_dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, LAT))
    t = np.asarray([999.0, 500.0], np.float32)
    ctx = rng.standard_normal((2, 7, CTX))
    y = rng.standard_normal((2, ADM)) if kind == "sdxl" else None
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16

    def j(a):
        return None if a is None else jnp.asarray(a, np_dtype)

    def tt(a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a, np.float32)).to(tdt))
    return ((j(x), jnp.asarray(t), j(ctx), j(y)),
            (tt(x), torch.from_numpy(t), tt(ctx), tt(y)))


@pytest.mark.parametrize("kind", ["sdxl", "sd1"])
def test_config_detection(tiny, kind):
    sd, jp, tp, cfg, jcfg = tiny[kind]
    base = unet.UNetConfig.from_state_dict(tp)
    assert dataclasses.asdict(base) == dataclasses.asdict(
        junet.UNetConfig.from_state_dict(jp))
    assert base.model_channels == MC and base.context_dim == CTX
    if kind == "sdxl":
        assert base.adm_in_channels == ADM and base.head_dim == 64
    else:
        assert base.adm_in_channels is None and base.num_heads == 8


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["sdxl", "sd1"])
def test_forward_matches_reference(tiny, kind, mode):
    sd, jp, tp, cfg, jcfg = tiny[kind]
    qcfg, jqcfg, np_dtype, tol = mode
    jx, tx = _inputs(kind, np_dtype)
    want = np.asarray(junet.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = unet.forward(tp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert got.shape == want.shape == (2, 8, 8, LAT)
    assert np.isfinite(got).all()
    assert _rel_l2(got, want) < tol


def test_unet_requires_y_for_sdxl(tiny):
    _, _, tp, cfg, _ = tiny["sdxl"]
    _, (x, t, ctx, _) = _inputs("sdxl", np.float32)
    with pytest.raises(ValueError, match="y"):
        unet.forward(tp, cfg, x, t, ctx, None)


GGUF_DIMS = {
    # one level of 512 channels, so the block linears planarize (the loader
    # keeps K below 1024 dense unless it is a multiple of 512); the 64-wide
    # context projections load dense
    "sdxl": testing.SDXLDims(model_channels=512, channel_mult=(1,),
                             num_res_blocks=1, depths=(1,), ctx=64,
                             adm=96),
    "sd1": testing.SDXLDims(model_channels=512, channel_mult=(1,),
                            num_res_blocks=1, depths=(1,), ctx=64,
                            adm=None),
}


def _write_unet(kind, path):
    sd = testing.unet_state_dict(GGUF_DIMS[kind], seed=2)
    testing.write_gguf(sd, path,
                       lambda k, v: testing.unet_block_qtype(k, v, Q.Q4_K),
                       kind)


@pytest.mark.parametrize("w8a8", [False, True], ids=["planar", "w8a8"])
@pytest.mark.parametrize("kind", ["sdxl", "sd1"])
def test_gguf_through_both_packages(tmp_path, kind, w8a8):
    """One tiny UNet GGUF through both packages' ``load_diffusion_model``
    (planar), and after ``requantize_i8()`` (``emb_layers`` kept planar):
    the same eps with f32 compute, within 1e-4 on the planar tree. The w8a8
    tree quantizes every linear's input rows to int8, a rounding with
    steps: the convolutions' float32 sums, taken in another order by the
    two packages (2.7e-7 apart), move a code by one step (1/127 of its
    row's largest value) now and then, and the blocks carry that on (each
    block gives the same bits on the same input; found 1.5e-2 to 1.8e-2 at
    the output). The w8a8 tree is held to ``W8A8_TOL`` (5e-2)."""
    path = str(tmp_path / f"{kind}.gguf")
    _write_unet(kind, path)
    model = pipeline.load_diffusion_model(path, device="cpu")
    jmodel = jpipeline.load_diffusion_model(path, prefer_pallas=False)
    model.qcfg, jmodel.qcfg = F32[0], F32[1]
    assert model.arch == jmodel.arch == kind
    assert model.stack() is model  # the UNets do not stack
    d = GGUF_DIMS[kind]
    assert model.config.model_channels == d.model_channels
    if w8a8:
        model.requantize_i8()
        jmodel.params = ji8.convert_tree_i8(
            jmodel.params, pred=lambda k, v: not is_modulation_key(k))
        kinds = {type(v).__name__ for k, v in model.params.items()
                 if k.endswith("attn1.to_q.weight")}
        assert kinds == {"I8Planar"}
        assert type(model.params[
            "input_blocks.1.0.emb_layers.1.weight"]).__name__ == "PlanarQuant"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, d.ctx)).astype(np.float32)
    y = (None if d.adm is None
         else rng.standard_normal((1, d.adm)).astype(np.float32))
    t = np.asarray([420.0], np.float32)
    want = np.asarray(jmodel.forward(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        None if y is None else jnp.asarray(y)), np.float32)
    got = model.forward(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
        None if y is None else torch.from_numpy(y))
    assert _rel_l2(got.numpy(), want) < (W8A8_TOL if w8a8 else F32[3])


@pytest.mark.parametrize("w8a8", [False, True], ids=["planar", "w8a8"])
def test_reference_tree_carried_across(w8a8):
    """The reference's own seed-made SDXL-geometry tree (packed planar
    linears, bf16 convs), and its w8a8 conversion, carried across with
    ``interop.params_from_numpy``: the same eps with f32 compute (1e-4;
    the w8a8 tree ``W8A8_TOL``, found 3.9e-2)."""
    from comfyui_gguf_tpu.models import testing as jtesting

    d = jtesting.SDXLDims(model_channels=64, channel_mult=(1, 2),
                          num_res_blocks=1, depths=(0, 1), ctx=64, adm=64)
    jp = jtesting.sdxl_random_params(d, seed=4)
    if w8a8:
        jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not
                                 is_modulation_key(k))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kinds = {type(v).__name__ for v in tp.values()}
    assert ("I8Planar" if w8a8 else "PlanarQuant") in kinds
    cfg, jcfg = (unet.UNetConfig.from_state_dict(tp),
                 junet.UNetConfig.from_state_dict(jp))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, 64)).astype(np.float32)
    y = rng.standard_normal((1, 64)).astype(np.float32)
    t = np.asarray([300.0], np.float32)
    want = np.asarray(junet.forward(jp, jcfg, *map(jnp.asarray, (x, t, ctx,
                                                                  y)),
                                    qcfg=F32[1]))
    got = unet.forward(tp, cfg, *map(torch.from_numpy, (x, t, ctx, y)),
                       qcfg=F32[0]).numpy()
    assert _rel_l2(got, want) < (W8A8_TOL if w8a8 else F32[3])


def _engine_requests(sigmas, n=2, seed=20):
    out = []
    for i, scale in zip(range(n), (7.0, 1.5, 3.0)):
        r = np.random.default_rng(seed + i)
        x0 = (r.standard_normal((8, 8, LAT)) * float(sigmas[0])).astype(
            np.float32)
        out.append((x0, {
            "ctx": r.standard_normal((7, CTX)).astype(np.float32),
            "nctx": r.standard_normal((7, CTX)).astype(np.float32),
            "adm": r.standard_normal((ADM,)).astype(np.float32),
            "cfg_scale": np.float32(scale)}))
    return out


def _models(tiny):
    _, jp, tp, cfg, jcfg = tiny["sdxl"]
    return (pipeline.DiffusionModel(arch="sdxl", params=tp, config=cfg,
                                    qcfg=F32[0], device=CPU),
            jpipeline.DiffusionModel(arch="sdxl", params=jp, config=jcfg,
                                     qcfg=F32[1]))


def test_unet_engine_cfg_serving(tiny):
    """Pooled requests, each with its own cfg scale, match the direct
    per-request k-diffusion CFG Euler step (the engine's eps
    parameterization) on the port."""
    mdl, _ = _models(tiny)
    sigmas = kd.normal_schedule(3, kd.ddpm_sigmas())
    reqs = _engine_requests(sigmas)
    eng = pipeline.unet_engine(mdl, max_batch=2)
    rs = [eng.submit(x.copy(), c, sigmas) for x, c in reqs]
    eng.run_until_drained()
    assert all(r.finished and r.error is None for r in rs)
    table = kd.ddpm_sigmas()

    def direct(x0, cond):
        ctx, nctx, adm = (torch.from_numpy(cond[k])[None].bfloat16()
                          for k in ("ctx", "nctx", "adm"))
        x = torch.from_numpy(x0)[None].bfloat16()
        for i in range(len(sigmas) - 1):
            s = torch.tensor([sigmas[i]], dtype=torch.float32)
            c_in = 1.0 / torch.sqrt(1.0 + s ** 2)
            t = kd.sigma_to_t(s, table)
            xs = (x.float() * c_in).bfloat16()
            e_c, e_u = (unet.forward(mdl.params, mdl.config, xs, t, c, adm,
                                     qcfg=mdl.qcfg).float()
                        for c in (ctx, nctx))
            eps = e_u + float(cond["cfg_scale"]) * (e_c - e_u)
            x = (x.float() + float(sigmas[i + 1] - sigmas[i]) * eps
                 ).bfloat16()
        return x[0].float().numpy()

    for (x0, c), r in zip(reqs, rs):
        assert _rel_l2(r.result, direct(x0, c)) <= _engine_tol(
            c["cfg_scale"])


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_unet_engine_matches_reference_engine(tiny, sampler):
    """The port's engine and the reference's on the same tiny SDXL-like
    UNet and the same three requests (mixed cfg scales and schedule
    lengths, so the pool is mixed-progress and padded)."""
    mdl, jmdl = _models(tiny)
    table = kd.ddpm_sigmas()
    reqs = [(x, c, kd.normal_schedule(3 + i, table))
            for i, (x, c) in enumerate(_engine_requests(
                kd.normal_schedule(3, table), n=3, seed=40))]
    out = []
    for mk, m in ((jpipeline.unet_engine, jmdl),
                  (pipeline.unet_engine, mdl)):
        eng = mk(m, max_batch=2, sampler=sampler)
        rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
        eng.run_until_drained()
        assert all(r.finished and r.error is None for r in rs)
        out.append([np.asarray(r.result, np.float32) for r in rs])
    for want, got, (_, c, _) in zip(*out, reqs):
        assert got.shape == want.shape == (8, 8, LAT)
        assert _rel_l2(got, want) <= _engine_tol(c["cfg_scale"])


def test_unet_engine_dpmpp_2m_pooled_equals_solo(tiny):
    """sampler="dpmpp_2m": a pooled mixed-cfg batch equals the same
    requests run one at a time, bit for bit (per-lane multistep state is
    exact under pooling and padding, and the forward is batch-invariant),
    and differs from Euler serving."""
    mdl, _ = _models(tiny)
    sigmas = kd.normal_schedule(4, kd.ddpm_sigmas())
    (x1, c1), (x2, c2) = _engine_requests(sigmas, seed=70)
    eng = pipeline.unet_engine(mdl, max_batch=2, sampler="dpmpp_2m")
    r1, r2 = (eng.submit(x.copy(), c, sigmas) for x, c in ((x1, c1),
                                                           (x2, c2)))
    eng.run_until_drained()
    solo = pipeline.unet_engine(mdl, max_batch=1, sampler="dpmpp_2m")
    outs = []
    for x, c in ((x1, c1), (x2, c2)):
        s = solo.submit(x.copy(), c, sigmas)
        solo.run_until_drained()
        outs.append(s.result)
    np.testing.assert_array_equal(r1.result, outs[0])
    np.testing.assert_array_equal(r2.result, outs[1])
    eng_e = pipeline.unet_engine(mdl, max_batch=2)
    e1 = eng_e.submit(x1.copy(), c1, sigmas)
    eng_e.run_until_drained()
    assert not np.allclose(r1.result, e1.result)


def test_unet_engine_rejects_other_samplers(tiny):
    mdl, _ = _models(tiny)
    with pytest.raises(ValueError, match="euler"):
        pipeline.unet_engine(mdl, sampler="heun")


def test_sdxl_random_params_generator_forward():
    """The seed-made tree (testing.sdxl_random_params) is one
    models/unet.py accepts: config introspection, forward shape, finite
    output; SD1's geometry too."""
    for d in (testing.SDXLDims(),
              testing.SDXLDims(channel_mult=(1, 2), depths=(1, 0),
                               adm=None, model_channels=64)):
        sd = testing.sdxl_random_params(d, seed=3, device="cpu")
        cfg = unet.UNetConfig.from_state_dict(sd)
        assert cfg.model_channels == d.model_channels
        assert cfg.context_dim == d.ctx and cfg.adm_in_channels == d.adm
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (1, 16, 16, d.in_ch)).astype(np.float32)).bfloat16()
        ctx = torch.from_numpy(rng.standard_normal(
            (1, 7, d.ctx)).astype(np.float32)).bfloat16()
        y = (None if d.adm is None else torch.from_numpy(
            rng.standard_normal((1, d.adm)).astype(np.float32)).bfloat16())
        out = unet.forward(sd, cfg, x, torch.tensor([500.0]), ctx, y)
        assert out.shape == (1, 16, 16, d.in_ch)
        assert bool(torch.isfinite(out.float()).all())


def test_unet_shapes_match_the_reference_builder():
    """The port's UNet geometry (``_unet_shapes``) names and sizes every
    tensor the reference's ``sdxl_random_params`` makes, at SDXL's and
    SD1's published geometry."""
    from comfyui_gguf_tpu.models import testing as jtesting

    for pd, jd in ((testing.SDXL_DIMS, jtesting.SDXL_DIMS),
                   (testing.SD1_DIMS, jtesting.SD1_DIMS)):
        assert dataclasses.asdict(pd) == dataclasses.asdict(jd)
        small = dataclasses.replace(pd, model_channels=32, ctx=64,
                                    adm=None if pd.adm is None else 64)
        jsmall = jtesting.SDXLDims(**dataclasses.asdict(small))
        want = {k: tuple(getattr(v, "shape", np.shape(v)))
                for k, v in jtesting.sdxl_random_params(jsmall).items()}
        got = testing._unet_shapes(small)
        assert got == want


# the independent torch derivations of tests/test_golden_blocks.py, held
# against the port's blocks: the golden test runs with the reference module
# it calls swapped for an adapter over the port's function

def _port(fn):
    """Wrap a port function to take and return what the golden tests pass
    the reference's (jax arrays in, arrays out; f32 compute)."""
    def call(*args):
        conv = [params_from_numpy(jax.tree.map(np.asarray, a), "cpu")
                if isinstance(a, dict) else
                torch.from_numpy(np.array(a)) if isinstance(a, jax.Array)
                else a for a in args]
        conv = [F32[0] if isinstance(a, JQuantConfig) else a for a in conv]
        out = fn(*conv)
        if isinstance(out, tuple):
            return tuple(None if o is None else o.numpy() for o in out)
        return out.numpy()
    return call


def test_sdxl_basic_transformer_block_golden(monkeypatch):
    monkeypatch.setattr(golden, "unet", types.SimpleNamespace(
        _basic_block=_port(unet._basic_block)))
    golden.test_sdxl_basic_transformer_block_golden()


def test_unet_resblock_golden(monkeypatch):
    monkeypatch.setattr(junet, "_resblock", _port(unet._resblock))
    golden.test_unet_resblock_golden()


def test_unet_downsample_golden(monkeypatch):
    monkeypatch.setattr(junet, "_apply_numbered_block",
                        _port(unet._apply_numbered_block))
    golden.test_unet_downsample_golden()
