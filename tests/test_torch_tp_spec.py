"""Spec-driven tensor parallelism (``parallel/tp_spec.py``): every arch's
table, sharder and forward wrapper on 2 gloo ranks against the JAX
package's ``tp_spec`` forward on the 8-device virtual CPU mesh
(``prefer_pallas=False``), from the same seed-made state dict; the w8a8
tree converted per shard; the byte plan against the reference's.

Tolerances (relative L2): 1e-4 for the float32 forwards (the reference's
own TP tests hold 2e-3 elementwise against its unsharded forward; the
ports read ~1e-6: sums in another order), 1e-3 for the w8a8 tree (each
rank quantizes its own K chunk's activations, as the reference's ranks
do, so the codes are the reference TP tree's, not the unsharded tree's;
an activation code can still round the other way where the packages'
f32 sums differ in the last bit), and the ranks' outputs bit-equal to
one another. HunyuanVideo holds 1e-3, its single-device bound
(``tests/test_torch_hyvid.py`` ``GUIDED_TOL``: the guidance embed's
angles reach 6e6 rad, where the packages' cos rounds apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.parallel import tp_spec as jtp
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch, tp_spec

TP = 2
F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TOL = 1e-4
ARCH_TOL = {"hyvid": 1e-3}
I8_TOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(TP, device="cpu") as r:
        yield r


def _jmesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:TP]), (jtp.AXIS,))


def _arrays(rng, *shapes):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _case(arch):
    """(sd, cfg, numpy inputs, shard fn name, forward fn name, block keys
    fn) of a tiny model of ``arch`` (the reference tests' dims)."""
    rng = np.random.default_rng(100)
    t = lambda v: np.full((1,), v, np.float32)  # noqa: E731
    if arch == "qwen_image":
        d = testing.QwenImageDims(hidden=512, n_heads=4, n_layers=2,
                                  in_ch=32, context_dim=96)
        sd = testing.random_flat_sd_from_spec(
            *testing.qwen_image_shape_spec(d), seed=3)
        from comfyui_gguf_tpu_torch.models import flux

        img, txt = _arrays(rng, (1, 16, d.in_ch), (1, 8, d.context_dim))
        ids = np.array(flux.make_img_ids(4, 4, 1))
        x = (img, ids, txt, np.zeros((1, 8, 3), np.int32), t(0.4))
        return sd, d.config(), x, ("transformer_blocks",)
    if arch == "wan":
        d = testing.WanDims(dim=512, ffn_dim=1024, n_heads=4, n_layers=2,
                            in_ch=16, text_dim=64)
        sd = testing.random_flat_sd_from_spec(*testing.wan_shape_spec(d),
                                              seed=5)
        x = _arrays(rng, (1, 2, 8, 8, d.in_ch), (1, 6, d.text_dim))
        return sd, d.config(), x + (t(0.6),), ("blocks",)
    if arch == "aura":
        d = testing.AuraDims(hidden=512, depth_double=1, depth_single=1,
                             mlp=1024, in_ch=4, cond_dim=64,
                             n_register_tokens=3, max_tokens=64)
        sd = testing.random_flat_sd_from_spec(*testing.aura_shape_spec(d),
                                              seed=11)
        x = _arrays(rng, (1, 8, 8, d.in_ch), (1, 6, d.cond_dim))
        return sd, d.config(), x + (t(0.5),), ("double_layers",
                                               "single_layers")
    if arch == "cosmos":
        d = testing.CosmosDims(dim=512, n_heads=4, n_layers=2, in_ch=16,
                               text_dim=64)
        sd = testing.random_flat_sd_from_spec(
            *testing.cosmos_shape_spec(d), seed=13)
        x = _arrays(rng, (1, 2, 8, 8, d.in_ch), (1, 6, d.text_dim))
        return sd, d.config(), x + (t(0.5),), ("blocks",)
    if arch == "hyvid":
        d = testing.HyVidDims(hidden=512, n_heads=4, depth_double=1,
                              depth_single=1, refiner_depth=1, in_ch=16,
                              text_dim=64)
        sd = testing.random_flat_sd_from_spec(*testing.hyvid_shape_spec(d),
                                              seed=17)
        x = _arrays(rng, (1, 2, 4, 4, d.in_ch), (1, 6, d.text_dim))
        return sd, d.config(), x + (t(0.5), t(6000.0)), ("double_blocks",
                                                         "single_blocks")
    if arch == "lumina2":
        d = testing.Lumina2Dims(dim=512, n_heads=4, n_layers=2, n_refiner=1,
                                n_context_refiner=1, ffn=1024, in_ch=4,
                                cap_dim=64)
        sd = testing.random_flat_sd_from_spec(
            *testing.lumina2_shape_spec(d), seed=15)
        x = _arrays(rng, (1, 8, 8, d.in_ch), (1, 6, d.cap_dim))
        return sd, d.config(), x + (t(0.5),), None
    if arch == "sd3":
        d = testing.TinySD3Dims(hidden=512, heads=4, depth=3, ctx_dim=64,
                                pooled=32, in_ch=16, pos_max=8,
                                qk_norm=True)
        sd = testing.sd3_flat_state_dict(d, seed=7)
        x = _arrays(rng, (1, 8, 8, d.in_ch), (1, 8, d.ctx_dim),
                    (1, d.pooled))
        return sd, d.config(), x + (t(0.5),), ("joint_blocks",
                                               "joint_blocks_last")
    if arch == "flux":
        d = testing.TinyFluxDims(hidden=512, heads=4, ctx=256, vec=64,
                                 in_ch=16, depth_double=1, depth_single=1,
                                 axes_dim=(32, 48, 48))
        sd = testing.flux_state_dict(d, seed=19)
        from comfyui_gguf_tpu_torch.models import flux

        img, txt, y = _arrays(rng, (1, 16, d.in_ch), (1, 8, d.ctx),
                              (1, d.vec))
        x = (img, np.array(flux.make_img_ids(4, 4, 1)), txt,
             np.zeros((1, 8, 3), np.int32), t(1.0), y, t(4.0))
        return sd, d.config(), x, ("double_blocks", "single_blocks")
    d = testing.TinyHiDreamDims(hidden=512, heads=4, depth_double=1,
                                depth_single=1, ffn=1024, n_experts=2,
                                top_k=2, t5_dim=64, llama_dim=96, pooled=48)
    sd = testing.random_flat_sd_from_spec(*testing.hidream_shape_spec(d),
                                          seed=29)
    x = _arrays(rng, (1, 8, 8, d.in_ch), (1, 6, d.t5_dim),
                (1, 5, d.llama_dim), (1, d.pooled))
    return sd, d.config(), x + (t(0.4),), ("double_stream_blocks",
                                           "single_stream_blocks")


ARCHS = ("qwen_image", "wan", "aura", "cosmos", "hyvid", "lumina2", "sd3",
         "flux", "hidream")


def _reference(arch, sd, cfg, x, i8=False):
    sharded = getattr(jtp, f"shard_{arch}_params")(sd, cfg, TP, Q.Q8_0)
    keys = (jtp.lumina2_tp_block_keys(sharded) if arch == "lumina2"
            else _case_keys[arch])
    if i8:
        sharded = ji8.convert_tree_i8(sharded)
    mesh = _jmesh()
    sharded = jtp.place_tp_params(sharded, mesh, keys)
    fwd = getattr(jtp, f"tp_{arch}_forward")
    return np.asarray(jax.jit(lambda p, *a: fwd(
        p, cfg, *a, mesh=mesh, qcfg=JF32))(sharded, *map(jnp.asarray, x)),
        np.float32)


_case_keys = {}


def _port(ranks, arch, sd, cfg, x, i8=False):
    sharded = getattr(tp_spec, f"shard_{arch}_params")(sd, cfg, TP, Q.Q8_0)
    keys = (tp_spec.lumina2_tp_block_keys(sharded) if arch == "lumina2"
            else _case_keys[arch])
    outs = ranks.run(jobs.tp_forward, f"tp_{arch}_forward", sharded, cfg,
                     tuple(torch.from_numpy(np.asarray(a)) for a in x), keys,
                     F32, i8)
    assert np.array_equal(outs[0][0], outs[1][0])  # replicated
    return outs[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_matches_reference(ranks, arch):
    sd, cfg, x, keys = _case(arch)
    _case_keys[arch] = keys
    got, stats = _port(ranks, arch, sd, cfg, x)
    want = _reference(arch, sd, cfg, x)
    assert got.shape == want.shape
    assert _rel(got, want) < ARCH_TOL.get(arch, TOL), _rel(got, want)
    assert stats["calls"] > 0 and stats["staged_bytes"] == 0  # CPU: gloo


def test_tp_qwen_image_i8_matches_reference_tp_tree(ranks):
    """The w8a8 TP tree: per-shard int8 weights (their own column scales)
    and per-rank activation codes of each K chunk, against the
    reference's TP tree; both sit within the w8a8 noise of the unsharded
    tree."""
    sd, cfg, x, keys = _case("qwen_image")
    _case_keys["qwen_image"] = keys
    got, _ = _port(ranks, "qwen_image", sd, cfg, x, i8=True)
    want = _reference("qwen_image", sd, cfg, x, i8=True)
    assert _rel(got, want) < I8_TOL, _rel(got, want)
    plain, _ = _port(ranks, "qwen_image", sd, cfg, x)
    assert 1e-4 < _rel(got, plain) < 5e-2


def test_shard_packed_params_equals_shard_stacked_params():
    """Sharding an already packed stacked tree on its device gives the
    shards ``shard_stacked_params`` builds from the state dict."""
    from comfyui_gguf_tpu_torch.models import flux
    from comfyui_gguf_tpu_torch.quant.planar import (TPNormShard, TPShard,
                                                    shard_view)

    sd, cfg, _, keys = _case("flux")
    rules = tp_spec.flux_rules(cfg.hidden)
    groups = [("double_blocks", cfg.depth_double),
              ("single_blocks", cfg.depth_single)]
    flat = tp_spec.quantize_unsharded(sd, block_groups=groups, rules=rules,
                                      qtype=Q.Q8_0)
    stacked = flux.stack_flux_params(flat, cfg)
    want = tp_spec.shard_flux_params(sd, cfg, TP, Q.Q8_0)
    for r in range(TP):
        got = tp_spec.shard_packed_params(stacked, block_keys=keys,
                                          rules=rules, tp=TP, index=r)
        for key in keys:
            for s, leaf in got[key].items():
                w = shard_view(want[key][s], r)
                assert not isinstance(leaf, TPNormShard)
                if isinstance(leaf, TPShard):
                    assert torch.equal(leaf.inner.qs, w.inner.qs), s
                    assert torch.equal(leaf.inner.scales, w.inner.scales), s
                else:
                    assert torch.equal(leaf.to(torch.float32),
                                       w.to(torch.float32)), s


@pytest.mark.parametrize("arch,dims_name,tp", [
    ("qwen_image", "QWEN_IMAGE_20B_DIMS", 2), ("hidream", "HIDREAM_I1_DIMS",
                                               2),
    ("wan", "WAN_14B_DIMS", 4), ("flux", "FLUX_DEV_DIMS", 1)])
def test_i8_plan_report_matches_reference(arch, dims_name, tp):
    """The byte plan from the port's own padding and int8 footprint,
    dict for dict the reference's."""
    dims = getattr(testing, dims_name)
    jdims = getattr(jtesting, dims_name)
    spec = getattr(testing, f"{arch}_shape_spec")(dims)[1]
    jspec = getattr(jtesting, f"{arch}_shape_spec")(jdims)[1]
    rules = {"qwen_image": lambda: tp_spec.qwen_image_rules(),
             "hidream": lambda: tp_spec.hidream_rules(dims.n_experts),
             "wan": lambda: tp_spec.wan_rules(),
             "flux": lambda: tp_spec.flux_rules(dims.hidden)}[arch]()
    jrules = {"qwen_image": lambda: jtp.qwen_image_rules(),
              "hidream": lambda: jtp.hidream_rules(jdims.n_experts),
              "wan": lambda: jtp.wan_rules(),
              "flux": lambda: jtp.flux_rules(jdims.hidden)}[arch]()
    for qt in (Q.Q4_K, Q.Q8_0):
        assert (tp_spec.i8_plan_report(spec, rules, tp, qt)
                == jtp.i8_plan_report(jspec, jrules, tp, qt))


def test_shard_rule_validation():
    from comfyui_gguf_tpu_torch.nn.layers import linear
    from comfyui_gguf_tpu_torch.quant.planar import TPShard

    with pytest.raises(ValueError, match="equal division|divisible"):
        tp_spec._split_dense(np.zeros((6, 4), np.float32), 4)
    with pytest.raises(ValueError, match="TPShard mode"):
        linear(torch.zeros(2, 8), TPShard(torch.zeros(4, 8), "bogus"))
    cfg = dataclasses.replace(_case("hidream")[1], n_heads=5)
    with pytest.raises(ValueError, match="n_heads % tp"):
        tp_spec.shard_hidream_params({}, cfg, 2, Q.Q8_0)


def test_tp_hidream_from_real_gguf(ranks, tmp_path):
    """A quantized GGUF through the loader: the sharder splits the file's
    own packed blocks (per-expert leaves too), and the TP forward equals
    the unsharded load of the same file."""
    from comfyui_gguf_tpu_torch import loader as L
    from comfyui_gguf_tpu_torch.gguf.writer import GGUFWriter
    from comfyui_gguf_tpu_torch.models import hidream
    from comfyui_gguf_tpu_torch.quant import codecs

    sd, cfg, x, keys = _case("hidream")
    rules = tp_spec.hidream_rules(cfg.n_experts)
    w = GGUFWriter("hidream")
    for k, v in sd.items():
        suffix = (k.split(".", 2)[2] if k.startswith(
            ("double_stream_blocks.", "single_stream_blocks.")) else None)
        if suffix in rules:
            w.add_tensor("model.diffusion_model." + k,
                         codecs.quantize(np.asarray(v, np.float32), Q.Q4_K),
                         raw_dtype=Q.Q4_K, raw_shape=v.shape)
        else:
            w.add_tensor("model.diffusion_model." + k,
                         np.asarray(v, np.float32))
    p = tmp_path / "hid.gguf"
    w.write_to_file(str(p))
    sd_qt = L.gguf_sd_loader(str(p))
    xt = tuple(torch.from_numpy(np.asarray(a)) for a in x)
    want = hidream.forward(L.to_torch_params(sd_qt, device="cpu"), cfg, *xt,
                           qcfg=F32).numpy()
    sharded = tp_spec.shard_hidream_params(sd_qt, cfg, TP, Q.Q4_K)
    outs = ranks.run(jobs.tp_forward, "tp_hidream_forward", sharded, cfg,
                     xt, keys, F32)
    assert _rel(outs[0][0], want) < TOL


def _engine_requests(arch, cfg):
    rng = np.random.default_rng(24)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    from comfyui_gguf_tpu_torch.sampling import linear_schedule

    if arch == "qwen_image":
        mk = lambda i: (a(16, cfg.in_channels),  # noqa: E731
                        {"txt": a(8, cfg.context_dim)})
        args = (4, 4, 8)
    elif arch == "wan":
        mk = lambda i: (a(2, 8, 8, cfg.in_channels),  # noqa: E731
                        {"ctx": a(6, cfg.text_dim), "nctx": a(6, cfg.text_dim),
                         "cfg_scale": np.float32(3.0 - 2 * i)})
        args = ()
    elif arch == "hyvid":
        mk = lambda i: (a(2, 4, 4, cfg.in_channels),  # noqa: E731
                        {"txt": a(6, cfg.text_dim),
                         "guidance": np.float32(6.0 - 5 * i)})
        args = ()
    else:
        mk = lambda i: (a(8, 8, cfg.in_channels),  # noqa: E731
                        {"t5": a(6, 64), "llama": a(5, 96), "pooled": a(48)})
        args = ()
    return [(*mk(i), linear_schedule(2 + i)) for i in range(2)], args


@pytest.mark.parametrize("arch", ["qwen_image", "wan", "hyvid", "hidream"])
def test_engine_tp_mesh_matches_reference(ranks, arch):
    """``{arch}_engine(mesh=tp2)`` on every rank with the same
    submissions (a mixed-progress pool) against the reference's engine
    over its TP forward: within the engines' 1e-2."""
    from comfyui_gguf_tpu import pipeline as jpipeline
    from comfyui_gguf_tpu_torch import pipeline

    sd, cfg, _, keys = _case(arch)
    _case_keys[arch] = keys
    reqs, args = _engine_requests(arch, cfg)
    sharded = getattr(tp_spec, f"shard_{arch}_params")(sd, cfg, TP, Q.Q8_0)
    model = pipeline.DiffusionModel(arch=arch, params=None, config=cfg,
                                    qcfg=F32, device=torch.device("cpu"))
    outs = ranks.run(jobs.engine, f"{arch}_engine", model, reqs,
                     {"tp": True, "args": args, "max_batch": 2}, sharded,
                     keys)
    mesh = _jmesh()
    jmodel = jpipeline.DiffusionModel(
        arch=arch, params=jtp.place_tp_params(
            getattr(jtp, f"shard_{arch}_params")(sd, cfg, TP, Q.Q8_0), mesh,
            keys), config=cfg, qcfg=JF32)
    eng = getattr(jpipeline, f"{arch}_engine")(jmodel, *args, max_batch=2,
                                               mesh=mesh)
    rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
    eng.run_until_drained()
    for a, b in zip(outs[0], outs[1]):
        assert np.array_equal(a, b)
    for got, r in zip(outs[0], rs):
        assert _rel(got, np.asarray(r.result, np.float32)) < 1e-2
