"""The port's SD3/SD3.5 MMDiT (``models/sd3.py``) against the reference.

Three tiny variants — sd3.5-large-like (per-head qk-norm), sd3.5-medium-like
(a dual-attention prefix of two blocks) and sd3-medium-like (no qk-norm) —
are written as Q4_K GGUFs by the port's writer and loaded by both packages.
The reference's ``tests/test_sd3.py`` runs on the port: config detection,
the forward on a quantized and a dense tree, the centre crop of the
position grid, stacked equal to unrolled (the dual prefix as its own group,
a non-contiguous dual layout refused), and the seed-made stacked builder.
Beside them, each forward is held against the reference's (plain XLA path)
on the same numpy inputs: flat, stacked (the port's stacking and the
reference's stacked tree carried across with ``interop.params_from_numpy``)
and after the w8a8 conversion. Tolerances (relative L2): 1e-4 with f32
compute; 2e-2 with bf16 compute (bf16 rounding points differ between the
packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import sd3 as jsd3
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import sd3, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
from comfyui_gguf_tpu_torch.quant.i8 import convert_tree_i8, is_modulation_key

torch.set_num_threads(2)

# hidden 256 so every block linear quantizes in Q4_K (K a multiple of 256)
VARIANTS = {
    "large": testing.TinySD3Dims(hidden=256, heads=4, depth=3, ctx_dim=64,
                                 pooled=32, pos_max=8),
    "medium": testing.TinySD3Dims(hidden=256, heads=4, depth=4, ctx_dim=64,
                                  pooled=32, pos_max=8, dual_prefix=2),
    "sd3": testing.TinySD3Dims(hidden=256, heads=4, depth=3, ctx_dim=64,
                               pooled=32, pos_max=8, qk_norm=False),
}
B, H_LAT, W_LAT, CTX_LEN = 2, 8, 8, 7
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def write_tiny_sd3(dims, path, qtype=Q.Q4_K, seed=0):
    sd = testing.sd3_flat_state_dict(dims, seed=seed)
    testing.write_gguf(sd, path,
                       lambda k, v: testing.sd3_block_qtype(k, v, qtype),
                       "sd3")
    return sd


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """variant → (reference tree, port tree, port config, reference config,
    GGUF path), both trees loaded from the same Q4_K file."""
    out = {}
    for name, dims in VARIANTS.items():
        path = str(tmp_path_factory.mktemp("sd3") / f"tiny_{name}.gguf")
        write_tiny_sd3(dims, path)
        jp = to_jax_params(j_sd_loader(path))
        model = load_diffusion_model(path, device="cpu")
        out[name] = (jp, model.params, model.config,
                     jsd3.SD3Config.from_state_dict(jp), path)
    return out


def _inputs(dims, np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, H_LAT, W_LAT, dims.in_ch))
    ctx = rng.standard_normal((B, CTX_LEN, dims.ctx_dim))
    pooled = rng.standard_normal((B, dims.pooled))
    t = np.asarray([1.0, 0.4], np.float32)
    jx = [jnp.asarray(a, np_dtype) for a in (lat, ctx, pooled)]
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (lat, ctx, pooled)]
    return jx + [jnp.asarray(t)], tx + [torch.from_numpy(t)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_config_detection(trees, variant):
    jp, tp, cfg, jcfg, path = trees[variant]
    dims = VARIANTS[variant]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg == dims.config()
    assert cfg.dual_attn_layers == tuple(range(dims.dual_prefix))
    model = load_diffusion_model(path, device="cpu")
    assert model.arch == "sd3" and not model.is_stacked


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_stacked_match_reference(trees, variant, mode):
    jp, tp, cfg, jcfg, _ = trees[variant]
    qcfg, jqcfg, np_dtype, tol = mode
    jx, tx = _inputs(VARIANTS[variant], np_dtype)
    want = np.asarray(jsd3.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = sd3.forward(tp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert got.shape == want.shape == (B, H_LAT, W_LAT, 16)
    assert _rel_l2(got, want) < tol

    sp = sd3.stack_sd3_params(tp, cfg)
    assert ("joint_blocks_dual" in sp) == (variant == "medium")
    got_s = sd3.forward_stacked(sp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert _rel_l2(got_s, want) < tol
    if mode is F32:
        # the reference's own stacked tree, carried across as numpy
        jsp = jax.tree.map(np.asarray, jsd3.stack_sd3_params(jp, jcfg))
        got_c = sd3.forward_stacked(params_from_numpy(jsp, "cpu"), cfg, *tx,
                                    qcfg=qcfg)
        assert _rel_l2(got_c.numpy(), want) < tol


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
def test_w8a8_forward_matches_reference(trees, mode):
    """After the w8a8 conversion (modulations kept planar) on both sides,
    the medium-like variant (dual prefix): flat and stacked."""
    jp, tp, cfg, jcfg, _ = trees["medium"]
    qcfg, jqcfg, np_dtype, tol = mode
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not is_modulation_key(k))
    tp = convert_tree_i8(tp, pred=lambda k, v: not is_modulation_key(k))
    jx, tx = _inputs(VARIANTS["medium"], np_dtype, seed=6)
    want = np.asarray(jsd3.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = sd3.forward(tp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert _rel_l2(got, want) < tol
    got_s = sd3.forward_stacked(sd3.stack_sd3_params(tp, cfg), cfg, *tx,
                                qcfg=qcfg).float().numpy()
    assert _rel_l2(got_s, want) < tol


def test_quantized_close_to_dense(tmp_path):
    """The reference's check: a Q8_0 file's forward within cosine 0.995 of
    the float file's (the port's forward on both)."""
    dims = VARIANTS["large"]
    outs = []
    for qtype in (None, Q.Q8_0):
        path = str(tmp_path / f"sd3_{qtype}.gguf")
        sd = testing.sd3_flat_state_dict(dims, seed=0)
        testing.write_gguf(
            sd, path, lambda k, v: None if qtype is None
            else testing.sd3_block_qtype(k, v, qtype), "sd3")
        m = load_diffusion_model(path, device="cpu")
        _, tx = _inputs(dims, np.float32)
        outs.append(sd3.forward(m.params, m.config, *tx,
                                qcfg=F32[0]).numpy().ravel())
    a, b = outs
    assert np.isfinite(a).all()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    assert cos > 0.995, cos


def test_pos_embed_crop_center():
    rng = np.random.default_rng(1)
    m = 8
    pe = rng.standard_normal((1, m * m, 4)).astype(np.float32)
    cfg = sd3.SD3Config(hidden=4, depth=1, n_heads=1, pos_embed_max=m)
    jcfg = jsd3.SD3Config(hidden=4, depth=1, n_heads=1, pos_embed_max=m)
    for h, w in ((4, 4), (2, 6), (8, 8)):
        crop = sd3.cropped_pos_embed({"pos_embed": torch.from_numpy(pe)},
                                     cfg, h, w).numpy()
        want = np.asarray(jsd3.cropped_pos_embed(
            {"pos_embed": jnp.asarray(pe)}, jcfg, h, w))
        np.testing.assert_array_equal(crop, want)
    grid = pe.reshape(m, m, 4)
    np.testing.assert_array_equal(
        sd3.cropped_pos_embed({"pos_embed": torch.from_numpy(pe[0])}, cfg,
                              4, 4).numpy(),
        grid[2:6, 2:6].reshape(1, 16, 4))


def test_non_contiguous_dual_layout_refuses_to_stack():
    dims = VARIANTS["large"]
    sd = testing.sd3_flat_state_dict(
        dataclasses.replace(dims, dual_prefix=2), seed=3)
    # move the dual attention from block 0 to block 1: layers (1,) only
    for k in [k for k in sd if k.startswith("joint_blocks.0.x_block.attn2")]:
        del sd[k]
    n = 6 * dims.hidden
    sd["joint_blocks.0.x_block.adaLN_modulation.1.weight"] = sd[
        "joint_blocks.0.x_block.adaLN_modulation.1.weight"][:n]
    sd["joint_blocks.0.x_block.adaLN_modulation.1.bias"] = sd[
        "joint_blocks.0.x_block.adaLN_modulation.1.bias"][:n]
    params = params_from_numpy(sd, "cpu")
    cfg = sd3.SD3Config.from_state_dict(params)
    assert cfg.dual_attn_layers == (1,)
    with pytest.raises(ValueError, match="contiguous"):
        sd3.stack_sd3_params(params, cfg)
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel

    model = DiffusionModel(arch="sd3", params=params, config=cfg,
                           qcfg=QuantConfig(), device=torch.device("cpu"))
    assert model.stack() is model  # stays on the unrolled forward
    _, tx = _inputs(dims, np.float32)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    want = jsd3.forward(jp, jsd3.SD3Config.from_state_dict(jp),
                        *_inputs(dims, np.float32)[0], qcfg=F32[1])
    got = model.forward(*tx)
    assert _rel_l2(got.float().numpy(), np.asarray(want)) < 2e-2


def test_stacked_blocks_are_views(trees):
    _, tp, cfg, _, _ = trees["medium"]
    sp = sd3.stack_sd3_params(tp, cfg)
    for group in ("joint_blocks_dual", "joint_blocks"):
        view = sd3.block_view(sp[group], 0)
        for k, leaf in sp[group].items():
            parts = ([(view[k].qs, leaf.qs), (view[k].scales, leaf.scales)]
                     if hasattr(leaf, "qs") else [(view[k], leaf)])
            for v, s in parts:
                assert (v.untyped_storage().data_ptr()
                        == s.untyped_storage().data_ptr()), k


@pytest.mark.parametrize("dual_prefix", [0, 1])
def test_seed_made_builders_run(dual_prefix):
    """The direct-stacked builder feeds forward_stacked and the flat one
    forward (shape and finite), at the stacked layout of each variant."""
    dims = dataclasses.replace(testing.TinySD3Dims(depth=3),
                               dual_prefix=dual_prefix)
    cfg = dims.config()
    inputs = testing.sd3_example_inputs(dims, h_lat=8, w_lat=8, ctx_len=8,
                                        device="cpu")
    sp = testing.sd3_random_stacked_params(dims, seed=5, device="cpu")
    assert ("joint_blocks_dual" in sp) == bool(dual_prefix)
    out = sd3.forward_stacked(sp, cfg, *inputs)
    assert out.shape == inputs[0].shape
    assert bool(torch.isfinite(out.float()).all())
    flat = testing.sd3_random_quant_params(dims, seed=5, device="cpu")
    out = sd3.forward(flat, cfg, *inputs)
    assert bool(torch.isfinite(out.float()).all())
