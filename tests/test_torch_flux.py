"""The port's flux denoise path as a whole, against the reference package.

A tiny flux (hidden 512 so every block weight planarizes, 4 heads of 128,
1 double + 1 single block, 16 image + 8 text tokens) is written as a Q4_K
GGUF and loaded by both packages. The port's ``forward`` and
``forward_stacked`` are held against the reference ``forward`` (plain XLA
path), on the planar tree and after the w8a8 conversion; a 2-step Euler
denoise runs through ``load_diffusion_model(device="cpu")``; and the stacked
forward is checked to read views, not copies. Tolerances: 1e-4 relative L2
with f32 compute, 2e-2 with bf16 compute (bf16 rounding points differ).
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
from comfyui_gguf_tpu.models import flux as jflux
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu.sampling import flow_match as jflow
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import flux, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
from comfyui_gguf_tpu_torch.quant.i8 import convert_tree_i8, is_modulation_key
from comfyui_gguf_tpu_torch.sampling import euler_sample, flux_schedule

torch.set_num_threads(2)

DIMS = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                            depth_single=1, axes_dim=(16, 56, 56))
B, H_LAT, W_LAT, TXT = 1, 8, 8, 8
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    sd = testing.flux_state_dict(DIMS, seed=0)
    path = str(tmp_path_factory.mktemp("flux") / "tiny_flux_q4k.gguf")
    testing.write_flux_gguf(
        sd, path, lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
    return path


@pytest.fixture(scope="module")
def trees(gguf_path):
    jp = to_jax_params(j_sd_loader(gguf_path))
    tp = to_torch_params(gguf_sd_loader(gguf_path), device="cpu")
    cfg = dataclasses.replace(flux.FluxConfig.from_state_dict(tp),
                              axes_dim=DIMS.axes_dim)
    jcfg = dataclasses.replace(jflux.FluxConfig.from_state_dict(jp),
                               axes_dim=DIMS.axes_dim)
    return jp, tp, cfg, jcfg


def _inputs(np_dtype, seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, H_LAT, W_LAT, DIMS.in_ch // 4))
    img = np.array(jflux.patchify(jnp.asarray(lat, np.float32)))
    img_ids = np.array(flux.make_img_ids(H_LAT // 2, W_LAT // 2, B))
    txt = rng.standard_normal((B, TXT, DIMS.ctx)).astype(np.float32)
    txt_ids = np.zeros((B, TXT, 3), np.int32)
    t = np.full((B,), 0.7, np.float32)
    y = rng.standard_normal((B, DIMS.vec)).astype(np.float32)
    g = np.full((B,), 4.0, np.float32)
    jx = [jnp.asarray(img, np_dtype), jnp.asarray(img_ids),
          jnp.asarray(txt, np_dtype), jnp.asarray(txt_ids), jnp.asarray(t),
          jnp.asarray(y, np_dtype), jnp.asarray(g)]
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    tx = [torch.from_numpy(img).to(tdt), torch.from_numpy(img_ids),
          torch.from_numpy(txt).to(tdt), torch.from_numpy(txt_ids),
          torch.from_numpy(t), torch.from_numpy(y).to(tdt),
          torch.from_numpy(g)]
    return jx, tx


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("w8a8", [False, True], ids=["planar", "w8a8"])
def test_forward_and_stacked_match_reference(trees, mode, w8a8):
    jp, tp, cfg, jcfg = trees
    qcfg, jqcfg, np_dtype, tol = mode
    if w8a8:
        jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not
                                 is_modulation_key(k))
        tp = convert_tree_i8(tp, pred=lambda k, v: not is_modulation_key(k))
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jflux.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = flux.forward(tp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert got.shape == want.shape == (B, 16, DIMS.in_ch)
    assert _rel_l2(got, want) < tol

    sp = flux.stack_flux_params(tp, cfg)
    got_s = flux.forward_stacked(sp, cfg, *tx, qcfg=qcfg).float().numpy()
    assert _rel_l2(got_s, want) < tol
    if mode is F32 and not w8a8:
        # the reference's own stacked tree, carried across as numpy
        jsp = jax.tree.map(np.asarray, jflux.stack_flux_params(jp, jcfg))
        got_c = flux.forward_stacked(params_from_numpy(jsp, "cpu"), cfg,
                                     *tx, qcfg=qcfg)
        assert _rel_l2(got_c.numpy(), want) < tol


def test_stacked_blocks_are_views(trees):
    _, tp, cfg, _ = trees
    sp = flux.stack_flux_params(tp, cfg)
    for group in ("double_blocks", "single_blocks"):
        stacked = sp[group]
        view = flux.block_view(stacked, 0)
        for k, leaf in stacked.items():
            parts = ([(view[k].qs, leaf.qs), (view[k].scales, leaf.scales)]
                     if hasattr(leaf, "qs") else [(view[k], leaf)])
            for v, s in parts:
                assert (v.untyped_storage().data_ptr()
                        == s.untyped_storage().data_ptr()), k


def test_euler_denoise_through_entry_point(gguf_path):
    model = load_diffusion_model(gguf_path, device="cpu")
    model.config = dataclasses.replace(model.config, axes_dim=DIMS.axes_dim)
    jmodel = jpipeline.load_diffusion_model(gguf_path, prefer_pallas=False)
    jmodel.config = dataclasses.replace(jmodel.config,
                                        axes_dim=DIMS.axes_dim)
    (jimg, jids, jtxt, jtids, _, jy, jg), (img, ids, txt, tids, _, y, g) = \
        _inputs("bfloat16", seed=3)
    sigmas = flux_schedule(2, img.shape[1])

    def vel(x, s):
        return model.forward(x, ids, txt, tids, s.expand(B), y, g)

    def jvel(x, s):
        return jmodel.forward(x, jids, jtxt, jtids, jnp.full((B,), s), jy,
                              jg)

    got = euler_sample(vel, img, sigmas)
    want = jflow.euler_sample(jvel, jimg, sigmas)
    assert got.shape == img.shape and bool(torch.isfinite(got).all())
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2
