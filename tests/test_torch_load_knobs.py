"""The loader knobs and environment switches of the reference, in the port.

* ``load_diffusion_model(path, dequant_dtype=, patch_dtype=)``: the
  reference's Advanced-loader string knobs map onto the same QuantConfig in
  both packages, and a tiny flux loaded with each value gives the same
  forward on the CPU (bf16 compute: 2e-2 relative L2, the flux parity
  tests' limit). The card takes every value too (its fused kernels have
  bfloat16, float16 and float32 instances); an unknown value is refused
  before any weight is read. The rank operands are rounded as the
  reference's kernels round them: to the dequant dtype in K1/K2
  (``_prep_lora``), to bfloat16 in the w8a8 kernel (``pallas_i8mm``).
* ``GGUF_TPU_SKIP_UNDECODABLE=1``: IQ1/IQ2/IQ3 tensors are skipped with a
  warning naming them; unset, one error names them all (the reference's
  ``tests/test_codecs.py``).
* ``GGUF_TPU_BF16_SCALES=1``: the loader stores bf16 scale planes, the
  same bits as the reference's loader under the same switch
  (``tests/test_planar.py``).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import flux as jflux
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGML_QUANT_SIZES
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.gguf.writer import GGUFWriter
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import flux, testing
from comfyui_gguf_tpu_torch.quant import codecs
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

torch.set_num_threads(2)

DIMS = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                            depth_single=1, axes_dim=(16, 56, 56))
B, H_LAT, W_LAT, TXT = 1, 8, 8, 8
KNOBS = [("default", "default"), ("target", "bfloat16"),
         ("float32", "default"), ("float16", "float32"),
         ("bfloat16", "float16")]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    sd = testing.flux_state_dict(DIMS, seed=0)
    path = str(tmp_path_factory.mktemp("flux") / "tiny_flux_q4k.gguf")
    testing.write_flux_gguf(
        sd, path, lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
    return path


def _inputs():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((B, H_LAT, W_LAT, DIMS.in_ch // 4))
    img = np.array(jflux.patchify(jnp.asarray(lat, np.float32)))
    img_ids = np.array(flux.make_img_ids(H_LAT // 2, W_LAT // 2, B))
    txt = rng.standard_normal((B, TXT, DIMS.ctx)).astype(np.float32)
    txt_ids = np.zeros((B, TXT, 3), np.int32)
    t = np.full((B,), 0.7, np.float32)
    y = rng.standard_normal((B, DIMS.vec)).astype(np.float32)
    g = np.full((B,), 4.0, np.float32)
    jx = [jnp.asarray(img, jnp.bfloat16), jnp.asarray(img_ids),
          jnp.asarray(txt, jnp.bfloat16), jnp.asarray(txt_ids),
          jnp.asarray(t), jnp.asarray(y, jnp.bfloat16), jnp.asarray(g)]
    tx = [torch.from_numpy(img).to(torch.bfloat16),
          torch.from_numpy(img_ids),
          torch.from_numpy(txt).to(torch.bfloat16),
          torch.from_numpy(txt_ids), torch.from_numpy(t),
          torch.from_numpy(y).to(torch.bfloat16), torch.from_numpy(g)]
    return jx, tx


def _tname(dt):
    return None if dt is None else str(dt).split(".")[-1]


def _jname(dt):
    return None if dt is None else jnp.dtype(dt).name


@pytest.mark.parametrize("dequant,patch", KNOBS, ids=str)
def test_dtype_knobs_match_reference(gguf_path, dequant, patch):
    jm = jpipeline.load_diffusion_model(gguf_path, dequant_dtype=dequant,
                                        patch_dtype=patch,
                                        prefer_pallas=False)
    tm = tpipeline.load_diffusion_model(gguf_path, device="cpu",
                                        dequant_dtype=dequant,
                                        patch_dtype=patch)
    for f in ("dequant_dtype", "patch_dtype", "compute_dtype"):
        assert _tname(getattr(tm.qcfg, f)) == _jname(getattr(jm.qcfg, f)), f
    # a linear kept dense by the loader carries the dequant dtype
    dense = [k for k, v in tm.params.items() if isinstance(v, torch.Tensor)
             and v.dim() == 2 and not k.endswith("scale")]
    for k in dense:
        assert str(tm.params[k].dtype).split(".")[-1] == str(
            jm.params[k].dtype), k
    jcfg = dataclasses.replace(jm.config, axes_dim=DIMS.axes_dim)
    tcfg = dataclasses.replace(tm.config, axes_dim=DIMS.axes_dim)
    jx, tx = _inputs()
    want = np.asarray(jflux.forward(jm.params, jcfg, *jx, qcfg=jm.qcfg),
                      np.float32)
    got = flux.forward(tm.params, tcfg, *tx, qcfg=tm.qcfg).float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel_l2(got, want) < 2e-2


@pytest.mark.parametrize("knob", [{"dequant_dtype": "float16"},
                                  {"dequant_dtype": "float32"},
                                  {"patch_dtype": "float32"},
                                  {"patch_dtype": "float16"}], ids=str)
def test_card_refuses_other_dtypes_before_loading(gguf_path, monkeypatch,
                                                  knob):
    """The card's kernels now compute in float16 and float32 as well as
    bfloat16, so the load takes these knob values on the card and goes on
    to read the file (the loader is replaced by one that fails); what it
    still refuses before the file is read: CUDA where there is no card, and
    a knob value the reference does not know."""
    def no_read(*a, **k):
        raise AssertionError("the file was read")

    monkeypatch.setattr(tpipeline, "gguf_sd_loader", no_read)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.load_diffusion_model(gguf_path, device="cuda", **knob)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(AssertionError, match="was read"):
        tpipeline.load_diffusion_model(gguf_path, device="cuda", **knob)
    bad = {k: "float8" for k in knob}
    with pytest.raises(ValueError, match="unknown dtype knob"):
        tpipeline.load_diffusion_model(gguf_path, device="cuda", **bad)


@pytest.mark.parametrize("which", ["dequant_dtype", "patch_dtype"])
@pytest.mark.parametrize("value", sorted(jpipeline._DTYPE_NAMES))
def test_card_takes_every_reference_knob(gguf_path, monkeypatch, which,
                                         value):
    """Every value of the reference's ``_DTYPE_NAMES``, for either knob,
    passes the card's load and reaches the file, and resolves to the dtype
    the reference resolves it to."""
    def no_read(*a, **k):
        raise AssertionError("the file was read")

    monkeypatch.setattr(tpipeline, "gguf_sd_loader", no_read)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(AssertionError, match="was read"):
        tpipeline.load_diffusion_model(gguf_path, device="cuda",
                                       **{which: value})
    tq = tpipeline._resolve_qcfg(**{which: value})
    jq = jpipeline._resolve_qcfg(**{which: value})
    for f in ("dequant_dtype", "patch_dtype"):
        assert _tname(getattr(tq, f)) == _jname(getattr(jq, f)), f


@pytest.mark.parametrize("dt", [torch.float16, torch.float32],
                         ids=["f16", "f32"])
def test_i8mm_wrapper_rounds_rank_operands_to_bf16(monkeypatch, dt):
    """The K4 wrapper hands its kernel bf16 rank operands whatever their
    dtype, the values the reference's ``pallas_i8mm`` rounds them to
    (``_prep_lora(..., jnp.bfloat16)``); the launch itself is replaced, so
    this runs on the CPU."""
    from comfyui_gguf_tpu.ops import qmatmul as jqmm
    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.ops import i8mm as ti8mm
    from comfyui_gguf_tpu_torch.quant.i8 import I8Planar

    rng = np.random.default_rng(4)
    M, K, R, r = 5, 256, 256, 12
    seen = {}
    real = ti8mm.prep_lora

    def spy(*a, **k):
        seen["out"] = real(*a, **k)
        return seen["out"]

    class FakeLib:
        def i8mm_lora_launch(self, *a):
            return 0

    monkeypatch.setattr(ti8mm, "prep_lora", spy)
    monkeypatch.setattr(_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 0)
    ip = I8Planar(qs=torch.zeros((R, K), dtype=torch.int8),
                  scales=torch.ones((1, R)), qtype=Q.Q8_0, shape=(R, K))
    h = rng.standard_normal((M, r)).astype(np.float32) / 3
    up = rng.standard_normal((r, R)).astype(np.float32) / 3
    ti8mm.i8mm_cuda_q(torch.zeros((M, K), dtype=torch.int8),
                      torch.ones((M, 1)), ip,
                      lora_h=torch.from_numpy(h).to(dt),
                      lora_up=torch.from_numpy(up).to(dt))
    th, tup, rk = seen["out"]
    assert th.dtype == tup.dtype == torch.bfloat16 and rk == 16
    jh, jup = jqmm._prep_lora(jnp.asarray(np.asarray(torch.from_numpy(h).to(
        dt).float())), jnp.asarray(np.asarray(torch.from_numpy(up).to(
            dt).float())), M, R, jnp.bfloat16)
    np.testing.assert_array_equal(th[:, :r].float().numpy(),
                                  np.asarray(jh, np.float32)[:, :r])
    np.testing.assert_array_equal(tup[:, :r].float().numpy(),
                                  np.asarray(jup, np.float32)[:r].T)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                torch.float32], ids=["bf16", "f16", "f32"])
def test_qmm_rank_operands_take_the_dequant_dtype(dt):
    """K1/K2's rank operands are rounded to the dequant dtype, the kernel's
    operand type, as the reference's ``pallas_qmm`` rounds them
    (``_prep_lora(..., dequant_dtype)``), whatever the patch dtype gave."""
    from comfyui_gguf_tpu.ops import qmatmul as jqmm
    from comfyui_gguf_tpu_torch.ops.qmatmul import prep_lora

    rng = np.random.default_rng(5)
    M, R, r = 7, 384, 20
    h = rng.standard_normal((M, r)).astype(np.float32)
    up = rng.standard_normal((r, R)).astype(np.float32)
    th, tup, rk = prep_lora(torch.from_numpy(h), torch.from_numpy(up), M, R,
                            R, dt)
    assert th.dtype == tup.dtype == dt and rk == 32
    assert th.shape == (M, rk) and tup.shape == (R, rk)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dt]
    jh, jup = jqmm._prep_lora(jnp.asarray(h), jnp.asarray(up), M, R, jdt)
    np.testing.assert_array_equal(th[:, :r].float().numpy(),
                                  np.asarray(jh, np.float32)[:, :r])
    np.testing.assert_array_equal(tup[:, :r].float().numpy(),
                                  np.asarray(jup, np.float32)[:r].T)
    assert not th[:, r:].any() and not tup[:, r:].any()


def test_unknown_dtype_knob_raises(gguf_path):
    with pytest.raises(ValueError, match="unknown dtype knob"):
        tpipeline.load_diffusion_model(gguf_path, device="cpu",
                                       dequant_dtype="float8")


def _iq2_file(tmp_path):
    block, type_size = GGML_QUANT_SIZES[Q.IQ2_XS]
    pre = "model.diffusion_model."
    w = GGUFWriter("flux")
    w.add_tensor(pre + "double_blocks.0.img_attn.proj.weight",
                 np.zeros((2, type_size), np.uint8), raw_dtype=Q.IQ2_XS,
                 raw_shape=(2, block))
    w.add_tensor(pre + "double_blocks.0.img_attn.qkv.weight",
                 np.zeros((2, type_size), np.uint8), raw_dtype=Q.IQ2_XS,
                 raw_shape=(2, block))
    w.add_tensor(pre + "img_in.weight", np.zeros((4, 8), np.float32))
    p = tmp_path / "iq2.gguf"
    w.write_to_file(str(p))
    return str(p)


def test_skip_undecodable(tmp_path, monkeypatch, caplog):
    """The reference's ``test_codecs.py`` case: two blocked tensors fail
    with ONE error naming both and the switch; with
    ``GGUF_TPU_SKIP_UNDECODABLE=1`` the rest loads, with a warning naming
    them, exactly as the reference loads it."""
    path = _iq2_file(tmp_path)
    monkeypatch.delenv("GGUF_TPU_SKIP_UNDECODABLE", raising=False)
    with pytest.raises(codecs.MissingCodebookError) as ei:
        gguf_sd_loader(path)
    msg = str(ei.value)
    assert "img_attn.proj.weight" in msg and "img_attn.qkv.weight" in msg
    assert "2 tensor(s)" in msg and "GGUF_TPU_SKIP_UNDECODABLE" in msg
    monkeypatch.setenv("GGUF_TPU_SKIP_UNDECODABLE", "0")
    with pytest.raises(codecs.MissingCodebookError):
        gguf_sd_loader(path)

    monkeypatch.setenv("GGUF_TPU_SKIP_UNDECODABLE", "1")
    with caplog.at_level(logging.WARNING):
        sd = gguf_sd_loader(path)
    assert list(sd) == ["img_in.weight"] == list(j_sd_loader(path))
    warned = " ".join(r.getMessage() for r in caplog.records)
    assert "img_attn.proj.weight" in warned and "qkv.weight" in warned


def test_bf16_scales_env_routes_the_loader(gguf_path, monkeypatch):
    """``GGUF_TPU_BF16_SCALES=1``: every planar leaf holds bf16 scale (and
    offset) planes, the reference loader's bits under the same switch;
    unset, float32 as before."""
    tp = to_torch_params(gguf_sd_loader(gguf_path), device="cpu")
    key = "double_blocks.0.img_attn.qkv.weight"
    assert tp[key].scales.dtype == torch.float32
    monkeypatch.setenv("GGUF_TPU_BF16_SCALES", "1")
    tp = to_torch_params(gguf_sd_loader(gguf_path), device="cpu")
    jp = to_jax_params(j_sd_loader(gguf_path))
    n = 0
    for k, v in tp.items():
        if isinstance(v, PlanarQuant):
            n += 1
            assert v.scales.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                v.scales.view(torch.int16).numpy(),
                np.asarray(jp[k].scales).view(np.int16))
            if v.offsets is not None:
                assert v.offsets.dtype == torch.bfloat16
    assert n == 13
