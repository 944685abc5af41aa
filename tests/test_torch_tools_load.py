"""Every file the port's quantizer writes, loaded by both packages' entry
points on the CPU: the diffusion presets through ``load_diffusion_model``
and the text recipe through ``load_text_encoder``.

Both packages quantize the same source file (the bytes must be equal), then
each loads the result through its own loader. Every leaf must dequantize to
the same float32 values bit for bit, and one forward (flux) or encode (T5)
of the same inputs must agree within 2e-2 relative L2: the default
bfloat16 compute, whose rounding points are the same in both packages but
whose summation order is not (the tolerance ``test_torch_flux.py`` and
``test_torch_t5.py`` state for bf16 compute). Inputs are made from a seed
with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu.tools import convert as jconvert
from comfyui_gguf_tpu.tools import quantize as jquantize
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.pipeline import (load_diffusion_model,
                                             load_text_encoder)
from comfyui_gguf_tpu_torch.quant import planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.tools import convert, quantize

torch.set_num_threads(2)

TOL = 2e-2
IMAGE_FTYPES = [f for f in quantize._FTYPE_BY_NAME
                if f not in ("IQ4_NL", "IQ4_XS")]  # refused for image archs
TEXT_FTYPES = list(quantize._FTYPE_BY_NAME)
FLUX = dict(hidden=512, heads=4, ctx=256, vec=256, in_ch=16, depth_double=1,
            depth_single=1, axes_dim=(16, 56, 56))
T5 = testing.T5Dims(d_model=256, d_kv=32, n_heads=8, d_ff=512, n_layers=2,
                    vocab=64)


@pytest.fixture(autouse=True)
def _reference_numpy_codecs(monkeypatch):
    """The reference's numpy codecs define the bytes (its optional C++
    Q4_0 encoder rounds some near-ties differently; see
    test_torch_tools.py)."""
    from comfyui_gguf_tpu import native

    monkeypatch.setattr(native, "available",
                        lambda qtype, decode=False: False)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _f32(leaf):
    """A leaf of either package as float32 numpy (a planar leaf through its
    package's own dequantization)."""
    if isinstance(leaf, PlanarQuant):
        return planar.dequantize(leaf).numpy()
    if isinstance(leaf, jplanar.PlanarQuant):
        return np.asarray(jplanar.dequantize(leaf, jnp.float32))
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(jnp.asarray(leaf, jnp.float32))


def _same_leaves(got: dict, want: dict):
    """The port's tree and the reference's hold the same keys, and each
    leaf dequantizes to the same float32 values."""
    assert set(got) == set(want)
    for k, w in want.items():
        a, b = _f32(got[k]), _f32(w)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, k)


def _quantize_both(src, tmp_path, ftype):
    """Both packages' quantize_file on the same source, into two
    directories; the two files must be equal. Returns the port's."""
    outs = []
    for sub, mod in (("ref", jquantize), ("port", quantize)):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        outs.append(mod.quantize_file(src, str(d / f"m-{ftype}.gguf"),
                                      ftype))
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    return outs[1]


@pytest.fixture(scope="module")
def flux_bf16(tmp_path_factory):
    """A BFL-named flux checkpoint at width 512 converted to BF16 GGUF by
    both packages (the same bytes)."""
    tmp = tmp_path_factory.mktemp("flux")
    sd = testing.flux_state_dict(testing.TinyFluxDims(**FLUX), seed=5)
    src = str(tmp / "flux.safetensors")
    _safetensors.save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                           src)
    outs = [mod.convert_file(src, str(tmp / f"{sub}-BF16.gguf"),
                             use_bf16_base=True)
            for sub, mod in (("ref", jconvert), ("port", convert))]
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    return outs[1]


@pytest.mark.parametrize("ftype", IMAGE_FTYPES)
def test_every_image_preset_loads_and_runs_like_the_reference(
        tmp_path, flux_bf16, ftype):
    path = _quantize_both(flux_bf16, tmp_path, ftype)
    model = load_diffusion_model(path, "cpu")
    jmodel = jpipeline.load_diffusion_model(path, prefer_pallas=False)
    assert model.arch == jmodel.arch == "flux"
    _same_leaves(model.params, jmodel.params)
    assert (dataclasses.asdict(model.config)
            == dataclasses.asdict(jmodel.config))
    kw = dict(h_lat=8, w_lat=8, txt_len=8, seed=1)
    x = testing.flux_example_inputs(testing.TinyFluxDims(**FLUX),
                                    device="cpu", **kw)
    jx = jtesting.flux_example_inputs(jtesting.TinyFluxDims(**FLUX), **kw)
    with torch.no_grad():
        got = model.forward(*x).float().numpy()
    want = np.asarray(jnp.asarray(jmodel.forward(*jx), jnp.float32))
    assert got.shape == want.shape == tuple(x[0].shape)
    assert _rel_l2(got, want) < TOL, ftype


@pytest.fixture(scope="module")
def t5_f16(tmp_path_factory):
    """A llama.cpp-named T5 encoder (d_model 256, 2 layers) in F16."""
    path = str(tmp_path_factory.mktemp("t5") / "t5-F16.gguf")
    testing.write_t5_gguf(testing.t5_state_dict(T5, seed=3), path,
                          qtype=Q.F16)
    return path


@pytest.mark.parametrize("ftype", TEXT_FTYPES)
def test_every_text_preset_loads_and_encodes_like_the_reference(
        tmp_path, t5_f16, ftype):
    path = _quantize_both(t5_f16, tmp_path, ftype)
    enc = load_text_encoder(path, "cpu")
    jenc = jpipeline.load_text_encoder(path, prefer_pallas=False)
    assert enc.kind == jenc.kind == "t5"
    _same_leaves(enc.params, jenc.params)
    rng = np.random.default_rng(4)
    ids = rng.integers(3, T5.vocab, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 12:] = 0
    got = enc.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    want = jax.device_get(jenc.encode(jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape == (2, 24, T5.d_model)
    assert _rel_l2(got.float().numpy(), want) < TOL, ftype
