"""The port's planar checkpoint cache (``checkpoint.py``) on the CPU.

The reference's three tests (``tests/test_checkpoint.py``) on the port,
plus: the port's int8 (w8a8) leaves round-trip in their own (Rp, Kp)
layout; a ``.npz`` the reference's ``save_params`` wrote (planar Q4_K and
Q8_0, int8, bf16 and f32 dense leaves of a tiny flux) loads in the port as
the same tree ``interop.params_from_numpy`` gives, value for value, and
gives the same flux forward; object leaves are refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import checkpoint as jcheckpoint
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import checkpoint
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.lifecycle import tree_leaves
from comfyui_gguf_tpu_torch.lora import LoRAPatch, PatchedWeight
from comfyui_gguf_tpu_torch.models import flux
from comfyui_gguf_tpu_torch.models.testing import random_planar
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar, requantize_i8
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant, dequantize

torch.set_num_threads(2)
CPU = "cpu"


def test_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {
        "blk.q": random_planar(Q.Q4_K, (64, 512), gen, device=CPU),
        "blk.q8": random_planar(Q.Q8_0, (64, 512), gen, device=CPU),
        "norm.weight": torch.randn(64, generator=gen),
        "big.bf16": torch.randn((8, 16), generator=gen).to(torch.bfloat16),
    }
    f = str(tmp_path / "m.npz")
    checkpoint.save_params(f, params)
    got = checkpoint.load_params(f, device=CPU)

    assert isinstance(got["blk.q"], PlanarQuant)
    torch.testing.assert_close(dequantize(got["blk.q"]),
                               dequantize(params["blk.q"]), rtol=0, atol=0)
    assert got["blk.q8"].layout == "int8" and got["blk.q8"].zero_point == 0
    assert got["blk.q"].shape == (64, 512)
    torch.testing.assert_close(got["norm.weight"], params["norm.weight"],
                               rtol=0, atol=0)
    assert got["big.bf16"].dtype == torch.bfloat16
    assert torch.equal(got["big.bf16"], params["big.bf16"])


def test_rejects_foreign_file(tmp_path):
    f = str(tmp_path / "x.npz")
    np.savez(f, a=np.zeros(3))
    with pytest.raises((ValueError, KeyError)):
        checkpoint.load_params(f, device=CPU)


def test_extensionless_path(tmp_path):
    params = {"w": torch.randn((4, 4), generator=torch.Generator()
                               .manual_seed(2))}
    p = str(tmp_path / "ckpt")  # no extension
    checkpoint.save_params(p, params)
    out = checkpoint.load_params(p, device=CPU)
    assert torch.equal(out["w"], params["w"])


def test_i8_roundtrip_keeps_the_port_layout(tmp_path):
    ip = requantize_i8(random_planar(Q.Q4_K, (200, 512),
                                     torch.Generator().manual_seed(3),
                                     device=CPU))
    f = str(tmp_path / "i8.npz")
    checkpoint.save_params(f, {"w": ip})
    got = checkpoint.load_params(f, device=CPU)["w"]
    assert isinstance(got, I8Planar) and got.shape == ip.shape
    assert torch.equal(got.qs, ip.qs) and torch.equal(got.scales, ip.scales)


def test_refuses_object_leaves(tmp_path):
    pq = random_planar(Q.Q4_K, (128, 512), torch.Generator().manual_seed(4),
                       device=CPU)
    patched = PatchedWeight(pq, (LoRAPatch(up=torch.ones(128, 2),
                                           down=torch.ones(2, 512),
                                           mid=None, diff=None, scale=1.0),))
    for leaf in (patched, {"nested": torch.ones(2)}):
        with pytest.raises(TypeError, match="not an array leaf"):
            checkpoint.save_params(str(tmp_path / "bad"), {"w": leaf})


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A tiny flux tree in the reference package (Q4_K planar blocks, the
    single blocks' linears converted to int8, bf16 and f32 dense leaves),
    written by the reference's save_params."""
    dims = jtesting.TinyFluxDims(hidden=256, heads=2, axes_dim=(16, 56, 56))
    jp = jtesting.quantize_flux_params(
        jtesting.flux_state_dict(dims, seed=0), qtype=JQ.Q4_K)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: k.startswith(
        "single_blocks."))
    jp["img_in.weight"] = jnp.asarray(jp["img_in.weight"], jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("ckpt") / "ref_flux.npz")
    jcheckpoint.save_params(path, jp)
    return path, jp, dims


def test_reference_file_loads_as_the_interop_tree(reference_file):
    path, jp, _ = reference_file
    got = checkpoint.load_params(path, device=CPU)
    want = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    assert got.keys() == want.keys()
    kinds = {type(v).__name__ for v in got.values()}
    assert {"PlanarQuant", "I8Planar", "Tensor"} <= kinds
    for k in want:
        assert type(got[k]) is type(want[k]), k
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want[k])):
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_reference_file_gives_the_same_forward(reference_file):
    path, jp, dims = reference_file
    got = checkpoint.load_params(path, device=CPU)
    want = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    cfg = flux.FluxConfig(**dataclasses.asdict(dims.config()))
    rng = np.random.default_rng(5)
    args = (torch.from_numpy(rng.standard_normal(
                (1, 16, dims.in_ch)).astype(np.float32)),
            torch.as_tensor(np.array(flux.make_img_ids(4, 4, 1))),
            torch.from_numpy(rng.standard_normal(
                (1, 8, dims.ctx)).astype(np.float32)),
            torch.zeros((1, 8, 3), dtype=torch.int32),
            torch.full((1,), 0.6), torch.from_numpy(rng.standard_normal(
                (1, dims.vec)).astype(np.float32)), torch.full((1,), 3.5))
    qcfg = QuantConfig(dequant_dtype=torch.float32,
                       compute_dtype=torch.float32)
    a = flux.forward(got, cfg, *args, qcfg=qcfg)
    b = flux.forward(want, cfg, *args, qcfg=qcfg)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
