"""Tiny flux with a LoRA on every block linear, stacked, against the
reference's Pallas kernels in interpret mode: the port's ``forward_stacked``
(plain versions on the CPU) against the reference's ``forward_stacked``
with ``prefer_pallas=True``, whose indexed kernels add the rank term in
their epilogues, planar Q4_K and after ``requantize_i8()``. Interpret mode
runs every Pallas grid step in Python: minutes, hence ``slow``. Tolerance
2e-2 relative L2 (bf16 compute; the Pallas kernels round the rank operands
to bf16 and accumulate in their own order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import lora as jlora
from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import flux as jflux
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import _safetensors, lora
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import flux, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8,
                                             is_modulation_key)

pytestmark = pytest.mark.slow

torch.set_num_threads(2)

DIMS = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                            depth_single=1, axes_dim=(16, 56, 56))


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("w8a8", [False, True], ids=["planar", "w8a8"])
def test_stacked_lora_matches_pallas_interpret(tmp_path, w8a8):
    gguf = str(tmp_path / "tiny_flux_q4k.gguf")
    testing.write_flux_gguf(
        testing.flux_state_dict(DIMS, seed=0), gguf,
        lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
    path = str(tmp_path / "lora.safetensors")
    _safetensors.save_file(testing.kohya_lora_state_dict(
        testing.flux_lora_targets(DIMS), rank=8, alpha=8.0, seed=4), path)
    jp = jlora.load_and_attach(to_jax_params(j_sd_loader(gguf)), path, 0.8)
    tp = lora.load_and_attach(
        to_torch_params(gguf_sd_loader(gguf), device="cpu"), path, 0.8)
    if w8a8:
        pred = lambda k, v: not is_modulation_key(k)  # noqa: E731
        jp = ji8.convert_tree_i8(jp, pred=pred)
        tp = convert_tree_i8(tp, pred=pred)
    cfg = dataclasses.replace(flux.FluxConfig.from_state_dict(tp),
                              axes_dim=DIMS.axes_dim)
    jcfg = dataclasses.replace(jflux.FluxConfig.from_state_dict(jp),
                               axes_dim=DIMS.axes_dim)
    inputs = testing.flux_example_inputs(DIMS, h_lat=8, w_lat=8, txt_len=8,
                                         seed=2, device="cpu")
    jin = [jnp.asarray(np.asarray(t.float() if t.is_floating_point()
                                  else t), jnp.bfloat16
                       if t.dtype == torch.bfloat16 else None)
           for t in inputs]
    want = jflux.forward_stacked(jflux.stack_flux_params(jp, jcfg), jcfg,
                                 *jin, qcfg=JQuantConfig(prefer_pallas=True))
    got = flux.forward_stacked(flux.stack_flux_params(tp, cfg), cfg,
                               *inputs, qcfg=QuantConfig())
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2
