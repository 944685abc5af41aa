"""The port's T5 encoder against the reference's, on the CPU.

One numpy state dict (``models.testing.t5_state_dict``) and one set of ids
and masks feed both packages. Tolerances, relative L2 of the final hidden
states:

* float32 compute, dense weights: 1e-4 (summation order only);
* the default bfloat16 compute: 2e-2 (both round to bf16 after every
  linear and norm, at the same places, but a different summation order
  moves a value across a rounding boundary now and then, and 2 layers of
  un-normalised residuals carry that on);
* Q8_0 planar weights (the layout a T5 GGUF loads to), float32
  activations: 1e-3, each side through its own fused-matmul plain path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu.models import t5 as jt5
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import codecs as jcodecs
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import t5 as tt5
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig as TQuantConfig
from comfyui_gguf_tpu_torch.quant import planar as tplanar

torch.set_num_threads(2)

JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TF32 = TQuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
DIMS = testing.T5Dims(d_model=64, d_kv=16, n_heads=4, d_ff=128, n_layers=2,
                      vocab=40)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ids(seed, B=2, L=24, vocab=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 2:] = 0
    ids[1, L // 2:] = 0
    return ids, mask


def test_config_from_state_dict_matches():
    sd = testing.t5_state_dict(DIMS)
    a = tt5.T5Config.from_state_dict(sd)
    b = jt5.T5Config.from_state_dict(sd)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.d_model, a.d_kv, a.n_heads, a.d_ff, a.n_layers,
            a.vocab_size) == (64, 16, 4, 128, 2, 40)


@pytest.mark.parametrize("buckets,maxd", [(32, 128), (16, 64)])
def test_relative_position_bucket_matches(buckets, maxd):
    rel = np.arange(-300, 301, dtype=np.int32)[None, :] \
        - np.arange(0, 3, dtype=np.int32)[:, None]
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel),
                                                   buckets, maxd))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), buckets,
                                       maxd).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_encode_f32_matches(with_mask):
    sd = testing.t5_state_dict(DIMS, seed=1)
    ids, mask = _ids(2)
    cfg_j = jt5.T5Config.from_state_dict(sd)
    want = np.asarray(jt5.encode(
        {k: jnp.asarray(v) for k, v in sd.items()}, cfg_j, jnp.asarray(ids),
        jnp.asarray(mask) if with_mask else None, qcfg=JF32,
        dtype=jnp.float32))
    with torch.no_grad():
        got = tt5.encode(
            params_from_numpy(sd, device="cpu"),
            tt5.T5Config.from_state_dict(sd), torch.from_numpy(ids),
            torch.from_numpy(mask) if with_mask else None, qcfg=TF32,
            dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, 24, 64)
    assert _rel(got, want) <= 1e-4


def test_encode_bf16_default_matches():
    sd = testing.t5_state_dict(DIMS, seed=3)
    ids, mask = _ids(4)
    want = np.asarray(jt5.encode(
        {k: jnp.asarray(v) for k, v in sd.items()},
        jt5.T5Config.from_state_dict(sd), jnp.asarray(ids),
        jnp.asarray(mask), qcfg=JQuantConfig(prefer_pallas=False)
    ).astype(jnp.float32))
    got = tt5.encode(params_from_numpy(sd, device="cpu"),
                     tt5.T5Config.from_state_dict(sd), torch.from_numpy(ids),
                     torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_encode_q8_0_planar_matches():
    """Weights as a Q8_0 GGUF loads them: planar packed linears (K = 512,
    so the loader keeps them packed) and a packed token table."""
    dims = testing.T5Dims(d_model=512, d_kv=64, n_heads=8, d_ff=512,
                          n_layers=1, vocab=48)
    sd = testing.t5_state_dict(dims, seed=5)
    ids, mask = _ids(6, L=16, vocab=48)
    jp, tp = {}, {}
    for k, v in sd.items():
        if v.ndim == 2 and "relative_attention_bias" not in k:
            raw = jcodecs.quantize(v, Q.Q8_0)
            jp[k] = jplanar.planarize(raw, Q.Q8_0, v.shape)
            tp[k] = tplanar.planarize(raw, Q.Q8_0, v.shape)
        else:
            jp[k] = jnp.asarray(v)
            tp[k] = torch.from_numpy(v)
    want = np.asarray(jt5.encode(jp, jt5.T5Config.from_state_dict(sd),
                                 jnp.asarray(ids), jnp.asarray(mask),
                                 qcfg=JF32, dtype=jnp.float32))
    with torch.no_grad():
        got = tt5.encode(tp, tt5.T5Config.from_state_dict(sd),
                         torch.from_numpy(ids), torch.from_numpy(mask),
                         qcfg=TF32, dtype=torch.float32).numpy()
    assert _rel(got, want) <= 1e-3


def test_umt5_per_layer_bias_is_used():
    sd = testing.t5_state_dict(DIMS, seed=7)
    rng = np.random.default_rng(8)
    key1 = ("encoder.block.1.layer.0.SelfAttention."
            "relative_attention_bias.weight")
    sd[key1] = rng.standard_normal((32, 4)).astype(np.float32)
    ids, mask = _ids(9)
    want = np.asarray(jt5.encode(
        {k: jnp.asarray(v) for k, v in sd.items()},
        jt5.T5Config.from_state_dict(sd), jnp.asarray(ids),
        jnp.asarray(mask), qcfg=JF32, dtype=jnp.float32))
    with torch.no_grad():
        got = tt5.encode(params_from_numpy(sd, device="cpu"),
                         tt5.T5Config.from_state_dict(sd),
                         torch.from_numpy(ids), torch.from_numpy(mask),
                         qcfg=TF32, dtype=torch.float32).numpy()
    assert _rel(got, want) <= 1e-4
