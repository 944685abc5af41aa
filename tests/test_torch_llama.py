"""The port's llama-family text encoder (``models/llama.py``) and its
``load_text_encoder`` branch against the reference, on the CPU.

Tiny llama-family GGUFs are written by the port's writer
(``testing.write_llama_gguf``: llama.cpp names, the GQA row permutation of
a "llama" file, Q8_0 linears, gpt2-BPE tokenizer metadata) and loaded by
both packages. Checked: config inference; ``encode`` on the same ids in
float32 and Q8_0 (planar: hidden 512, so every linear is a packed leaf),
with GQA (32 heads, 8 kv heads), a padded mask and ``return_layers``; the
qwen3 variant (per-head q/k RMS norms, no permutation); Qwen-VL's M-RoPE
over 3-D ``position_ids`` and ``inputs_embeds``; ``load_text_encoder`` on
llama, qwen3 and qwen2vl files (tokenizer included); and
the llama slice of a kohya LoRA file through ``TextEncoder.apply_lora``.

Tolerance (relative L2): 1e-4 with float32 compute (the same products in
another order); 2e-2 with bfloat16 compute (bf16 rounding points differ
between the packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.loader import gguf_clip_loader as j_clip_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import llama as jllama
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import lora
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import llama, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.pipeline import load_text_encoder
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

torch.set_num_threads(2)

DIMS = testing.LlamaDims(hidden=512, n_layers=2, n_heads=32, n_kv_heads=8,
                         head_dim=16, intermediate=1024, vocab=300)
QWEN3 = dataclasses.replace(DIMS, n_kv_heads=32, qk_norm=True)
TF32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TOL_F32, TOL_BF16 = 1e-4, 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _write(path, dims, qtype, arch="llama", seed=0):
    testing.write_llama_gguf(testing.llama_state_dict(dims, seed=seed), path,
                             qtype=qtype, tokenizer=testing.bpe_spec(
                                 dims.vocab), arch=arch)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama")
    return {"f32": _write(d / "llama_f32.gguf", DIMS, Q.F32),
            "q8": _write(d / "llama_q8.gguf", DIMS, Q.Q8_0),
            "qwen3": _write(d / "qwen3_q8.gguf", QWEN3, Q.Q8_0, "qwen3", 1)}


def _both(path):
    """(reference params, port encoder) of one file."""
    sd, arch, _ = j_clip_loader(path)
    return to_jax_params(sd, JF32), load_text_encoder(path, device="cpu")


def _ids(seed=3, B=2, L=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, DIMS.vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0  # the second prompt is padded
    return ids, mask


def test_config_inference(files):
    jp, enc = _both(files["q8"])
    jcfg = jllama.LlamaConfig.from_state_dict(jp)
    assert enc.kind == "llama"
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jcfg)
    assert enc.config == DIMS.config()
    assert (enc.config.n_heads, enc.config.n_kv_heads,
            enc.config.head_dim) == (32, 8, 16)
    _, qenc = _both(files["qwen3"])
    assert qenc.config.qk_norm and qenc.config.n_kv_heads == 32


def test_gqa_permutation_round_trips(files):
    """The writer's llama.cpp permutation and the loader's un-permute give
    back the state dict's q and k rows."""
    sd = testing.llama_state_dict(DIMS, seed=0)
    enc = load_text_encoder(files["f32"], device="cpu")
    for key in ("model.layers.1.self_attn.q_proj.weight",
                "model.layers.1.self_attn.k_proj.weight"):
        np.testing.assert_array_equal(
            enc.params[key].float().numpy(), sd[key].astype(np.float32))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["f32", "q8", "qwen3"])
def test_encode_matches_reference(files, name, f32):
    jp, enc = _both(files[name])
    if name != "f32":  # the Q8_0 linears load as planar leaves
        assert isinstance(enc.params["model.layers.0.mlp.down_proj.weight"],
                          PlanarQuant)
    jcfg = jllama.LlamaConfig.from_state_dict(jp)
    ids, mask = _ids()
    jkw = dict(qcfg=JF32 if f32 else JQuantConfig(prefer_pallas=False),
               dtype=jnp.float32 if f32 else jnp.bfloat16)
    want = jllama.encode(jp, jcfg, jnp.asarray(ids),
                         mask=jnp.asarray(mask), return_layers=(0, 1), **jkw)
    got = llama.encode(enc.params, enc.config, torch.as_tensor(ids),
                       mask=torch.as_tensor(mask), return_layers=(0, 1),
                       qcfg=TF32 if f32 else QuantConfig(),
                       dtype=torch.float32 if f32 else torch.bfloat16)
    tol = TOL_F32 if f32 else TOL_BF16
    assert got["last_hidden"].shape == (2, 9, DIMS.hidden)
    assert set(got["layers"]) == {0, 1}
    assert _rel(got["last_hidden"].float(),
                np.asarray(want["last_hidden"], np.float32)) < tol
    assert _rel(got["layers"][1].float(),
                np.asarray(want["layers"][1], np.float32)) < tol


def test_mrope_and_inputs_embeds_match_reference(files):
    """Qwen-VL's multimodal RoPE: 3-D (t, h, w) position streams, with the
    token embedding replaced by ``inputs_embeds``."""
    jp, enc = _both(files["qwen3"])
    jcfg = jllama.LlamaConfig.from_state_dict(jp)
    rng = np.random.default_rng(4)
    B, L = 2, 10
    ids = rng.integers(0, DIMS.vocab, size=(B, L)).astype(np.int32)
    emb = rng.standard_normal((B, L, DIMS.hidden)).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(L), (B, L)),
                    np.broadcast_to(np.arange(L) // 3, (B, L)),
                    np.broadcast_to(np.arange(L) % 3, (B, L))]).astype(
                        np.int32)
    want = jllama.encode(jp, jcfg, jnp.asarray(ids), qcfg=JF32,
                         dtype=jnp.float32, inputs_embeds=jnp.asarray(emb),
                         position_ids=jnp.asarray(pos))
    got = llama.encode(enc.params, enc.config, torch.as_tensor(ids),
                       qcfg=TF32, dtype=torch.float32,
                       inputs_embeds=torch.as_tensor(emb),
                       position_ids=torch.as_tensor(pos))
    assert _rel(got["last_hidden"],
                np.asarray(want["last_hidden"])) < TOL_F32
    # the streams do differ from 1-D positions
    plain = llama.encode(enc.params, enc.config, torch.as_tensor(ids),
                         qcfg=TF32, dtype=torch.float32,
                         inputs_embeds=torch.as_tensor(emb))
    assert _rel(got["last_hidden"], plain["last_hidden"]) > 1e-3


@pytest.mark.parametrize("name", ["q8", "qwen3"])
def test_load_text_encoder_matches_reference(files, name):
    """load_text_encoder in both packages: the llama graph, the native BPE
    tokenizer from the file's metadata, and the same states for a
    prompt."""
    jenc = jpipeline.load_text_encoder(files[name])
    enc = load_text_encoder(files[name], device="cpu")
    assert jenc.kind == enc.kind == "llama"
    prompt = "a photo of a cat on the moon"
    ids, mask = enc.tokenizer.encode_batch([prompt], max_length=16)
    jids, jmask = jenc.tokenizer.encode_batch([prompt], max_length=16)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.sum() < 16  # padded
    want = jenc.encode(jnp.asarray(ids), jnp.asarray(mask))["last_hidden"]
    got = enc.encode(torch.as_tensor(ids), torch.as_tensor(mask))
    assert got["last_hidden"].dtype == torch.bfloat16
    assert _rel(got["last_hidden"].float(),
                np.asarray(want, np.float32)) < TOL_BF16


def test_qwen2vl_still_raises(tmp_path):
    """A qwen2vl file used to raise until its mmproj sidecar was ported
    (the qwen_image slice); now it loads into the llama graph as the
    reference loads it: the same config and keys (no sidecar beside it,
    so no vision tower) and the same states."""
    path = _write(tmp_path / "qwen2vl.gguf", QWEN3, Q.Q8_0, "qwen2vl")
    enc = load_text_encoder(path, device="cpu")
    jenc = jpipeline.load_text_encoder(path)
    assert enc.kind == jenc.kind == "llama"
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config)
    assert set(enc.params) == set(jenc.params)
    assert not any(k.startswith("visual.") for k in enc.params)
    ids, mask = _ids(seed=7)
    got = enc.encode(torch.as_tensor(ids), torch.as_tensor(mask))
    want = jenc.encode(jnp.asarray(ids), jnp.asarray(mask))
    assert _rel(got["last_hidden"].float(),
                np.asarray(want["last_hidden"], np.float32)) < TOL_BF16


def test_llama_lora_slice_matches_reference(files, tmp_path):
    """A kohya file with a ``lora_llama_`` slice over every attention and
    MLP linear: attached in both packages, the same states; unapplied, the
    port's states come back."""
    enc = load_text_encoder(files["q8"], device="cpu")
    jenc = jpipeline.load_text_encoder(files["q8"])
    targets = testing.encoder_lora_targets(enc.params)
    assert len(targets) == 7 * DIMS.n_layers
    path = str(tmp_path / "llama_lora.safetensors")
    _safetensors.save_file(testing.kohya_lora_state_dict(
        targets, rank=4, alpha=4.0, seed=5, std=0.1, prefix="lora_llama_"),
        path)
    ids, mask = _ids(seed=6)
    base = enc.encode(torch.as_tensor(ids), torch.as_tensor(mask))
    for e in (enc, jenc):
        e.apply_lora(path, strength=0.8)
    assert sum(isinstance(v, lora.PatchedWeight)
               for v in enc.params.values()) == len(targets)
    want = jenc.encode(jnp.asarray(ids), jnp.asarray(mask))["last_hidden"]
    got = enc.encode(torch.as_tensor(ids), torch.as_tensor(mask))
    assert _rel(got["last_hidden"].float(),
                np.asarray(want, np.float32)) < TOL_BF16
    assert _rel(got["last_hidden"].float(),
                base["last_hidden"].float()) > 3 * TOL_BF16
    enc.unapply_loras()
    again = enc.encode(torch.as_tensor(ids), torch.as_tensor(mask))
    assert torch.equal(again["last_hidden"], base["last_hidden"])


def test_text_encoder_requantize_i8_matches_reference(files):
    """``TextEncoder.requantize_i8`` against the reference's w8a8 tree with
    float32 compute. Both sides quantize each activation row to int8 with
    the same arithmetic, so the states agree far inside the bf16 limit;
    the limit is the w8a8 one of queue 3 (an activation code may land on
    the other side of a rounding boundary where the f32 sums differ in the
    last bits)."""
    from comfyui_gguf_tpu.quant import i8 as ji8

    jp, enc = _both(files["q8"])
    jcfg = jllama.LlamaConfig.from_state_dict(jp)
    enc.requantize_i8()
    jp = ji8.convert_tree_i8(jp)
    ids, mask = _ids(seed=7)
    want = jllama.encode(jp, jcfg, jnp.asarray(ids), mask=jnp.asarray(mask),
                         qcfg=JF32, dtype=jnp.float32)
    got = llama.encode(enc.params, enc.config, torch.as_tensor(ids),
                       mask=torch.as_tensor(mask), qcfg=TF32,
                       dtype=torch.float32)
    assert _rel(got["last_hidden"], np.asarray(want["last_hidden"])) < 3e-4
