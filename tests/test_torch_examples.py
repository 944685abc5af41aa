"""The port's entry scripts ``examples/torch_*.py`` against the reference's
``examples/*.py``, on the CPU.

A module fixture writes tiny files once with the port's writers: two flux
GGUFs (Q8_0 and Q4_K), a 2-layer T5 GGUF with a unigram tokenizer, CLIP-L
and CLIP-G safetensors with a vocabulary beside them (and a CLIP-L without
one), an AutoencoderKL, a flux LoRA and an SD3 GGUF. Each script then runs
twice on the same files and arguments, each in a directory of its own: the
port's ``main`` with ``--device cpu`` and the reference script's ``main``.
The port draws its noise from ``torch.Generator``, the reference from
``jax.random``; the test hands the port the reference's draw (the scripts'
``_noise`` helpers, and ``FluxPipeline.generate`` for the txt2img script),
so both run the same requests, and compares the files each wrote.

Tolerances (relative L2 of each written array), the pipeline tests'
(``tests/test_torch_pipeline.py``): 1e-2, 2e-2 where the latent went
through the w8a8 path (a moved int8 code). Both packages compute in
bfloat16 here, as the scripts do (found: 4.7e-3 for the txt2img image,
3.3e-3 to 4.2e-3 for the served flux latents, 1.1e-3 to 1.4e-3 for SD3).

Also: every flag of a reference script is a flag of its port, and the
reference's error paths (an encoder without a tokenizer) give the same
exit code. The two tensor-parallel scripts are in
``test_torch_examples_tp.py``.
"""

import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SCRIPTS = ("generate_flux", "serve_flux", "serve_multi", "serve_sd3",
           "serve_qwen_tp", "serve_hidream_tp")
TOL, TOL_I8 = 1e-2, 2e-2
# head dim 128: a flux file's heads are read as hidden / 128
FLUX = testing.TinyFluxDims(hidden=512, heads=4, ctx=64, vec=32,
                            depth_double=1, depth_single=1,
                            axes_dim=(16, 56, 56))
PROMPTS = ("a photo of a cat on the moon", "a red bicycle")


def load_script(name: str):
    """examples/{name}.py as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example_files")
    f = {}
    for name, seed, qtype in (("flux_a", 1, Q.Q8_0), ("flux_b", 2, Q.Q4_K)):
        f[name] = str(tmp / f"{name}.gguf")
        testing.write_flux_gguf(
            testing.flux_state_dict(FLUX, seed=seed), f[name],
            lambda k, v, q=qtype: testing.flux_block_qtype(k, v, q))
    f["t5"] = str(tmp / "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=FLUX.ctx, d_kv=16, n_heads=4, d_ff=128, n_layers=2,
            vocab=64), seed=3), f["t5"], qtype=Q.Q8_0,
        tokenizer=testing.unigram_spec(64))
    clip_dir = tmp / "clip"
    clip_dir.mkdir()
    for name, dims, seed in (
            ("clip_l", dict(hidden=64, n_layers=2, n_heads=1,
                            intermediate=96, proj=FLUX.vec), 4),
            ("clip_g", dict(hidden=1280, n_layers=1, n_heads=20,
                            intermediate=1280, proj=32), 5)):
        f[name] = str(clip_dir / f"{name}.safetensors")
        _safetensors.save_file(testing.clip_state_dict(testing.CLIPDims(
            vocab=600, max_positions=16, **dims), seed=seed), f[name])
    testing.write_clip_vocab(str(clip_dir), *testing.clip_vocab(600))
    bare = tmp / "bare"  # a CLIP-L with no vocabulary beside it
    bare.mkdir()
    f["clip_bare"] = str(bare / "clip_l.safetensors")
    _safetensors.save_file(testing.clip_state_dict(testing.CLIPDims(
        hidden=64, n_layers=2, n_heads=1, intermediate=96, vocab=600,
        max_positions=16, proj=FLUX.vec), seed=4), f["clip_bare"])
    f["vae"] = str(tmp / "ae.safetensors")
    _safetensors.save_file(testing.vae_state_dict(testing.VAEDims(
        z_channels=FLUX.in_ch // 4, base_ch=32), seed=6), f["vae"])
    f["lora"] = str(tmp / "lora.safetensors")
    _safetensors.save_file(testing.kohya_lora_state_dict(
        testing.flux_lora_targets(FLUX), rank=4, alpha=4.0, seed=7,
        std=0.05), f["lora"])
    sd3 = testing.TinySD3Dims(hidden=64, heads=2, depth=2,
                              ctx_dim=64 + 1280, pooled=FLUX.vec + 32,
                              in_ch=16, pos_max=8)
    f["sd3"] = str(tmp / "sd3.gguf")
    testing.write_gguf(testing.sd3_flat_state_dict(sd3, seed=8), f["sd3"],
                       lambda k, v: testing.sd3_block_qtype(k, v, Q.Q8_0),
                       "sd3")
    f["prompts"] = str(tmp / "prompts.txt")
    with open(f["prompts"], "w") as fh:
        fh.write("\n".join(PROMPTS) + "\n\n")
    return f


def _jax_noise(seed, shape, device=None):
    """The reference scripts' float32 draw of ``jax.random.key(seed)``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape),
                      np.float32)


def _run_both(name, argv, tmp_path, monkeypatch, patch_port=None):
    """The port's ``main(argv + --device cpu)`` in ``tmp_path/port``, the
    reference's ``main()`` with ``sys.argv`` set in ``tmp_path/ref``. →
    (port dir, ref dir, port exit, ref exit)."""
    port = load_script(f"torch_{name}")
    if patch_port is not None:
        patch_port(port)
    ref = load_script(name)
    dirs = []
    codes = []
    for which, fn, args in (
            ("port", lambda: port.main(argv + ["--device", "cpu"]), None),
            ("ref", ref.main, argv)):
        d = tmp_path / which
        d.mkdir()
        monkeypatch.chdir(d)
        if args is not None:
            monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
        with torch.no_grad():
            codes.append(fn())
        dirs.append(d)
    return dirs[0], dirs[1], codes[0], codes[1]


def _load(path):
    """A written array as float32 (the reference saves bfloat16 arrays,
    which numpy reads back as 2-byte voids)."""
    a = np.load(path)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(jnp.bfloat16)
    return a.astype(np.float32)


def _compare_files(port_dir, ref_dir, names, tol):
    for n in names:
        a, b = _load(port_dir / n), _load(ref_dir / n)
        assert a.shape == b.shape, n
        assert np.isfinite(a).all(), n
        assert _rel(a, b) < tol, (n, _rel(a, b))


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_takes_every_flag_of_the_reference(name):
    """``--help`` of the port lists every option of the reference script,
    with the same defaults, and ``--device`` beside them."""
    import argparse

    def options(mod, argv_main):
        seen = {}

        class Stop(Exception):
            pass

        def fake_parse(self, args=None, namespace=None):
            for a in self._actions:
                for s in a.option_strings:
                    seen[s] = a.default
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = fake_parse
        try:
            with pytest.raises(Stop):
                argv_main(mod)
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    port = options(load_script(f"torch_{name}"), lambda m: m.main([]))
    ref = options(load_script(name), lambda m: m.main())
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert port["--device"] == "cuda"


def test_generate_flux_matches_reference(files, tmp_path, monkeypatch):
    """txt2img through the VAE with a LoRA at strength 0.8; the card's
    machine has no PIL, so both write the image as ``out.png.npy``."""
    monkeypatch.setitem(sys.modules, "PIL", None)

    def patch(mod):
        def generate(self, prompt, width=1024, height=1024, steps=20,
                     guidance=3.5, seed=0):
            noise = np.asarray(jax.random.normal(
                jax.random.key(seed), (1, height // 8, width // 8,
                                       self.model.config.in_channels // 4),
                jnp.bfloat16), np.float32)
            return self.generate_from_noise(prompt, noise, width=width,
                                            height=height, steps=steps,
                                            guidance=guidance)
        monkeypatch.setattr(tpipeline.FluxPipeline, "generate", generate)

    argv = ["--unet", files["flux_a"], "--t5", files["t5"], "--clip-l",
            files["clip_l"], "--vae", files["vae"], "--lora",
            files["lora"] + ":0.8", "--prompt", PROMPTS[0], "--width", "64",
            "--height", "64", "--steps", "3", "--seed", "5", "--out",
            "cat.png"]
    p, r, cp, cr = _run_both("generate_flux", argv, tmp_path, monkeypatch,
                             patch)
    assert cp is None and cr is None
    _compare_files(p, r, ["cat.png.npy"], TOL)
    assert np.load(p / "cat.png.npy").shape == (64, 64, 3)


def test_generate_flux_latent_without_vae(files, tmp_path, monkeypatch):
    """Without ``--vae`` both write the latent, from the port's own
    ``torch.Generator`` noise here: the shape and the file name agree."""
    port = load_script("torch_generate_flux")
    monkeypatch.chdir(tmp_path)
    assert port.main(["--unet", files["flux_a"], "--t5", files["t5"],
                      "--clip-l", files["clip_l"], "--prompt", PROMPTS[1],
                      "--width", "64", "--height", "64", "--steps", "2",
                      "--device", "cpu"]) is None
    lat = np.load(tmp_path / "out.png.latent.npy")
    assert lat.shape == (8, 8, FLUX.in_ch // 4) and np.isfinite(lat).all()


@pytest.mark.parametrize("i8", [False, True], ids=["bf16_fused", "w8a8"])
def test_serve_flux_matches_reference(files, tmp_path, monkeypatch, i8):
    """Two prompts through the engine (max batch 2, dpmpp_2m), with
    latent previews every two steps from the VAE."""
    argv = ["--unet", files["flux_a"], "--t5", files["t5"], "--clip-l",
            files["clip_l"], "--prompts", files["prompts"], "--width", "64",
            "--height", "64", "--steps", "4", "--max-batch", "2",
            "--sampler", "dpmpp_2m", "--vae", files["vae"],
            "--preview-every", "2", "--t5-len", "16"] + (
                ["--i8"] if i8 else [])
    p, r, cp, cr = _run_both(
        "serve_flux", argv, tmp_path, monkeypatch,
        lambda m: monkeypatch.setattr(m, "_noise", _jax_noise))
    assert cp is None and cr is None
    outs = [f"out_{i:03d}.latent.npy" for i in range(len(PROMPTS))]
    _compare_files(p, r, outs, TOL_I8 if i8 else TOL)
    previews = sorted(x.name for x in p.glob("preview_*.npy"))
    assert previews == sorted(x.name for x in r.glob("preview_*.npy"))
    assert previews  # every request, at steps 0 and 2
    for n in previews:
        assert _load(p / n).shape == _load(r / n).shape


def test_serve_multi_matches_reference(files, tmp_path, monkeypatch,
                                       capsys):
    """Two flux models (Q8_0 and Q4_K) behind one server under a budget
    that holds one of them at a time: both requests served, the same
    residency counts in both packages."""
    argv = ["--model-a", files["flux_a"], "--model-b", files["flux_b"],
            "--t5", files["t5"], "--clip-l", files["clip_l"], "--size", "64",
            "--steps", "3", "--t5-len", "16", "--hbm-budget-gb", "0.03"]
    p, r, cp, cr = _run_both(
        "serve_multi", argv, tmp_path, monkeypatch,
        lambda m: monkeypatch.setattr(m, "_noise", _jax_noise))
    assert cp == cr == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("model ")]
    assert len(lines) == 4  # two a package, the port's first
    for a, b in zip(lines[:2], lines[2:]):
        assert a.split(", latency")[0] == b.split(", latency")[0]


def test_no_tokenizer_exit_codes(files, tmp_path, monkeypatch):
    """A CLIP-L without a vocabulary: serve_flux and serve_multi stop with
    exit code 1 in both packages."""
    for name, argv in (
            ("serve_flux", ["--unet", files["flux_a"], "--t5", files["t5"],
                            "--clip-l", files["clip_bare"], "--prompts",
                            files["prompts"]]),
            ("serve_multi", ["--model-a", files["flux_a"], "--model-b",
                             files["flux_b"], "--t5", files["t5"],
                             "--clip-l", files["clip_bare"]])):
        d = tmp_path / name
        d.mkdir()
        _, _, cp, cr = _run_both(name, argv, d, monkeypatch)
        assert cp == cr == 1


def test_serve_sd3_matches_reference(files, tmp_path, monkeypatch):
    """Two prompts through ``sd3_engine`` (CLIP-L and CLIP-G, no T5) at
    shift 3 over the linear schedule."""
    argv = ["--unet", files["sd3"], "--clip-l", files["clip_l"], "--clip-g",
            files["clip_g"], "--prompts", files["prompts"], "--width", "64",
            "--height", "64", "--steps", "3", "--max-batch", "2"]
    p, r, cp, cr = _run_both(
        "serve_sd3", argv, tmp_path, monkeypatch,
        lambda m: monkeypatch.setattr(m, "_noise", _jax_noise))
    assert cp is None and cr is None
    _compare_files(p, r, [f"out_{i:03d}.latent.npy"
                          for i in range(len(PROMPTS))], TOL)


def test_scripts_need_the_card_by_default(files, tmp_path, monkeypatch):
    """Without ``--device`` a script asks for the card, and where there is
    none it raises instead of going on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port = load_script("torch_generate_flux")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--unet", files["flux_a"], "--t5", files["t5"],
                   "--clip-l", files["clip_l"], "--prompt", "x"])
    assert not os.listdir(tmp_path)
