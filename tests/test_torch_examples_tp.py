"""The port's tensor-parallel entry scripts (``examples/torch_serve_qwen_tp.py``,
``examples/torch_serve_hidream_tp.py``) against the reference's, on the
CPU.

A module fixture writes a tiny Qwen-Image and a tiny HiDream GGUF (Q4_K, as
published files are quantized) with the port's writers and starts two gloo
ranks on the CPU once (``parallel.launch.Ranks``), with ``examples/`` on
the import path they are spawned with: a rank finds a script's job by
importing the script. Each script then runs at tp = 2 with ``--smoke`` in
both packages on the same file, each in a directory of its own: the
reference on the 8-device virtual CPU mesh ``tests/conftest.py`` sets up,
the port's ``main`` with ``--device cpu`` on those ranks. The port takes
the reference's ``jax.random`` draw as its initial noise (the scripts'
``_noise`` helper); the smoke states come from
``np.random.default_rng`` in both. The latents rank 0 wrote are compared
within the pipeline tests' 1e-2 (2e-2 under ``--i8``, ``TOL_I8``; found:
3.2e-3 / 3.7e-3 for Qwen-Image, 1.9e-3 / 2.0e-3 for HiDream, planar /
w8a8).

Also: without encoder states and without ``--smoke`` both packages stop
with exit code 1.
"""

import contextlib
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.parallel import launch

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TOL, TOL_I8 = 1e-2, 2e-2


def _ref_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(path):
    """A written array as float32 (the reference saves bfloat16 arrays,
    which numpy reads back as 2-byte voids)."""
    a = np.load(path)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(jax.numpy.bfloat16)
    return a.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example_tp_files")
    f = {}
    for arch, dims, spec in (
            ("qwen_image", testing.QwenImageDims(
                hidden=512, n_heads=4, n_layers=2, in_ch=32,
                context_dim=96), testing.qwen_image_shape_spec),
            ("hidream", testing.TinyHiDreamDims(
                hidden=512, heads=4, depth_double=1, depth_single=1,
                ffn=1024, n_experts=2, top_k=1),
             testing.hidream_shape_spec)):
        f[arch] = str(tmp / f"{arch}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0), f[arch],
            arch, Q.Q4_K)
    return f


@pytest.fixture(scope="module")
def ranks():
    """Two CPU ranks, spawned with ``examples/`` on their import path."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        with launch.Ranks(2, device="cpu") as r:
            yield r
    finally:
        sys.path.remove(str(EXAMPLES))


def _jax_noise(seed, shape, device=None):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape),
                      np.float32)


def _run_both(name, argv, ranks, tmp_path, monkeypatch):
    """The port's ``main`` on the module's ranks in ``tmp_path/port``, the
    reference's in ``tmp_path/ref``. → (port dir, ref dir, exit codes)."""
    port = importlib.import_module(f"torch_{name}")
    monkeypatch.setattr(port, "_noise", _jax_noise)
    monkeypatch.setattr(launch, "Ranks",
                        lambda world, device: contextlib.nullcontext(ranks))
    ref = _ref_script(name)
    out = []
    for which, fn in (
            ("port", lambda: port.main(argv + ["--device", "cpu"])),
            ("ref", ref.main)):
        d = tmp_path / which
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
        out.append((d, fn()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("i8", [False, True], ids=["planar", "w8a8"])
def test_serve_qwen_tp_matches_reference(files, ranks, tmp_path,
                                         monkeypatch, i8):
    argv = ["--unet", files["qwen_image"], "--tp", "2", "--smoke",
            "--prompt-tokens", "8", "--size", "64", "--steps", "3"] + (
                ["--i8"] if i8 else [])
    p, r, cp, cr = _run_both("serve_qwen_tp", argv, ranks, tmp_path,
                             monkeypatch)
    assert cp == cr == 0
    a, b = _load(p / "qwen_latent.npy"), _load(r / "qwen_latent.npy")
    assert a.shape == b.shape == (16, 32) and np.isfinite(a).all()
    assert _rel(a, b) < (TOL_I8 if i8 else TOL)


@pytest.mark.parametrize("i8", [False, True], ids=["planar", "w8a8"])
def test_serve_hidream_tp_matches_reference(files, ranks, tmp_path,
                                            monkeypatch, i8):
    argv = ["--unet", files["hidream"], "--tp", "2", "--smoke", "--size",
            "64", "--steps", "3"] + (["--i8"] if i8 else [])
    p, r, cp, cr = _run_both("serve_hidream_tp", argv, ranks, tmp_path,
                             monkeypatch)
    assert cp == cr == 0
    a = _load(p / "hidream_latent.npy")
    b = _load(r / "hidream_latent.npy")
    assert a.shape == b.shape == (8, 8, 16) and np.isfinite(a).all()
    assert _rel(a, b) < (TOL_I8 if i8 else TOL)


@pytest.mark.parametrize("name", ["serve_qwen_tp", "serve_hidream_tp"])
def test_missing_states_exit_codes(files, ranks, tmp_path, monkeypatch,
                                   name):
    """No encoder states and no ``--smoke``: exit code 1 in both."""
    arch = "qwen_image" if name == "serve_qwen_tp" else "hidream"
    argv = ["--unet", files[arch], "--tp", "2", "--size", "64", "--steps",
            "2"]
    port = importlib.import_module(f"torch_{name}")
    monkeypatch.setattr(launch, "Ranks",
                        lambda world, device: contextlib.nullcontext(ranks))
    monkeypatch.chdir(tmp_path)
    try:
        cp = port.main(argv + ["--device", "cpu"])
    except SystemExit as e:
        cp = e.code
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    try:
        cr = _ref_script(name).main()
    except SystemExit as e:
        cr = e.code
    assert cp == cr == 1
    assert not list(tmp_path.glob("*.npy"))
