"""The port's kernel build cache (``compile_cache.py``) on the CPU.

The port compiles no graph: its compiled artefact is the kernel library
``_build`` links, named by a digest of the sources, flags and compiler.
The reference's two tests (``tests/test_compile_cache.py``): ``enable``
points the build at a persistent directory and a library already built
there is reused without compiling (a stand-in ``nvcc`` that only answers
``--version`` proves no compile ran), and ``GGUF_TPU_COMPILE_CACHE``
turns it on.
"""

import os
import stat

import pytest

from comfyui_gguf_tpu_torch import _build, compile_cache


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / "bin" / "nvcc"
    exe.parent.mkdir()
    exe.write_text("#!/bin/sh\n"
                   "if [ \"$1\" = --version ]; then echo 'Cuda 12.8 stub';"
                   " exit 0; fi\n"
                   "echo 'compiled' >&2; exit 1\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    return str(exe)


def test_enable_writes_and_reuses_entries(tmp_path, fake_nvcc):
    d = str(tmp_path / "cc")
    compile_cache.enable(d)
    assert _build.BUILD_DIR == tmp_path / "cc" and os.path.isdir(d)
    # a library of these sources, flags and compiler already sits there:
    # the build reuses it (the stand-in nvcc fails any real compile)
    lib = _build.BUILD_DIR / f"libgguf_kernels_{_build._digest(fake_nvcc)}.so"
    lib.write_bytes(b"built earlier")
    assert _build.build() == lib
    assert _build.BUILD_REPORT["cached"] is True
    # another cache directory holds no library: a compile is attempted
    compile_cache.enable(str(tmp_path / "other"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


def test_enable_from_env(tmp_path, monkeypatch, fake_nvcc):
    assert not compile_cache.enable_from_env()  # default: the package dir
    d = str(tmp_path / "envcc")
    monkeypatch.setenv("GGUF_TPU_COMPILE_CACHE", d)
    assert compile_cache.enable_from_env()
    assert os.path.isdir(d) and str(_build.BUILD_DIR) == d


def test_load_diffusion_model_honours_the_env(tmp_path, monkeypatch,
                                              fake_nvcc):
    """The reference's ``load_diffusion_model`` calls ``enable_from_env``;
    so does the port's: a load with ``GGUF_TPU_COMPILE_CACHE`` set points
    the kernel build at that directory, and a library already built there
    is the one the first kernel launch would load."""
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    dims = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                                depth_single=1, axes_dim=(16, 56, 56))
    path = str(tmp_path / "tiny.gguf")
    testing.write_flux_gguf(
        testing.flux_state_dict(dims, seed=0), path,
        lambda k, v: testing.flux_block_qtype(k, v, Q.Q8_0))
    d = tmp_path / "loadcc"
    monkeypatch.setenv("GGUF_TPU_COMPILE_CACHE", str(d))
    model = load_diffusion_model(path, device="cpu")
    assert model.arch == "flux"
    assert _build.BUILD_DIR == d and d.is_dir()
    lib = d / f"libgguf_kernels_{_build._digest(fake_nvcc)}.so"
    lib.write_bytes(b"built earlier")
    assert _build.build() == lib and _build.BUILD_REPORT["cached"] is True
