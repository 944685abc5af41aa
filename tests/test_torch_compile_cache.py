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
