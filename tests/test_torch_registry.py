"""The port's model registry against the reference's on one directory
tree: the same entries, the same resolved paths and the same errors."""

import pytest

from comfyui_gguf_tpu.registry import ModelRegistry as JModelRegistry
from comfyui_gguf_tpu_torch import ModelRegistry
from comfyui_gguf_tpu_torch import registry


@pytest.fixture
def tree(tmp_path):
    (tmp_path / "unet").mkdir()
    (tmp_path / "clip").mkdir()
    (tmp_path / "unet" / "flux1-dev-Q4_K_S.gguf").write_bytes(b"x")
    (tmp_path / "unet" / "sub").mkdir()
    (tmp_path / "unet" / "sub" / "sd3.gguf").write_bytes(b"x")
    (tmp_path / "clip" / "clip_l.safetensors").write_bytes(b"x")
    (tmp_path / "clip" / "t5-Q8_0.gguf").write_bytes(b"x")
    (tmp_path / "clip" / "notes.txt").write_bytes(b"x")
    return tmp_path


def _both(roots):
    return ModelRegistry(roots), JModelRegistry(roots)


def _entries(reg, role, **kw):
    return [(e.name, e.path, e.role, e.is_gguf) for e in reg.scan(role, **kw)]


def test_scan_roles(tree):
    reg, jreg = _both([str(tree)])
    unets = reg.list_names("unet")
    assert "flux1-dev-Q4_K_S.gguf" in unets
    assert any(n.endswith("sd3.gguf") for n in unets)  # recursive
    assert set(reg.list_names("clip")) == {"clip_l.safetensors",
                                           "t5-Q8_0.gguf"}
    for role in ("unet", "clip", "vae", "lora", "upscale"):
        assert _entries(reg, role) == _entries(jreg, role)


def test_gguf_only_filter(tree):
    reg, jreg = _both([str(tree)])
    assert reg.list_names("clip", gguf_only=True) == ["t5-Q8_0.gguf"]
    assert (_entries(reg, "unet", gguf_only=True)
            == _entries(jreg, "unet", gguf_only=True))


def test_get_full_path(tree):
    reg, jreg = _both([str(tree)])
    p = reg.get_full_path("unet", "flux1-dev-Q4_K_S.gguf")
    assert p.endswith("unet/flux1-dev-Q4_K_S.gguf")
    assert p == jreg.get_full_path("unet", "flux1-dev-Q4_K_S.gguf")
    # a basename resolves when it is unique
    assert (reg.get_full_path("unet", "sd3.gguf")
            == jreg.get_full_path("unet", "sd3.gguf"))
    for r in (reg, jreg):
        with pytest.raises(FileNotFoundError, match="not found"):
            r.get_full_path("unet", "nope.gguf")


def test_ambiguous_basename_is_an_error(tree, tmp_path_factory):
    other = tmp_path_factory.mktemp("other")
    (other / "diffusion_models" / "a").mkdir(parents=True)
    (other / "diffusion_models" / "a" / "sd3.gguf").write_bytes(b"x")
    reg, jreg = _both([str(tree), str(other)])
    assert _entries(reg, "unet") == _entries(jreg, "unet")
    msgs = []
    for r in (reg, jreg):
        with pytest.raises(FileNotFoundError, match="ambiguous") as e:
            r.get_full_path("unet", "sd3.gguf")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the root-relative name still resolves
    assert reg.get_full_path("unet", "a/sd3.gguf") == str(
        other / "diffusion_models" / "a" / "sd3.gguf")


def test_model_dirs_from_the_environment(tree, monkeypatch, tmp_path_factory):
    empty = tmp_path_factory.mktemp("empty")
    monkeypatch.setenv("GGUF_TPU_MODEL_DIRS", f"{empty}::{tree}")
    reg, jreg = _both(None)
    assert reg.roots == jreg.roots == [str(empty), str(tree)]
    assert _entries(reg, "clip") == _entries(jreg, "clip")
    monkeypatch.delenv("GGUF_TPU_MODEL_DIRS")
    assert ModelRegistry().roots == JModelRegistry().roots == ["."]
    assert registry.ROLE_SUBDIRS["unet"] == ("unet", "diffusion_models")
