"""Model-file registry: discover GGUF/safetensors checkpoints by role
(PyTorch port of comfyui_gguf_tpu/registry.py).

The role of ComfyUI-GGUF's folder registration (``unet_gguf`` /
``clip_gguf`` folder keys with a ``.gguf`` extension filter) without
ComfyUI: scan configured directories (``roots``, else the colon-separated
``GGUF_TPU_MODEL_DIRS``, else ``.``), classify files by role, resolve names
to paths. A basename found under two roots is an error, not the first hit.
"""

from __future__ import annotations

import dataclasses
import os

# role -> subdirectory names searched under each root (ComfyUI layout)
ROLE_SUBDIRS = {
    "unet": ("unet", "diffusion_models"),
    "clip": ("clip", "text_encoders"),
    "vae": ("vae",),
    "lora": ("loras",),
}

_EXTS = (".gguf", ".safetensors", ".sft")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str  # filename relative to its role dir
    path: str
    role: str
    is_gguf: bool


class ModelRegistry:
    def __init__(self, roots: list[str] | None = None):
        env = os.environ.get("GGUF_TPU_MODEL_DIRS", "")
        self.roots = list(roots or [p for p in env.split(":") if p]) or ["."]

    def scan(self, role: str, gguf_only: bool = False) -> list[ModelEntry]:
        out: list[ModelEntry] = []
        subdirs = ROLE_SUBDIRS.get(role, (role,))
        for root in self.roots:
            for sub in subdirs:
                base = os.path.join(root, sub)
                if not os.path.isdir(base):
                    continue
                for dirpath, _dirs, files in os.walk(base):
                    for f in sorted(files):
                        if not f.lower().endswith(_EXTS):
                            continue
                        is_gguf = f.lower().endswith(".gguf")
                        if gguf_only and not is_gguf:
                            continue
                        full = os.path.join(dirpath, f)
                        rel = os.path.relpath(full, base)
                        out.append(ModelEntry(name=rel, path=full, role=role,
                                              is_gguf=is_gguf))
        return out

    def get_full_path(self, role: str, name: str) -> str:
        entries = self.scan(role)
        exact = [e.path for e in entries if e.name == name]
        if exact:
            return exact[0]
        # basename fallback: ambiguity is an ERROR, not first-scanned-wins
        # (two roots shipping "model-Q4_K_S.gguf" would silently load
        # whichever the walk hit first)
        by_base = sorted({e.path for e in entries
                          if os.path.basename(e.path) == name})
        if len(by_base) == 1:
            return by_base[0]
        if by_base:
            raise FileNotFoundError(
                f"{role} model {name!r} is ambiguous: {by_base} — use the "
                "root-relative name")
        raise FileNotFoundError(f"{role} model {name!r} not found under "
                                f"{self.roots}")

    def list_names(self, role: str, gguf_only: bool = False) -> list[str]:
        return [e.name for e in self.scan(role, gguf_only=gguf_only)]
