"""User-facing model loading (PyTorch port of the diffusion-model part of
comfyui_gguf_tpu/pipeline.py).

``load_diffusion_model(path)`` takes a GGUF file to a ``DiffusionModel``
with packed planar weights on the card; ``requantize_i8()`` converts it to
the w8a8 format and ``stack()`` restacks the blocks along a depth axis.
The flux forward runs through ``DiffusionModel.forward``. Text encoders,
VAE, ``FluxPipeline``, LoRA and the other architectures come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from ._device import resolve_device
from .loader import gguf_sd_loader, to_torch_params
from .models import flux as flux_model
from .nn.layers import QuantConfig

# arch -> (model module, config class); flux only in this slice
_ARCH_TABLE = {"flux": (flux_model, flux_model.FluxConfig)}


def _arch_module(arch: str):
    entry = _ARCH_TABLE.get(arch)
    if entry is None:
        raise NotImplementedError(
            f"forward graph for arch {arch!r} is not ported yet")
    return entry[0]


@dataclasses.dataclass
class DiffusionModel:
    """Loaded DiT + config."""

    arch: str
    params: dict
    config: object
    qcfg: QuantConfig
    device: torch.device

    @property
    def is_stacked(self) -> bool:
        return self.arch == "flux" and "double_blocks" in self.params

    def forward(self, *args, **kwargs):
        mod = _arch_module(self.arch)
        fn = mod.forward_stacked if self.is_stacked else mod.forward
        return fn(self.params, self.config, *args, qcfg=self.qcfg, **kwargs)

    def requantize_i8(self, *, mod_planar: bool = True) -> "DiffusionModel":
        """Convert packed planar weights to the w8a8 format (quant/i8.py).

        mod_planar: keep the adaLN/modulation projections (M=batch rows,
        bandwidth-bound) on the planar path. Each planar leaf is dropped as
        it converts, so both trees never sit on the card at once. Mutates
        self and returns it.
        """
        from .quant.i8 import convert_tree_i8, is_modulation_key

        pred = (lambda k, v: not is_modulation_key(k)) if mod_planar \
            else None
        self.params = convert_tree_i8(self.params, free_source=True,
                                      pred=pred)
        return self

    def stack(self) -> "DiffusionModel":
        """Restack per-block params along a depth axis (copies the block
        weights once); forward then runs forward_stacked."""
        if self.arch == "flux" and not self.is_stacked:
            return dataclasses.replace(
                self, params=flux_model.stack_flux_params(self.params,
                                                          self.config))
        return self


def load_diffusion_model(path: str, device="cuda") -> DiffusionModel:
    """GGUF diffusion model → DiffusionModel on ``device`` (the card unless
    the caller asks for the CPU; raises if CUDA is asked for and absent)."""
    device = resolve_device(device)
    qcfg = QuantConfig()
    sd, arch = gguf_sd_loader(path, return_arch=True)
    params = to_torch_params(sd, qcfg, device=device)
    config = None
    if arch in _ARCH_TABLE:
        config = _ARCH_TABLE[arch][1].from_state_dict(params)
    return DiffusionModel(arch=arch, params=params, config=config, qcfg=qcfg,
                          device=device)
