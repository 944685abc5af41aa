from .layers import (
    QuantConfig,
    layer_norm,
    linear,
    linear_gelu,
    materialize,
    rms_norm,
)

__all__ = [
    "QuantConfig",
    "linear",
    "linear_gelu",
    "layer_norm",
    "rms_norm",
    "materialize",
]
