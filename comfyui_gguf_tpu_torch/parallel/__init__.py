"""Parallelism on ``torch.distributed``: a rank per process, a
``DeviceMesh`` with the reference's axis names, and the collectives of
``collectives.py``. Tensor (``tp``, ``tp_flux``, ``tp_spec``), data
(``pipeline`` engines' ``dp_mesh``), pipeline (``pp``), expert (``ep``) and
sequence (``ring``) parallelism; ``launch`` starts local ranks."""

from .mesh import make_mesh, replicate, shard_quant_params

__all__ = ["make_mesh", "shard_quant_params", "replicate"]
