"""The device mesh and the placement of packed weights on it.

The port's mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the process group, with the reference's axis names:
``("dp", "tp")`` from ``make_mesh`` and ``("host", "dp", "tp")`` from
``make_multihost_mesh``. Every rank runs the same program and holds only
its own shard of a sharded weight.

* ``dp`` splits requests or the batch; ``tp`` splits weight out- or
  in-features (``tp``, ``tp_flux``, ``tp_spec``).
* On a multi-host mesh only the batch rides ``host``: a denoise step
  needs no collective across samples, so the slow link between hosts
  carries request dispatch alone, while the per-block ``tp`` all-reduces
  stay among the ranks of one host. Every host holds a whole packed
  replica of the weights.
"""

from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..lifecycle import to_device
from ..quant.planar import PlanarQuant, TPShard, shard_planar
from . import collectives


def _device_type() -> str:
    """The mesh's device type: "cuda" where the process group runs NCCL,
    "cpu" under gloo (which moves CUDA tensors through the host,
    ``collectives``)."""
    return "cuda" if str(dist.get_backend()) == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, tp: int | None = None):
    """A (dp, tp) mesh over every rank of the process group. tp defaults
    to all of them (pure tensor parallelism)."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, "
                         f"world size {n}")
    if tp is None:
        tp = n
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return init_device_mesh(_device_type(), (n // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def make_axis_mesh(axis: str):
    """A one-axis mesh over every rank (``("sp",)``, ``("pp",)``,
    ``("ep",)``: the axes of ``ring``, ``pp`` and ``ep``)."""
    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_multihost_mesh(tp: int | None = None,
                        ranks_per_host: int | None = None):
    """A (host, dp, tp) mesh. Ranks are numbered host by host (rank r is
    on host r // ranks_per_host, as ``torchrun`` numbers them);
    ``ranks_per_host`` defaults to ``LOCAL_WORLD_SIZE``. tp defaults to
    the ranks of one host."""
    n = dist.get_world_size()
    per_host = int(ranks_per_host or os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % per_host:
        raise ValueError(f"world size {n} not divisible by {per_host} "
                         "ranks per host")
    if tp is None:
        tp = per_host
    if per_host % tp:
        raise ValueError(f"{per_host} per-host devices not divisible by "
                         f"tp={tp}")
    return init_device_mesh(_device_type(),
                            (n // per_host, per_host // tp, tp),
                            mesh_dim_names=("host", "dp", "tp"))


def batch_spec(mesh) -> tuple[str, ...]:
    """The axes the batch splits over: (host, dp) on a multi-host mesh
    (the link between hosts carries only request dispatch), dp
    otherwise."""
    return (("host", "dp") if "host" in mesh.mesh_dim_names
            else ("dp",))


def batch_index(mesh) -> tuple[int, int]:
    """(this rank's slice, the number of slices) of a batch split over
    ``batch_spec(mesh)``, slices ordered host-major."""
    idx, n = 0, 1
    for axis in batch_spec(mesh):
        size = collectives.axis_size(axis, mesh)
        idx, n = idx * size + collectives.axis_index(axis, mesh), n * size
    return idx, n


def shard_quant_params(params: dict, mesh, device="cuda") -> dict:
    """This rank's share of a param tree, on ``device``.

    A ``PlanarQuant`` whose out-features divide by tp keeps this rank's
    column slice (re-padded on its own, ``shard_planar``) as a "gather"
    ``TPShard``, and its ``.bias`` sibling the matching slice: under
    ``collectives.active(mesh)`` the linear runs locally and one tiled
    all-gather gives every rank the whole output. Everything else is
    replicated (norm scales, biases and embeddings are small beside the
    packed 2-D weights).
    """
    tp = collectives.axis_size("tp", mesh)
    r = collectives.axis_index("tp", mesh)

    def walk(tree):
        out = {}
        split = {k for k, v in tree.items()
                 if isinstance(v, PlanarQuant) and v.out_features % tp == 0}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in split:
                out[k] = TPShard(shard_planar(v, tp, "r", index=r),
                                 "gather", "tp")
            elif (k.endswith(".bias") and k[:-5] + ".weight" in split):
                w = v.shape[-1] // tp
                out[k] = v[..., r * w:(r + 1) * w]
            else:
                out[k] = v
        return out

    return to_device(walk(params), device)


def replicate(tree, mesh=None, device="cuda"):
    """Every rank's own copy of ``tree`` on ``device``: replication is
    what each rank holding the whole tree means."""
    return to_device(tree, device)
