"""The multi-host mesh (``parallel/mesh.py`` ``make_multihost_mesh``) on 4
gloo ranks as 2 "hosts" × 2 (``LOCAL_WORLD_SIZE`` 2): its coordinates, the
batch split over (host, dp), a tp all-reduce that stays inside a host, and
one quantized flux forward with the batch split across hosts and the
packed weights column-split over tp, against the JAX package's single
process forward of the same codec blocks.

Tolerance: 1e-5 relative L2 in float32 (the port's own single-device flux
parity is 1e-4; the column splits gather whole outputs, so the sums are
the unsharded ones) against the port's unsharded forward, 1e-4 against
the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import flux, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch
from comfyui_gguf_tpu_torch.quant import codecs, planar

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(4, device="cpu", ranks_per_host=2) as r:
        yield r


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_multihost_mesh_layout(ranks):
    outs = ranks.run(jobs.multihost, 2)
    for rank, (coords, sizes, spec, (idx, n), s) in enumerate(outs):
        assert sizes == (2, 1, 2)
        assert coords == (rank // 2, 0, rank % 2)
        assert spec == ("host", "dp") and n == 2 and idx == rank // 2
        # the tp all-reduce sums the two ranks of this host only
        host = rank // 2
        assert s.tolist() == [float(2 * host + 2 * host + 1)]


def test_multihost_flux_forward_matches_single_process(ranks):
    from comfyui_gguf_tpu.models import flux as jflux
    from comfyui_gguf_tpu.nn.layers import QuantConfig as JQ
    from comfyui_gguf_tpu.quant import planar as jplanar

    dims = testing.TinyFluxDims()
    sd = testing.flux_state_dict(dims, seed=0)
    cfg = dims.config()
    port, ref = {}, {}
    for k, v in sd.items():
        if v.ndim == 2 and "blocks" in k:
            b = codecs.quantize(v, Q.Q8_0)
            port[k] = planar.planarize(b, Q.Q8_0, v.shape)
            ref[k] = jplanar.planarize(b, Q.Q8_0, v.shape)
        else:
            port[k], ref[k] = torch.from_numpy(v), jnp.asarray(v)
    inputs = testing.flux_example_inputs(dims, batch=4, dtype=torch.float32,
                                         device="cpu")
    outs = ranks.run(jobs.multihost_flux, port, cfg, inputs, F32)
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])
    mine = flux.forward(port, cfg, *inputs, qcfg=F32).numpy()
    assert _rel(outs[0], mine) < 1e-5
    want = np.asarray(jflux.forward(
        ref, cfg, *(jnp.asarray(t.numpy()) for t in inputs),
        qcfg=JQ(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                prefer_pallas=False)))
    assert _rel(outs[0], want) < 1e-4
