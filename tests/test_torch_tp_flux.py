"""The hand-sharded tensor-parallel flux forward (``parallel/tp_flux.py``)
and the parallel flux engines on gloo ranks, against the JAX package's
``tp_flux`` and engines on the 8-device virtual CPU mesh
(``prefer_pallas=False``), from the same seed-made state dict.

Tolerances (relative L2): 1e-4 for float32 forwards at tp = 2 and tp = 4
(the single-device flux parity bound; sums in another order than XLA's,
and at tp = 4 the all-reduce adds four partials in gloo's order), 1e-2 for
served latents (bf16 latents rounded every step, the engines' bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.parallel import tp_flux as jtp_flux
from comfyui_gguf_tpu_torch import pipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch, tp_flux, tp_spec
from comfyui_gguf_tpu_torch.sampling import linear_schedule

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
KW = dict(hidden=512, heads=4, ctx=256, vec=64, in_ch=16, depth_double=2,
          depth_single=2, axes_dim=(32, 48, 48))
DIMS, JDIMS = testing.TinyFluxDims(**KW), jtesting.TinyFluxDims(**KW)
H_LAT = TXT = 8
TOL = 1e-4
ENGINE_TOL = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(2, device="cpu") as r:
        yield r


@pytest.fixture(scope="module")
def setup():
    sd = testing.flux_state_dict(DIMS, seed=11)
    inputs = testing.flux_example_inputs(DIMS, batch=1, h_lat=H_LAT,
                                         w_lat=H_LAT, txt_len=TXT,
                                         dtype=torch.float32, device="cpu")
    return sd, DIMS.config(), inputs


def _jmesh(n, axes=("tp",)):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]).reshape(
        (1,) * (len(axes) - 1) + (n,)), axes)


def _reference(sd, cfg, inputs, tp):
    mesh = _jmesh(tp)
    sharded = jtp_flux.place_tp_params(
        jtp_flux.shard_flux_params(sd, cfg, tp, Q.Q8_0), mesh)
    xs = [jnp.asarray(t.numpy()) for t in inputs]
    return np.asarray(jax.jit(lambda p, *a: jtp_flux.tp_forward_stacked(
        p, cfg, *a, mesh=mesh, qcfg=JF32))(sharded, *xs), np.float32)


def test_tp_forward_matches_reference(ranks, setup):
    sd, cfg, inputs = setup
    sharded = tp_flux.shard_flux_params(sd, cfg, 2, Q.Q8_0)
    outs = ranks.run(jobs.tp_forward, None, sharded, cfg, inputs,
                     tp_flux.BLOCK_KEYS, F32, module="tp_flux")
    want = _reference(sd, cfg, inputs, 2)
    assert np.array_equal(outs[0][0], outs[1][0])
    assert _rel(outs[0][0], want) < TOL
    # 4 all-reduces and 2 all-gathers a double block, 1 and 1 a single
    assert outs[0][1]["calls"] == 6 * cfg.depth_double + 2 * cfg.depth_single


def test_tp4_forward_matches_reference(setup):
    """tp = 4: one head a rank, and four partials in each all-reduce."""
    sd, cfg, inputs = setup
    sharded = tp_flux.shard_flux_params(sd, cfg, 4, Q.Q8_0)
    outs = launch.run(jobs.tp_forward, 4, None, sharded, cfg, inputs,
                      tp_flux.BLOCK_KEYS, F32, module="tp_flux",
                      device="cpu")
    want = _reference(sd, cfg, inputs, 4)
    for got, _ in outs:
        assert np.array_equal(got, outs[0][0])
        assert _rel(got, want) < TOL


def test_hand_layout_equals_spec_layout(setup):
    """tp_flux's shards are tp_spec's flux table unwrapped, byte for
    byte."""
    sd, cfg, _ = setup
    hand = tp_flux.shard_flux_params(sd, cfg, 2, Q.Q8_0)
    spec = tp_spec.shard_flux_params(sd, cfg, 2, Q.Q8_0)
    for key in tp_flux.BLOCK_KEYS:
        for s, leaf in hand[key].items():
            other = spec[key][s]
            other = getattr(other, "inner", other) if not isinstance(
                other, torch.Tensor) else other
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf, other), s
            else:
                assert torch.equal(leaf.qs, other.qs), s


def _requests(cfg, n=2):
    rng = np.random.default_rng(7)
    L = (H_LAT // 2) ** 2
    return [(rng.standard_normal((L, cfg.in_channels)).astype(np.float32),
             {"txt": rng.standard_normal((TXT, cfg.context_dim)).astype(
                 np.float32),
              "y": rng.standard_normal((cfg.vec_dim,)).astype(np.float32),
              "guidance": np.float32(4.0 - i)},
             linear_schedule(3 + i)) for i in range(n)]


def _jax_engine(model, reqs, **kw):
    eng = jpipeline.flux_engine(model, H_LAT, H_LAT, TXT, max_batch=2, **kw)
    rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
    eng.run_until_drained()
    return [np.asarray(r.result, np.float32) for r in rs]


def test_tp_engine_matches_reference(ranks, setup):
    """flux_engine(mesh=tp2) on every rank, the same submissions, against
    the reference's flux_engine(mesh=...) over its TP forward."""
    sd, cfg, _ = setup
    reqs = _requests(cfg)
    sharded = tp_flux.shard_flux_params(sd, cfg, 2, Q.Q8_0)
    model = pipeline.DiffusionModel(arch="flux", params=None, config=cfg,
                                    qcfg=F32, device=torch.device("cpu"))
    outs = ranks.run(jobs.engine, "flux_engine", model, reqs,
                     {"tp": True, "args": (H_LAT, H_LAT, TXT),
                      "max_batch": 2}, sharded, tp_flux.BLOCK_KEYS)
    mesh = _jmesh(2)
    jmodel = jpipeline.DiffusionModel(
        arch="flux", params=jtp_flux.place_tp_params(
            jtp_flux.shard_flux_params(sd, cfg, 2, Q.Q8_0), mesh),
        config=cfg, qcfg=JF32)
    want = _jax_engine(jmodel, reqs, mesh=mesh)
    for a, b in zip(outs[0], outs[1]):
        assert np.array_equal(a, b)
    for got, w in zip(outs[0], want):
        assert _rel(got, w) < ENGINE_TOL


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_dp_engine_matches_reference_and_batch_one(ranks, setup, sampler):
    """flux_engine(dp_mesh=dp2): each rank steps one lane of the pair (and
    its multistep state); the results equal each request served alone at
    batch 1 (per-sample ops) and the reference's dp engine within the
    engine bound."""
    sd, cfg, _ = setup
    reqs = _requests(cfg)
    flat = tp_spec.quantize_unsharded(
        sd, block_groups=[("double_blocks", cfg.depth_double),
                          ("single_blocks", cfg.depth_single)],
        rules=tp_spec.flux_rules(cfg.hidden), qtype=Q.Q8_0)
    model = pipeline.DiffusionModel(arch="flux", params=flat, config=cfg,
                                    qcfg=F32, device=torch.device("cpu"))
    outs = ranks.run(jobs.engine, "flux_engine", model, reqs,
                     {"dp": True, "args": (H_LAT, H_LAT, TXT),
                      "max_batch": 2, "sampler": sampler})
    alone = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' count: CPU sums split by it
    try:
        for x, c, s in reqs:
            eng = pipeline.flux_engine(model, H_LAT, H_LAT, TXT, max_batch=1,
                                       sampler=sampler)
            r = eng.submit(x.copy(), c, s)
            eng.run_until_drained()
            alone.append(np.asarray(r.result, np.float32))
    finally:
        torch.set_num_threads(threads)
    for got, a in zip(outs[0], alone):
        assert np.array_equal(got, a)
    from comfyui_gguf_tpu.parallel import tp_spec as jtp_spec

    jflat = jtp_spec.quantize_unsharded(
        sd, block_groups=[("double_blocks", cfg.depth_double),
                          ("single_blocks", cfg.depth_single)],
        rules=jtp_spec.flux_rules(cfg.hidden), qtype=Q.Q8_0)
    jmodel = jpipeline.DiffusionModel(arch="flux", params=jflat, config=cfg,
                                      qcfg=JF32)
    want = _jax_engine(jmodel, reqs, dp_mesh=_jmesh(2, ("dp",)),
                       sampler=sampler)
    for got, w in zip(outs[0], want):
        assert _rel(got, w) < ENGINE_TOL


def test_dp_engine_refuses_indivisible_batch(setup):
    import types

    sd, cfg, _ = setup
    model = pipeline.DiffusionModel(arch="flux", params={}, config=cfg,
                                    qcfg=F32, device=torch.device("cpu"))
    stub = types.SimpleNamespace(mesh_dim_names=("dp",),
                                 size=lambda i: 2, get_local_rank=lambda a: 0)
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        pipeline.flux_engine(model, H_LAT, H_LAT, TXT, max_batch=3,
                             dp_mesh=stub)
