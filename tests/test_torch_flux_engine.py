"""The port's continuous-batching flux engine (``pipeline.flux_engine``)
over a real tiny quantized flux, on the CPU.

The reference's four engine tests (``tests/test_flux_engine.py``) run on the
port: pooled requests against direct single-request integration (Euler,
and DPM-Solver++(2M) through the flow x₀-adapter), two models under a
memory budget through ``ResidentModelServer``, and the bucket router over
real engines. Beside them, the port's engine against the reference's
``flux_engine`` on the same tiny Q8_0 flux (carried across with
``interop.params_from_numpy``), the same requests and float32 compute, for
"euler" and "dpmpp_2m": within 1e-2 relative L2 (the latent steps in
bfloat16 in both, so a different float32 summation order moves a value
across a rounding boundary now and then; found 1.6e-3 to 2.9e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch import pipeline
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.lifecycle import tree_bytes, tree_leaves
from comfyui_gguf_tpu_torch.models import flux
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.sampling import (euler_sample, linear_schedule,
                                             sample_flow)

torch.set_num_threads(2)

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
H_LAT = W_LAT = 8
TXT_LEN = 8
CPU = torch.device("cpu")
DIMS = jtesting.TinyFluxDims()


def _jparams(seed):
    return jtesting.quantize_flux_params(
        jtesting.flux_state_dict(DIMS, seed=seed), qtype=JQ.Q8_0)


def _model(seed=0):
    params = params_from_numpy(jax.tree.map(np.asarray, _jparams(seed)),
                               "cpu")
    cfg = flux.FluxConfig(**dataclasses.asdict(DIMS.config()))
    return pipeline.DiffusionModel(arch="flux", params=params, config=cfg,
                                   qcfg=F32, device=CPU)


@pytest.fixture(scope="module")
def model():
    return _model(0)


def _cond(seed):
    rng = np.random.default_rng(seed)
    return {
        "txt": rng.standard_normal((TXT_LEN, DIMS.ctx)).astype(np.float32),
        "y": rng.standard_normal((DIMS.vec,)).astype(np.float32),
        "guidance": np.float32(4.0),
    }


def _tokens(seed, L=(H_LAT // 2) * (W_LAT // 2)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((L, DIMS.in_ch)).astype(np.float32)


def _velocity(mdl, cond, h_lat=H_LAT, w_lat=W_LAT):
    img_ids = torch.as_tensor(np.array(flux.make_img_ids(h_lat // 2,
                                                         w_lat // 2, 1)))
    txt_ids = torch.zeros((1, TXT_LEN, 3), dtype=torch.int32)
    txt = torch.from_numpy(cond["txt"])[None].to(torch.bfloat16)
    y = torch.from_numpy(cond["y"])[None].to(torch.bfloat16)
    g = torch.tensor([float(cond["guidance"])], dtype=torch.float32)

    def velocity(x, s):
        return flux.forward(mdl.params, mdl.config, x, img_ids, txt,
                            txt_ids, s.expand(1), y, g, qcfg=F32)
    return velocity


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_engine_matches_direct_euler(model):
    eng = pipeline.flux_engine(model, H_LAT, W_LAT, TXT_LEN, max_batch=4)
    x0 = _tokens(1)
    cond = _cond(2)
    sigmas = linear_schedule(3)
    req = eng.submit(x0, cond, sigmas)
    # a second request with a different schedule shares the pool
    req2 = eng.submit(_tokens(5), _cond(3), linear_schedule(5))
    eng.run_until_drained()
    assert req.finished and req2.finished

    want = euler_sample(_velocity(model, cond),
                        torch.from_numpy(x0)[None].to(torch.bfloat16),
                        sigmas)
    np.testing.assert_allclose(req.result, want[0].float().numpy(),
                               rtol=0.05, atol=0.05)
    assert req.result.dtype == np.float32
    assert eng.stats.completed == 2
    assert eng.stats.mean_batch_occupancy > 0.5


def test_engine_dpmpp_2m_matches_direct(model):
    """sampler="dpmpp_2m": pooled mixed-progress requests each match a
    per-request DPM-Solver++(2M) integration through the flow x₀-adapter
    (``sample_flow(..., "dpmpp_2m")``) — per-lane history is exact."""
    eng = pipeline.flux_engine(model, H_LAT, W_LAT, TXT_LEN, max_batch=2,
                               sampler="dpmpp_2m")
    (x1, c1, s1), (x2, c2, s2) = ((_tokens(40), _cond(40),
                                   linear_schedule(4)),
                                  (_tokens(41), _cond(41),
                                   linear_schedule(3)))
    r1 = eng.submit(x1.copy(), c1, s1)
    r2 = eng.submit(x2.copy(), c2, s2)
    eng.run_until_drained()
    assert r1.finished and r2.finished and r1.error is None

    for r, x, c, s in ((r1, x1, c1, s1), (r2, x2, c2, s2)):
        want = sample_flow(_velocity(model, c),
                           torch.from_numpy(x)[None].to(torch.bfloat16), s,
                           sampler="dpmpp_2m")
        np.testing.assert_allclose(r.result, want[0].float().numpy(),
                                   rtol=0.05, atol=0.05)

    with pytest.raises(ValueError, match="euler|dpmpp_2m"):
        pipeline.flux_engine(model, H_LAT, W_LAT, TXT_LEN, sampler="bogus")


def test_resident_model_server_two_models_lru():
    """TWO models sharing one device under a budget smaller than their
    sum: LRU eviction must swap them, results must match each model's
    standalone engine, and the evict→re-place cycle must not change
    outputs."""
    from comfyui_gguf_tpu_torch import serving

    seeds = {"m_a": 0, "m_b": 9}
    models = {name: _model(seed) for name, seed in seeds.items()}
    per_model = tree_bytes(models["m_a"].params)
    # budget fits ~one model: serving the other forces an eviction
    srv = serving.ResidentModelServer(hbm_budget=int(per_model * 1.5),
                                      device="cpu")
    for name, mdl in models.items():
        srv.register(
            name, mdl.params,
            lambda provider, mdl=mdl: pipeline.flux_engine(
                mdl, H_LAT, W_LAT, TXT_LEN, max_batch=2,
                params_provider=provider))

    # register (free_source default) must release the caller's tensors —
    # otherwise the still-referenced source trees keep their memory and
    # the budget is decorative
    for mdl in models.values():
        assert all(leaf.untyped_storage().nbytes() == 0
                   or leaf.numel() == 0
                   for leaf in tree_leaves(mdl.params))

    x0 = _tokens(4)
    cond = _cond(5)
    sigmas = linear_schedule(3)
    reqs = {n: srv.submit(n, x0, cond, sigmas) for n in models}
    srv.run_until_drained()
    assert all(r.finished for r in reqs.values())

    st = srv.stats["models"]
    assert sum(e["resident"] for e in st.values()) == 1, st  # one evicted
    assert not any(e["pinned"] for e in st.values())
    # the two models are different weights — results must differ
    assert not np.allclose(reqs["m_a"].result, reqs["m_b"].result)

    # standalone single-model engines give the same answers (fresh param
    # trees — the registered sources were freed above)
    for name, seed in seeds.items():
        eng = pipeline.flux_engine(_model(seed), H_LAT, W_LAT, TXT_LEN,
                                   max_batch=2)
        ref = eng.submit(x0, cond, sigmas)
        eng.run_until_drained()
        np.testing.assert_allclose(reqs[name].result, ref.result,
                                   rtol=1e-5, atol=1e-5)

    # second round: m_a must be re-placed (it was evicted) and still give
    # the same output
    req_a2 = srv.submit("m_a", x0, cond, sigmas)
    srv.run_until_drained()
    np.testing.assert_array_equal(req_a2.result, reqs["m_a"].result)


def test_bucket_router_over_flux_engines(model):
    """BucketRouter over REAL flux engines: two resolution buckets share
    one model's params, requests route by latent shape, results match
    per-bucket standalone engines."""
    from comfyui_gguf_tpu_torch.serving import BucketRouter

    def factory(shape):
        side = int(shape[0] ** 0.5) * 2  # h_tok == w_tok buckets here
        return pipeline.flux_engine(model, side, side, TXT_LEN, max_batch=2)

    router = BucketRouter(factory)
    x_small, x_big = _tokens(17, 16), _tokens(18, 36)
    c1, c2 = _cond(18), _cond(19)
    s = linear_schedule(3)
    r1 = router.submit(x_small.copy(), c1, s)
    r2 = router.submit(x_big.copy(), c2, s)
    router.run_until_drained()
    assert r1.finished and r2.finished
    assert set(router.engines) == {(16, DIMS.in_ch), (36, DIMS.in_ch)}

    for x, c, r, side in ((x_small, c1, r1, 8), (x_big, c2, r2, 12)):
        eng = pipeline.flux_engine(model, side, side, TXT_LEN, max_batch=2)
        ref = eng.submit(x.copy(), c, s)
        eng.run_until_drained()
        np.testing.assert_allclose(r.result, ref.result, rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jmodel():
    return jpipeline.DiffusionModel(arch="flux", params=_jparams(0),
                                    config=DIMS.config(), qcfg=JF32)


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_engine_matches_reference_engine(model, jmodel, sampler, stacked):
    """The port's engine and the reference's on the same tiny flux and the
    same three requests (mixed schedules, so the pool is mixed-progress
    and padded), on the flat and the depth-stacked tree."""
    tm = model.stack() if stacked else model
    jm = jmodel.stack() if stacked else jmodel
    reqs = [(_tokens(60 + i), _cond(70 + i), linear_schedule(3 + i))
            for i in range(3)]
    out = []
    for mk, m in ((jpipeline.flux_engine, jm), (pipeline.flux_engine, tm)):
        eng = mk(m, H_LAT, W_LAT, TXT_LEN, max_batch=2, sampler=sampler)
        rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
        eng.run_until_drained()
        assert all(r.finished and r.error is None for r in rs)
        out.append([np.asarray(r.result, np.float32) for r in rs])
    for want, got in zip(*out):
        assert got.shape == want.shape == (16, DIMS.in_ch)
        assert _rel(got, want) <= 1e-2


def test_parallel_engines_raise_until_ported(model):
    for kw in ({"mesh": object()}, {"dp_mesh": object()}):
        with pytest.raises(ValueError, match="axis"):
            pipeline.flux_engine(model, H_LAT, W_LAT, TXT_LEN, **kw)


def test_cfg_mix_velocity_matches_reference():
    """The CFG-mixing velocity closure (the other archs' engines use it)
    against the reference's: per-request scales mixed in float32."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    ctx, nctx = (rng.standard_normal((3, 4)).astype(np.float32)
                 for _ in range(2))
    scale = np.asarray([1.0, 3.5, 7.0], np.float32)

    def fwd(params, cfg, x, c, s, qcfg=None):
        return x * c[:, None, :] + s[:, None, None]

    class M:
        config = qcfg = None

    s_cur = np.asarray([0.9, 0.5, 0.1], np.float32)
    want = jpipeline._cfg_mix_velocity(fwd, M)(
        None, jnp.asarray(x), jnp.asarray(s_cur),
        {"ctx": jnp.asarray(ctx), "nctx": jnp.asarray(nctx),
         "cfg_scale": jnp.asarray(scale)})
    got = pipeline._cfg_mix_velocity(fwd, M)(
        None, torch.from_numpy(x), torch.from_numpy(s_cur),
        {"ctx": torch.from_numpy(ctx), "nctx": torch.from_numpy(nctx),
         "cfg_scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
