"""The port's samplers and schedules (``sampling/kdiffusion.py``,
``sampling/flow_match.py``) against the reference package's, on the CPU.

* Each of the 9 schedules and ``make_schedule`` equal the reference's
  within 1e-6 (relative).
* Each of the 15 k-diffusion samplers on a closed-form nonlinear denoiser,
  float32, within 1e-5 (relative to the output's scale). The stochastic
  ones get the reference's own draws: the test replays its key chain
  (``key, sub = split(key); normal(sub, shape)``) and feeds those arrays
  through ``noise``, counting the calls against the reference's draws.
* Each flow sampler (the 9 of ``FLOW_SAMPLERS`` and the 7 of
  ``FLOW_STOCHASTIC_SAMPLERS``) on a tiny Q8_0 flux carried across with
  ``interop.params_from_numpy``, float32 compute and float32 latents,
  3 steps of ``flux_schedule``: within 1e-4 (the two packages' f32 flux
  forwards agree to ~1e-6 a call; the samplers compound a few calls).
* ``_lms_coeffs`` against the reference's host and traced versions,
  ``run_sampler``'s errors, and the reference's 31 property tests
  (``tests/test_samplers.py``) run on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.models import flux as jflux
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.sampling import flow_match as jfm
from comfyui_gguf_tpu.sampling import kdiffusion as jkd
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import flux
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.sampling import flow_match as fm
from comfyui_gguf_tpu_torch.sampling import kdiffusion as kd

torch.set_num_threads(2)

TOL_CLOSED, TOL_FLUX = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _sched(n, smax=10.0, smin=0.1, end_zero=True):
    s = np.geomspace(smax, smin, n)
    if end_zero:
        s = np.append(s, 0.0)
    return np.asarray(s, np.float32)


class Replay:
    """The reference's draws from ``key``, in order, as ``noise(shape)``."""

    def __init__(self, key, n, shape):
        self.draws = []
        for _ in range(n):
            key, sub = jax.random.split(key)
            self.draws.append(np.asarray(
                jax.random.normal(sub, shape, jnp.float32)))
        self.calls = 0

    def __call__(self, shape):
        a = self.draws[self.calls]
        assert a.shape == tuple(shape)
        self.calls += 1
        return torch.from_numpy(a.copy())


# the reference's draws a step: 2 in dpmpp_sde, 0 in dpmpp_3m_sde at eta 0
DRAWS_PER_STEP = {"dpmpp_sde": 2}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

TABLE = jkd.ddpm_sigmas()


def test_ddpm_sigmas_match():
    np.testing.assert_array_equal(kd.ddpm_sigmas(), jkd.ddpm_sigmas())


@pytest.mark.parametrize("name", sorted(jkd.SCHEDULES))
@pytest.mark.parametrize("steps", [1, 7, 20])
def test_schedule_matches_reference(name, steps):
    want = jkd.make_schedule(name, steps, TABLE)
    got = kd.make_schedule(name, steps, kd.ddpm_sigmas())
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the registry's own entry, not only the dispatcher
    np.testing.assert_allclose(kd.SCHEDULES[name](steps, TABLE), want,
                               rtol=1e-6, atol=0)


def test_schedule_functions_with_their_own_arguments():
    for got, want in (
            (kd.karras_schedule(9, 0.03, 14.6, rho=5.0),
             jkd.karras_schedule(9, 0.03, 14.6, rho=5.0)),
            (kd.exponential_schedule(9, 0.03, 14.6),
             jkd.exponential_schedule(9, 0.03, 14.6)),
            (kd.kl_optimal_schedule(9, 0.03, 14.6),
             jkd.kl_optimal_schedule(9, 0.03, 14.6)),
            (kd.linear_quadratic_schedule(9, 1.0, 0.05, 3),
             jkd.linear_quadratic_schedule(9, 1.0, 0.05, 3)),
            (kd.beta_schedule(9, TABLE, 0.5, 0.7),
             jkd.beta_schedule(9, TABLE, 0.5, 0.7))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert sorted(kd.SCHEDULES) == sorted(jkd.SCHEDULES)
    with pytest.raises(ValueError, match="scheduler"):
        kd.make_schedule("bogus", 10, TABLE)


# ---------------------------------------------------------------------------
# k-diffusion samplers on a closed-form denoiser
# ---------------------------------------------------------------------------

_A = np.random.default_rng(11).standard_normal((8, 8)).astype(np.float32)


def _jden(x, s):
    return (jnp.tanh(x.astype(jnp.float32) @ (0.1 * _A)) * (1 + s)
            + 0.3 * x.astype(jnp.float32))


def _tden(x, s):
    return (torch.tanh(x.to(torch.float32) @ torch.from_numpy(0.1 * _A))
            * (1 + s) + 0.3 * x.to(torch.float32))


X0 = (np.random.default_rng(0).standard_normal((2, 8)) * 10).astype(
    np.float32)
SIG = _sched(7)


@pytest.mark.parametrize("name", sorted(jkd.SAMPLERS))
def test_deterministic_sampler_matches_reference(name):
    want = jkd.SAMPLERS[name](_jden, jnp.asarray(X0), jnp.asarray(SIG))
    got = kd.SAMPLERS[name](_tden, _t(X0), SIG)
    assert got.dtype == torch.float32 and got.shape == X0.shape
    assert _rel(got.numpy(), want) <= TOL_CLOSED


@pytest.mark.parametrize("name", sorted(jkd.STOCHASTIC_SAMPLERS))
def test_stochastic_sampler_matches_reference_with_its_draws(name):
    key = jax.random.key(5)
    want = jkd.STOCHASTIC_SAMPLERS[name](_jden, jnp.asarray(X0),
                                         jnp.asarray(SIG), key)
    n_steps = len(SIG) - 1
    noise = Replay(key, 2 * n_steps, X0.shape)
    got = kd.STOCHASTIC_SAMPLERS[name](_tden, _t(X0), SIG, noise)
    assert noise.calls == DRAWS_PER_STEP.get(name, 1) * n_steps
    assert _rel(got.numpy(), want) <= TOL_CLOSED


@pytest.mark.parametrize("knobs", [
    ("euler_ancestral", {"eta": 0.5}), ("dpm_2_ancestral", {"eta": 0.6}),
    ("dpmpp_2s_ancestral", {"eta": 0.0}), ("dpmpp_3m_sde", {"eta": 0.0}),
    ("dpmpp_3m_sde", {"eta": 0.7}),
    ("dpmpp_2m_sde", {"eta": 0.5, "solver": "heun", "s_noise": 0.8}),
    ("dpmpp_sde", {"eta": 0.8, "s_noise": 0.9, "r": 0.3})],
    ids=lambda k: f"{k[0]}-{k[1]}")
def test_stochastic_knobs_match_reference(knobs):
    name, kw = knobs
    key = jax.random.key(9)
    want = jkd.STOCHASTIC_SAMPLERS[name](_jden, jnp.asarray(X0),
                                         jnp.asarray(SIG), key, **kw)
    noise = Replay(key, 2 * (len(SIG) - 1), X0.shape)
    got = kd.STOCHASTIC_SAMPLERS[name](_tden, _t(X0), SIG, noise, **kw)
    if name == "dpmpp_3m_sde" and kw["eta"] == 0.0:
        assert noise.calls == 0  # the reference draws only when eta > 0
    assert _rel(got.numpy(), want) <= TOL_CLOSED


@pytest.mark.parametrize("name,kw", [("dpm_2_ancestral", {"eta": 2.0}),
                                     ("dpmpp_sde", {"eta": 1.5, "r": 0.3})])
def test_ancestral_eta_above_one_divergence(name, kw):
    """At eta > 1 σ_up clamps to σ' and σ_down = sqrt(σ'² − σ'²) is exactly
    0, where k-diffusion takes an Euler step. The port computes it so. The
    reference's compiled scan leaves a rounding residue instead (3e-4 and
    2e-5 on these sigmas), so its dpm_2_ancestral takes a midpoint step
    towards a σ_mid near 0 (an output 1.2 away in relative terms). Run op by
    op (``jax.disable_jit``), the reference computes σ_down = 0 too, and the
    port matches it within the 1e-5 of the other knobs."""
    split = jax.jit(lambda a, b: jkd._ancestral_split(a, b, 2.0))
    residues = [float(split(jnp.float32(a), jnp.float32(b))[0])
                for a, b in zip(SIG[:-1], SIG[1:])]
    assert max(residues) > 0.0
    assert all(kd._ancestral_split(a, b, 2.0)[0] == 0.0
               for a, b in zip(SIG[:-1], SIG[1:]))
    key = jax.random.key(9)
    with jax.disable_jit():
        want = jkd.STOCHASTIC_SAMPLERS[name](_jden, jnp.asarray(X0),
                                             jnp.asarray(SIG), key, **kw)
    noise = Replay(key, 2 * (len(SIG) - 1), X0.shape)
    got = kd.STOCHASTIC_SAMPLERS[name](_tden, _t(X0), SIG, noise, **kw)
    assert _rel(got.numpy(), want) <= TOL_CLOSED


@pytest.mark.parametrize("variant", ["bh1", "bh2"])
def test_uni_pc_variants_match_reference(variant):
    want = jkd.uni_pc_sample_sigma(_jden, jnp.asarray(X0), jnp.asarray(SIG),
                                   variant=variant)
    got = kd.uni_pc_sample_sigma(_tden, _t(X0), SIG, variant=variant)
    assert _rel(got.numpy(), want) <= TOL_CLOSED


def test_bf16_latent_sampler_matches_reference():
    """A bf16 latent is rounded between steps in both packages (uni_pc
    carries two rounded states)."""
    for name in ("uni_pc", "dpmpp_2m", "heun"):
        want = jkd.SAMPLERS[name](_jden, jnp.asarray(X0, jnp.bfloat16),
                                  jnp.asarray(SIG))
        got = kd.SAMPLERS[name](_tden, _t(X0).to(torch.bfloat16), SIG)
        assert got.dtype == torch.bfloat16
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
            <= 1e-2, name


def test_inpaint_sampler_matches_reference():
    rng = np.random.default_rng(2)
    z0 = rng.standard_normal(X0.shape).astype(np.float32)
    mask = (rng.uniform(size=X0.shape) > 0.5).astype(np.float32)
    key = jax.random.key(4)
    want = jkd.euler_sample_sigma_inpaint(
        _jden, jnp.asarray(X0), jnp.asarray(SIG), jnp.asarray(z0),
        jnp.asarray(mask), key)
    draws = iter([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                               X0.shape))
                  for i in range(len(SIG) - 1)])
    got = kd.euler_sample_sigma_inpaint(
        _tden, _t(X0), SIG, _t(z0), _t(mask),
        lambda shape: torch.from_numpy(next(draws).copy()))
    assert _rel(got.numpy(), want) <= TOL_CLOSED


def test_eps_and_v_denoisers_match_reference():
    table = jkd.ddpm_sigmas()
    W = np.random.default_rng(1).standard_normal((8, 8)).astype(np.float32)

    def jfn(x, t):
        return jnp.tanh(x @ W) + 1e-3 * t[:, None]

    def tfn(x, t):
        return torch.tanh(x @ torch.from_numpy(W)) + 1e-3 * t[:, None]

    x = X0 / 10
    for mk, jmk in ((kd.make_eps_denoiser, jkd.make_eps_denoiser),
                    (kd.make_v_denoiser, jkd.make_v_denoiser)):
        for s in (0.05, 1.3, 14.0):
            want = jmk(jfn, table)(jnp.asarray(x), jnp.float32(s))
            got = mk(tfn, table)(_t(x), torch.tensor(s, dtype=torch.float32))
            assert _rel(got.numpy(), want) <= 1e-6
    s = np.asarray([0.01, 0.5, 3.0, 14.0, 20.0], np.float32)
    np.testing.assert_allclose(kd.sigma_to_t(torch.from_numpy(s),
                                             table).numpy(),
                               np.asarray(jkd.sigma_to_t(s, table)),
                               rtol=1e-5, atol=1e-4)


def test_lms_coeffs_match_both_reference_versions():
    """The port computes lms's weights on the host only (its loop knows the
    schedule): equal to the reference's host version, and within float32
    of its traced closed form."""
    for sig in (_sched(7), _sched(3), np.linspace(1, 0, 9, dtype=np.float32)):
        s64 = np.asarray(sig, np.float64)
        for order in (1, 2, 3, 4):
            got = kd._lms_coeffs(s64, order)
            np.testing.assert_array_equal(got, jkd._lms_coeffs(s64, order))
        traced = np.asarray(jkd._lms_coeffs_jnp(jnp.asarray(sig)))
        np.testing.assert_allclose(kd._lms_coeffs(s64, 4), traced,
                                   rtol=2e-4, atol=2e-5)


def test_run_sampler_dispatch_and_errors():
    den = lambda x, s: torch.zeros_like(x)  # noqa: E731
    x0 = torch.ones((2, 2))
    sig = _sched(4)
    with pytest.raises(ValueError, match="stochastic: pass noise"):
        kd.run_sampler("lcm", den, x0, sig)
    with pytest.raises(ValueError, match="unknown sampler 'bogus'"):
        kd.run_sampler("bogus", den, x0, sig)
    with pytest.raises(ValueError, match="solver must be"):
        kd.run_sampler("dpmpp_2m_sde", den, x0, sig,
                       generator=torch.Generator(), solver="rk4")
    with pytest.raises(ValueError, match="variant must be"):
        kd.run_sampler("uni_pc", den, x0, sig, variant="bh3")
    a = kd.run_sampler("euler_ancestral", den, x0, _sched(4, end_zero=False),
                       generator=torch.Generator().manual_seed(1))
    b = kd.run_sampler("euler_ancestral", den, x0, _sched(4, end_zero=False),
                       generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sorted(kd.SAMPLERS) == sorted(jkd.SAMPLERS)
    assert sorted(kd.STOCHASTIC_SAMPLERS) == sorted(jkd.STOCHASTIC_SAMPLERS)


# ---------------------------------------------------------------------------
# flow samplers on tiny flux
# ---------------------------------------------------------------------------

JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TF32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
H_LAT, TXT = 8, 8


@pytest.fixture(scope="module")
def tiny_flux():
    dims = jtesting.TinyFluxDims()
    jp = jtesting.quantize_flux_params(
        jtesting.flux_state_dict(dims, seed=0), qtype=JQ.Q8_0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg = dims.config()
    tcfg = flux.FluxConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    L = (H_LAT // 2) ** 2
    img = rng.standard_normal((1, L, dims.in_ch)).astype(np.float32)
    ids = np.array(jflux.make_img_ids(H_LAT // 2, H_LAT // 2, 1))
    txt = rng.standard_normal((1, TXT, dims.ctx)).astype(np.float32)
    tids = np.zeros((1, TXT, 3), np.int32)
    y = rng.standard_normal((1, dims.vec)).astype(np.float32)
    g = np.full((1,), 3.5, np.float32)

    def jvel(x, s):
        return jflux.forward(jp, cfg, x, ids, txt, tids,
                             jnp.full((1,), s, jnp.float32), y, g, qcfg=JF32)

    targs = [torch.from_numpy(a) for a in (ids, txt, tids, y, g)]

    def tvel(x, s):
        i, t, ti, yy, gg = targs
        return flux.forward(tp, tcfg, x, i, t, ti, s.expand(1), yy, gg,
                            qcfg=TF32)

    sig = jfm.flux_schedule(3, L)
    return jvel, tvel, img, sig


FLOW_NAMES = sorted(jfm.FLOW_SAMPLERS)
FLOW_STOCH_NAMES = sorted(jfm.FLOW_STOCHASTIC_SAMPLERS)


def test_flow_menus_match_reference():
    assert sorted(fm.FLOW_SAMPLERS) == FLOW_NAMES
    assert sorted(fm.FLOW_STOCHASTIC_SAMPLERS) == FLOW_STOCH_NAMES


@pytest.mark.parametrize("name", FLOW_NAMES)
def test_flow_sampler_on_tiny_flux_matches_reference(tiny_flux, name):
    jvel, tvel, img, sig = tiny_flux
    want = jfm.FLOW_SAMPLERS[name](jvel, jnp.asarray(img), jnp.asarray(sig))
    got = fm.sample_flow(tvel, _t(img), sig, sampler=name)
    assert bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), want) <= TOL_FLUX


@pytest.mark.parametrize("name", FLOW_STOCH_NAMES)
def test_flow_stochastic_sampler_on_tiny_flux_matches_reference(tiny_flux,
                                                                name):
    jvel, tvel, img, sig = tiny_flux
    key = jax.random.key(7)
    want = jfm.FLOW_STOCHASTIC_SAMPLERS[name](jvel, jnp.asarray(img),
                                              jnp.asarray(sig), key)
    noise = Replay(key, 2 * (len(sig) - 1), img.shape)
    got = fm.FLOW_STOCHASTIC_SAMPLERS[name](tvel, _t(img), sig, noise)
    assert noise.calls == DRAWS_PER_STEP.get(name, 1) * (len(sig) - 1)
    assert _rel(got.numpy(), want) <= TOL_FLUX


def test_cfg_wrap_matches_reference():
    def jm(x, s, c):
        return x * c + s

    def tm(x, s, c):
        return x * c + s

    x = np.linspace(-1, 1, 6, dtype=np.float32)
    for scale, unc in ((1.0, 0.5), (4.0, 0.5), (4.0, None)):
        want = jfm.cfg_wrap(jm, 2.0, unc, scale)(jnp.asarray(x), 0.3)
        got = fm.cfg_wrap(tm, 2.0, unc, scale)(_t(x), 0.3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_sample_flow_default_and_unknown_name():
    v = lambda x, s: -x  # noqa: E731
    x0 = torch.full((4,), 2.0)
    sig = np.linspace(1.0, 0.2, 6).astype(np.float32)
    assert fm.DEFAULT_FLOW_SAMPLER == "euler"
    torch.testing.assert_close(fm.sample_flow(v, x0, sig),
                               fm.euler_sample(v, x0, sig))
    with pytest.raises(ValueError, match="unknown flow sampler"):
        fm.sample_flow(v, x0, sig, sampler="bogus")
    with pytest.raises(ValueError, match="unknown flow sampler"):
        fm.set_flow_sampler("bogus")
    try:
        fm.set_flow_sampler("multistep")
        torch.testing.assert_close(fm.sample_flow(v, x0, sig),
                                   fm.multistep_sample(v, x0, sig))
    finally:
        fm.set_flow_sampler("euler")


# ---------------------------------------------------------------------------
# the reference's property tests (tests/test_samplers.py), on the port
# ---------------------------------------------------------------------------

def _key_noise(seed):
    return kd.generator_noise(torch.Generator().manual_seed(seed))


def test_all_samplers_reach_clean_target():
    """Perfect denoiser D(x, σ) = c: every sampler must land exactly on
    c (the final σ→0 step collapses to the denoised output)."""
    c = torch.full((2, 8), 3.5)
    den = lambda x, s: c  # noqa: E731
    x0 = _t(X0)
    sig = _sched(8)
    for fn in (kd.euler_sample_sigma, kd.heun_sample_sigma,
               kd.dpmpp_2m_sample_sigma):
        torch.testing.assert_close(fn(den, x0, sig), c, rtol=1e-4,
                                   atol=1e-4)
    out = kd.euler_ancestral_sample_sigma(den, x0, sig, _key_noise(0))
    torch.testing.assert_close(out, c, rtol=1e-4, atol=1e-4)


def test_second_order_beats_euler_on_power_ode():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)
    sig = _sched(6, smax=10.0, smin=0.5, end_zero=False)
    exact = 8.0 * np.sqrt(float(sig[-1]) / float(sig[0]))

    def err(fn):
        return abs(float(fn(den, x0, sig)[0]) - exact)

    e_eul = err(kd.euler_sample_sigma)
    assert err(kd.heun_sample_sigma) < e_eul
    assert err(kd.dpmpp_2m_sample_sigma) < e_eul


def test_ancestral_eta0_equals_euler():
    den = lambda x, s: 0.3 * x  # noqa: E731
    x0 = _t(np.random.default_rng(1).standard_normal((3, 5)))
    sig = _sched(7)
    a = kd.euler_ancestral_sample_sigma(den, x0, sig, _key_noise(1),
                                        eta=0.0)
    b = kd.euler_sample_sigma(den, x0, sig)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_ancestral_is_stochastic():
    den = lambda x, s: 0.0 * x  # noqa: E731
    x0 = torch.ones((2, 4))
    sig = _sched(6, end_zero=False)
    a = kd.euler_ancestral_sample_sigma(den, x0, sig, _key_noise(2))
    b = kd.euler_ancestral_sample_sigma(den, x0, sig, _key_noise(3))
    assert float((a - b).abs().max()) > 1e-3


def test_flow_multistep_beats_euler():
    v_fn = lambda x, s: -x  # noqa: E731
    x0 = torch.full((4,), 2.0)
    sig = np.linspace(1.0, 0.2, 6).astype(np.float32)
    exact = 2.0 * np.exp(float(sig[0]) - float(sig[-1]))
    e_eul = abs(float(fm.euler_sample(v_fn, x0, sig)[0]) - exact)
    e_ms = abs(float(fm.multistep_sample(v_fn, x0, sig)[0]) - exact)
    assert e_ms < e_eul, (e_ms, e_eul)


def test_flow_multistep_linear_exact():
    v_fn = lambda x, s: torch.full_like(x, 3.0)  # noqa: E731
    x0 = torch.zeros((2,))
    sig = np.asarray([1.0, 0.6, 0.3, 0.0], np.float32)
    for fn in (fm.euler_sample, fm.multistep_sample):
        np.testing.assert_allclose(float(fn(v_fn, x0, sig)[0]), -3.0,
                                   rtol=1e-6)


def test_new_samplers_reach_clean_target():
    c = torch.full((2, 8), 3.5)
    den = lambda x, s: c.expand(x.shape)  # noqa: E731
    x0 = _t(X0)
    sig = _sched(8)
    torch.testing.assert_close(kd.ddim_sample_sigma(den, x0, sig), c,
                               rtol=1e-4, atol=1e-4)
    for fn in (kd.lcm_sample_sigma, kd.dpmpp_2m_sde_sample_sigma,
               kd.dpmpp_sde_sample_sigma):
        torch.testing.assert_close(fn(den, x0, sig, _key_noise(0)), c,
                                   rtol=1e-4, atol=1e-4)


def test_ddim_exact_for_constant_denoised_any_grid():
    c = 3.5
    den = lambda x, s: torch.full_like(x, c)  # noqa: E731
    x0 = torch.full((4,), -7.0)
    for sig in (_sched(2, end_zero=False), _sched(9, end_zero=False)):
        out = kd.ddim_sample_sigma(den, x0, sig)
        ratio = float(sig[-1] / sig[0])
        want = ratio * (-7.0) + (1 - ratio) * c
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dpmpp_2m_sde_eta0_matches_ddim_on_constant():
    den = lambda x, s: torch.full_like(x, 2.0)  # noqa: E731
    x0 = torch.full((4,), 9.0)
    sig = _sched(6, end_zero=False)
    a = kd.dpmpp_2m_sde_sample_sigma(den, x0, sig, _key_noise(1), eta=0.0)
    b = kd.ddim_sample_sigma(den, x0, sig)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dpmpp_sde_eta0_second_order():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)
    sig = _sched(6, end_zero=False)
    exact = 8.0 * np.sqrt(float(sig[-1]) / float(sig[0]))
    e_euler = abs(float(kd.euler_sample_sigma(den, x0, sig)[0]) - exact)
    e_sde = abs(float(kd.dpmpp_sde_sample_sigma(
        den, x0, sig, _key_noise(0), eta=0.0)[0]) - exact)
    assert e_sde < e_euler, (e_sde, e_euler)


def test_2m_sde_solvers_agree_smooth_field():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)
    sig = _sched(12, end_zero=False)
    m = kd.dpmpp_2m_sde_sample_sigma(den, x0, sig, _key_noise(2), eta=0.0,
                                     solver="midpoint")
    h = kd.dpmpp_2m_sde_sample_sigma(den, x0, sig, _key_noise(2), eta=0.0,
                                     solver="heun")
    np.testing.assert_allclose(m.numpy(), h.numpy(), rtol=0.02)
    s = kd.dpmpp_2m_sde_sample_sigma(den, x0, sig, _key_noise(2), eta=1.0)
    assert not np.allclose(s.numpy(), m.numpy())


def test_lcm_final_step_is_denoised():
    den = lambda x, s: torch.full_like(x, 1.25)  # noqa: E731
    x0 = torch.full((3,), 50.0)
    sig = np.asarray([10.0, 0.0], np.float32)
    out = kd.lcm_sample_sigma(den, x0, sig, _key_noise(0))
    np.testing.assert_allclose(out.numpy(), 1.25, atol=1e-6)


def _flow_const_x0(c):
    def vel(x, s):
        return (x.to(torch.float32) - c) / torch.clamp_min(
            torch.as_tensor(s, dtype=torch.float32), 1e-12)
    return vel


def test_flow_sigma_space_samplers_exact_constant_x0():
    c = 2.25
    vel = _flow_const_x0(c)
    x0 = torch.full((2, 4), -5.0)
    sig = np.linspace(1.0, 0.0, 4).astype(np.float32)
    for name in ("ddim", "dpmpp_2m", "heun"):
        out = fm.FLOW_SAMPLERS[name](vel, x0, sig)
        np.testing.assert_allclose(out.numpy(), c, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    out = fm.FLOW_STOCHASTIC_SAMPLERS["dpmpp_2m_sde"](vel, x0, sig,
                                                       _key_noise(0))
    np.testing.assert_allclose(out.numpy(), c, rtol=1e-4, atol=1e-4)


def test_flow_euler_matches_ddim_converged():
    def vel(x, s):
        return torch.tanh(x) * (1.0 + s)

    x0 = torch.full((2,), 0.7)
    sig = np.linspace(1.0, 0.0, 257).astype(np.float32)
    a = fm.FLOW_SAMPLERS["euler"](vel, x0, sig)
    b = fm.FLOW_SAMPLERS["ddim"](vel, x0, sig)
    torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_new_schedules():
    expo = kd.exponential_schedule(10, 0.03, 14.6)
    assert len(expo) == 11 and expo[-1] == 0.0
    assert np.allclose(np.diff(np.log(expo[:-1])),
                       np.diff(np.log(expo[:-1]))[0])
    table = kd.ddpm_sigmas()
    sgm = kd.sgm_uniform_schedule(8, table)
    norm = kd.normal_schedule(8, table)
    assert len(sgm) == 9 and sgm[-1] == 0.0
    # sgm_uniform excludes the σ_min table endpoint; normal includes it
    assert sgm[-2] > norm[-2]
    assert np.all(np.diff(sgm[:-1]) < 0)


def test_uni_pc_reaches_clean_target():
    c = torch.full((2, 8), 3.5)
    den = lambda x, s: c.expand(x.shape)  # noqa: E731
    for variant in ("bh1", "bh2"):
        out = kd.uni_pc_sample_sigma(den, _t(X0), _sched(8), variant=variant)
        torch.testing.assert_close(out, c, rtol=1e-4, atol=1e-4)


def test_uni_pc_exact_constant_denoised_no_zero():
    den = lambda x, s: torch.full_like(x, 2.0)  # noqa: E731
    x0 = torch.full((4,), 9.0)
    sig = _sched(6, end_zero=False)
    torch.testing.assert_close(kd.uni_pc_sample_sigma(den, x0, sig),
                               kd.ddim_sample_sigma(den, x0, sig),
                               rtol=1e-5, atol=1e-5)


def test_uni_pc_second_order():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)

    def err(n):
        sig = _sched(n, end_zero=False)
        exact = 8.0 * np.sqrt(float(sig[-1]) / float(sig[0]))
        return abs(float(kd.uni_pc_sample_sigma(den, x0, sig)[0]) - exact)

    sig6 = _sched(6, end_zero=False)
    exact6 = 8.0 * np.sqrt(float(sig6[-1]) / float(sig6[0]))
    e_euler = abs(float(kd.euler_sample_sigma(den, x0, sig6)[0]) - exact6)
    assert err(6) < e_euler / 3, (err(6), e_euler)
    assert err(11) < err(6) / 3, (err(11), err(6))


def test_uni_pc_through_flow_adapter():
    c = 2.25
    x0 = torch.full((2, 4), -5.0)
    sig = np.linspace(1.0, 0.0, 5).astype(np.float32)
    out = fm.FLOW_SAMPLERS["uni_pc"](_flow_const_x0(c), x0, sig)
    np.testing.assert_allclose(out.numpy(), c, rtol=1e-4, atol=1e-4)


def test_ancestral_eta2_clamped_still_converges():
    c = torch.full((2, 8), 3.5)
    den = lambda x, s: c.expand(x.shape)  # noqa: E731
    x0 = torch.full((2, 8), -20.0)
    sig = _sched(8)
    out = kd.euler_ancestral_sample_sigma(den, x0, sig, _key_noise(0),
                                          eta=2.0)
    torch.testing.assert_close(out, c, rtol=1e-4, atol=1e-4)
    out2 = kd.dpmpp_sde_sample_sigma(den, x0, sig, _key_noise(0), eta=2.0)
    torch.testing.assert_close(out2, c, rtol=1e-4, atol=1e-4)


def test_dpm2_ipndm_lms_reach_or_approach_clean_target():
    c = torch.full((2, 8), 3.5)
    den = lambda x, s: c  # noqa: E731
    x0 = _t(np.random.default_rng(3).standard_normal((2, 8)) * 10)
    sig = _sched(10)
    torch.testing.assert_close(kd.dpm_2_sample_sigma(den, x0, sig), c,
                               rtol=1e-4, atol=1e-4)
    for fn in (kd.ipndm_sample_sigma, kd.lms_sample_sigma):
        out = fn(den, x0, sig)
        assert float((out - 3.5).abs().max()) < 0.2, fn


def test_new_multistep_samplers_beat_euler_on_power_ode():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)
    sig = _sched(8, smax=10.0, smin=0.5, end_zero=False)
    exact = 8.0 * np.sqrt(float(sig[-1]) / float(sig[0]))

    def err(fn):
        return abs(float(fn(den, x0, sig)[0]) - exact)

    e_eul = err(kd.euler_sample_sigma)
    for fn in (kd.dpm_2_sample_sigma, kd.ipndm_sample_sigma,
               kd.lms_sample_sigma):
        assert err(fn) < e_eul, (fn, err(fn), e_eul)


def test_dpm2_ancestral_eta0_equals_dpm2():
    den = lambda x, s: 0.3 * x  # noqa: E731
    x0 = _t(np.random.default_rng(5).standard_normal((3, 5)))
    sig = _sched(7)
    a = kd.dpm_2_ancestral_sample_sigma(den, x0, sig, _key_noise(2),
                                        eta=0.0)
    b = kd.dpm_2_sample_sigma(den, x0, sig)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_lms_coeffs_order1_is_euler():
    sig = np.asarray(_sched(6), np.float64)
    c = kd._lms_coeffs(sig, order=1)
    np.testing.assert_allclose(c[:, 0], np.diff(sig), rtol=1e-6)
    den = lambda x, s: 0.4 * x  # noqa: E731
    x0 = _t(np.random.default_rng(6).standard_normal((4,)))
    a = kd.lms_sample_sigma(den, x0, sig.astype(np.float32), order=1)
    b = kd.euler_sample_sigma(den, x0, sig.astype(np.float32))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_run_sampler_dispatch_new_names():
    den = lambda x, s: torch.zeros_like(x)  # noqa: E731
    x0 = torch.ones((2, 2))
    sig = _sched(4)
    for name in ("dpm_2", "ipndm", "lms"):
        assert bool(torch.isfinite(kd.run_sampler(name, den, x0, sig)).all())
    out = kd.run_sampler("dpm_2_ancestral", den, x0, sig,
                         generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out).all())


def test_lms_host_coeffs_and_tensor_schedule():
    """The reference also checks its traced coefficient twin under jit;
    the port has only the host version, so: the host weights against the
    reference's traced ones, and a schedule handed over as a tensor gives
    the same result as the numpy one."""
    sig = np.asarray(_sched(7), np.float64)
    np.testing.assert_allclose(
        np.asarray(jkd._lms_coeffs_jnp(jnp.asarray(sig, jnp.float32))),
        kd._lms_coeffs(sig, order=4), rtol=2e-4, atol=2e-5)
    den = lambda x, s: 0.4 * x  # noqa: E731
    x0 = _t(np.random.default_rng(7).standard_normal((4,)))
    got = kd.lms_sample_sigma(den, x0, torch.from_numpy(
        sig.astype(np.float32)))
    want = kd.lms_sample_sigma(den, x0, sig.astype(np.float32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_new_schedulers_shapes_and_monotonicity():
    table = kd.ddpm_sigmas()
    for name in ("normal", "karras", "exponential", "sgm_uniform",
                 "ddim_uniform", "beta", "kl_optimal",
                 "linear_quadratic"):
        sig = kd.make_schedule(name, 12, table)
        assert sig[-1] == 0.0, name
        assert np.all(np.diff(sig) < 0), (name, sig)
        assert sig[0] > 1.0, name
    lq = kd.linear_quadratic_schedule(10, sigma_max=14.6)
    d = np.diff(lq[:5])
    np.testing.assert_allclose(d, d[0], rtol=1e-4)
    with pytest.raises(ValueError, match="scheduler"):
        kd.make_schedule("bogus", 10, table)


def test_dpmpp_2s_ancestral_and_3m_sde_reach_clean_target():
    c = torch.full((2, 8), -2.25)
    den = lambda x, s: c  # noqa: E731
    x0 = _t(np.random.default_rng(8).standard_normal((2, 8)) * 10)
    sig = _sched(8)
    for fn in (kd.dpmpp_2s_ancestral_sample_sigma,
               kd.dpmpp_3m_sde_sample_sigma):
        torch.testing.assert_close(fn(den, x0, sig, _key_noise(3)), c,
                                   rtol=1e-4, atol=1e-4)


def test_dpmpp_2s_3m_eta0_deterministic_and_beat_euler():
    den = lambda x, s: 0.5 * x  # noqa: E731
    x0 = torch.full((4,), 8.0)
    sig = _sched(8, smax=10.0, smin=0.5, end_zero=False)
    exact = 8.0 * np.sqrt(float(sig[-1]) / float(sig[0]))
    e_eul = abs(float(kd.euler_sample_sigma(den, x0, sig)[0]) - exact)
    for fn in (kd.dpmpp_2s_ancestral_sample_sigma,
               kd.dpmpp_3m_sde_sample_sigma):
        a = fn(den, x0, sig, _key_noise(4), eta=0.0)
        b = fn(den, x0, sig, _key_noise(5), eta=0.0)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert abs(float(a[0]) - exact) < e_eul, (fn, float(a[0]), exact)


def test_run_sampler_dispatch_2s_3m():
    den = lambda x, s: torch.zeros_like(x)  # noqa: E731
    x0 = torch.ones((2, 2))
    sig = _sched(5)
    for name in ("dpmpp_2s_ancestral", "dpmpp_3m_sde"):
        out = kd.run_sampler(name, den, x0, sig,
                             generator=torch.Generator().manual_seed(6))
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-5)


def test_simple_schedule():
    table = np.linspace(0.03, 14.6, 1000).astype(np.float32)
    sig = kd.make_schedule("simple", 10, table)
    assert sig.shape == (11,) and sig[-1] == 0.0
    assert np.all(np.diff(sig) < 0)
    np.testing.assert_allclose(sig[0], table[-1], rtol=1e-6)
    want = [table[-(1 + int(100 * i))] for i in range(10)]
    np.testing.assert_allclose(sig[:-1], want, rtol=1e-6)
