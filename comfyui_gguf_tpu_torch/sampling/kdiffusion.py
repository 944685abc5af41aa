"""k-diffusion-style σ-space samplers and schedules (PyTorch port of
comfyui_gguf_tpu/sampling/kdiffusion.py).

The SD UNet family is trained as discrete-time eps prediction over a beta
schedule, sampled here in continuous sigma space with the standard
k-diffusion parameterization (public EDM/k-diffusion math):

    σ_t = sqrt((1 − ᾱ_t)/ᾱ_t)            (discrete table from betas)
    denoised = x − σ·eps(x / sqrt(1+σ²), t(σ))
    Euler:  x ← x + (σ_next − σ)·(x − denoised)/σ

Every sampler is a Python loop over a host schedule (the reference's
``lax.scan``). The step's scalars (log-σ steps, ratios, ancestral splits,
multistep weights) are worked out on the host in float32, as the reference
computes them, and the branches the reference selects with
``jnp.where``/``lax.cond`` are taken on the host, so nothing waits for the
device. ``denoiser(x, sigma)`` receives sigma as a 0-d float32 tensor on
x's device and returns x₀̂ (any float dtype).

The stochastic samplers take ``noise(shape) -> float32 tensor`` in place of
the reference's ``jax.random`` key and call it exactly where the reference
draws (``key, sub = split(key); normal(sub, shape)``): once a step, twice a
step in dpmpp_sde, even on a final σ→0 step whose draw is masked, and in
dpmpp_3m_sde only when eta > 0. ``run_sampler`` builds such a callable
from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
_EPS = F(1e-12)


def ddpm_sigmas(beta_start: float = 0.00085, beta_end: float = 0.012,
                n: int = 1000) -> np.ndarray:
    """Discrete sigma table from the SD scaled-linear beta schedule."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n,
                        dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1 - alphas_cumprod) / alphas_cumprod).astype(np.float32)


def karras_schedule(num_steps: int, sigma_min: float, sigma_max: float,
                    rho: float = 7.0) -> np.ndarray:
    """Karras et al. spacing; appends σ=0. (num_steps+1,)."""
    ramp = np.linspace(0, 1, num_steps, dtype=np.float64)
    min_r = sigma_min ** (1 / rho)
    max_r = sigma_max ** (1 / rho)
    sigmas = (max_r + ramp * (min_r - max_r)) ** rho
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def simple_schedule(num_steps: int, sigma_table: np.ndarray) -> np.ndarray:
    """Host 'simple' scheduler: even fractional strides through the
    (ascending) discrete table measured from the top — the host UI's
    σ_i = table[-(1 + ⌊(T/steps)·i⌋)] — plus σ=0. (num_steps+1,)."""
    T = len(sigma_table)
    x = T / num_steps
    sig = [float(sigma_table[-(1 + int(x * i))]) for i in range(num_steps)]
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def normal_schedule(num_steps: int, sigma_table: np.ndarray) -> np.ndarray:
    """Evenly-spaced indices into the discrete sigma table + σ=0."""
    idx = np.linspace(len(sigma_table) - 1, 0, num_steps).round().astype(int)
    return np.concatenate([sigma_table[idx], [0.0]]).astype(np.float32)


def exponential_schedule(num_steps: int, sigma_min: float,
                         sigma_max: float) -> np.ndarray:
    """Log-linear sigma spacing (host 'exponential' scheduler) + σ=0."""
    sigmas = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                                num_steps, dtype=np.float64))
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def sgm_uniform_schedule(num_steps: int,
                         sigma_table: np.ndarray) -> np.ndarray:
    """Uniform timestep spacing EXCLUDING the final table entry before
    appending σ=0 (host 'sgm_uniform' scheduler; 'normal' includes both
    endpoints)."""
    idx = np.linspace(len(sigma_table) - 1, 0,
                      num_steps + 1).round().astype(int)[:-1]
    return np.concatenate([sigma_table[idx], [0.0]]).astype(np.float32)


def ddim_uniform_schedule(num_steps: int,
                          sigma_table: np.ndarray) -> np.ndarray:
    """Host 'ddim_uniform' scheduler: stride the discrete table by
    T//steps from the top (the original DDIM timestep subset) + σ=0."""
    T = len(sigma_table)
    stride = max(T // num_steps, 1)
    idx = np.arange(1, num_steps * stride + 1, stride)[::-1]
    idx = np.clip(idx, 0, T - 1)
    return np.concatenate([sigma_table[idx], [0.0]]).astype(np.float32)


def beta_schedule(num_steps: int, sigma_table: np.ndarray,
                  alpha: float = 0.6, beta: float = 0.6) -> np.ndarray:
    """Host 'beta' scheduler (Beta(0.6, 0.6)-distributed timestep
    quantiles over the discrete table) + σ=0."""
    import scipy.stats

    T = len(sigma_table)
    ts = 1.0 - np.linspace(0.0, 1.0, num_steps, endpoint=False)
    ts = np.rint(scipy.stats.beta.ppf(ts, alpha, beta) * (T - 1))
    out, last = [], -1
    for t in ts:
        if t != last:
            out.append(sigma_table[int(t)])
        last = t
    return np.concatenate([out, [0.0]]).astype(np.float32)


def kl_optimal_schedule(num_steps: int, sigma_min: float,
                        sigma_max: float) -> np.ndarray:
    """'kl_optimal' (Align-Your-Steps paper, eq. 33): σ interpolates in
    arctan space + σ=0."""
    t = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    sig = np.tan((1.0 - t) * np.arctan(sigma_max)
                 + t * np.arctan(sigma_min))
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def linear_quadratic_schedule(num_steps: int, sigma_max: float = 1.0,
                              threshold_noise: float = 0.025,
                              linear_steps: int | None = None
                              ) -> np.ndarray:
    """Host 'linear_quadratic' scheduler (LTX-Video recipe): linear ramp
    to ``threshold_noise`` over the first half, quadratic tail after,
    scaled to σ_max, descending + σ=0."""
    if num_steps == 1:
        return np.asarray([sigma_max, 0.0], np.float32)
    lin = num_steps // 2 if linear_steps is None else linear_steps
    lin = min(max(lin, 1), num_steps - 1)
    sigma_schedule = [i * threshold_noise / lin for i in range(lin)]
    quad_steps = num_steps - lin
    # quadratic tail solving f(lin)=τ, f(n)=1, f'(lin)=τ/lin (C¹ join
    # with the linear ramp)
    threshold_noise_step_diff = lin - threshold_noise * num_steps
    quadratic_coef = threshold_noise_step_diff / (lin * quad_steps ** 2)
    linear_coef = (threshold_noise / lin
                   - 2 * threshold_noise_step_diff / (quad_steps ** 2))
    const = (threshold_noise - quadratic_coef * lin ** 2
             - linear_coef * lin)
    for i in range(lin, num_steps):
        sigma_schedule.append(quadratic_coef * i ** 2 + linear_coef * i
                              + const)
    sigma_schedule.append(1.0)
    sig = (1.0 - np.asarray(sigma_schedule, np.float64)) * sigma_max
    return np.concatenate([sig[:-1], [0.0]]).astype(np.float32)


# scheduler registry: every entry takes (num_steps, sigma_table) — the
# (σ_min, σ_max)-parameterized schedules read the table's endpoints
SCHEDULES = {
    "simple": simple_schedule,
    "normal": normal_schedule,
    "karras": lambda n, tab: karras_schedule(
        n, float(tab[0]), float(tab[-1])),
    "exponential": lambda n, tab: exponential_schedule(
        n, float(tab[0]), float(tab[-1])),
    "sgm_uniform": sgm_uniform_schedule,
    "ddim_uniform": ddim_uniform_schedule,
    "beta": beta_schedule,
    "kl_optimal": lambda n, tab: kl_optimal_schedule(
        n, float(tab[0]), float(tab[-1])),
    "linear_quadratic": lambda n, tab: linear_quadratic_schedule(
        n, float(tab[-1])),
}


def make_schedule(name: str, num_steps: int,
                  sigma_table: np.ndarray) -> np.ndarray:
    """Scheduler menu (host UI parity): name → (num_steps+1,) descending
    sigmas ending at 0, derived from the model's discrete table."""
    fn = SCHEDULES.get(name)
    if fn is None:
        raise ValueError(f"unknown scheduler {name!r}; have "
                         f"{sorted(SCHEDULES)}")
    return fn(num_steps, sigma_table)


# ---------------------------------------------------------------------------
# denoiser adapters
# ---------------------------------------------------------------------------

def sigma_to_t(sigma: torch.Tensor, sigma_table) -> torch.Tensor:
    """Continuous timestep by log-linear interpolation into the table."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    log_s = torch.log(torch.clamp_min(sigma, 1e-10))
    log_tab = torch.log(torch.as_tensor(np.asarray(sigma_table, np.float32),
                                        device=sigma.device))
    # the table is increasing in t; searchsorted over the log table
    idx = torch.clamp(torch.searchsorted(log_tab, log_s.reshape(-1)),
                      1, log_tab.shape[0] - 1).reshape(log_s.shape)
    lo, hi = log_tab[idx - 1], log_tab[idx]
    w = torch.clamp((log_s - lo) / (hi - lo), 0.0, 1.0)
    return ((idx - 1).to(torch.float32) + w).to(torch.float32)


def make_eps_denoiser(eps_fn, sigma_table):
    """eps_fn(x_scaled, t, *cond) → denoiser(x, σ, *cond) → denoised x₀."""
    table = np.asarray(sigma_table, np.float32)

    def denoiser(x, sigma, *cond):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        c_in = 1.0 / torch.sqrt(1.0 + sigma ** 2)
        t = sigma_to_t(sigma, table)
        eps = eps_fn((x.to(torch.float32) * c_in).to(x.dtype),
                     t.expand(x.shape[0]), *cond)
        return (x.to(torch.float32)
                - sigma * eps.to(torch.float32)).to(x.dtype)

    return denoiser


def make_v_denoiser(v_fn, sigma_table):
    """v-prediction variant (SD2.x / some SDXL refiners)."""
    table = np.asarray(sigma_table, np.float32)

    def denoiser(x, sigma, *cond):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        c_in = 1.0 / torch.sqrt(1.0 + sigma ** 2)
        c_skip = 1.0 / (1.0 + sigma ** 2)
        c_out = -sigma * c_in
        t = sigma_to_t(sigma, table)
        v = v_fn((x.to(torch.float32) * c_in).to(x.dtype),
                 t.expand(x.shape[0]), *cond)
        return (x.to(torch.float32) * c_skip
                + c_out * v.to(torch.float32)).to(x.dtype)

    return denoiser


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def host_sigmas(sigmas) -> np.ndarray:
    """The schedule as a host float32 array (a tensor is copied once)."""
    if isinstance(sigmas, torch.Tensor):
        sigmas = sigmas.detach().cpu().numpy()
    return np.asarray(sigmas, np.float32)


def sigma_tensor(value, x: torch.Tensor) -> torch.Tensor:
    """A host sigma as the 0-d float32 tensor on x's device the denoiser
    receives (a fill, no copy from the host)."""
    return torch.full((), float(value), dtype=torch.float32, device=x.device)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _log(s) -> np.float32:
    return F(np.log(np.maximum(F(s), _EPS)))


def generator_noise(generator: torch.Generator, device=None):
    """``noise(shape)`` drawing float32 normals from ``generator`` on its own
    device, moved to ``device`` (pass a generator on the latent's device to
    keep the draws there)."""
    def noise(shape):
        out = torch.randn(tuple(shape), generator=generator,
                          device=generator.device, dtype=torch.float32)
        return out if device is None else out.to(device)
    return noise


# ---------------------------------------------------------------------------
# deterministic samplers
# ---------------------------------------------------------------------------

def euler_sample_sigma(denoiser, x: torch.Tensor, sigmas) -> torch.Tensor:
    """Euler in σ space; x starts as noise · σ_max."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = denoiser(x, sigma_tensor(s, x))
        d = (_f32(x) - _f32(denoised)) / float(s)
        x = (_f32(x) + float(s_next - s) * d).to(x.dtype)
    return x


def heun_sample_sigma(denoiser, x: torch.Tensor, sigmas) -> torch.Tensor:
    """Heun (2nd-order trapezoid): Euler predictor + averaged corrector;
    2 model calls per step except the final σ→0 step (plain Euler there,
    matching k-diffusion sample_heun)."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(s, x)))) / float(s)
        x_eul = xf + float(s_next - s) * d
        if s_next > 0:
            d2 = (x_eul - _f32(denoiser(x_eul.to(x.dtype),
                                        sigma_tensor(s_next, x)))) \
                / float(s_next)
            x_eul = xf + float((s_next - s) * F(0.5)) * (d + d2)
        x = x_eul.to(x.dtype)
    return x


def _ancestral_split(s, s_next, eta: float):
    """(σ_down, σ_up) per k-diffusion get_ancestral_step; σ_up clamped
    to σ_next (matters for eta > 1: without it σ_down collapses to 0 and
    x is discarded entirely)."""
    su2 = (F(eta ** 2) * s_next ** 2 * (s ** 2 - s_next ** 2)
           / np.maximum(s ** 2, _EPS))
    su = np.minimum(np.sqrt(np.maximum(su2, F(0))), s_next)
    sd = np.sqrt(np.maximum(s_next ** 2 - su ** 2, F(0)))
    return F(sd), F(su)


def dpmpp_2m_sample_sigma(denoiser, x: torch.Tensor,
                          sigmas) -> torch.Tensor:
    """DPM-Solver++ (2M): multistep 2nd order in log-σ time, one model
    call per step (k-diffusion sample_dpmpp_2m)."""
    sig = host_sigmas(sigmas)
    old_denoised = None
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        t, t_next = -_log(s), -_log(s_next)
        h = t_next - t
        ratio = float(s_next / s)
        expm = float(np.expm1(-h))
        if s_next > 0 and i > 0:
            h_last = t - (-_log(sig[i - 1]))
            r = h_last / h
            dd = (float(1 + 1 / (2 * r)) * denoised
                  - float(1 / (2 * r)) * old_denoised)
            out = ratio * _f32(x) - expm * dd
        elif s_next > 0:
            out = ratio * _f32(x) - expm * denoised
        else:  # final σ=0 step: exact denoised output
            out = denoised
        x = out.to(x.dtype)
        old_denoised = denoised
    return x


def ddim_sample_sigma(denoiser, x: torch.Tensor, sigmas) -> torch.Tensor:
    """Deterministic DDIM == DPM-Solver-1: the exponential integrator
    x ← (σ'/σ)·x + (1 − σ'/σ)·denoised, exact under locally-constant
    x₀-prediction (the host UI's 'ddim' sampler at eta=0)."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        ratio = s_next / np.maximum(s, _EPS)
        x = (float(ratio) * _f32(x)
             + float(F(1) - ratio) * denoised).to(x.dtype)
    return x


def uni_pc_sample_sigma(denoiser, x: torch.Tensor, sigmas,
                        variant: str = "bh2") -> torch.Tensor:
    """UniPC (order 2, data prediction): unified predictor-corrector in
    λ = −log σ time, ONE model call per step — the corrector reuses the
    model output evaluated at the predicted point, which then seeds the
    next predictor.

    All updates are the σ-space data-prediction form (α≡1):
        x_t' = (σ_t/σ_s)·x − expm1(−h)·m₀ − B(h)·Σρᵢ·D1ᵢ,  h = log(σ_s/σ_t)
    with B(h) = −h (bh1) or expm1(−h) (bh2) and ρ solved from the
    order-2 Vandermonde system in closed form. The final σ→0 step
    returns the x₀-prediction exactly.
    """
    if variant not in ("bh1", "bh2"):
        raise ValueError(f"variant must be bh1|bh2, got {variant!r}")
    sig = host_sigmas(sigmas)

    def lam(s):
        return -_log(s)

    def bh_coeffs(h):
        """(h_phi_1, B_h, b1, b2) for step size h>0 (hh = −h)."""
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = hh if variant == "bh1" else np.expm1(hh)
        h_phi_k1 = h_phi_1 / hh - F(1)
        b1 = h_phi_k1 / B_h
        h_phi_k2 = h_phi_k1 / hh - F(0.5)
        b2 = h_phi_k2 * F(2) / B_h
        return F(h_phi_1), F(B_h), F(b1), F(b2)

    dtype = x.dtype
    x_unc, x_prev = x, x
    m_a = m_b = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(len(sig) - 1):
        s_pp, s_p = sig[max(i - 2, 0)], sig[max(i - 1, 0)]
        s, s_next = sig[i], sig[i + 1]
        m_t = _f32(denoiser(x_unc, sigma_tensor(s, x)))

        # ---- corrector for the point σ_i (uses m_t, free NFE) ----
        if i == 0:
            x_cur = _f32(x_unc)
        else:
            h_c = lam(s) - lam(s_p)
            h_phi_1c, B_hc, b1c, b2c = bh_coeffs(h_c)
            x_t_c = (float(s / np.maximum(s_p, _EPS)) * _f32(x_prev)
                     - float(h_phi_1c) * m_a)
            D1_t = m_t - m_a
            if i == 1:
                # order-1 corrector: UniPC hardcodes ρ = 0.5 here
                x_cur = x_t_c - float(B_hc) * (0.5 * D1_t)
            else:  # order-2 corrector: extra point σ_{i-2}
                r1c = (lam(s_pp) - lam(s_p)) / h_c
                D1_0c = (m_b - m_a) / float(F(1) if r1c == 0 else r1c)
                rho0 = (b2c - b1c) / (_EPS if r1c == 1.0 else r1c - F(1))
                rho1 = b1c - rho0
                x_cur = x_t_c - float(B_hc) * (float(rho0) * D1_0c
                                               + float(rho1) * D1_t)

        # ---- predictor σ_i → σ_{i+1} ----
        if s_next > 0:
            h = lam(s_next) - lam(s)
            h_phi_1, B_h, _, _ = bh_coeffs(h)
            ratio = s_next / np.maximum(s, _EPS)
            x_next = float(ratio) * x_cur - float(h_phi_1) * m_t
            if i > 0:  # order 2: UniPC hardcodes ρ = 0.5
                r1 = (lam(s_p) - lam(s)) / h
                D1_0 = (m_a - m_t) / float(F(1) if r1 == 0 else r1)
                x_next = x_next - float(B_h) * (0.5 * D1_0)
        else:
            x_next = m_t
        x_unc, x_prev = x_next.to(dtype), x_cur.to(dtype)
        m_a, m_b = m_t, m_a
    return x_unc


def _cube_mid(s, s_to) -> np.float32:
    """((σ^⅓ + σ'^⅓)/2)³ in float32, the cube as two products (the
    reference's integer power)."""
    m = F((s ** F(1 / 3) + s_to ** F(1 / 3)) / F(2))
    return F(F(m * m) * m)


def dpm_2_sample_sigma(denoiser, x: torch.Tensor, sigmas) -> torch.Tensor:
    """DPM-Solver-2 (deterministic midpoint, k-diffusion sample_dpm_2):
    evaluate d at σ, take a half step to the log-cubic midpoint
    σ_mid = ((σ^⅓+σ'^⅓)/2)³, re-evaluate, full step with d_mid. Two
    model calls per step; plain Euler on the final σ→0 step."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(s, x)))) / float(s)
        if s_next > 0:
            s_mid = _cube_mid(s, s_next)
            x2 = xf + float(s_mid - s) * d
            d2 = (x2 - _f32(denoiser(x2.to(x.dtype),
                                     sigma_tensor(s_mid, x)))) / float(s_mid)
            out = xf + float(s_next - s) * d2
        else:
            out = xf + float(s_next - s) * d
        x = out.to(x.dtype)
    return x


def ipndm_sample_sigma(denoiser, x: torch.Tensor, sigmas) -> torch.Tensor:
    """iPNDM: 4th-order Adams–Bashforth on d over σ, warming up through
    orders 1→4 — one model call per step."""
    sig = host_sigmas(sigmas)
    hist = []  # d of the previous steps, newest first
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(s, x)))) / float(s)
        if i >= 3:
            d1, d2, d3 = hist
            upd = (55 * d - 59 * d1 + 37 * d2 - 9 * d3) / 24
        elif i == 2:
            d1, d2 = hist[:2]
            upd = (23 * d - 16 * d1 + 5 * d2) / 12
        elif i == 1:
            upd = (3 * d - hist[0]) / 2
        else:
            upd = d
        x = (xf + float(s_next - s) * upd).to(x.dtype)
        hist = [d] + hist[:2]
    return x


def _lms_coeffs(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """(n_steps, order) exact Lagrange-basis integral coefficients for
    linear multistep over the σ grid: coeff[i, j] = ∫_{σ_i}^{σ_{i+1}}
    Π_{k≠j} (τ−σ_{i−k})/(σ_{i−j}−σ_{i−k}) dτ — computed with exact
    polynomial integration (np.poly1d), not quadrature."""
    n = len(sigmas) - 1
    # always 4 columns (extra columns are exact zeros)
    out = np.zeros((n, max(order, 4)), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            p = np.poly1d([1.0])
            for k in range(cur):
                if k == j:
                    continue
                p *= np.poly1d(
                    [1.0, -sigmas[i - k]]) / (sigmas[i - j] - sigmas[i - k])
            ip = p.integ()
            out[i, j] = ip(sigmas[i + 1]) - ip(sigmas[i])
    return out.astype(np.float32)


def lms_sample_sigma(denoiser, x: torch.Tensor, sigmas,
                     order: int = 4) -> torch.Tensor:
    """Linear multistep (k-diffusion sample_lms, default order 4): the
    per-step coefficients are exact integrals of the Lagrange basis over
    each σ interval, worked out on the host in float64 (the loop knows its
    schedule, so the reference's traced twin has no counterpart)."""
    sig = host_sigmas(sigmas)
    coeffs = _lms_coeffs(sig.astype(np.float64), order)
    hist = []  # d of the previous steps, newest first
    for i in range(len(sig) - 1):
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(sig[i], x)))) / float(sig[i])
        c = coeffs[i]
        out = xf + float(c[0]) * d
        for cj, dj in zip(c[1:], hist):
            if cj != 0:  # a zero weight (warm-up, lower order) adds nothing
                out = out + float(cj) * dj
        x = out.to(x.dtype)
        hist = [d] + hist[:2]
    return x


SAMPLERS = {
    "euler": euler_sample_sigma,
    "heun": heun_sample_sigma,
    "dpmpp_2m": dpmpp_2m_sample_sigma,
    "ddim": ddim_sample_sigma,
    "uni_pc": uni_pc_sample_sigma,
    "dpm_2": dpm_2_sample_sigma,
    "ipndm": ipndm_sample_sigma,
    "lms": lms_sample_sigma,
}


# ---------------------------------------------------------------------------
# stochastic samplers: (denoiser, x, sigmas, noise, **knobs)
# ---------------------------------------------------------------------------

def euler_ancestral_sample_sigma(denoiser, x: torch.Tensor, sigmas, noise,
                                 eta: float = 1.0) -> torch.Tensor:
    """Euler-ancestral: stochastic σ-down/σ-up split per step
    (k-diffusion get_ancestral_step) with fresh noise each step."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        sd, su = _ancestral_split(s, s_next, eta)
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(s, x)))) / float(s)
        xf = xf + float(sd - s) * d
        z = noise(x.shape)
        if s_next > 0:
            xf = xf + z * float(su)
        x = xf.to(x.dtype)
    return x


def lcm_sample_sigma(denoiser, x: torch.Tensor, sigmas,
                     noise) -> torch.Tensor:
    """Latent Consistency Model sampling (k-diffusion sample_lcm): each
    step jumps straight to the x₀-prediction, then re-noises to the next
    sigma (except the final σ=0 step)."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        denoised = _f32(denoiser(x, sigma_tensor(sig[i], x)))
        z = noise(x.shape)
        s_next = sig[i + 1]
        out = denoised + float(s_next) * z if s_next > 0 else denoised
        x = out.to(x.dtype)
    return x


def dpmpp_2m_sde_sample_sigma(denoiser, x: torch.Tensor, sigmas, noise,
                              eta: float = 1.0, s_noise: float = 1.0,
                              solver: str = "midpoint") -> torch.Tensor:
    """DPM-Solver++ (2M) SDE (k-diffusion sample_dpmpp_2m_sde): multistep
    second order in log-σ with an SDE noise channel; one model call per
    step. ``solver`` ∈ {"midpoint", "heun"}; eta=0 is deterministic.
    Gaussian noise replaces k-diffusion's BrownianTree."""
    if solver not in ("midpoint", "heun"):
        raise ValueError(f"solver must be midpoint|heun, got {solver!r}")
    sig = host_sigmas(sigmas)
    old_denoised = None
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        # h = log(σ/σ') > 0 for a descending schedule
        h = _log(s) - _log(s_next)
        eta_h = F(eta) * h
        ratio = s_next / np.maximum(s, _EPS)
        decay = -np.expm1(-h - eta_h)  # 1 - e^{-(h+ηh)}
        out = (float(ratio * np.exp(-eta_h)) * _f32(x)
               + float(decay) * denoised)
        if i > 0 and s_next > 0:
            h_last = _log(sig[i - 1]) - _log(s)
            r = h / np.maximum(h_last, _EPS)
            diff = denoised - old_denoised
            if solver == "heun":
                corr = -(float((decay / (h + eta_h) - F(1)) * r) * diff)
            else:
                corr = float(F(0.5) * decay * r) * diff
            out = out + corr
        z = noise(x.shape)
        if s_next > 0:
            sde_scale = (s_next * np.sqrt(-np.expm1(F(-2.0) * eta_h))
                         * F(s_noise))
            out = out + z * float(sde_scale)
        else:
            out = denoised
        x = out.to(x.dtype)
        old_denoised = denoised
    return x


def dpmpp_sde_sample_sigma(denoiser, x: torch.Tensor, sigmas, noise,
                           eta: float = 1.0, s_noise: float = 1.0,
                           r: float = 0.5) -> torch.Tensor:
    """DPM-Solver++ (SDE) (k-diffusion sample_dpmpp_sde): single-step
    second order — a midpoint model call at log-σ fraction ``r`` with
    ancestral noise injection at both stages; two model calls per step
    (one on the final σ→0 step, which is plain Euler; its two draws are
    made all the same). Gaussian noise replaces k-diffusion's
    BrownianTree."""
    sig = host_sigmas(sigmas)

    def ancestral(s_from, s_to):
        su2 = (F(eta ** 2) * s_to ** 2 * (s_from ** 2 - s_to ** 2)
               / np.maximum(s_from ** 2, _EPS))
        # clamp sigma_up to sigma_to like k-diffusion get_ancestral_step;
        # sigma_down derives from the UNscaled sigma_up — s_noise scales
        # only the injected noise
        su = np.minimum(np.sqrt(np.maximum(su2, F(0))), s_to)
        sd = np.sqrt(np.maximum(s_to ** 2 - su ** 2, F(0)))
        return F(sd), F(su * F(s_noise))

    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        xf = _f32(x)
        if not s_next > 0:
            noise(x.shape)  # the reference draws both, then masks them
            noise(x.shape)
            # final σ=0 step: plain Euler to the denoised output
            out = xf + (float(s_next - s) * (xf - denoised)) \
                / float(np.maximum(s, _EPS))
            x = out.to(x.dtype)
            continue
        t, t_next = -_log(s), -_log(s_next)
        h = t_next - t
        s_mid = F(np.exp(-(t + h * F(r))))
        fac = 1.0 / (2.0 * r)  # a host double, as in the reference

        # stage 1: ancestral sub-step to the midpoint sigma
        sd1, su1 = ancestral(s, s_mid)
        ratio1 = sd1 / np.maximum(s, _EPS)
        x2 = float(ratio1) * xf + float(F(1) - ratio1) * denoised
        x2 = x2 + noise(x.shape) * float(su1)
        denoised2 = _f32(denoiser(x2.to(x.dtype), sigma_tensor(s_mid, x)))

        # stage 2: combined-slope ancestral step to σ'
        sd2, su2_ = ancestral(s, s_next)
        denoised_d = (float(F(1.0 - fac)) * denoised
                      + float(F(fac)) * denoised2)
        ratio2 = sd2 / np.maximum(s, _EPS)
        out = float(ratio2) * xf + float(F(1) - ratio2) * denoised_d
        out = out + noise(x.shape) * float(su2_)
        x = out.to(x.dtype)
    return x


def dpm_2_ancestral_sample_sigma(denoiser, x: torch.Tensor, sigmas, noise,
                                 eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver-2 ancestral (k-diffusion sample_dpm_2_ancestral): the
    midpoint step integrates to the ancestral σ_down, fresh noise at
    σ_up re-inflates. eta=0 degrades exactly to dpm_2."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        sd, su = _ancestral_split(s, s_next, eta)
        xf = _f32(x)
        d = (xf - _f32(denoiser(x, sigma_tensor(s, x)))) / float(s)
        if sd > 0:
            s_mid = _cube_mid(s, sd)
            x2 = xf + float(s_mid - s) * d
            d2 = (x2 - _f32(denoiser(x2.to(x.dtype),
                                     sigma_tensor(s_mid, x)))) / float(s_mid)
            out = xf + float(sd - s) * d2
        else:
            out = xf + float(sd - s) * d
        z = noise(x.shape)
        if s_next > 0:
            out = out + z * float(su)
        x = out.to(x.dtype)
    return x


def dpmpp_2s_ancestral_sample_sigma(denoiser, x: torch.Tensor, sigmas,
                                    noise, eta: float = 1.0
                                    ) -> torch.Tensor:
    """DPM-Solver++ (2S) ancestral (k-diffusion
    sample_dpmpp_2s_ancestral): a single-step 2nd-order exponential-
    integrator update to the ancestral σ_down (midpoint in log-σ time),
    fresh noise at σ_up. eta=0 is the deterministic 2S solver; the
    σ_down=0 tail degrades to the exact Euler→denoised step."""
    sig = host_sigmas(sigmas)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        sd, su = _ancestral_split(s, s_next, eta)
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        xf = _f32(x)
        if sd > 0:
            t, t_next = -_log(s), -_log(sd)
            h = t_next - t
            s_mid = F(np.exp(-(t + F(0.5) * h)))
            x2 = (float(s_mid / s) * xf
                  - float(np.expm1(F(-0.5) * h)) * denoised)
            den2 = _f32(denoiser(x2.to(x.dtype), sigma_tensor(s_mid, x)))
            out = float(sd / s) * xf - float(np.expm1(-h)) * den2
        else:
            d = (xf - denoised) / float(s)
            out = xf + float(sd - s) * d
        z = noise(x.shape)
        if s_next > 0:
            out = out + z * float(su)
        x = out.to(x.dtype)
    return x


def dpmpp_3m_sde_sample_sigma(denoiser, x: torch.Tensor, sigmas, noise,
                              eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver++ (3M) SDE (k-diffusion sample_dpmpp_3m_sde): 3rd-order
    multistep in log-σ time with an exponential-decay SDE noise channel.
    Order warms up 1→2→3 over the first steps; eta=0 is the deterministic
    3M solver (and draws no noise)."""
    sig = host_sigmas(sigmas)
    den1 = den2 = None
    h1 = h2 = F(1)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        t, t_next = -_log(s), -_log(s_next)
        h = t_next - t
        h_eta = h * F(eta + 1.0)
        out = (float(np.exp(-h_eta)) * _f32(x)
               - float(np.expm1(-h_eta)) * denoised)
        if i >= 1:
            phi2 = np.expm1(-h_eta) / h_eta + F(1)
            r0 = np.maximum(h1 / h, _EPS)
            d1_0 = (denoised - den1) / float(r0)
            if i >= 2:
                phi3 = phi2 / h_eta - F(0.5)
                r1 = np.maximum(h2 / h, _EPS)
                d1_1 = (den1 - den2) / float(r1)
                d1 = d1_0 + (d1_0 - d1_1) * float(r0) / float(r0 + r1)
                d2 = (d1_0 - d1_1) / float(r0 + r1)
                out = out + float(phi2) * d1 - float(phi3) * d2
            else:
                out = out + float(phi2) * d1_0
        if eta > 0:
            z = noise(x.shape)
            amp = s_next * np.sqrt(np.maximum(
                -np.expm1(F(-2.0) * h * F(eta)), F(0)))
            out = out + z * float(amp)
        if not s_next > 0:  # final σ=0 step: exact denoised output
            out = denoised
        x = out.to(x.dtype)
        den1, den2, h1, h2 = denoised, den1, h, h1
    return x


STOCHASTIC_SAMPLERS = {
    "euler_ancestral": euler_ancestral_sample_sigma,
    "lcm": lcm_sample_sigma,
    "dpmpp_2m_sde": dpmpp_2m_sde_sample_sigma,
    "dpmpp_sde": dpmpp_sde_sample_sigma,
    "dpm_2_ancestral": dpm_2_ancestral_sample_sigma,
    "dpmpp_2s_ancestral": dpmpp_2s_ancestral_sample_sigma,
    "dpmpp_3m_sde": dpmpp_3m_sde_sample_sigma,
}


def euler_sample_sigma_inpaint(denoiser, x: torch.Tensor, sigmas, z0, mask,
                               noise) -> torch.Tensor:
    """Masked Euler in σ space (eps-model inpainting): after every step
    the kept region (mask == 0) is re-projected onto the forward-noised
    source z0 + σ'·ε at the new sigma. ``noise(shape)`` is called once a
    step, in step order (the reference folds the step index into its
    key)."""
    sig = host_sigmas(sigmas)
    mask = _f32(mask)
    z0f = _f32(z0)
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        denoised = _f32(denoiser(x, sigma_tensor(s, x)))
        xf = _f32(x)
        d = (xf - denoised) / float(s)
        xf = xf + float(s_next - s) * d
        x_keep = z0f + float(s_next) * noise(z0f.shape)
        xf = mask * xf + (1.0 - mask) * x_keep
        x = xf.to(x.dtype)
    return x


def run_sampler(name: str, denoiser, x, sigmas, noise=None, generator=None,
                **knobs):
    """Dispatch by name across both tables. A stochastic sampler needs
    ``noise`` (``noise(shape) -> float32 tensor``) or a ``torch.Generator``
    to draw it from."""
    if name in SAMPLERS:
        return SAMPLERS[name](denoiser, x, sigmas, **knobs)
    if name in STOCHASTIC_SAMPLERS:
        if noise is None:
            if generator is None:
                raise ValueError(f"sampler {name!r} is stochastic: pass "
                                 f"noise= or generator=")
            noise = generator_noise(generator, x.device)
        return STOCHASTIC_SAMPLERS[name](denoiser, x, sigmas, noise,
                                         **knobs)
    raise ValueError(f"unknown sampler {name!r}; have "
                     f"{sorted(SAMPLERS) + sorted(STOCHASTIC_SAMPLERS)}")
