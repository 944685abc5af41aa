"""The w8a8 conversion's cost at published width, the port against the
reference, on the CPU.

AuraFlow v0.3 (hidden 3072, 12 heads of 256, MLP 8192; 1 double + 2
single layers) and Lumina 2 (dim 2304, 24 heads of 96, FFN 6144; 2 layers
and the 2 + 2 refiners) at their published widths, cut in depth and run
on a 16 x 16 latent, so that a run fits a CPU. The tree is the reference's
``random_stacked_from_spec`` (Q4_K, seed 0), carried into the port. Both
packages compute in float32 and convert with ``convert_tree_i8`` and the
reference's modulation predicate. Checked: the port's planar forward
within 1e-4 of the reference's; the int8 weights the same codes and
scales (rtol 1e-6) but for codes one step off where the two packages'
f32 scales differ in the last bit (at most 1e-5 of them); the distance
between the w8a8 and planar forwards the same in both packages within 5%,
so that distance is the conversion's own, not the port's; and the two
w8a8 forwards nearer each other than to the planar one. They are not
nearer than that: at these seed-made weights (the reference helper's,
weights of standard deviation ~0.087, a gain of ~4.8 a linear) a code one
step off moves the next linear's rows by enough to move tens of their
codes in turn, so the two packages' w8a8 AuraFlow forwards end 5.5e-2
apart after three layers (ROADMAP queue 3). Slow: each case dequantizes a
few hundred million weights twice in each package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.models import aura as jaura
from comfyui_gguf_tpu.models import lumina2 as jlumina2
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import aura, lumina2
from comfyui_gguf_tpu_torch.models import testing as ttesting
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import convert_tree_i8, is_modulation_key

pytestmark = pytest.mark.slow

torch.set_num_threads(4)

QCFG = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JQCFG = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                     prefer_pallas=False)

# arch -> (reference module, port module, the depth cut, reference
# generator, text width)
CASES = {
    "aura": (jaura, aura, dict(depth_double=1, depth_single=2),
             jtesting.aura_random_stacked_params, 2048),
    "lumina2": (jlumina2, lumina2, dict(n_layers=2),
                jtesting.lumina2_random_stacked_params, 2304),
}
DIMS = {"aura": (jtesting.AURA_V03_DIMS, ttesting.AURA_V03_DIMS),
        "lumina2": (jtesting.LUMINA2_DIMS, ttesting.LUMINA2_DIMS)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("arch", sorted(CASES))
def test_w8a8_cost_at_published_width_matches_reference(arch):
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    jmod, tmod, cut, make, cond_dim = CASES[arch]
    jdims, tdims = (dataclasses.replace(d, **cut) for d in DIMS[arch])
    jcfg, tcfg = jdims.config(), tdims.config()
    jsp = make(jdims, seed=0)
    tsp = params_from_numpy(jax.tree.map(np.asarray, jsp), "cpu")
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((1, 16, 16, jdims.in_ch)).astype(np.float32)
    cond = rng.standard_normal((1, 32, cond_dim)).astype(np.float32)
    t = np.asarray([0.7], np.float32)
    jx = [jnp.asarray(a) for a in (lat, cond, t)]
    tx = [torch.from_numpy(a) for a in (lat, cond, t)]

    want_p = np.asarray(jmod.forward_stacked(jsp, jcfg, *jx, qcfg=JQCFG))
    got_p = tmod.forward_stacked(tsp, tcfg, *tx, qcfg=QCFG).numpy()
    jsp_w = ji8.convert_tree_i8(jsp, pred=lambda k, v: not j_is_mod(k))
    want_w = np.asarray(jmod.forward_stacked(jsp_w, jcfg, *jx, qcfg=JQCFG))
    tsp_w = convert_tree_i8(tsp, pred=lambda k, v: not is_modulation_key(k))
    got_w = tmod.forward_stacked(tsp_w, tcfg, *tx, qcfg=QCFG).numpy()

    # the conversion: the same codes but where the two packages' f32
    # absmax / 127 differ in the last bit (one step, a few per million)
    jleaves, tleaves = dict(_i8_leaves(jsp_w)), dict(_i8_leaves(tsp_w))
    assert jleaves.keys() == tleaves.keys() and jleaves
    n_off = n_all = 0
    for k, jl in jleaves.items():
        tl = tleaves[k]
        R, K = tl.shape
        jq = np.swapaxes(np.asarray(jl.qs), -1, -2)[..., :R, :K]
        d = np.abs(jq.astype(np.int16) - tl.qs.numpy()[..., :R, :K])
        assert d.max() <= 1, k
        n_off, n_all = n_off + int(d.sum()), n_all + d.size
        np.testing.assert_allclose(tl.scales.numpy().reshape(-1),
                                   np.asarray(jl.scales).reshape(-1),
                                   rtol=1e-6)
    assert n_off <= 1e-5 * n_all

    cost_ref, cost_port = _rel(want_w, want_p), _rel(got_w, got_p)
    print(f"{arch}: planar port vs reference {_rel(got_p, want_p):.3e}; "
          f"w8a8 codes one step off {n_off} of {n_all}; w8a8 port vs "
          f"reference {_rel(got_w, want_w):.4e}; w8a8 vs planar: reference "
          f"{cost_ref:.4e}, port {cost_port:.4e}")
    assert _rel(got_p, want_p) < 1e-4
    assert abs(cost_port / cost_ref - 1) < 0.05
    # the two w8a8 forwards drift apart (a code one step off moves the next
    # linear's rows and their codes in turn) but stay nearer each other
    # than to the planar forward
    assert _rel(got_w, want_w) < cost_ref


def _i8_leaves(tree, prefix=""):
    """(key, leaf) of every int8 weight (a leaf with codes and scales) of a
    param tree, group dicts included."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _i8_leaves(v, f"{prefix}{k}.")
        elif hasattr(v, "qs") and hasattr(v, "scales") and not hasattr(
                v, "offsets"):
            yield prefix + k, v
