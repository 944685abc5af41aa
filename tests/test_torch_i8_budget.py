"""The port's budgeted w8a8 conversion (``quant/i8.py``: ``plan_i8_budget``,
``requantize_i8_host``, ``convert_tree_i8(max_bytes=, host_stage=)``,
``DiffusionModel.requantize_i8(max_bytes=, host_stage=)``) against the
reference, on the CPU. These mirror ``tests/test_i8.py``'s budget and
host-staging tests (``:46``, ``:65``, ``:549``, ``:580``).

Planar leaves are made by both packages' ``planarize`` from the same GGML
blocks. Checked: the planner picks the reference's key set at every budget
(greedy by descending byte delta, within a predicate) and the bytes it
counts are the reference's; the host-staged conversion gives the port's
on-device codes and scales bit for bit (both run the same two roundings)
and the reference's within its FMA caveat for offset formats (a code one
step off on a rounding boundary, a scale one ulp off), for 2-D, depth-
stacked and (depth, experts)-stacked leaves, and frees the source; a
budget at or below the planar footprint converts nothing and warns.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models.flux import _stack_leaves
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant import codecs, i8, planar

torch.set_num_threads(2)

OFFSET_FORMATS = (Q.Q4_1, Q.Q5_1, Q.Q4_K, Q.Q5_K)


def _blocks(R, K, qtype, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((R, K)).astype(
        np.float32) * scale
    return codecs.quantize(x, qtype)


def _pair(R, K, qtype=Q.Q4_K, seed=0):
    """(port PlanarQuant, reference PlanarQuant) of the same blocks."""
    b = _blocks(R, K, qtype, seed)
    return (planar.planarize(b, qtype, (R, K)),
            jplanar.planarize(b, qtype, (R, K)))


def _assert_vs_reference(ip, jip, qtype):
    """The port's I8Planar (codes (Rp, Kp)) against the reference's (codes
    (Kp, Rp)): equal for offset-free formats; within the FMA caveat for
    offset formats."""
    q = ip.qs.numpy().astype(np.int32)
    jq = np.swapaxes(np.asarray(jip.qs, np.int32), -1, -2)
    s, js = ip.scales.numpy(), np.asarray(jip.scales)
    if qtype not in OFFSET_FORMATS:
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        return
    np.testing.assert_allclose(s, js, rtol=2e-7, atol=0)
    diff = np.abs(q - jq)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def _tree():
    """Three leaves, as test_i8.py's budget test: a large and a small
    non-expert weight and an expert weight (port and reference trees)."""
    a, ja = _pair(256, 512, seed=0)
    b, jb = _pair(64, 512, seed=1)
    e, je = _pair(256, 512, seed=2)
    return ({"attn.weight": a, "mlp.weight": b, "experts.w1.weight": e},
            {"attn.weight": ja, "mlp.weight": jb, "experts.w1.weight": je})


def test_leaf_bytes_match_reference():
    for R, K, qtype in ((256, 512, Q.Q4_K), (96, 1024, Q.Q8_0),
                        (300, 2560, Q.Q6_K)):
        p, jp = _pair(R, K, qtype)
        assert i8._leaf_bytes(p) == ji8._leaf_bytes(jp)


@pytest.mark.parametrize("frac", [-0.1, 0.0, 0.3, 0.5, 0.8, 1.0, 2.0])
@pytest.mark.parametrize("with_pred", [False, True], ids=["all", "pred"])
def test_plan_picks_the_reference_key_set(frac, with_pred):
    """At budgets across the planar → int8 range, with and without a
    predicate, the same keys as the reference's planner."""
    tree, jtree = _tree()
    planar_bytes = sum(i8._leaf_bytes(v)[0] for v in tree.values())
    int8_bytes = sum(i8._leaf_bytes(v)[1] for v in tree.values())
    budget = int(planar_bytes + frac * (int8_bytes - planar_bytes))
    pred = (lambda k, v: "experts" not in k) if with_pred else None
    got = i8.plan_i8_budget(tree, max_bytes=budget, pred=pred)
    want = ji8.plan_i8_budget(jtree, max_bytes=budget, pred=pred)
    assert got == want
    total = planar_bytes + sum(i8._leaf_bytes(tree[k])[1]
                               - i8._leaf_bytes(tree[k])[0] for k in got)
    assert total <= max(budget, planar_bytes)


def test_convert_tree_budget():
    """max_bytes: the two non-experts fit, the expert does not (the
    reference's test_convert_tree_budget); an unlimited budget converts
    all; the planar footprint converts none."""
    tree, _ = _tree()
    pb = {k: i8._leaf_bytes(v) for k, v in tree.items()}
    planar_bytes = sum(p for p, _ in pb.values())
    budget = planar_bytes + sum(pb[k][1] - pb[k][0]
                                for k in ("attn.weight", "mlp.weight"))
    out = i8.convert_tree_i8(dict(tree), max_bytes=budget)
    assert isinstance(out["attn.weight"], i8.I8Planar)
    assert isinstance(out["mlp.weight"], i8.I8Planar)
    assert isinstance(out["experts.w1.weight"], planar.PlanarQuant)
    out = i8.convert_tree_i8(dict(tree), max_bytes=1 << 40)
    assert all(isinstance(v, i8.I8Planar) for v in out.values())
    out = i8.convert_tree_i8(dict(tree), max_bytes=planar_bytes)
    assert all(isinstance(v, planar.PlanarQuant) for v in out.values())


def test_budget_noop_warns(caplog):
    tree, _ = _tree()
    pb = i8._leaf_bytes(tree["attn.weight"])[0]
    with caplog.at_level(logging.WARNING,
                         logger="comfyui_gguf_tpu_torch.quant.i8"):
        out = i8.convert_tree_i8({"attn.weight": tree["attn.weight"]},
                                 max_bytes=pb)
    assert isinstance(out["attn.weight"], planar.PlanarQuant)
    assert any("NOTHING will be converted" in r.message
               for r in caplog.records)


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0, Q.Q4_1, Q.Q6_K],
                         ids=lambda q: q.name)
def test_host_staged_matches_device_and_reference(qtype):
    """requantize_i8_host against requantize_i8 (equal) and the reference's
    host path (within its caveat), for a 2-D leaf, a depth stack and a
    (depth, experts) stack; free_source empties the source."""
    p, jp = _pair(96, 512, qtype, seed=5)
    host = i8.requantize_i8_host(p)
    dev = i8.requantize_i8(p)
    assert torch.equal(host.qs, dev.qs) and torch.equal(host.scales,
                                                        dev.scales)
    _assert_vs_reference(host, ji8.requantize_i8_host(jp), qtype)

    pairs = [_pair(96, 512, qtype, seed=10 + i) for i in range(6)]
    stacked = _stack_leaves([a for a, _ in pairs])
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                      *[b for _, b in pairs])
    dev = i8.requantize_i8(stacked)
    host = i8.requantize_i8_host(stacked, free_source=True)
    assert stacked.qs.numel() == 0 and stacked.scales.numel() == 0
    assert torch.equal(host.qs, dev.qs) and torch.equal(host.scales,
                                                        dev.scales)
    _assert_vs_reference(host, ji8.requantize_i8_host(jstacked), qtype)

    # (depth 2, experts 3): each 2-D slice as converted alone
    nested = _stack_leaves([_stack_leaves([a for a, _ in pairs[3 * d:
                                                               3 * d + 3]])
                            for d in range(2)])
    got = i8.requantize_i8_host(nested)
    assert tuple(got.qs.shape[:2]) == (2, 3)
    for d in range(2):
        for e in range(3):
            one = i8.requantize_i8(pairs[3 * d + e][0])
            assert torch.equal(got[d][e].qs, one.qs)
            assert torch.equal(got[d][e].scales, one.scales)


def test_convert_tree_host_stage_matches_device():
    """convert_tree_i8(host_stage=True) under the modulation predicate
    equals the on-device conversion leaf for leaf."""
    w, _ = _pair(64, 512, seed=1)
    m, _ = _pair(64, 512, seed=2)
    pred = lambda k, v: not i8.is_modulation_key(k)  # noqa: E731
    a = i8.convert_tree_i8({"blk": {"w": w, "mod.w": m}}, pred=pred)
    b = i8.convert_tree_i8({"blk": {"w": w, "mod.w": m}}, pred=pred,
                           host_stage=True)
    assert isinstance(b["blk"]["w"], i8.I8Planar)
    assert isinstance(b["blk"]["mod.w"], planar.PlanarQuant)
    assert torch.equal(a["blk"]["w"].qs, b["blk"]["w"].qs)
    assert torch.equal(a["blk"]["w"].scales, b["blk"]["w"].scales)


def test_diffusion_model_budgeted_requantize():
    """DiffusionModel.requantize_i8(max_bytes=) on a seed-made HiDream tree
    (the modulations kept planar): host staging on by default with a
    budget; the converted leaves are the planner's, the packed total stays
    within the budget, and the forward matches the unbudgeted conversion
    where the same leaves convert."""
    dims = testing.TinyHiDreamDims(hidden=512, heads=4, depth_double=1,
                                   depth_single=1, ffn=1024, n_experts=2,
                                   top_k=1, t5_dim=64, llama_dim=64,
                                   pooled=32)

    def model():
        return tpipeline.DiffusionModel(
            arch="hidream", params=testing.hidream_random_stacked_params(
                dims, seed=4, device="cpu"),
            config=dims.config(),
            qcfg=QuantConfig(dequant_dtype=torch.float32,
                             compute_dtype=torch.float32),
            device=torch.device("cpu"))

    pred = lambda k, v: not i8.is_modulation_key(k)  # noqa: E731
    m = model()
    cands = {}

    def scan(node, path):
        for k, v in node.items():
            kp = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                scan(v, kp)
            elif isinstance(v, planar.PlanarQuant):
                cands[kp] = i8._leaf_bytes(v)

    scan(m.params, "")
    planar_bytes = sum(p for p, _ in cands.values())
    full = planar_bytes + sum(b - p for k, (p, b) in cands.items()
                              if pred(k, None))
    budget = int(planar_bytes + 0.6 * (full - planar_bytes))
    plan = i8.plan_i8_budget(m.params, max_bytes=budget, pred=pred)
    assert plan and len(plan) < sum(pred(k, None) for k in cands)
    m.requantize_i8(max_bytes=budget)
    converted = set()

    def walk(node, path):
        for k, v in node.items():
            kp = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, kp)
            elif isinstance(v, i8.I8Planar):
                converted.add(kp)

    walk(m.params, "")
    assert converted == plan
    rng = np.random.default_rng(9)
    lat, t5s, lls, pooled = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((1, 8, 8, 16), (1, 5, 64), (1, 4, 64),
                               (1, 32)))
    t = torch.tensor([0.5])
    got = m.forward(lat, t5s, lls, pooled, t)
    ref = model()
    ref.params = i8.convert_tree_i8(ref.params, pred=lambda k, v: k in plan)
    want = ref.forward(lat, t5s, lls, pooled, t)
    assert torch.equal(got, want)
