"""Tensor parallelism of the port (``parallel/``, ``quant/planar.py``'s
shards, ``nn/layers.py``'s TP branches, ``quant/i8.py`` through
``TPShard``) against the JAX package, the port on gloo ranks
(``parallel.launch``; one launch for the module) and the reference on the
8-device virtual CPU mesh.

Tolerances: shards bit-identical to the reference's; float32 layer
outputs 2e-4 relative (the reference's own ``test_tp.py`` bound; sums in
another order than XLA's); the ranks' replicated outputs bit-equal to one
another; a row-parallel output at tp = 2 bit-equal to the sum of its two
partial products (one f32 addition is order-free), at tp = 4 within 1e-6
of it (the all-reduce's order is gloo's); norms 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_jobs as jobs
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.parallel import make_mesh as jmake_mesh
from comfyui_gguf_tpu.parallel import tp as jtp
from comfyui_gguf_tpu.parallel import tp_spec as jtp_spec
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import flux, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.parallel import launch, tp_spec
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar, convert_tree_i8

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TOL = 2e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(2, device="cpu") as r:
        yield r


@pytest.fixture(scope="module")
def ranks4():
    with launch.Ranks(4, device="cpu") as r:
        yield r


def _packed(rng, R, K, qtype=Q.Q8_0):
    w = rng.standard_normal((R, K), dtype=np.float32)
    return codecs.quantize(w, qtype), codecs.dequantize(
        codecs.quantize(w, qtype), qtype, (R, K))


@pytest.mark.parametrize("qtype", [Q.Q8_0, Q.Q4_K, Q.Q4_0, Q.Q6_K])
@pytest.mark.parametrize("axis", ["r", "k"])
def test_planarize_shards_matches_reference(qtype, axis):
    """Shards bit for bit the reference's, and ``shard_planar`` of the
    unsharded planar weight gives the same bytes."""
    rng = np.random.default_rng(0)
    R, K = (768, 512) if axis == "r" else (256, 1536)
    groups = [256, 256, 256] if axis == "r" else [512, 1024]
    blocks, _ = _packed(rng, R, K, qtype)
    got = planar.planarize_shards(blocks, qtype, (R, K), 2, axis, groups)
    want = jplanar.planarize_shards(blocks, qtype, (R, K), 2, axis, groups)
    for f in ("qs", "scales", "offsets"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w)), f
    again = planar.shard_planar(planar.planarize(blocks, qtype, (R, K)), 2,
                                axis, groups)
    assert torch.equal(again.qs, got.qs)
    assert torch.equal(again.scales, got.scales)


def test_k_split_inside_superblocks_is_exact():
    """A row split at 384 cuts Q4_K superblocks; each shard still
    dequantizes to its columns of the whole weight."""
    rng = np.random.default_rng(5)
    R, K, n = 128, 3072, 8
    blocks, ref = _packed(rng, R, K, Q.Q4_K)
    st = planar.planarize_shards(blocks, Q.Q4_K, (R, K), n, axis="k")
    per = K // n
    for s in range(n):
        got = planar.dequantize(planar.shard_view(st, s)).numpy()
        assert np.array_equal(got, ref[:, s * per:(s + 1) * per])


def test_k_split_rejects_sub_group_cuts():
    rng = np.random.default_rng(10)
    blocks, _ = _packed(rng, 64, 512, Q.Q4_K)
    with pytest.raises(ValueError, match="granularity"):
        planar.planarize_shards(blocks, Q.Q4_K, (64, 512), 32, axis="k")


def test_ranks_and_collectives(ranks):
    info = ranks.run(jobs.rank_info)
    assert [i[:4] for i in info] == [(0, 0, 1, 2), (0, 1, 1, 2)]
    assert {i[4] for i in info} == {"gloo"}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    outs = ranks.run(jobs.collective_ops, x)
    for r, (s, g, p) in enumerate(outs):
        np.testing.assert_array_equal(s, 3 * x.numpy())
        np.testing.assert_array_equal(
            g, np.concatenate([x.numpy(), 2 * x.numpy()], axis=-1))
        np.testing.assert_array_equal(p, (2 - r) * x.numpy())


def test_ranks_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.Ranks(2)
    assert launch.backend_for("cpu", 2) == "gloo"


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(launch.RankError,
                       match=r"rank \d failed:(.|\n)*TypeError"):
        launch.run(jobs.tp_linear, 2, "bogus", None, None, None, None,
                   device="cpu")


def _jmesh(tp):
    return jmake_mesh(tp, tp=tp)


@pytest.mark.parametrize("tp_ranks", ["ranks", "ranks4"])
def test_tp_primitives_match_reference(tp_ranks, request):
    """column_linear / row_linear / tp_mlp against the reference's on the
    virtual mesh, from the same blocks."""
    r = request.getfixturevalue(tp_ranks)
    n = r.world
    rng = np.random.default_rng(1)
    D, F, M = 256, 512, 12
    up_b, _ = _packed(rng, F, D)
    down_b, _ = _packed(rng, D, F)
    col_b, _ = _packed(rng, 512, D)
    row_b, _ = _packed(rng, 256, D)
    x = rng.standard_normal((M, D), dtype=np.float32)
    sh = lambda b, s, a: planar.planarize_shards(b, Q.Q8_0, s, n, a)  # noqa
    outs = r.run(jobs.tp_primitives, sh(up_b, (F, D), "r"),
                 sh(down_b, (D, F), "k"), sh(col_b, (512, D), "r"),
                 sh(row_b, (256, D), "k"), torch.from_numpy(x), F32)
    m = _jmesh(n)
    jsh = lambda b, s, a: jtp.place_stacked(  # noqa: E731
        jplanar.planarize_shards(b, Q.Q8_0, s, n, a), m)
    want_c = np.asarray(jtp.column_linear(jnp.asarray(x),
                                          jsh(col_b, (512, D), "r"), m,
                                          cfg=JF32))
    want_r = np.asarray(jtp.row_linear(jnp.asarray(x),
                                       jsh(row_b, (256, D), "k"), m,
                                       cfg=JF32))
    want_m = np.asarray(jtp.tp_mlp(jnp.asarray(x), jsh(up_b, (F, D), "r"),
                                   jsh(down_b, (D, F), "k"), m, cfg=JF32))
    for got in outs:
        assert _rel(got[0], want_c) < TOL
        assert _rel(got[1], want_r) < TOL
        assert _rel(got[2], want_m) < TOL
    for a, b in zip(outs[0], outs[-1]):
        assert np.array_equal(a, b)  # replicated on every rank


@pytest.mark.parametrize("kind", ["col", "row", "gather"])
def test_tp_linear_modes(ranks, kind):
    """``linear`` of a TPShard: col gives the rank's columns, row and
    gather the whole output; at tp = 2 the row all-reduce is bit-equal to
    the two partial products summed."""
    rng = np.random.default_rng(2)
    R, K, M = 256, 512, 8
    blocks, ref = _packed(rng, R, K)
    st = planar.planarize_shards(blocks, Q.Q8_0, (R, K), 2,
                                 "k" if kind == "row" else "r")
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    bias = torch.from_numpy(rng.standard_normal((R,), dtype=np.float32))
    outs = ranks.run(jobs.tp_linear, kind, st, x, bias, F32)
    want = x.numpy() @ ref.T + bias.numpy()
    if kind == "col":
        got = np.concatenate(outs, axis=-1)
    else:
        assert np.array_equal(outs[0], outs[1])
        got = outs[0]
    assert _rel(got, want) < TOL
    if kind == "row":
        from comfyui_gguf_tpu_torch.nn.layers import linear

        parts = [linear(x[:, s * 256:(s + 1) * 256],
                        planar.shard_view(st, s), cfg=F32) for s in (0, 1)]
        assert np.array_equal(got, (parts[0] + parts[1] + bias).numpy())


def test_tp_linear_gelu_and_row_tail_refusal(ranks):
    rng = np.random.default_rng(3)
    R, K, M = 512, 256, 8
    blocks, ref = _packed(rng, R, K)
    st = planar.planarize_shards(blocks, Q.Q8_0, (R, K), 2, "r")
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    outs = ranks.run(jobs.tp_linear, "col", st, x, None, F32, 128)
    h = x.numpy() @ ref.T
    want = [h[:, :256].copy(), h[:, 256:].copy()]
    for w in want:
        w[:, 128:] = np.asarray(jax.nn.gelu(jnp.asarray(w[:, 128:])))
    for got, w in zip(outs, want):
        assert _rel(got, w) < TOL
    st_k = planar.planarize_shards(_packed(rng, 128, 512)[0], Q.Q8_0,
                                   (128, 512), 2, "k")
    with pytest.raises(launch.RankError, match="tail_from"):
        launch.run(jobs.tp_linear, 2, "row", st_k,
                   torch.zeros(2, 512), None, F32, 64, device="cpu")


def test_tp_norm_shards_match_full_width(ranks):
    from comfyui_gguf_tpu.nn.layers import layer_norm as jln, rms_norm as jrms

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    s = rng.standard_normal((64,), dtype=np.float32)
    b = rng.standard_normal((64,), dtype=np.float32)
    outs = ranks.run(jobs.tp_norms, torch.from_numpy(x), torch.from_numpy(s),
                     torch.from_numpy(b))
    want_ln = np.asarray(jln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                             eps=1e-6))
    want_rms = np.asarray(jrms(jnp.asarray(x), jnp.asarray(s), eps=1e-6))
    for ln, rms in outs:
        assert _rel(ln, want_ln) < 1e-5
        assert _rel(rms, want_rms) < 1e-5


QWEN_DIMS = testing.QwenImageDims(hidden=512, n_heads=4, n_layers=2,
                                  in_ch=32, context_dim=96)


def test_i8_conversion_is_per_shard_like_the_reference():
    """convert_tree_i8 through TPShard: every shard's int8 codes and column
    scales are the reference's (its codes transposed), and differ from a
    slice of the unsharded conversion's scales for row shards."""
    from comfyui_gguf_tpu.models import testing as jtesting

    nonblock, groups = testing.qwen_image_shape_spec(QWEN_DIMS)
    sd = testing.random_flat_sd_from_spec(nonblock, groups, seed=3)
    cfg = QWEN_DIMS.config()
    got = convert_tree_i8(tp_spec.shard_qwen_image_params(sd, cfg, 2,
                                                          Q.Q8_0))
    jsd = jtesting.random_flat_sd_from_spec(
        *jtesting.qwen_image_shape_spec(
            jtesting.QwenImageDims(hidden=512, n_heads=4, n_layers=2,
                                   in_ch=32, context_dim=96)), seed=3)
    want = ji8.convert_tree_i8(jtp_spec.shard_qwen_image_params(
        jsd, cfg, 2, Q.Q8_0))
    n = 0
    for k, leaf in got["transformer_blocks"].items():
        wl = want["transformer_blocks"][k]
        if not isinstance(getattr(leaf, "inner", None), I8Planar):
            continue
        g, w = leaf.inner, wl.inner
        assert g.qs.shape[:2] == (2, QWEN_DIMS.n_layers)
        assert np.array_equal(g.qs.numpy(),
                              np.swapaxes(np.asarray(w.qs), -1, -2)), k
        assert np.array_equal(g.scales.numpy(), np.asarray(w.scales)), k
        n += 1
    assert n == len(tp_spec.qwen_image_rules())


def test_shard_quant_params_forward_matches_unsharded(ranks):
    """``mesh.shard_quant_params`` (packed leaves column-split as gather
    shards, biases with them) under the active mesh: the unmodified flux
    forward equals the unsharded one."""
    dims = testing.TinyFluxDims(hidden=256, heads=2, ctx=64, vec=32,
                                in_ch=16, depth_double=1, depth_single=1,
                                axes_dim=(32, 48, 48))
    sd = testing.flux_state_dict(dims, seed=5)
    cfg = dims.config()
    params = {k: (planar.planarize(codecs.quantize(v, Q.Q8_0), Q.Q8_0,
                                   v.shape)
                  if v.ndim == 2 and "blocks" in k
                  else torch.from_numpy(v)) for k, v in sd.items()}
    inputs = testing.flux_example_inputs(dims, batch=1, h_lat=8, w_lat=8,
                                         txt_len=8, dtype=torch.float32,
                                         device="cpu")
    want = flux.forward(params, cfg, *inputs, qcfg=F32).numpy()
    outs = ranks.run(jobs.gather_quant_forward,
                     "comfyui_gguf_tpu_torch.models.flux", params, cfg,
                     inputs, F32)
    for got in outs:
        assert _rel(got, want) < 1e-5
