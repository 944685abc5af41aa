"""The q/k norm + RoPE op before each attention call (ops/qkrope.py, K9).

On the CPU: the op's plain path is bit for bit the composition the flux
and Wan blocks ran before it (``rms_norm``, then ``apply_rope``, then
``torch.cat``) at flux's double block (two parts, per-head norms), flux's
single block (a strided view of linear1's output), Wan's self-attention
(full-width norms, an (L, D/2, 2) table) and Wan's cross-attention (no
table, k at another length), in bf16, f16 and f32; Wan's block sends a
``TPNormShard`` gain (tensor parallelism) to the plain version itself; a
head dim or a dtype without an instance takes the plain version on CPU
tensors, and the kernel's wrapper refuses it and whatever else it does
not take; every attention call of a tiny flux and Wan forward goes
through the op.

On the card (``cuda`` marker; skipped here): K9 against the plain version
in the working dtype at the cells' shapes (flux double txt 512 + img 4096
at B = 1 and 4, flux single at L = 4608 on linear1's view, Wan self at
L = 32760 and G = 1536, Wan cross with k at 512 rows): rel L2 <= 1e-3 and
each element within 2 ulps of the working dtype at its magnitude (for a
rotated element, its pair's magnitude, which the rotation keeps): the mean
of squares is summed in another order and the kernel's rsqrt may differ
in the last bit, so an intermediate rounding can flip. In f32 no rounding
to a coarser type absorbs the summation order, and the composition's own
f32 error reaches 4-5 ulps of the formula evaluated in f64 on the same
inputs; there the kernel is held to rel L2 1e-3 of the composition and,
as the composition is, to ``F32_ULPS`` of the f64 evaluation. The launch
counter: 57 launches a tiny flux forward (19 + 38 blocks), 60 a tiny Wan
forward (30 blocks, self and cross), at reduced widths and D = 128; on the
card, inputs without an instance raise and launch nothing. Run them with
``python -m pytest tests/test_torch_qkrope.py -q -m cuda --noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch import _build
from comfyui_gguf_tpu_torch.models import flux, testing, wan
from comfyui_gguf_tpu_torch.nn.layers import materialize, rms_norm
from comfyui_gguf_tpu_torch.ops import qkrope
from comfyui_gguf_tpu_torch.quant.planar import TPNormShard

torch.set_num_threads(2)

CPU = torch.device("cpu")
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
OP = qkrope.qk_norm_rope


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(g, *shape, dtype=torch.float32, scale=1.0, mean=0.0):
    t = torch.randn(shape, generator=g, device=g.device) * scale + mean
    return t.to(dtype)


def _flux_pe(B, L_txt, h_tok, w_tok, dev, axes=(16, 56, 56)):
    """The joint table of flux's prelude: text ids 0, image ids (row, col)."""
    img_ids = torch.as_tensor(np.array(flux.make_img_ids(h_tok, w_tok, B)),
                              device=dev)
    txt_ids = torch.zeros((B, L_txt, 3), dtype=torch.int32, device=dev)
    return flux.rope_freqs(torch.cat([txt_ids, img_ids], dim=1), axes)


def _wan_pe(f, h, w, dev, head_dim=128):
    cfg = wan.WanConfig(dim=head_dim, ffn_dim=1, n_heads=1, n_layers=1)
    return wan.rope_3d(f, h, w, cfg.axes_dim, device=dev)


# -- the cases: (parts, n_heads, pe) and the composition before K9 -----------


def _flux_double(dev, dtype, B, L_txt, h_tok, H=24, D=128, seed=0):
    g = _gen(dev, seed)
    W = H * D
    txt = _randn(g, B, L_txt, 3 * W, dtype=dtype)
    img = _randn(g, B, h_tok * h_tok, 3 * W, dtype=dtype)
    gains = [_randn(g, D, scale=0.3, mean=1.0, dtype=gdt)
             for gdt in (torch.float32, torch.bfloat16) * 2]
    pe = _flux_pe(B, L_txt, h_tok, h_tok, dev, _axes(D))
    parts = [(txt[..., :W], txt[..., W:2 * W], txt[..., 2 * W:], *gains[:2]),
             (img[..., :W], img[..., W:2 * W], img[..., 2 * W:], *gains[2:])]

    def composition():
        def split(x):  # the blocks' head split of a fused qkv
            qkv = x.reshape(B, x.shape[1], 3, H, -1)
            return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

        tq, tk, tv = split(txt)
        iq, ik, iv = split(img)
        tq, tk = rms_norm(tq, gains[0]), rms_norm(tk, gains[1])
        iq, ik = rms_norm(iq, gains[2]), rms_norm(ik, gains[3])
        q = flux.apply_rope(torch.cat([tq, iq], dim=2), pe)
        k = flux.apply_rope(torch.cat([tk, ik], dim=2), pe)
        return q, k, torch.cat([tv, iv], dim=2)

    return parts, H, pe, composition


def _flux_single(dev, dtype, B, h_tok, L_txt=512, H=24, D=128, seed=1):
    g = _gen(dev, seed)
    W = H * D
    L = L_txt + h_tok * h_tok
    h = _randn(g, B, L, 3 * W + 4 * W, dtype=dtype)  # linear1's output
    gains = [_randn(g, D, scale=0.3, mean=1.0) for _ in range(2)]
    pe = _flux_pe(B, L_txt, h_tok, h_tok, dev, _axes(D))
    qkv = h[..., :3 * W]
    parts = [(qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:], *gains)]

    def composition():
        q, k, v = (t.transpose(1, 2) for t in
                   qkv.reshape(B, L, 3, H, D).unbind(2))
        q, k = rms_norm(q, gains[0]), rms_norm(k, gains[1])
        return flux.apply_rope(q, pe), flux.apply_rope(k, pe), v

    return parts, H, pe, composition


def _wan(dev, dtype, B, f, hw, L_ctx=None, H=12, D=128, seed=2):
    """Wan self-attention (L_ctx None: k and v at the video's rows, the
    3-D table) or cross-attention (k and v at L_ctx text rows, no table)."""
    g = _gen(dev, seed)
    W = H * D
    L = f * hw * hw
    Lk = L if L_ctx is None else L_ctx
    q = _randn(g, B, L, W, dtype=dtype)
    k = _randn(g, B, Lk, W, dtype=dtype)
    v = _randn(g, B, Lk, W, dtype=dtype)
    gains = [_randn(g, W, scale=0.3, mean=1.0) for _ in range(2)]
    pe = _wan_pe(f, hw, hw, dev, D) if L_ctx is None else None
    parts = [(q, k, v, *gains)]

    def composition():
        def heads(x):
            return x.reshape(B, x.shape[1], H, D).transpose(1, 2)

        qn = heads(rms_norm(q, gains[0]))
        kn = heads(rms_norm(k, gains[1]))
        if pe is not None:
            qn, kn = (flux.apply_rope(t, pe[None]) for t in (qn, kn))
        return qn, kn, heads(v)

    return parts, H, pe, composition


def _axes(D):
    """flux's RoPE axes for a head of D (16, 56, 56 at 128)."""
    a = 2 * (7 * D // 32)
    return (D - 2 * a, a, a)


CPU_CASES = {
    "flux-double": lambda dt: _flux_double(CPU, dt, 2, 6, 4, H=3, D=32),
    "flux-single": lambda dt: _flux_single(CPU, dt, 2, 4, L_txt=5, H=3,
                                           D=32),
    "wan-self": lambda dt: _wan(CPU, dt, 2, 2, 3, H=3, D=32),
    "wan-cross": lambda dt: _wan(CPU, dt, 2, 2, 3, L_ctx=7, H=3, D=32),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_path_is_the_composition_bit_for_bit(case, dtype):
    parts, H, pe, composition = CPU_CASES[case](dtype)
    got = qkrope.qk_norm_rope(parts, H, pe)
    want = composition()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_a_tp_norm_shard_gain_takes_the_composition(monkeypatch):
    """Wan's block sends a TPNormShard gain (tp_spec's full-width norm over
    a column-split row) to the plain version, other gains to the op; the
    kernel's wrapper refuses the shard."""
    parts, H, pe, _ = _wan(CPU, torch.bfloat16, 1, 2, 3, H=3, D=32)
    q, k, v, gq, gk = parts[0]
    shard = TPNormShard(weight=gq, axis="tp", full_dim=gq.numel())
    calls = []
    monkeypatch.setattr(qkrope, "qk_norm_rope",
                        lambda *a, **kw: calls.append("op") or OP(*a, **kw))
    p = {"self_attn.norm_q.weight": gq, "self_attn.norm_k.weight": gk}
    want = wan._norm_rope(p, "self_attn", q, k, v, H, pe)
    assert calls == ["op"]
    # the plain version reduces a TPNormShard over its mesh axis: outside a
    # mesh only the route is checked (tests/test_torch_tp_spec.py runs Wan
    # under TP)
    monkeypatch.setattr(qkrope, "rms_norm", lambda x, w, eps: (
        rms_norm(x, w.weight if isinstance(w, TPNormShard) else w, eps=eps)))
    p["self_attn.norm_q.weight"] = shard
    out = wan._norm_rope(p, "self_attn", q, k, v, H, pe)
    assert calls == ["op"]
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    with pytest.raises(NotImplementedError, match="TPNormShard"):
        qkrope._gain("q", shard, 32, 96, CPU)


@pytest.mark.parametrize("H,D,dtype", [(2, 96, torch.bfloat16),
                                       (3, 40, torch.float32),
                                       (2, 128, torch.float64)],
                         ids=["D96", "D40", "float64"])
def test_no_instance_takes_the_composition(H, D, dtype):
    """On CPU tensors the op is the composition at any head dim and dtype;
    the kernel's wrapper has no instance for these and refuses them."""
    parts, H, pe, composition = _wan(CPU, dtype, 1, 1, 2, H=H, D=D)
    out = qkrope.qk_norm_rope(parts, H, pe)
    assert all(torch.equal(a, b) for a, b in zip(out, composition()))
    with pytest.raises(NotImplementedError, match="K9 has"):
        qkrope.qk_norm_rope_cuda(parts, H, pe)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    parts, H, pe, _ = _flux_double(CPU, torch.bfloat16, 1, 2, 2, H=2, D=32)
    with pytest.raises(ValueError, match="CUDA"):
        qkrope.qk_norm_rope_cuda(parts, H, pe)
    w_parts, wH, _, _ = _wan(CPU, torch.bfloat16, 1, 1, 2, H=2, D=96)
    with pytest.raises(NotImplementedError, match="head dims"):
        qkrope.qk_norm_rope_cuda(w_parts, wH)
    f_parts, fH, _, _ = _wan(CPU, torch.float64, 1, 1, 2, H=2, D=32)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        qkrope.qk_norm_rope_cuda(f_parts, fH)
    many = parts * 3  # 6 parts: 18 descriptors
    with pytest.raises(NotImplementedError, match="descriptors"):
        qkrope.qk_norm_rope_cuda(many, H, None)


def _count_op_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(qkrope, "qk_norm_rope",
                        lambda *a, **kw: calls.append(1) or OP(*a, **kw))
    return calls


def test_every_attention_call_of_a_tiny_forward_takes_the_op(monkeypatch):
    dims = testing.TinyFluxDims(hidden=64, heads=2, depth_double=2,
                                depth_single=3, axes_dim=(8, 12, 12))
    sp = testing.flux_random_stacked_params(dims, device="cpu")
    x = testing.flux_example_inputs(dims, device="cpu")
    calls = _count_op_calls(monkeypatch)
    flux.forward_stacked(sp, dims.config(), *x)
    assert len(calls) == 5
    flux.forward(testing.flux_flat_views(sp), dims.config(), *x)
    assert len(calls) == 10
    wd = testing.WanDims(dim=64, ffn_dim=128, n_heads=2, n_layers=3)
    wp = testing.wan_random_stacked_params(wd, device="cpu")
    del calls[:]
    wan.forward_stacked(wp, wd.config(), *_wan_inputs(wd, CPU))
    assert len(calls) == 6


def _wan_inputs(wd, dev, B=1):
    g = _gen(dev, 9)
    lat = _randn(g, B, 2, 4, 4, wd.in_ch, dtype=torch.bfloat16)
    ctx = _randn(g, B, 6, wd.text_dim, dtype=torch.bfloat16)
    return lat, ctx, torch.full((B,), 0.7, device=dev)


# -- on the card -------------------------------------------------------------


def _ulps(got, want, dtype, rope):
    """Largest |got - want| in ulps of ``dtype`` at each element's
    magnitude (a rotated element's: its pair's)."""
    w = want.double()
    mag = w.abs()
    if rope:
        pairs = w.reshape(*w.shape[:-1], -1, 2)
        mag = pairs.norm(dim=-1, keepdim=True).expand_as(pairs).reshape(
            w.shape)
    mant, emin = {torch.bfloat16: (8, -126), torch.float16: (11, -14),
                  torch.float32: (24, -126)}[dtype]
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), (e - mant).clamp(min=emin - mant
                                                             + 1))
    return float(((got.double() - w).abs() / ulp).max())


def _exact(parts, H, pe):
    """The norms, joint concat and rotation in f64 on the same inputs,
    without a rounding between them: (B, H, L, D) q, k, v."""
    def heads(x):
        B, L, W = x.shape
        return x.double().reshape(B, L, H, W // H).transpose(1, 2)

    def norm(x, gain):
        g = materialize(gain, torch.float64).reshape(-1)
        x = x.double()
        if g.numel() != x.shape[-1]:  # a head's norm
            x = heads(x)
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * g
        return y if y.dim() == 4 else heads(y)

    q, k, v = (torch.cat(ts, dim=2) for ts in (
        [norm(p[0], p[3]) for p in parts], [norm(p[1], p[4]) for p in parts],
        [heads(p[2]) for p in parts]))
    if pe is not None:
        pe = (pe if pe.dim() == 4 else pe[None]).double()[:, None]
        c, s = pe[..., 0], pe[..., 1]

        def rotate(x):
            x0, x1 = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
            return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                               dim=-1).flatten(-2)

        q, k = rotate(q), rotate(k)
    return q, k, v


# f32: the largest distance from the f64 evaluation, in ulps, that the
# composition itself keeps to at the cells' shapes (4-5), with one to spare
F32_ULPS = 6.0


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / (b.norm() + 1e-12))


CARD_CASES = {
    "flux-double-B1": lambda dev, dt: _flux_double(dev, dt, 1, 512, 64),
    "flux-double-B4": lambda dev, dt: _flux_double(dev, dt, 4, 512, 64),
    "flux-single-B1": lambda dev, dt: _flux_single(dev, dt, 1, 64),
    "wan-self": lambda dev, dt: _wan(dev, dt, 1, 21, 30),
    "wan-self-ragged": lambda dev, dt: _wan(dev, dt, 1, 3, 5, H=5),
    "wan-cross": lambda dev, dt: _wan(dev, dt, 1, 21, 30, L_ctx=512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_its_plain_version(cuda, case, dtype):
    parts, H, pe, _ = CARD_CASES[case](cuda, dtype)
    before = _build.LAUNCHES["qk_norm_rope"]
    got = qkrope.qk_norm_rope_cuda(parts, H, pe)
    again = qkrope.qk_norm_rope_cuda(parts, H, pe)
    want = qkrope.plain_qk_norm_rope(parts, H, pe)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qk_norm_rope"] == before + 2
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name  # no atomics: the same bits
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 1e-3, (name, _rel_l2(g, w))
    if dtype == torch.float32:  # the kernel and the composition alike
        for name, g, w, x in zip("qkv", got, want, _exact(parts, H, pe)):
            rope = pe is not None and name != "v"
            ulps = (_ulps(g, x, dtype, rope), _ulps(w, x, dtype, rope))
            assert max(ulps) <= F32_ULPS, (name, ulps)
    else:
        for name, g, w in zip("qkv", got, want):
            ulps = _ulps(g, w, dtype, rope=pe is not None and name != "v")
            assert ulps <= 2.0, (name, ulps)
    # K7 reads q and k in place: unit stride along D, (B, L, H, D) storage
    q, k, v = got
    assert q.stride(-1) == 1 and q.stride(2) == H * q.shape[-1]


@pytest.mark.cuda
def test_a_shared_table_and_a_patched_gain(cuda):
    """A (1, L, D/2, 2) table for four lanes (read with batch stride 0) and
    a LoRA-patched gain (``materialize`` folds it) match the plain version."""
    from comfyui_gguf_tpu_torch.lora import LoRAPatch, PatchedWeight

    parts, H, pe, _ = _flux_double(cuda, torch.bfloat16, 4, 64, 8)
    g = _gen(cuda, 5)
    patched = PatchedWeight(parts[0][3], (LoRAPatch(
        up=None, down=None, mid=None, scale=0.5,
        diff=_randn(g, parts[0][3].numel(), scale=0.1)),))
    parts[0] = parts[0][:3] + (patched, parts[0][4])
    got = qkrope.qk_norm_rope_cuda(parts, H, pe[:1])
    want = qkrope.plain_qk_norm_rope(parts, H, pe[:1])
    for name, a, b in zip("qkv", got, want):
        assert _ulps(a, b, torch.bfloat16, rope=name != "v") <= 2.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,dtype", [(2, 96, torch.bfloat16),
                                       (2, 128, torch.float64)],
                         ids=["D96", "float64"])
def test_the_op_routes_what_the_kernel_does_not_take(cuda, H, D, dtype):
    """On the card, inputs without an instance raise, as K7's do, and
    launch nothing: no call leaves the kernel unseen."""
    parts, H, pe, _ = _wan(cuda, dtype, 1, 1, 2, H=H, D=D)
    before = _build.LAUNCHES["qk_norm_rope"]
    with pytest.raises(NotImplementedError, match="K9 has"):
        qkrope.qk_norm_rope(parts, H, pe)
    assert _build.LAUNCHES["qk_norm_rope"] == before


@pytest.mark.cuda
def test_one_launch_an_attention_call(cuda):
    """57 launches a flux forward (19 double + 38 single blocks), flat and
    stacked, and 60 a Wan forward (30 blocks, self and cross), at reduced
    widths and D = 128: no attention call takes the composition."""
    dims = dataclasses.replace(testing.FLUX_DEV_DIMS, hidden=256, heads=2,
                               ctx=64, vec=32, in_ch=16)
    sp = testing.flux_random_stacked_params(dims, device=cuda)
    x = testing.flux_example_inputs(dims, device=cuda)
    for fwd, params in ((flux.forward_stacked, sp),
                        (flux.forward, testing.flux_flat_views(sp))):
        _build.reset_launch_counts()
        out = fwd(params, dims.config(), *x)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _build.LAUNCHES["qk_norm_rope"] == 57
    wd = testing.WanDims(dim=256, ffn_dim=512, n_heads=2, n_layers=30)
    wp = testing.wan_random_stacked_params(wd, device=cuda)
    _build.reset_launch_counts()
    out = wan.forward_stacked(wp, wd.config(), *_wan_inputs(wd, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _build.LAUNCHES["qk_norm_rope"] == 60
