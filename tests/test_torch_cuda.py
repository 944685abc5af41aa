"""The PyTorch port's CUDA kernels against their plain PyTorch versions.

Each kernel (K1 nib4 and K2 int8 fused dequant-matmul, K4 w8a8 matmul, K6
int8 flash attention and its prep, K7 flash attention, K8 GEMM probes)
runs on the card beside its plain version on the same inputs, at small
shapes that cover the ragged edges: M=1, M not a multiple of the tile, K
padded, R not a multiple of 128, the GELU tail, odd key lengths, Lq != Lk
and strided views; K7 also at SD1's head dims 40, 80 and 160, Lumina 2's
96 and AuraFlow's 256; K6 at head dims 128 and 256 and in its split
instance (384, 512). K1/K2 run through
both of their bodies (split-K for M <= 8, wgmma above) over every format
of each layout; K4 through both of its tile widths. One-hot rows check
every tile position of K1/K2/K4 bit for bit. The LoRA instances of K1/K2
(both bodies) and K4 (both widths) run at ranks 1, 16 and 16 + 64 against
the plain versions with the same rank operands, with one-hot rank rows, at
strength 0 (equal to the unpatched launch) and on stacked views. The
serving path's batch shapes (four requests stacked: K4 at M = 4·4608,
4·4096 and 4·512, K7 at B = 4 and the flux length, the split-K body at
M = 4) and one continuous-batching engine run on the card against the
same engine on the CPU (launch counts per tick) run here too. Whether a
card exists is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip. Two tests of the
wrappers' host side (the LoRA operands' layout and limits, and the dispatch
handing them to the kernel wrappers) run on the CPU. Run them on the card
with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest`` (the
repo's conftest imports jax, which the card's machine need not have).
"""

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu_torch import _build
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.nn.attention import (flash_attn_cuda,
                                                 plain_attention)
from comfyui_gguf_tpu_torch.ops import gemm_probe
from comfyui_gguf_tpu_torch.ops.i8attn import (i8_attention_cuda,
                                               kernel_block_kv,
                                               kernel_operands,
                                               plain_i8_attention,
                                               prep_cuda,
                                               quantize_attn_inputs)
from comfyui_gguf_tpu_torch.ops.i8mm import (i8mm_cuda, i8mm_cuda_q,
                                            plain_i8mm)
from comfyui_gguf_tpu_torch.ops.qmatmul import (I8MM_WIDTHS, SMALL_M_MAX,
                                                plain_quantized_matmul,
                                                qmm_cuda, qmm_route,
                                                smallm_plan)
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.quant.i8 import (I8Planar, quantize_rows,
                                             requantize_i8)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / (b.norm() + 1e-12))


def _bf16_ulp(t):
    """Spacing of bf16 values at |t| (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _planar(qtype, R, K, seed, device):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((R, K), dtype=np.float32)
    return planar.planarize(codecs.quantize(w, qtype), qtype, (R, K),
                            device=device)


QMM_CASES = [
    # qtype, M, R, K, bias, act_from_col
    (Q.Q4_K, 1, 384, 512, True, None),
    (Q.Q4_K, 37, 200, 2432, False, 0),
    (Q.Q4_0, 130, 256, 1024, True, 128),
    (Q.Q2_K, 5, 128, 512, True, None),
    (Q.Q8_0, 37, 384, 512, True, 256),
    (Q.Q6_K, 200, 256, 1024, False, None),
    (Q.Q5_1, 16, 128, 512, True, 0),
]


def _qmm_key(pq, M):
    """The launch counter of the body that takes this shape."""
    key = "qmm_nib4" if pq.layout == "nib4" else "qmm_int8"
    small = qmm_route(M, pq.padded_in, pq.shape[0],
                      pq.layout == "nib4") == "smallm"
    return key + "_smallm" if small else key


def _check_qmm(cuda, pq, M, K, R, bias, act, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn((R,), generator=g, device=cuda) if bias else None)
    key = _qmm_key(pq, M)
    before = dict(_build.LAUNCHES)
    got = qmm_cuda(x, pq, bias=b, act_from_col=act)
    torch.cuda.synchronize()
    want = plain_quantized_matmul(x, pq, bias=b, act_from_col=act)
    assert _build.LAUNCHES[key] == before[key] + 1
    assert got.shape == (M, R) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) < 5e-3
    return x, b, got


@pytest.mark.parametrize("qtype,M,R,K,bias,act", QMM_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_qmm_kernel_matches_plain(cuda, qtype, M, R, K, bias, act):
    pq = _planar(qtype, R, K, seed=int(qtype), device=cuda)
    _check_qmm(cuda, pq, M, K, R, bias, act, seed=M)


# every format each layout holds (group sizes 16 and 32, with and without
# offsets), through both bodies: M up to SMALL_M_MAX takes the split-K
# body, every larger M the wgmma body
NIB4_TYPES = [Q.Q4_0, Q.Q4_1, Q.Q4_K, Q.Q2_K]
INT8_TYPES = [Q.Q5_0, Q.Q5_1, Q.Q8_0, Q.Q3_K, Q.Q5_K, Q.Q6_K, Q.IQ4_NL,
              Q.IQ4_XS]
QMM_MS = [1, 2, 3, SMALL_M_MAX, SMALL_M_MAX + 1, 65, 200]


@pytest.mark.parametrize("M", QMM_MS)
@pytest.mark.parametrize("qtype", NIB4_TYPES + INT8_TYPES,
                         ids=lambda q: q.name)
def test_qmm_bodies_formats_and_rows(cuda, qtype, M):
    # R is no multiple of 128 and K is padded (K < Kp): the ragged edges
    R, K = 328, 768
    pq = _planar(qtype, R, K, seed=int(qtype) + 100, device=cuda)
    for bias, act in ((True, None), (False, 0), (True, 136)):
        _check_qmm(cuda, pq, M, K, R, bias, act, seed=M)


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K], ids=lambda q: q.name)
@pytest.mark.parametrize("M", [1, 130])
def test_qmm_every_tile_position(cuda, qtype, M):
    """A one-hot x row picks single weight rows: each output must equal the
    dequantized bf16 weight exactly, at every k and column of the tiles (a
    wrong swizzle or fragment order cannot hide in a sum)."""
    R, K = 256, 1024
    pq = _planar(qtype, R, K, seed=7, device=cuda)
    w = planar.dequantize_kmajor(pq, torch.bfloat16)  # (K, R)
    picks = ([torch.arange(k0, k0 + 128) for k0 in range(0, K, 128)]
             if M > 1 else
             [torch.tensor([k]) for k in (0, 1, 517, K // 2, K - 1)])
    for ks in picks:
        ks = ks.to(cuda)
        x = torch.zeros((M, K), device=cuda, dtype=torch.bfloat16)
        x[torch.arange(ks.numel(), device=cuda), ks] = 1.0
        got = qmm_cuda(x, pq)
        assert torch.equal(got[: ks.numel()], w[ks])
        assert not bool(got[ks.numel():].any())


def test_qmm_smallm_is_deterministic(cuda):
    pq = _planar(Q.Q4_K, 1024, 3072, seed=3, device=cuda)
    x = torch.randn((4, 3072), device=cuda).to(torch.bfloat16)
    assert smallm_plan(4, pq.padded_in, 1024, True)[0] > 1  # a real K split
    a = qmm_cuda(x, pq)
    b = qmm_cuda(x, pq)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_qmm_kernel_on_stacked_view(cuda):
    a = _planar(Q.Q4_K, 256, 1024, seed=1, device=cuda)
    b = _planar(Q.Q4_K, 256, 1024, seed=2, device=cuda)
    st = planar.PlanarQuant(
        qs=torch.stack([a.qs, b.qs]), scales=torch.stack([a.scales,
                                                          b.scales]),
        offsets=torch.stack([a.offsets, b.offsets]), qtype=a.qtype,
        layout=a.layout, group_size=a.group_size, zero_point=a.zero_point,
        shape=a.shape)
    x = torch.randn((64, 1024), device=cuda).to(torch.bfloat16)
    view = st[1]
    assert (view.qs.untyped_storage().data_ptr()
            == st.qs.untyped_storage().data_ptr())
    got = qmm_cuda(x, view)
    assert _rel_l2(got, plain_quantized_matmul(x, b)) < 5e-3


I8_CASES = [
    # M, R, K, bias, act_from_col
    (1, 256, 512, True, None),
    (37, 200, 2432, True, 0),
    (300, 384, 1024, False, 256),
    (129, 128, 3072, True, None),
]


@pytest.mark.parametrize("M,R,K,bias,act", I8_CASES, ids=str)
def test_i8mm_kernel_matches_plain(cuda, M, R, K, bias, act):
    ip = requantize_i8(_planar(Q.Q4_K, R, K, seed=M, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn((R,), generator=g, device=cuda) if bias else None)
    got = i8mm_cuda(x, ip, bias=b, act_from_col=act)
    torch.cuda.synchronize()
    want = plain_i8mm(x, ip, bias=b, act_from_col=act)
    # the integer accumulation is exact: only the f32 epilogue's rounding
    # may differ, which moves a bf16 result by at most one ulp
    assert bool(((got.float() - want.float()).abs()
                 <= torch.maximum(_bf16_ulp(got), _bf16_ulp(want))).all())


def _check_i8(cuda, ip, M, bias, act, bn=None, seed=0):
    R, K = ip.shape
    g = torch.Generator(device=cuda).manual_seed(M * 31 + seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn((R,), generator=g, device=cuda) if bias else None)
    xq, xs = quantize_rows(x)
    before = _build.LAUNCHES["i8mm"]
    got = i8mm_cuda_q(xq, xs, ip, bias=b, act_from_col=act, bn=bn)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["i8mm"] == before + 1
    want = plain_i8mm(x, ip, bias=b, act_from_col=act)
    assert got.shape == (M, R) and got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs()
                 <= torch.maximum(_bf16_ulp(got), _bf16_ulp(want))).all())


@pytest.mark.parametrize("R,qtype", [(328, Q.Q4_K), (333, Q.Q8_0)],
                         ids=str)
@pytest.mark.parametrize("bn", I8MM_WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 129, 300])
def test_i8mm_tile_widths_and_ragged_edges(cuda, M, bn, R, qtype):
    # R is no multiple of 128 or 256 (333: nor of 8, so the kernel writes
    # rows padded to 336), K < Kp (2432 pads to 2560), GELU from a column
    # inside a tile, with and without bias
    K = 2432
    ip = requantize_i8(_planar(qtype, R, K, seed=M + bn, device=cuda))
    assert ip.padded_in > K
    for bias, act in ((True, None), (False, 0), (True, 136), (False, 300)):
        _check_i8(cuda, ip, M, bias, act, bn)


@pytest.mark.parametrize("M", [1, 4, 77, 1024])
def test_unet_narrow_linears(cuda, M):
    """The UNet's narrowest linears (SD1's level 0: K = 320, no multiple of
    Q4_K's 256-element block, padded to 512; N = 320 outputs), the GEGLU
    projection (320 → 2560) and a 1280-wide input, through K1/K2 (both
    bodies: M <= 4 split-K, wgmma above) and K4 after requantize_i8, in a
    real Q8_0 encoding and a seed-made Q4_K tree as the SD1 run makes it."""
    from comfyui_gguf_tpu_torch.models.testing import random_planar

    gen = torch.Generator(device=cuda).manual_seed(M)
    for R, K in ((320, 320), (2560, 320), (320, 1280)):
        for pq in (_planar(Q.Q8_0, R, K, seed=R + K, device=cuda),
                   random_planar(Q.Q4_K, (R, K), gen, device=cuda)):
            assert pq.padded_in > K
            _check_qmm(cuda, pq, M, K, R, True, None, seed=M + R)
            _check_i8(cuda, requantize_i8(pq), M, True, None)


def test_i8mm_kernel_on_stacked_view(cuda):
    a, b = (requantize_i8(_planar(Q.Q4_K, 384, 1024, seed=s, device=cuda))
            for s in (1, 2))
    st = I8Planar(qs=torch.stack([a.qs, b.qs]),
                  scales=torch.stack([a.scales, b.scales]), qtype=a.qtype,
                  shape=a.shape)
    view = st[1]
    assert (view.qs.untyped_storage().data_ptr()
            == st.qs.untyped_storage().data_ptr())
    x = torch.randn((200, 1024), device=cuda).to(torch.bfloat16)
    got = i8mm_cuda(x, view, act_from_col=64)
    want = plain_i8mm(x, b, act_from_col=64)
    assert bool(((got.float() - want.float()).abs()
                 <= torch.maximum(_bf16_ulp(got), _bf16_ulp(want))).all())


@pytest.mark.parametrize("bn", I8MM_WIDTHS)
def test_i8mm_every_tile_position(cuda, bn):
    """Rows that are 127 at one k and 0 elsewhere quantize to xs = 1 and
    xq = 127 there, so output (m, r) is the int8 weight at (r, k) times 127,
    rescaled by ws[r] with one rounding: bit for bit, at every k and column
    of the tiles (a wrong swizzle or fragment order cannot hide in a
    sum)."""
    R, K = 384, 1024
    ip = requantize_i8(_planar(Q.Q6_K, R, K, seed=9, device=cuda))
    wq = ip.qs[:R, :K].float()
    ws = ip.scales[0, :R]
    M = 130  # a full token tile and a ragged one of zero rows
    rows = torch.arange(128, device=cuda)
    for k0 in range(0, K, 128):
        x = torch.zeros((M, K), device=cuda, dtype=torch.bfloat16)
        x[rows, k0 + rows] = 127
        xq, xs = quantize_rows(x)
        assert bool((xs[:128] == 1.0).all())
        got = i8mm_cuda_q(xq, xs, ip, bn=bn)
        want = ((127 * wq[:, k0:k0 + 128]).t() * ws).to(torch.bfloat16)
        assert torch.equal(got[:128], want)
        assert not bool(got[128:].any())


ATTN_CASES = [
    # B, H, Lq, Lk, D
    (1, 2, 128, 128, 128),
    (2, 3, 77, 77, 64),
    (1, 2, 250, 131, 128),
    (1, 1, 5, 300, 64),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D", ATTN_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, B, H, Lq, Lk, D):
    g = torch.Generator(device=cuda).manual_seed(Lq * 7 + Lk)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    scale = D ** -0.5
    got = flash_attn_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Lq, D)
    assert _rel_l2(got, plain_attention(q, k, v, scale)) < 1e-2


def test_flash_kernel_on_strided_views(cuda):
    B, L, H, D = 1, 96, 4, 64
    qkv = torch.randn((B, L, 3, H, D), device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attn_cuda(q, k, v, 0.125)
    want = plain_attention(q, k, v, 0.125)
    assert _rel_l2(got, want) < 1e-2


FLASH_EDGES = [
    # B, H, Lq, Lk, D: ragged query and key tiles, Lk below one 128-key
    # tile, cross attention over several key tiles, B > 1, Lk = 1, Lq = 1
    (2, 2, 300, 300, 128),
    (1, 3, 257, 100, 64),
    (2, 2, 130, 513, 128),
    (3, 1, 64, 1, 128),
    (1, 2, 1, 200, 64),
    (2, 4, 640, 77, 64),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D", FLASH_EDGES, ids=str)
def test_flash_kernel_edges(cuda, B, H, Lq, Lk, D):
    g = torch.Generator(device=cuda).manual_seed(Lq * 3 + Lk + D)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    before = _build.LAUNCHES["flash_attn"]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn"] == before + 1
    assert got.shape == (B, H, Lq, D) and bool(torch.isfinite(got).all())
    assert got.permute(0, 2, 1, 3).is_contiguous()
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_on_qkv_views(cuda, D):
    """q/k/v as the strided (B, L, 3, H, D) views of one fused projection,
    at a length that is no multiple of the tiles."""
    B, L, H = 2, 200, 3
    qkv = torch.randn((B, L, 3, H, D), device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


SD_ATTN_CASES = [
    # B, H, Lq, Lk, D: SD1's head dims (8 heads over 320, 640 and 1280
    # channels) on the padded instances — self attention, cross attention
    # over the 77 CLIP tokens (a ragged key tile), the 64-token mid block,
    # B > 1, a ragged query tile and Lk below one key tile
    (1, 8, 1024, 1024, 40),
    (2, 8, 300, 77, 40),
    (1, 8, 256, 256, 80),
    (2, 3, 200, 77, 80),
    (1, 8, 256, 256, 160),
    (1, 8, 64, 64, 160),
    (2, 8, 256, 77, 160),
    (1, 2, 130, 300, 160),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D", SD_ATTN_CASES, ids=str)
def test_flash_kernel_padded_head_dims(cuda, B, H, Lq, Lk, D):
    """Head dims 40, 80 and 160 run the 64-, 128- and 192-wide instances on
    columns TMA zero-fills; the output keeps the true D and the scale is
    D^-0.5 of the true D."""
    g = torch.Generator(device=cuda).manual_seed(Lq * 5 + Lk + D)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    before = _build.LAUNCHES["flash_attn"]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn"] == before + 1
    assert got.shape == (B, H, Lq, D) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


@pytest.mark.parametrize("D", [40, 80, 160])
def test_flash_kernel_padded_on_projection_views(cuda, D):
    """q/k/v as the strided (B, L, H·D) projection views SD1's attention
    hands the kernel (L strides of 640, 1280 and 2560 bytes), read in
    place, with a cross-attention key length of 77."""
    B, H, Lq, Lk = 2, 8, 192, 77
    g = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn((B, Lq, H * D), generator=g, device=cuda).bfloat16()
    ctx = torch.randn((B, Lk, 2, H * D), generator=g,
                      device=cuda).bfloat16()
    q = x.reshape(B, Lq, H, D).transpose(1, 2)
    k = ctx[:, :, 0].reshape(B, Lk, H, D).transpose(1, 2)
    v = ctx[:, :, 1].reshape(B, Lk, H, D).transpose(1, 2)
    assert not q.is_contiguous() and not v.is_contiguous()
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


LUMINA_AURA_ATTN_CASES = [
    # B, H, Lq, Lk, D: Lumina 2's head dim 96 on the 128-wide instance and
    # AuraFlow's 256 on the 256-wide one (64-key tiles) — ragged query and
    # key tiles, Lk below one key tile, cross attention with Lq != Lk over
    # several key tiles, B > 1, Lk = 1
    (1, 3, 300, 300, 96),
    (2, 2, 77, 77, 96),
    (1, 2, 130, 513, 96),
    (2, 3, 257, 45, 96),
    (1, 2, 300, 300, 256),
    (2, 1, 77, 77, 256),
    (1, 2, 130, 513, 256),
    (2, 2, 257, 45, 256),
    (1, 1, 64, 1, 256),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D", LUMINA_AURA_ATTN_CASES, ids=str)
def test_flash_kernel_d96_d256(cuda, B, H, Lq, Lk, D):
    """Head dims 96 (Lumina 2) and 256 (AuraFlow) against plain_attention,
    each counted under its own instance."""
    g = torch.Generator(device=cuda).manual_seed(Lq * 11 + Lk + D)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"flash_attn_d{D}"] == before[
        f"flash_attn_d{D}"] + 1
    assert _build.LAUNCHES["flash_attn"] == before["flash_attn"] + 1
    assert got.shape == (B, H, Lq, D) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


@pytest.mark.parametrize("D", [96, 256])
def test_flash_kernel_d96_d256_on_projection_views(cuda, D):
    """q/k/v as views of one fused (B, L, 3·H·D) projection split into
    thirds, the way Lumina 2 hands v to the kernel (q and k are rewritten
    by its qk-norm; here all three stay views), at a length that is no
    multiple of the tiles; read in place."""
    B, L, H = 2, 333, 3
    g = torch.Generator(device=cuda).manual_seed(D)
    qkv = torch.randn((B, L, 3 * H * D), generator=g, device=cuda).bfloat16()
    q, k, v = (a.reshape(B, L, H, D).transpose(1, 2)
               for a in torch.chunk(qkv, 3, dim=-1))
    assert not v.is_contiguous()
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


def test_flash_kernel_refuses_what_it_has_no_instance_for(cuda):
    """A head dim without an instance raises and names the ones there are;
    a view TMA cannot read (an 8-byte offset) raises rather than being
    copied; nothing falls back to another attention route."""
    before = _build.LAUNCHES["flash_attn"]
    for D in (32, 48):
        q = torch.zeros((1, 2, 16, D), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError,
                           match="40, 64, 80, 96, 128, 160, 256"):
            flash_attn_cuda(q, q, q, D ** -0.5)
    buf = torch.zeros((1, 2, 16, 40 + 4), device=cuda, dtype=torch.bfloat16)
    q = buf[..., 4:]
    with pytest.raises(ValueError, match="TMA"):
        flash_attn_cuda(q, q, q, 40 ** -0.5)
    assert _build.LAUNCHES["flash_attn"] == before


I8ATTN_CASES = [
    # B, H, Lq, Lk: a ragged last key tile, Lq != Lk, one tile, many tiles,
    # Lk below one tile and no multiple of 16
    (1, 2, 128, 128),
    (2, 3, 77, 77),
    (1, 2, 250, 131),
    (1, 1, 5, 300),
    (2, 4, 512, 512),
    (1, 2, 200, 45),
]


def _qkv(cuda, B, H, Lq, Lk, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    # a token mean for the prep to remove
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16() + 1
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    return q, k, v


def _check_i8attn(q, k, v, pv_int8):
    B, H, Lq, D = q.shape
    scale = D ** -0.5
    key = "i8attn_pv" if pv_int8 else "i8attn_qk"
    before = dict(_build.LAUNCHES)
    got = i8_attention_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before[key] + 1
    assert _build.LAUNCHES["i8attn_prep"] == before["i8attn_prep"] + 1
    assert got.shape == (B, H, Lq, D) and got.dtype == torch.bfloat16
    assert got.permute(0, 2, 1, 3).is_contiguous()
    # the integers agree (but for k codes one step apart where the mean's
    # summation order differs); exp and the f32 summation order differ,
    # which can move a quantized probability by one step of 1/127
    want = plain_i8_attention(q, k, v, scale=scale, pv_int8=pv_int8,
                              block_kv=kernel_block_kv(D))
    assert _rel_l2(got, want) < 2e-3
    # and the int8 path stays near exact attention
    assert _rel_l2(got, plain_attention(q, k, v, scale)) < 3.5e-2


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("B,H,Lq,Lk", I8ATTN_CASES, ids=str)
def test_i8attn_kernel_matches_plain(cuda, B, H, Lq, Lk, pv_int8):
    _check_i8attn(*_qkv(cuda, B, H, Lq, Lk, 128, Lq * 7 + Lk), pv_int8)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("B,H,Lq,Lk", I8ATTN_CASES, ids=str)
def test_i8attn_kernel_d256_matches_plain(cuda, B, H, Lq, Lk, pv_int8):
    _check_i8attn(*_qkv(cuda, B, H, Lq, Lk, 256, Lq * 5 + Lk), pv_int8)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("B,H,Lq,Lk", [(1, 2, 250, 131), (2, 2, 77, 300),
                                       (1, 1, 5, 45)], ids=str)
def test_i8attn_kernel_split_head_dims_match_plain(cuda, B, H, Lq, Lk, D,
                                                   pv_int8):
    """Head dims past 256 run the split instance (a block a 128-column
    part of the output, Q and K streamed in 128-byte chunks)."""
    _check_i8attn(*_qkv(cuda, B, H, Lq, Lk, D, Lq * 3 + Lk + D), pv_int8)


def test_i8attn_kernel_on_strided_views(cuda):
    for D in (128, 256, 384):
        B, L, H = 2, 192, 3
        qkv = torch.randn((B, L, 3, H, D), device=cuda).bfloat16()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        for pv in (True, False):
            _check_i8attn(q, k, v, pv)


PREP_CASES = [
    # B, H, Lq, Lk, D
    (1, 2, 96, 96, 128),
    (2, 3, 77, 200, 128),
    (1, 2, 130, 45, 256),
    (2, 2, 512, 512, 256),
    (1, 24, 1024, 1024, 128),
    (1, 2, 130, 45, 384),
    (2, 2, 200, 333, 512),
]


def _check_prep(q, k, v, pv_int8):
    D = q.shape[-1]
    scale = D ** -0.5
    before = _build.LAUNCHES["i8attn_prep"]
    got = prep_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    again = prep_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["i8attn_prep"] == before + 2
    want = kernel_operands(*quantize_attn_inputs(q, k, v, scale,
                                                 pv_int8=pv_int8),
                           pv_int8=pv_int8)
    # two launches, the same bits (no atomics)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    qq, qs, kq, ks, vk, vs = got
    # q's and v's codes and scales: the plain prep's, bit for bit
    assert torch.equal(qq, want[0]) and torch.equal(qs, want[1])
    assert torch.equal(vs, want[5])
    if pv_int8:
        assert torch.equal(vk, want[4])
    else:
        assert torch.equal(vk.reshape(want[4].shape), want[4])
    # k after its mean: torch sums the mean in another order, which can move
    # it by an ulp, a scale by a few ulps and a code by one step
    d = kq.int() - want[2].int()
    assert int(d.abs().max()) <= 1
    assert int(d.count_nonzero()) <= max(2, d.numel() // 1000)
    assert torch.allclose(ks, want[3], rtol=1e-6, atol=0)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("B,H,Lq,Lk,D", PREP_CASES, ids=str)
def test_i8attn_prep_matches_plain_prep(cuda, B, H, Lq, Lk, D, pv_int8):
    _check_prep(*_qkv(cuda, B, H, Lq, Lk, D, Lq + 3 * Lk + D), pv_int8)


@pytest.mark.parametrize("D", [128, 256, 384])
def test_i8attn_prep_on_qkv_views(cuda, D):
    """q/k/v as the strided (B, L, 3, H, D) views of one fused projection:
    read in place, without a gather."""
    B, L, H = 2, 333, 3
    qkv = torch.randn((B, L, 3, H, D), device=cuda).bfloat16() + 0.5
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for pv in (True, False):
        _check_prep(q, k, v, pv)


@pytest.mark.parametrize("bn", gemm_probe.TILES)
def test_gemm_probe_kernels_match_plain(cuda, bn):
    M, K, R = 256, 320, 512  # K: two full 128-byte s8 steps and a ragged one
    g = torch.Generator(device=cuda).manual_seed(bn)
    xb = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    wb = torch.randn((K, R), generator=g, device=cuda).bfloat16()
    got = gemm_probe.probe_bf16(xb, wb, bn=bn)
    assert _rel_l2(got, gemm_probe.plain_probe_bf16(xb, wb)) < 5e-3
    x8 = torch.randint(-127, 128, (M, K), generator=g, device=cuda,
                       dtype=torch.int8)
    # the s8 probes read w (R, K), K contiguous
    w8 = torch.randint(-127, 128, (R, K), generator=g, device=cuda,
                       dtype=torch.int8)
    # exact integer sums: the casts are the same, so the results are equal
    got = gemm_probe.probe_s8(x8, w8, bn=bn)
    assert torch.equal(got, gemm_probe.plain_probe_s8(x8, w8))
    xs = torch.rand((M, 128), generator=g, device=cuda) + 0.5
    ws = torch.rand((1, R), generator=g, device=cuda) + 0.5
    got = gemm_probe.probe_w8a8(x8, w8, xs, ws, bn=bn)
    assert torch.equal(got, gemm_probe.plain_probe_w8a8(x8, w8, xs, ws))
    got1 = gemm_probe.probe_w8a8(x8, w8, xs[:, :1].contiguous(), ws, bn=bn)
    assert torch.equal(got1, got)


# -- the LoRA instances: the rank term h @ upᵀ in the epilogues ------------

def _lora_ops(cuda, M, R, rank, seed, strength=1.0):
    """Rank operands as ``lora.rank_factorize`` gives them: h (M, Σr) and
    the scale-folded upᵀ (Σr, R), bf16 on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((M, rank), generator=g, device=cuda).to(torch.bfloat16)
    # the weights of _planar are N(0, 1): the term moves a K-long sum
    upt = (torch.randn((rank, R), generator=g, device=cuda)
           * strength).to(torch.bfloat16)
    return h, upt


def _qmm_lora_case(cuda, pq, M, rank, bias, act, seed):
    R, K = pq.shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((R,), generator=g, device=cuda) if bias else None
    h, upt = _lora_ops(cuda, M, R, rank, seed)
    key = _qmm_key(pq, M) + "_lora"
    before = dict(_build.LAUNCHES)
    got = qmm_cuda(x, pq, bias=b, act_from_col=act, lora_h=h, lora_up=upt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before[key] + 1
    assert _build.LAUNCHES[key[:-5]] == before[key[:-5]]
    want = plain_quantized_matmul(x, pq, bias=b, act_from_col=act,
                                  lora_h=h, lora_up=upt)
    assert got.shape == (M, R) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) < 5e-3
    # the term is really there: without it the result is far off
    assert _rel_l2(qmm_cuda(x, pq, bias=b, act_from_col=act), want) > 1e-2
    return x, b, h, upt, got


# ranks 1, 16 and 16 + 64 (two stacked LoRAs: two rank chunks of the ring)
LORA_RANKS = [1, 16, 80]


@pytest.mark.parametrize("rank", LORA_RANKS)
@pytest.mark.parametrize("M", [1, 5, 9, 200, 300])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_qmm_lora_matches_plain(cuda, qtype, M, rank):
    """Both bodies (split-K for M <= 8, wgmma above, 128- and 256-token
    tiles) with the rank term, ragged R and padded K, bias and a GELU
    tail."""
    R, K = 328, 768
    pq = _planar(qtype, R, K, seed=rank + M, device=cuda)
    _qmm_lora_case(cuda, pq, M, rank, True, 136, seed=M)


@pytest.mark.parametrize("M", [3, 130])
@pytest.mark.parametrize("qtype", NIB4_TYPES + INT8_TYPES,
                         ids=lambda q: q.name)
def test_qmm_lora_every_format(cuda, qtype, M):
    R, K = 256, 1024
    pq = _planar(qtype, R, K, seed=int(qtype) + 7, device=cuda)
    for bias, act in ((False, None), (True, 0)):
        _qmm_lora_case(cuda, pq, M, 16, bias, act, seed=M + int(qtype))


@pytest.mark.parametrize("M", [2, 130])
def test_qmm_lora_rank_positions(cuda, M):
    """x = 0 and a one-hot h row picks one rank column: each output is
    that column of up, bit for bit (a wrong fragment order, row pairing or
    rank chunk cannot hide in a sum)."""
    R, K, rank = 256, 512, 80
    pq = _planar(Q.Q4_K, R, K, seed=5, device=cuda)
    _, upt = _lora_ops(cuda, M, R, rank, seed=3)
    x = torch.zeros((M, K), device=cuda, dtype=torch.bfloat16)
    for j in (0, 1, 17, 63, 64, 79):
        h = torch.zeros((M, rank), device=cuda, dtype=torch.bfloat16)
        h[:, j] = 1.0
        got = qmm_cuda(x, pq, lora_h=h, lora_up=upt)
        assert torch.equal(got, upt[j][None].expand(M, R))


@pytest.mark.parametrize("M", [4, 200])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K], ids=lambda q: q.name)
def test_qmm_lora_strength_zero_is_unpatched(cuda, qtype, M):
    """up scaled by 0: the LoRA instance computes the same base product and
    adds exact zeros, so it equals the unpatched launch value for value."""
    R, K = 384, 1024
    pq = _planar(qtype, R, K, seed=11, device=cuda)
    x = torch.randn((M, K), device=cuda).to(torch.bfloat16)
    b = torch.randn((R,), device=cuda)
    h, upt = _lora_ops(cuda, M, R, 16, seed=1, strength=0.0)
    got = qmm_cuda(x, pq, bias=b, act_from_col=128, lora_h=h, lora_up=upt)
    assert torch.equal(got, qmm_cuda(x, pq, bias=b, act_from_col=128))


def test_qmm_lora_smallm_is_deterministic(cuda):
    pq = _planar(Q.Q4_K, 1024, 3072, seed=3, device=cuda)
    x = torch.randn((4, 3072), device=cuda).to(torch.bfloat16)
    h, upt = _lora_ops(cuda, 4, 1024, 80, seed=2)
    assert smallm_plan(4, pq.padded_in, 1024, True)[0] > 1  # a real K split
    a = qmm_cuda(x, pq, lora_h=h, lora_up=upt)
    b = qmm_cuda(x, pq, lora_h=h, lora_up=upt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_qmm_lora_on_stacked_view(cuda):
    """A block of a stacked patched weight: base and factors are views."""
    a = _planar(Q.Q4_K, 256, 1024, seed=1, device=cuda)
    st = planar.PlanarQuant(
        qs=torch.stack([a.qs, a.qs]), scales=torch.stack([a.scales,
                                                          a.scales]),
        offsets=torch.stack([a.offsets, a.offsets]), qtype=a.qtype,
        layout=a.layout, group_size=a.group_size, zero_point=a.zero_point,
        shape=a.shape)
    x = torch.randn((64, 1024), device=cuda).to(torch.bfloat16)
    h, upt = _lora_ops(cuda, 64, 256, 16, seed=4)
    ups = torch.stack([upt * 0, upt])
    got = qmm_cuda(x, st[1], lora_h=h, lora_up=ups[1])
    want = plain_quantized_matmul(x, a, lora_h=h, lora_up=upt)
    assert _rel_l2(got, want) < 5e-3


def _i8_lora_case(cuda, ip, M, rank, bias, act, bn=None, seed=0,
                  strength=1.0):
    R, K = ip.shape
    g = torch.Generator(device=cuda).manual_seed(M * 31 + seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((R,), generator=g, device=cuda) if bias else None
    h, upt = _lora_ops(cuda, M, R, rank, seed, strength)
    xq, xs = quantize_rows(x)
    before = dict(_build.LAUNCHES)
    got = i8mm_cuda_q(xq, xs, ip, bias=b, act_from_col=act, bn=bn,
                      lora_h=h, lora_up=upt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["i8mm_lora"] == before["i8mm_lora"] + 1
    assert _build.LAUNCHES["i8mm"] == before["i8mm"]
    want = plain_i8mm(x, ip, bias=b, act_from_col=act, lora_h=h,
                      lora_up=upt)
    assert got.shape == (M, R) and got.dtype == torch.bfloat16
    _check_lora_ulps(got, want)
    return xq, xs, b, h, upt, got


def _check_lora_ulps(got, want):
    """Exact integers and the same f32 rescale as the plain version, but
    the tensor cores add the rank term onto the accumulator in their own
    order and precision: a bf16 result moves by one ulp now and then, and
    by more where it is tiny beside its addends (or under GELU, where 1 +
    tanh cancels for a large negative input). Held to the fused matmuls'
    rel-L2 limit, with at most one value in a thousand beyond one ulp."""
    over = ((got.float() - want.float()).abs()
            > torch.maximum(_bf16_ulp(got), _bf16_ulp(want)))
    assert float(over.float().mean()) <= 1e-3
    assert _rel_l2(got, want) < 5e-3


@pytest.mark.parametrize("rank", LORA_RANKS)
@pytest.mark.parametrize("bn", I8MM_WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 129, 300])
def test_i8mm_lora_matches_plain(cuda, M, bn, rank):
    """K4's LoRA instance at both tile widths, ranks 1 / 16 / 16 + 64,
    ragged M, R no multiple of 8 (rows padded to 336), K < Kp, bias and a
    GELU tail (the rank term lands before them)."""
    R, K = 333, 2432
    ip = requantize_i8(_planar(Q.Q8_0, R, K, seed=M + bn, device=cuda))
    for bias, act in ((True, None), (False, 0), (True, 136)):
        _i8_lora_case(cuda, ip, M, rank, bias, act, bn, seed=rank)


@pytest.mark.parametrize("bn", I8MM_WIDTHS)
def test_i8mm_lora_rank_positions(cuda, bn):
    """x = 0 (xq = 0) and a one-hot h row: each output is a column of up,
    bit for bit, at every rank chunk and tile column."""
    R, K, M, rank = 384, 512, 130, 80
    ip = requantize_i8(_planar(Q.Q6_K, R, K, seed=9, device=cuda))
    _, upt = _lora_ops(cuda, M, R, rank, seed=3)
    xq = torch.zeros((M, K), device=cuda, dtype=torch.int8)
    xs = torch.ones((M, 1), device=cuda)
    for j in (0, 5, 16, 63, 64, 79):
        h = torch.zeros((M, rank), device=cuda, dtype=torch.bfloat16)
        h[:, j] = 1.0
        got = i8mm_cuda_q(xq, xs, ip, bn=bn, lora_h=h, lora_up=upt)
        assert torch.equal(got, upt[j][None].expand(M, R))


@pytest.mark.parametrize("bn", I8MM_WIDTHS)
def test_i8mm_lora_strength_zero_is_unpatched(cuda, bn):
    R, K, M = 512, 1024, 300
    ip = requantize_i8(_planar(Q.Q4_K, R, K, seed=3, device=cuda))
    xq, xs, b, h, upt, got = _i8_lora_case(cuda, ip, M, 16, True, 256, bn,
                                           strength=0.0)
    assert torch.equal(got, i8mm_cuda_q(xq, xs, ip, bias=b, act_from_col=256,
                                        bn=bn))


def test_i8mm_lora_on_stacked_view(cuda):
    a, b = (requantize_i8(_planar(Q.Q4_K, 384, 1024, seed=s, device=cuda))
            for s in (1, 2))
    st = I8Planar(qs=torch.stack([a.qs, b.qs]),
                  scales=torch.stack([a.scales, b.scales]), qtype=a.qtype,
                  shape=a.shape)
    x = torch.randn((200, 1024), device=cuda).to(torch.bfloat16)
    h, upt = _lora_ops(cuda, 200, 384, 16, seed=6)
    got = i8mm_cuda(x, st[1], act_from_col=64, lora_h=h, lora_up=upt)
    want = plain_i8mm(x, b, act_from_col=64, lora_h=h, lora_up=upt)
    _check_lora_ulps(got, want)


# -- the wrappers' host side, on the CPU ---------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the dispatch takes
    its CUDA branch (where the kernel wrapper is replaced by a recorder)."""

    @property
    def is_cuda(self):
        return True


def test_cuda_dispatch_passes_lora_operands(monkeypatch):
    """On a CUDA tensor the dispatchers hand the rank operands to the
    kernel wrappers (they used to raise NotImplementedError)."""
    from comfyui_gguf_tpu_torch.ops import i8mm as i8mm_mod
    from comfyui_gguf_tpu_torch.ops import qmatmul as qmm_mod

    seen = []
    monkeypatch.setattr(qmm_mod, "qmm_cuda",
                        lambda x, pq, **kw: seen.append(("qmm", kw)))
    monkeypatch.setattr(i8mm_mod, "i8mm_cuda",
                        lambda x, ip, **kw: seen.append(("i8mm", kw)))
    pq = _planar(Q.Q4_K, 128, 512, seed=1, device="cpu")
    x = torch.zeros((2, 512), dtype=torch.bfloat16).as_subclass(_OnCard)
    h = torch.zeros((2, 16), dtype=torch.bfloat16)
    upt = torch.zeros((16, 128), dtype=torch.bfloat16)
    qmm_mod.quantized_matmul(x, pq, lora_h=h, lora_up=upt)
    i8mm_mod.i8_matmul(x, requantize_i8(pq), lora_h=h, lora_up=upt)
    assert [k for k, _ in seen] == ["qmm", "i8mm"]
    assert all(kw["lora_h"] is h and kw["lora_up"] is upt for _, kw in seen)


def test_prep_lora_layout_and_limits():
    """The kernels' operand layout: h (M, rk), up (Rp, rk) bf16, the rank
    zero-padded to a multiple of 16 and up not transposed; any rank is
    taken; another dtype or a shape that does not fit raises, naming the
    limit."""
    from comfyui_gguf_tpu_torch.ops.qmatmul import LORA_RANK_STEP, prep_lora

    M, R, Rp = 5, 200, 256
    for rank in (1, 16, 80, 600):
        h = torch.randn((M, rank)).to(torch.bfloat16)
        upt = torch.randn((rank, R)).to(torch.bfloat16)
        hp, up, rk = prep_lora(h, upt, M, R, Rp)
        assert rk % LORA_RANK_STEP == 0 and rank <= rk < rank + 16
        assert hp.shape == (M, rk) and up.shape == (Rp, rk)
        assert hp.is_contiguous() and up.is_contiguous()
        assert torch.equal(hp[:, :rank], h) and not hp[:, rank:].any()
        assert torch.equal(up[:R, :rank], upt.t())
        assert not up[R:].any() and not up[:, rank:].any()
    h = torch.randn((M, 16))
    upt = torch.randn((16, R))
    with pytest.raises(TypeError, match="bfloat16"):
        prep_lora(h, upt, M, R, Rp)
    with pytest.raises(ValueError):
        prep_lora(h.bfloat16(), upt.bfloat16()[:, :100], M, R, Rp)
    with pytest.raises(ValueError):
        prep_lora(h.bfloat16(), upt.bfloat16(), M + 1, R, Rp)
    with pytest.raises(ValueError, match="pairs"):
        prep_lora(h.bfloat16(), None, M, R, Rp)


def test_ptxas_entries_names_each_instance():
    """The one parser of nvcc's ptxas report (phase 2 of chip_smoke.py and
    tools_kernel_ab_cuda.py read it): each compiled entry by its kernel
    name and template arguments, with its register and spill lines."""
    import importlib.util
    from pathlib import Path

    lines = [
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN9gguf_cuda12_GLOBAL__N_116qmm_wgmma_kernelILb1ELb0ELi2ELb1EEEvK"
        "14CUtensorMap_stS3_PKhPKfS7_P13__nv_bfloat16iiiiiii' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z16qmm_wgmma_kernelILi1E",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_Z17gemm_wgmma_kernelILi0ELi256ELb0EEvPKaS1_PKfS3_S3_' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z17gemm_wgmma_kernelI",
        "    96 bytes stack frame, 92 bytes spill stores, 92 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, used 16 barriers, 96 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function 'prep_fold' for 'sm_90a'",
        "ptxas info    : Used 32 registers"]
    got = _build.ptxas_entries(lines)
    assert [n for n, _, _ in got] == ["qmm_wgmma_kernel<1,0,2,1>",
                                      "gemm_wgmma_kernel<0,256,0>",
                                      "prep_fold"]
    assert got[0][1] == "Used 168 registers, used 1 barriers"
    assert got[1][2].startswith("96 bytes stack frame, 92 bytes spill")
    assert got[2][2] == ""
    spec = importlib.util.spec_from_file_location(
        "tools_kernel_ab_cuda",
        Path(__file__).resolve().parents[1] / "tools_kernel_ab_cuda.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.same_instance("gemm_wgmma_kernel<0,256>",
                            "gemm_wgmma_kernel<0,256,0>")
    assert ab.same_instance("prep_fold", "prep_fold")
    assert not ab.same_instance("gemm_wgmma_kernel<0,256>",
                                "gemm_wgmma_kernel<0,256,1>")


# ---------------------------------------------------------------------------
# the serving path's shapes: four requests stacked per tick
# ---------------------------------------------------------------------------

SERVING_I8 = [
    # M = 4 requests x a flux block's tokens at 1024², R, K, act_from_col
    (4 * 4608, 21504, 3072, 9216),  # single-block linear1, GELU tail
    (4 * 4096, 9216, 3072, None),  # double-block img qkv
    (4 * 512, 9216, 3072, None),  # double-block txt qkv
]


@pytest.mark.parametrize("M,R,K,act", SERVING_I8, ids=str)
def test_i8mm_at_serving_batch_shapes(cuda, M, R, K, act):
    from comfyui_gguf_tpu_torch.models.testing import random_planar

    gen = torch.Generator(device=cuda).manual_seed(M)
    ip = requantize_i8(random_planar(Q.Q4_K, (R, K), gen, device=cuda))
    _check_i8(cuda, ip, M, True, act)


def test_flash_kernel_batch4_flux_length(cuda):
    """B = 4 at the flux joint length: each batch element equals its own
    B = 1 launch bit for bit, and the first and last are within the
    kernel's limit of the plain version."""
    B, H, L, D = 4, 24, 4608, 128
    g = torch.Generator(device=cuda).manual_seed(4608)
    q, k, v = (torch.randn((B, H, L, D), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (B, H, L, D) and bool(torch.isfinite(got).all())
    for b in range(B):
        one = flash_attn_cuda(q[b:b + 1], k[b:b + 1], v[b:b + 1], D ** -0.5)
        assert torch.equal(got[b:b + 1], one)
    for b in (0, B - 1):
        want = plain_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                               D ** -0.5)
        assert _rel_l2(got[b:b + 1], want) < 1e-2


def test_qmm_smallm_at_serving_batch(cuda):
    """The modulation projections at M = 4 (3072 → 18432, Q4_K): the
    split-K body, against the plain version and deterministic."""
    from comfyui_gguf_tpu_torch.models.testing import random_planar

    gen = torch.Generator(device=cuda).manual_seed(18432)
    pq = random_planar(Q.Q4_K, (18432, 3072), gen, device=cuda)
    assert qmm_route(4, pq.padded_in, 18432, True) == "smallm"
    x, b, got = _check_qmm(cuda, pq, 4, 3072, 18432, True, None, seed=4)
    again = qmm_cuda(x, pq, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_flux_engine_ticks_on_the_card(cuda):
    """A w8a8 tiny flux (head dim 128) served by ``flux_engine`` on the
    card and on the CPU: three requests of mixed schedules in a bucket of
    4 (one padding lane), the same results within 3e-2, and per tick the
    kernel launches of one forward (K4 on every token-facing block linear,
    K7 once a block, the split-K body on every modulation)."""
    from comfyui_gguf_tpu_torch.lifecycle import to_device
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel, flux_engine
    from comfyui_gguf_tpu_torch.sampling import flux_schedule

    dims = testing.TinyFluxDims(hidden=512, heads=4, depth_double=2,
                                depth_single=2, axes_dim=(16, 56, 56))
    params = testing.flux_random_stacked_params(dims, seed=0, device=cuda)
    out = {}
    for dev in ("cuda", "cpu"):
        model = DiffusionModel(
            arch="flux", params=to_device(params, dev),
            config=dims.config(), qcfg=QuantConfig(),
            device=torch.device(dev)).requantize_i8()
        eng = flux_engine(model, 16, 16, 8, max_batch=4)
        rng = np.random.default_rng(7)
        reqs = []
        for i in range(3):
            cond = {"txt": rng.standard_normal((8, dims.ctx)).astype(
                        np.float32),
                    "y": rng.standard_normal(dims.vec).astype(np.float32),
                    "guidance": np.float32(3.5)}
            x0 = rng.standard_normal((64, dims.in_ch)).astype(np.float32)
            reqs.append(eng.submit(x0, cond, flux_schedule(2 + i, 64)))
        _build.reset_launch_counts()
        eng.run_until_drained()
        out[dev] = ([r.result for r in reqs], dict(_build.LAUNCHES),
                    eng.stats)
    (got, counts, st), (want, _, _) = out["cuda"], out["cpu"]
    ticks = st.batches_executed
    assert ticks == 4 and st.total_padding_lanes > 0
    nd, ns = dims.depth_double, dims.depth_single
    assert counts["i8mm"] == (8 * nd + 2 * ns) * ticks
    assert counts["flash_attn"] == (nd + ns) * ticks
    assert counts["qmm_nib4_smallm"] == (2 * nd + ns) * ticks
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, dims.in_ch)
        assert _rel_l2(torch.from_numpy(g), torch.from_numpy(w)) < 3e-2


def test_unet_forward_is_batch_invariant(cuda):
    """A UNet forward at B = 3 gives each sample the bits it gets at B = 1:
    the convolutions and group norms run each sample alone, the linears and
    attention are row-independent (what lets ``unet_engine`` hold a served
    request to the direct step through CFG)."""
    from comfyui_gguf_tpu_torch.models import testing, unet

    d = testing.SDXLDims(model_channels=64, channel_mult=(1, 2),
                         num_res_blocks=1, depths=(1, 1), ctx=128, adm=256)
    params = testing.sdxl_random_params(d, seed=2, device=cuda)
    for k in list(params):
        if k.endswith("attn1.to_q.weight"):
            params[k] = requantize_i8(params[k])  # K4 on some linears
    cfg = unet.UNetConfig.from_state_dict(params)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((3, 32, 32, 4), generator=g, device=cuda).bfloat16()
    ctx = torch.randn((3, 77, 128), generator=g, device=cuda).bfloat16()
    y = torch.randn((3, 256), generator=g, device=cuda).bfloat16()
    t = torch.tensor([900.0, 500.0, 20.0], device=cuda)
    with torch.no_grad():
        both = unet.forward(params, cfg, x, t, ctx, y)
        for i in range(3):
            one = unet.forward(params, cfg, x[i:i + 1], t[i:i + 1],
                               ctx[i:i + 1], y[i:i + 1])
            assert torch.equal(both[i:i + 1], one)
