"""The PyTorch port's CUDA kernels against their plain PyTorch versions.

Each kernel (K1 nib4 and K2 int8 fused dequant-matmul, K4 w8a8 matmul, K6
int8 flash attention and its prep, K7 flash attention, K8 GEMM probes)
runs on the card beside its plain version on the same inputs, at small
shapes that cover the ragged edges: M=1, M not a multiple of the tile, K
padded, R not a multiple of 128, the GELU tail, odd key lengths, Lq != Lk
and strided views; K7 also at SD1's head dims 40, 80 and 160, Lumina 2's
96 and AuraFlow's 256; K6 at head dims 128 and 256 and in its split
instance (384, 512). Qwen-Image's and HiDream-I1's shapes at 1024² (K4,
K1/K2, K7) run too, and K4 and K1 on one expert of a (depth, E, …) stacked
leaf. K1/K2 run through
both of their bodies (split-K for M <= 8, wgmma above) over every format
of each layout; K4 through both of its tile widths. One-hot rows check
every tile position of K1/K2/K4 bit for bit. The LoRA instances of K1/K2
(both bodies) and K4 (both widths) run at ranks 1, 16 and 16 + 64 against
the plain versions with the same rank operands, with one-hot rank rows, at
strength 0 (equal to the unpatched launch) and on stacked views. The
wgmma body also runs with its K split over a cluster (1, 2 and 8 blocks) at
both token-tile widths, and both bodies with bfloat16 scale planes, each
launched twice for equal bits. The f16 and f32 instances of K1/K2 (the
wgmma body at f16, the f32 FMA body, the split-K body at both, and their
LoRA instances) run against the plain version in the same dtype (f16
2e-3, f32 1e-5), every format, one-hot rows bit for bit, the f32 FMA body
also at M and R off its tiles and at flux's deepest K, the f32 split-K
body at every M from 1 to 8 (its 1, 2, 4 and 8-token instances) over
both layouts with and without offsets, both scale-plane types, every K
split and its LoRA instance, each launched twice for equal bits; K7's f32
(3xTF32) instances at D = 384 and 512 with ragged query and key tiles,
their shared memory within a block's; K7's wide-head body (D = 384, the
Wan VAE's mid-block, and 512, the HunyuanVideo VAE's) in bf16 and f16 at
ragged lengths, Lq != Lk, B > 1 and on strided views of one projection,
two launches equal, its shared memory within a block's. Tiny
HunyuanVideo and LTX-Video forwards (planar and w8a8, flat and stacked)
and their VAEs' decodes run on the card against the CPU, and the tile
autotuner leaves a legal entry that the dispatch then takes. The
tensor-parallel shards of flux-dev (``shard_planar``, each re-padded on its
own: linear1 and qkv column shards, linear2 and proj row shards at tp = 2
and 4, a modulation gather shard at M = 1) run K1 / K4 against their plain
versions, and K7 runs a rank's 12 local heads on views of its qkv. The serving path's batch shapes (four requests stacked: K4 at M = 4·4608,
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
                                                smallm_f32_plan, smallm_plan,
                                                wgmma_split_plan)
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


def _planar(qtype, R, K, seed, device, scale_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((R, K), dtype=np.float32)
    return planar.planarize(codecs.quantize(w, qtype), qtype, (R, K),
                            device=device, scale_dtype=scale_dtype)


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
    copied; a dtype without instances (float64) raises and names the
    dtypes there are; nothing falls back to another attention route."""
    before = dict(_build.LAUNCHES)
    for D in (32, 48):
        q = torch.zeros((1, 2, 16, D), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError,
                           match="40, 64, 80, 96, 128, 160, 256"):
            flash_attn_cuda(q, q, q, D ** -0.5)
    buf = torch.zeros((1, 2, 16, 40 + 4), device=cuda, dtype=torch.bfloat16)
    q = buf[..., 4:]
    with pytest.raises(ValueError, match="TMA"):
        flash_attn_cuda(q, q, q, 40 ** -0.5)
    q = torch.zeros((1, 2, 16, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(NotImplementedError,
                       match="bfloat16, float16, float32"):
        flash_attn_cuda(q, q, q, 128 ** -0.5)
    with pytest.raises(NotImplementedError,
                       match="bfloat16, float16, float32"):
        i8_attention_cuda(q, q, q, scale=128 ** -0.5)
    assert _build.LAUNCHES == before


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
    taken; operands of another dtype are rounded to the kernel's operand
    type (bf16 by default, as the reference's ``_prep_lora`` rounds them to
    the dequant dtype); a dtype the kernels have no instance for or a
    shape that does not fit raises, naming the limit."""
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
    hp, up, _ = prep_lora(h, upt, M, R, Rp)
    assert hp.dtype == up.dtype == torch.bfloat16
    assert torch.equal(hp, h.bfloat16())
    assert torch.equal(up[:R], upt.bfloat16().t())
    with pytest.raises(TypeError, match="float64"):
        prep_lora(h, upt, M, R, Rp, torch.float64)
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


# Qwen-Image and HiDream-I1 at 1024²: K4 on Qwen-Image's image-stream MLP
# (GELU in the epilogue) and projections and on HiDream's expert SwiGLU
# over the joint length; K1's split-K body on HiDream's double-block adaLN;
# K2 on the Qwen2.5-VL-7B-shaped encoder's linears (q/k/v biases); K7 at
# both joint lengths
QH_I8_CASES = [
    # M, R, K, act_from_col
    (4096, 12288, 3072, 0),
    (4096, 3072, 12288, None),
    (4096, 3072, 3072, None),
    (4352, 6912, 2560, None),
    (4352, 2560, 6912, None),
]
QH_QMM_CASES = [
    # qtype, M, R, K, bias
    (Q.Q4_K, 1, 30720, 2560, True),
    (Q.Q8_0, 256, 3584, 3584, True),
    (Q.Q8_0, 256, 18944, 3584, False),
]
QH_ATTN_CASES = [(1, 24, 4352, 4352, 128), (1, 20, 4352, 4352, 128)]


@pytest.mark.parametrize("M,R,K,act", QH_I8_CASES, ids=str)
def test_i8mm_qwen_image_hidream_shapes(cuda, M, R, K, act):
    ip = requantize_i8(_planar(Q.Q4_K, R, K, seed=K, device=cuda))
    _check_i8(cuda, ip, M, True, act, seed=R)


@pytest.mark.parametrize("qtype,M,R,K,bias", QH_QMM_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_qmm_qwen_image_hidream_shapes(cuda, qtype, M, R, K, bias):
    pq = _planar(qtype, R, K, seed=R, device=cuda)
    _check_qmm(cuda, pq, M, K, R, bias, None, seed=K)


@pytest.mark.parametrize("B,H,Lq,Lk,D", QH_ATTN_CASES, ids=str)
def test_flash_qwen_image_hidream_shapes(cuda, B, H, Lq, Lk, D):
    test_flash_kernel_matches_plain(cuda, B, H, Lq, Lk, D)


def test_kernels_on_expert_views(cuda):
    """K4 and K1 on one expert of a (depth, E, …) stacked leaf, HiDream's
    ``experts_stacked`` layout: the view ``leaf[d][e]`` is read in place and
    gives the expert's own launch."""
    from comfyui_gguf_tpu_torch.models.flux import _stack_leaves

    pqs = [[_planar(Q.Q4_K, 384, 1024, seed=10 * d + e, device=cuda)
            for e in range(3)] for d in range(2)]
    st = _stack_leaves([_stack_leaves(row) for row in pqs])
    ip = requantize_i8(st)
    assert tuple(ip.qs.shape[:2]) == (2, 3)
    x = torch.randn((200, 1024), device=cuda).to(torch.bfloat16)
    for leaf, one, fn in ((st, pqs[1][2], qmm_cuda),
                          (ip, requantize_i8(pqs[1][2]), i8mm_cuda)):
        view = leaf[1][2]
        assert (view.qs.untyped_storage().data_ptr()
                == leaf.qs.untyped_storage().data_ptr())
        assert torch.equal(fn(x, view), fn(x, one))


# -- the wgmma body's K split over a cluster, and bf16 scale planes --------

SPLIT_TYPES = [Q.Q4_K, Q.Q2_K, Q.Q4_0, Q.Q8_0, Q.Q6_K, Q.Q5_K]
SCALE_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("sdt", SCALE_DTYPES, ids=str)
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("qtype", SPLIT_TYPES, ids=lambda q: q.name)
def test_qmm_wgmma_split_and_scale_planes(cuda, qtype, nt, split, sdt):
    """Every (token sub-tiles, K split) of the wgmma body, both scale-plane
    types, over both layouts (group sizes 16 and 32, offsets or a zero
    point): ragged M, R and K (300 x 1792 -> 328; Kp = 2048), bias and a
    GELU tail, against the plain version (which widens bf16 planes the
    same way); two launches give the same bits."""
    M, R, K = 300, 328, 1792
    pq = _planar(qtype, R, K, seed=int(qtype) + 31, device=cuda,
                 scale_dtype=sdt)
    assert pq.scales.dtype == sdt
    g = torch.Generator(device=cuda).manual_seed(split + 10 * nt)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((R,), generator=g, device=cuda)
    key = "qmm_nib4" if pq.layout == "nib4" else "qmm_int8"
    before = _build.LAUNCHES[key]
    got = qmm_cuda(x, pq, bias=b, act_from_col=136, tiles=(nt, split))
    again = qmm_cuda(x, pq, bias=b, act_from_col=136, tiles=(nt, split))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    want = plain_quantized_matmul(x, pq, bias=b, act_from_col=136)
    assert got.shape == (M, R) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) < 5e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize("sdt", SCALE_DTYPES, ids=str)
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K], ids=lambda q: q.name)
def test_qmm_wgmma_split_every_tile_position(cuda, qtype, sdt):
    """One-hot x rows through an 8-block K split: each output is one
    dequantized bf16 weight, bit for bit (the ranks that do not hold that k
    add exact zeros), at every k of every rank's slice."""
    R, K = 256, 2048
    pq = _planar(qtype, R, K, seed=7, device=cuda, scale_dtype=sdt)
    w = planar.dequantize_kmajor(pq, torch.bfloat16)  # (K, R)
    for k0 in range(0, K, 256):
        ks = torch.arange(k0, k0 + 256, device=cuda)
        x = torch.zeros((256, K), device=cuda, dtype=torch.bfloat16)
        x[torch.arange(256, device=cuda), ks] = 1.0
        got = qmm_cuda(x, pq, tiles=(2, 8))
        assert torch.equal(got, w[ks])


@pytest.mark.parametrize("sdt", SCALE_DTYPES, ids=str)
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("rank", [16, 80])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_qmm_lora_wgmma_split_and_scale_planes(cuda, qtype, rank, split,
                                               sdt):
    """The LoRA instances with a K split (rank 0 adds the rank term once)
    and both scale-plane types; strength 0 equals the unpatched launch and
    two launches give the same bits."""
    M, R, K = 300, 328, 1792
    pq = _planar(qtype, R, K, seed=rank + split, device=cuda,
                 scale_dtype=sdt)
    g = torch.Generator(device=cuda).manual_seed(rank)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((R,), generator=g, device=cuda)
    h, upt = _lora_ops(cuda, M, R, rank, seed=split)
    kw = dict(bias=b, act_from_col=136, tiles=(2, split))
    key = ("qmm_nib4" if pq.layout == "nib4" else "qmm_int8") + "_lora"
    before = _build.LAUNCHES[key]
    got = qmm_cuda(x, pq, lora_h=h, lora_up=upt, **kw)
    again = qmm_cuda(x, pq, lora_h=h, lora_up=upt, **kw)
    zero = qmm_cuda(x, pq, lora_h=h, lora_up=upt * 0, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 3
    want = plain_quantized_matmul(x, pq, bias=b, act_from_col=136,
                                  lora_h=h, lora_up=upt)
    assert _rel_l2(got, want) < 5e-3
    assert _rel_l2(qmm_cuda(x, pq, **kw), want) > 1e-2
    assert torch.equal(got, again)
    assert torch.equal(zero, qmm_cuda(x, pq, **kw))


@pytest.mark.parametrize("M", [1, 3, SMALL_M_MAX, 9, 130])
@pytest.mark.parametrize("qtype", NIB4_TYPES + INT8_TYPES,
                         ids=lambda q: q.name)
def test_qmm_bf16_scale_planes_every_format(cuda, qtype, M):
    """bf16 scale planes through both bodies (split-K at M <= 8, wgmma
    above, the planned split), every format of each layout, with and
    without the LoRA term; two launches give the same bits."""
    R, K = 328, 768
    pq = _planar(qtype, R, K, seed=int(qtype) + 5, device=cuda,
                 scale_dtype=torch.bfloat16)
    for bias, act in ((True, None), (False, 0), (True, 136)):
        x, b, got = _check_qmm(cuda, pq, M, K, R, bias, act, seed=M)
        assert torch.equal(got, qmm_cuda(x, pq, bias=b, act_from_col=act))
    _qmm_lora_case(cuda, pq, M, 16, True, 136, seed=M)


@pytest.mark.parametrize("M", [1, 130])
def test_qmm_bf16_scale_planes_every_tile_position(cuda, M):
    """One-hot rows through both bodies with bf16 planes: the outputs are
    the plain dequantized weight bit for bit (a bf16 scale widens to f32
    exactly, so the weight keeps the plain version's bits)."""
    R, K = 256, 1024
    pq = _planar(Q.Q4_K, R, K, seed=9, device=cuda,
                 scale_dtype=torch.bfloat16)
    w = planar.dequantize_kmajor(pq, torch.bfloat16)
    picks = ([torch.arange(k0, k0 + 128) for k0 in range(0, K, 128)]
             if M > 1 else
             [torch.tensor([k]) for k in (0, 1, 517, K // 2, K - 1)])
    for ks in picks:
        ks = ks.to(cuda)
        x = torch.zeros((M, K), device=cuda, dtype=torch.bfloat16)
        x[torch.arange(ks.numel(), device=cuda), ks] = 1.0
        got = qmm_cuda(x, pq)
        assert torch.equal(got[: ks.numel()], w[ks])


# the encoder shapes the plan splits: Pile-T5 and llama q at 256 tokens,
# T5-xxl at 512
ENCODER_CASES = [(256, 2048, 2048), (256, 2304, 2048), (512, 4096, 4096)]


@pytest.mark.parametrize("M,K,R", ENCODER_CASES, ids=str)
def test_qmm_planned_split_at_encoder_shapes(cuda, M, K, R):
    pq = _planar(Q.Q8_0, R, K, seed=M + K, device=cuda)
    assert wgmma_split_plan(M, pq.padded_in, R)[1] > 1
    x, b, got = _check_qmm(cuda, pq, M, K, R, True, None, seed=R)
    assert torch.equal(got, qmm_cuda(x, pq, bias=b))



# -- the f16 and f32 instances of K1/K2 (dequant_dtype float16 / float32) --

QMM_DTYPES = [torch.float16, torch.float32]
# the limits against the plain version in the same dtype: f16 operands in
# f32 sums (the order differs), f32 operands on f32 FMAs
QMM_DT_TOL = {torch.float16: 2e-3, torch.float32: 1e-5}
_SFX = {torch.float16: "_f16", torch.float32: "_f32"}


def _qmm_dt_key(pq, M, dt, lora=False):
    """The launch counter of the body and instance that take this shape
    at dequant dtype ``dt``."""
    route = qmm_route(M, pq.padded_in, pq.shape[0], pq.layout == "nib4", dt)
    key = "qmm_nib4" if pq.layout == "nib4" else "qmm_int8"
    key += {"smallm": "_smallm", "simt": "_simt", "wgmma": ""}[route]
    return key + ("_lora" if lora else "") + _SFX[dt]


@pytest.mark.parametrize("dt", QMM_DTYPES, ids=["f16", "f32"])
@pytest.mark.parametrize("qtype,M,R,K,bias,act", QMM_CASES, ids=str)
def test_qmm_f16_f32_instances_match_plain(cuda, dt, qtype, M, R, K, bias,
                                           act):
    """Both bodies at float16 (wgmma f32.f16.f16, mma.sync f16) and at
    float32 (the SIMT body, the split-K body's FMAs) against the plain
    version computing in the same dtype, f32 out; two launches equal."""
    pq = _planar(qtype, R, K, seed=M + 3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, K), generator=g, device=cuda)
    b = torch.randn((R,), generator=g, device=cuda) if bias else None
    key = _qmm_dt_key(pq, M, dt)
    before = _build.LAUNCHES[key]
    kw = dict(bias=b, act_from_col=act, out_dtype=torch.float32,
              dequant_dtype=dt)
    got = qmm_cuda(x, pq, **kw)
    again = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    want = plain_quantized_matmul(x, pq, **kw)
    assert got.shape == (M, R) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) < QMM_DT_TOL[dt]
    assert torch.equal(got, again)


@pytest.mark.parametrize("dt", QMM_DTYPES, ids=["f16", "f32"])
@pytest.mark.parametrize("sdt", SCALE_DTYPES, ids=str)
@pytest.mark.parametrize("M", [3, 300])
@pytest.mark.parametrize("qtype", NIB4_TYPES + INT8_TYPES,
                         ids=lambda q: q.name)
def test_qmm_f16_f32_every_format(cuda, qtype, M, sdt, dt):
    """Every format of both layouts, both scale-plane types, both bodies,
    at float16 and float32."""
    R, K = 328, 1792
    pq = _planar(qtype, R, K, seed=int(qtype) + 5, device=cuda,
                 scale_dtype=sdt)
    x = torch.randn((M, K), device=cuda)
    kw = dict(out_dtype=torch.float32, dequant_dtype=dt)
    got = qmm_cuda(x, pq, bias=None, act_from_col=None, **kw)
    want = plain_quantized_matmul(x, pq, **kw)
    assert _rel_l2(got, want) < QMM_DT_TOL[dt]


@pytest.mark.parametrize("dt", QMM_DTYPES, ids=["f16", "f32"])
@pytest.mark.parametrize("M", [1, 130])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K], ids=lambda q: q.name)
def test_qmm_f16_f32_every_tile_position(cuda, qtype, M, dt):
    """One-hot x rows: each output is one weight rounded to the dequant
    dtype, bit for bit, at every k (both nibble planes, every slice)."""
    R, K = 256, 1024
    pq = _planar(qtype, R, K, seed=9, device=cuda)
    w = planar.dequantize_kmajor(pq, dt).float()  # (K, R)
    for k0 in range(0, K, 128):
        x = torch.zeros((M, K), device=cuda)
        ks = torch.arange(M, device=cuda) % 128 + k0
        x[torch.arange(M, device=cuda), ks] = 1.0
        got = qmm_cuda(x, pq, out_dtype=torch.float32, dequant_dtype=dt)
        assert torch.equal(got, w[ks])


@pytest.mark.parametrize("dt", QMM_DTYPES, ids=["f16", "f32"])
@pytest.mark.parametrize("rank", LORA_RANKS)
@pytest.mark.parametrize("M", [3, 200])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_qmm_lora_f16_f32_match_plain(cuda, qtype, M, rank, dt):
    """The LoRA instances at float16 and float32: the rank operands in the
    dequant dtype (the reference's ``_prep_lora``), against the plain
    version with the same operands."""
    R, K = 384, 1024
    pq = _planar(qtype, R, K, seed=2, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(M + rank)
    x = torch.randn((M, K), generator=g, device=cuda)
    b = torch.randn((R,), generator=g, device=cuda)
    h = torch.randn((M, rank), generator=g, device=cuda).to(dt)
    upt = torch.randn((rank, R), generator=g, device=cuda).to(dt)
    key = _qmm_dt_key(pq, M, dt, lora=True)
    before = _build.LAUNCHES[key]
    kw = dict(bias=b, act_from_col=128, out_dtype=torch.float32,
              dequant_dtype=dt, lora_h=h, lora_up=upt)
    got = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 1
    want = plain_quantized_matmul(x, pq, **kw)
    assert _rel_l2(got, want) < QMM_DT_TOL[dt]
    kw.update(lora_h=None, lora_up=None)
    assert _rel_l2(qmm_cuda(x, pq, **kw), want) > 1e-2


@pytest.mark.parametrize("dt", QMM_DTYPES, ids=["f16", "f32"])
def test_qmm_f16_f32_smallm_is_deterministic(cuda, dt):
    pq = _planar(Q.Q4_K, 1024, 3072, seed=3, device=cuda)
    x = torch.randn((4, 3072), device=cuda)
    plan = (smallm_plan(4, pq.padded_in, 1024, True) if dt == torch.float16
            else smallm_f32_plan(4, pq.padded_in, 1024, True)[1:])
    assert plan[0] > 1
    a = qmm_cuda(x, pq, dequant_dtype=dt)
    b = qmm_cuda(x, pq, dequant_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("qtype,M,R,K", [
    # M and R off the 128 x 128 tile, both token tiles (M = 130 and 200
    # take 64, 4097 takes 128); flux's linear2 depth (K = 15360)
    (Q.Q4_K, 130, 328, 1792), (Q.Q8_0, 4097, 328, 512),
    (Q.Q5_1, 200, 3072, 15360), (Q.Q4_0, 4097, 3072, 15360)], ids=str)
def test_qmm_f32_tiles_and_deep_k(cuda, qtype, M, R, K, lora):
    """K1/K2's f32 body at token counts and out-features that are not
    multiples of its tiles and at the deepest K of flux (linear2), with and
    without a rank-48 LoRA: within 1e-5 of the plain version in f32 (so
    every output of the ragged last tiles written), and two launches
    equal."""
    pq = _planar(qtype, R, K, seed=M + K, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(R)
    x = torch.randn((M, K), generator=g, device=cuda)
    kw = dict(bias=torch.randn((R,), generator=g, device=cuda),
              act_from_col=R // 2, out_dtype=torch.float32,
              dequant_dtype=torch.float32)
    if lora:
        kw.update(lora_h=torch.randn((M, 48), generator=g, device=cuda),
                  lora_up=torch.randn((48, R), generator=g, device=cuda))
    key = ("qmm_nib4" if pq.layout == "nib4" else "qmm_int8") + "_simt" + (
        "_lora" if lora else "") + "_f32"
    before = _build.LAUNCHES[key]
    got = qmm_cuda(x, pq, **kw)
    again = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    assert _rel_l2(got, plain_quantized_matmul(x, pq, **kw)) < 1e-5
    assert torch.equal(got, again)


def test_qmm_refuses_a_dtype_without_instances(cuda):
    pq = _planar(Q.Q4_K, 128, 512, seed=1, device=cuda)
    x = torch.randn((2, 512), device=cuda)
    with pytest.raises(NotImplementedError, match="float16"):
        qmm_cuda(x, pq, dequant_dtype=torch.float64)


# -- the f32 split-K body (qmm_smallm_f32.cu): one instance a token count --

# both layouts with and without offsets, 32- and 16-row scale groups
F32_SPLITK_TYPES = [Q.Q4_K, Q.Q4_0, Q.Q2_K, Q.Q5_1, Q.Q8_0, Q.Q6_K]


@pytest.mark.parametrize("sdt", SCALE_DTYPES, ids=str)
@pytest.mark.parametrize("M", list(range(1, SMALL_M_MAX + 1)))
@pytest.mark.parametrize("qtype", F32_SPLITK_TYPES, ids=lambda q: q.name)
def test_qmm_f32_splitk_every_token_count(cuda, qtype, M, sdt):
    """The f32 split-K body at every M from 1 to 8 (the instances of 1, 2,
    4 and 8 token rows), f32 and bf16 scale planes, a ragged R (328) and a
    K split over a cluster of 8: within 1e-5 of the plain version in f32
    with the bias and a GELU tail, and two launches equal."""
    R, K = 328, 3072
    pq = _planar(qtype, R, K, seed=int(qtype) + M, device=cuda,
                 scale_dtype=sdt)
    mt, split, _ = smallm_f32_plan(M, pq.padded_in, R, pq.layout == "nib4")
    assert split > 1 and mt >= M
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, K), generator=g, device=cuda)
    kw = dict(bias=torch.randn((R,), generator=g, device=cuda),
              act_from_col=200, out_dtype=torch.float32,
              dequant_dtype=torch.float32)
    key = _qmm_dt_key(pq, M, torch.float32)
    assert key.endswith("_smallm_f32")
    before = _build.LAUNCHES[key]
    got = qmm_cuda(x, pq, **kw)
    again = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    assert got.shape == (M, R) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_quantized_matmul(x, pq, **kw)) < 1e-5
    assert torch.equal(got, again)


# (split, R, K) where the plan takes each K split: 128 code rows admit only
# 1, 2, 4 and 8 (8 wins at one strip), 66 / 72 / 132 / 264 strips fill the
# card's 264 block slots at 4 / 3 / 2 / 1, and 3 strips take 6
F32_SPLITK_SPLITS = [(1, 33792, 512), (2, 16896, 3072), (3, 9216, 3072),
                     (4, 8448, 3072), (6, 328, 3072), (8, 128, 256)]


@pytest.mark.parametrize("split,R,K", F32_SPLITK_SPLITS, ids=str)
@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K], ids=lambda q: q.name)
def test_qmm_f32_splitk_every_split(cuda, qtype, M, split, R, K):
    """The f32 split-K body at shapes whose plan takes each K split from
    1 to 8 (a cluster of one block through eight): the cluster's reduction
    in rank order within 1e-5 of the plain version, two launches equal."""
    pq = _planar(qtype, R, K, seed=split, device=cuda)
    assert smallm_f32_plan(M, pq.padded_in, R,
                           pq.layout == "nib4")[1] == split
    x = torch.randn((M, K), device=cuda)
    kw = dict(out_dtype=torch.float32, dequant_dtype=torch.float32)
    got = qmm_cuda(x, pq, **kw)
    again = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got, plain_quantized_matmul(x, pq, **kw)) < 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("rank", [16, 48])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_qmm_lora_f32_splitk_every_token_count(cuda, qtype, M, rank):
    """The f32 split-K body's LoRA instance at each token-count instance:
    the rank term once, after the cluster's reduction, against the plain
    version with the same f32 rank operands; two launches equal, and the
    term is really there."""
    R, K = 384, 1024
    pq = _planar(qtype, R, K, seed=5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(M + rank)
    x = torch.randn((M, K), generator=g, device=cuda)
    kw = dict(bias=torch.randn((R,), generator=g, device=cuda),
              act_from_col=128, out_dtype=torch.float32,
              dequant_dtype=torch.float32,
              lora_h=torch.randn((M, rank), generator=g, device=cuda),
              lora_up=torch.randn((rank, R), generator=g, device=cuda))
    key = _qmm_dt_key(pq, M, torch.float32, lora=True)
    before = _build.LAUNCHES[key]
    got = qmm_cuda(x, pq, **kw)
    again = qmm_cuda(x, pq, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    want = plain_quantized_matmul(x, pq, **kw)
    assert _rel_l2(got, want) < 1e-5
    assert torch.equal(got, again)
    kw.update(lora_h=None, lora_up=None)
    assert _rel_l2(qmm_cuda(x, pq, **kw), want) > 1e-2


@pytest.mark.parametrize("M", [2, 5, 8])
def test_qmm_f32_splitk_one_hot_rows(cuda, M):
    """One-hot x rows at the M = 2, 4 and 8 instances: each output row is
    one dequantized f32 weight row bit for bit, at every k (both nibble
    planes, every slice of the K split), and rows past M are not
    written."""
    R, K = 256, 1024
    pq = _planar(Q.Q4_K, R, K, seed=9, device=cuda)
    w = planar.dequantize_kmajor(pq, torch.float32).float()  # (K, R)
    for k0 in range(0, K, 128):
        x = torch.zeros((M, K), device=cuda)
        ks = (torch.arange(M, device=cuda) * 37) % 128 + k0
        x[torch.arange(M, device=cuda), ks] = 1.0
        got = qmm_cuda(x, pq, out_dtype=torch.float32,
                       dequant_dtype=torch.float32)
        assert got.shape == (M, R)
        assert torch.equal(got, w[ks])


# -- K7 at head dim 384 (the Wan 2.1 VAE's single-head mid-block) ---------

@pytest.mark.parametrize("B,H,Lq,Lk", [(3, 1, 700, 700), (1, 2, 130, 77),
                                       (2, 1, 64, 300)], ids=str)
def test_flash_kernel_d384(cuda, B, H, Lq, Lk):
    """The wide-head instance (flash_attn_wide.cuh): the scores computed
    once over all 384 columns, the output columns split over the two
    consumer warpgroups, against the plain version; ragged key and query
    tiles; two launches equal."""
    D = 384
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    before = _build.LAUNCHES["flash_attn_d384"]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_d384"] == before + 1
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2
    assert torch.equal(got, flash_attn_cuda(q, k, v, D ** -0.5))


def test_flash_kernel_d384_on_qkv_views(cuda):
    """The Wan VAE's layout: q, k and v are column slices of one (N, 1, HW,
    3C) projection, read in place."""
    N, L, C = 2, 900, 384
    qkv = torch.randn((N, 1, L, 3 * C), device=cuda).bfloat16()
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    got = flash_attn_cuda(q, k, v, C ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, C ** -0.5)) < 1e-2


# -- K7 at head dim 512 (the HunyuanVideo VAE's single-head mid-block) -----

@pytest.mark.parametrize("B,H,Lq,Lk", [(3, 1, 701, 701), (1, 2, 130, 77),
                                       (2, 1, 64, 333), (1, 1, 1, 31)],
                         ids=str)
def test_flash_kernel_d512(cuda, B, H, Lq, Lk):
    """The wide-head instance: the scores computed once over all 512
    columns, against the plain version; an odd length, Lq != Lk both ways,
    B > 1 and a key length below one tile; two launches equal."""
    D = 512
    g = torch.Generator(device=cuda).manual_seed(Lq * 3 + Lk)
    q = torch.randn((B, H, Lq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, H, Lk, D), generator=g, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_d512"] == before["flash_attn_d512"] + 1
    assert _build.LAUNCHES["flash_attn"] == before["flash_attn"] + 1
    assert got.shape == (B, H, Lq, D) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2
    assert torch.equal(got, flash_attn_cuda(q, k, v, D ** -0.5))


def test_flash_kernel_d512_on_head_views(cuda):
    """The HyVid VAE's layout: q, k and v are (N, HW, C) projections seen
    as one head, ``x[:, None]``, read in place."""
    N, L, C = 2, 900, 512
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((N, L, C), generator=g, device=cuda).bfloat16()
               [:, None] for _ in range(3))
    got = flash_attn_cuda(q, k, v, C ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, C ** -0.5)) < 1e-2


# -- K7's wide-head body (D = 384 and 512) in bf16 and f16 ----------------

WIDE_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("B,H,Lq,Lk", [
    # ragged 64-row query tiles (one cluster's second block with no rows),
    # Lq != Lk both ways, ragged and partial 128-key tiles, B > 1, H > 1
    (3, 1, 700, 700), (1, 2, 130, 77), (2, 1, 64, 333), (1, 1, 1, 31),
    (2, 2, 191, 1000)], ids=str)
@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("dt", WIDE_DTYPES, ids=["bf16", "f16"])
def test_flash_wide_heads_match_plain(cuda, dt, D, B, H, Lq, Lk):
    """The wide-head body in both tensor-core dtypes: within 1e-2 of
    plain_attention in q's dtype, finite, launched once on its counters,
    two launches equal."""
    g = torch.Generator(device=cuda).manual_seed(D + 7 * Lq + Lk)
    q, k, v = (torch.randn((B, H, L, D), generator=g, device=cuda).to(dt)
               for L in (Lq, Lk, Lk))
    key = f"flash_attn_d{D}" if dt == torch.bfloat16 else "flash_attn_f16"
    before = _build.LAUNCHES[key]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    again = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 2
    assert got.shape == (B, H, Lq, D) and got.dtype == dt
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("dt", WIDE_DTYPES, ids=["bf16", "f16"])
def test_flash_wide_heads_on_strided_views(cuda, dt, D):
    """Strided q/k/v read in place by the 4-D tensor maps: column slices of
    one (N, 1, L, 3D) projection (the Wan VAE's layout) and heads of one
    (B, L, 3, H, D) projection."""
    qkv = torch.randn((2, 1, 900, 3 * D), device=cuda).to(dt)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2
    qkv = torch.randn((2, 200, 3, 2, D), device=cuda).to(dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2
    assert torch.equal(got, flash_attn_cuda(q, k, v, D ** -0.5))


def test_flash_shared_memory_fits_a_block(cuda):
    """The dynamic shared memory of each bf16/f16 instance, as its C entry
    states it, fits the 232,448 bytes a block may have; the wide-head
    body's holds its resident Q (64 rows x D), P (64 x 128) and a ring of
    more than one tile's 8 V chunks of 16 KB."""
    from comfyui_gguf_tpu_torch.nn.attention import FLASH_HEAD_DIMS

    lib = _build.lib()
    for D in FLASH_HEAD_DIMS:
        assert 0 < lib.flash_attn_smem_bytes(D) <= 232448
    for D in (384, 512):
        assert lib.flash_attn_smem_bytes(D) > (64 * D * 2 + 64 * 128 * 2
                                               + 8 * 16384)


# -- HunyuanVideo and LTX-Video on the card against the CPU ----------------

def _video_model(tmp_path, device, arch):
    """A tiny HunyuanVideo (four heads of 128) or LTX-Video (eight heads of
    64) written as a Q4_K GGUF, loaded on ``device``."""
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    path = tmp_path / f"{arch}.gguf"
    if not path.exists():
        if arch == "hyvid":
            spec = testing.hyvid_shape_spec(testing.HyVidDims(
                hidden=512, n_heads=4, refiner_depth=2, text_dim=512))
        else:
            spec = testing.ltxv_shape_spec(testing.LTXVDims(
                dim=512, in_ch=128, caption_dim=512))
        testing.write_spec_gguf(testing.random_flat_sd_from_spec(*spec,
                                                                 seed=0),
                                str(path), arch, Q.Q4_K)
    return load_diffusion_model(str(path), device=device)


def _video_inputs(arch, device, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)

    ts = torch.full((1,), 0.6, device=device)
    if arch == "hyvid":
        return (t(1, 3, 8, 8, 16), t(1, 40, 512), ts,
                torch.full((1,), 6000.0, device=device))
    ids = torch.as_tensor(rng.integers(0, 8, (1, 300, 3)).astype(np.int32),
                          device=device)
    return t(1, 300, 128), ids, t(1, 77, 512), ts


@pytest.mark.parametrize("tree", ["planar", "w8a8"])
@pytest.mark.parametrize("arch,k7", [("hyvid", "flash_attn_d128"),
                                     ("ltxv", "flash_attn_d64")])
def test_video_dit_forward_on_the_card_matches_cpu(cuda, tmp_path, arch, k7,
                                                   tree):
    """One forward of the tiny HunyuanVideo / LTX-Video on the card (K1/K2
    or K4, and K7 at the arch's head dim) against the same forward on the
    CPU (the plain versions) within 3e-2, flat and stacked equal."""
    models = [_video_model(tmp_path, d, arch) for d in (cuda, "cpu")]
    if tree == "w8a8":
        models = [m.requantize_i8() for m in models]
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = models[0].forward(*_video_inputs(arch, cuda))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        want = models[1].forward(*_video_inputs(arch, "cpu"))
        stacked = models[0].stack().forward(*_video_inputs(arch, cuda))
    assert launched[k7] > 0
    assert launched["i8mm" if tree == "w8a8" else "qmm_nib4"] > 0
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got.cpu(), want) < 3e-2
    assert torch.equal(stacked, got)


@pytest.mark.parametrize("arch", ["hyvid", "ltxv"])
def test_video_vae_decode_on_the_card_matches_cpu(cuda, arch):
    """The small HunyuanVideo VAE (its mid-block attention on K7's f32
    instance at D = 64: q/k/v keep the f32 of the latent) and the small
    LTX-Video VAE decode on the card as on the CPU, within 3e-2."""
    from comfyui_gguf_tpu_torch.models import hyvid_vae, ltxv_vae, testing

    if arch == "hyvid":
        sd = testing.hyvid_vae_state_dict(testing.HyVidVAEDims(), seed=1)
        mod, z_shape = hyvid_vae, (1, 2, 6, 8, 16)
        cfg = mod.HyVidVAEConfig.from_state_dict(sd)
    else:
        sd = testing.ltxv_vae_state_dict(testing.LTXVVAEDims(latent=128),
                                         seed=1)
        mod, z_shape = ltxv_vae, (1, 2, 2, 3, 128)
        cfg = mod.LTXVVAEConfig.from_state_dict(sd)
    z = np.random.default_rng(2).standard_normal(z_shape).astype(np.float32)
    before = _build.LAUNCHES["flash_attn_f32"]
    outs = [mod.decode({k: torch.from_numpy(v).to(d) for k, v in sd.items()},
                       cfg, torch.from_numpy(z).to(d)) for d in (cuda, "cpu")]
    torch.cuda.synchronize()
    if arch == "hyvid":
        assert _build.LAUNCHES["flash_attn_f32"] > before
    assert bool(torch.isfinite(outs[0]).all())
    assert _rel_l2(outs[0].cpu(), outs[1]) < 3e-2


@pytest.mark.parametrize("qtype,M", [(Q.Q4_K, 512), (Q.Q5_K, 300)])
def test_autotune_leaves_a_legal_entry(cuda, qtype, M):
    """The tuner on one small planar weight: every legal candidate timed,
    a winner among them recorded under the weight's key, and ``qmm_cuda``
    through the table equal to the forced tiles and within 2e-3 of the plain
    version."""
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.ops import autotune, qmatmul

    gen = torch.Generator(device=cuda).manual_seed(5)
    pq = random_planar(qtype, (1024, 1536), gen, device=cuda)
    qmatmul.SHAPE_TILES.clear()
    try:
        times = {}
        best = autotune.tune_shape(pq, M, times=times)
        assert best is not None and best in times
        # every legal candidate was timed: one that failed to launch is
        # missing from ``times``
        assert set(times) == {t for t in autotune.CANDIDATES
                              if autotune._legal(pq, M, t)}
        assert autotune._legal(pq, M, best)
        key = qmatmul.shape_key(M, pq.padded_in, pq.padded_out, pq.layout)
        assert qmatmul.SHAPE_TILES == {key: best}
        x = torch.randn(M, 1536, generator=gen, device=cuda).to(
            torch.bfloat16)
        got = qmm_cuda(x, pq)
        assert torch.equal(got, qmm_cuda(x, pq, tiles=best))
        assert _rel_l2(got, plain_quantized_matmul(x, pq)) <= 2e-3
    finally:
        qmatmul.SHAPE_TILES.clear()


# tensor-parallel shards of flux-dev (``quant.planar.shard_planar``, each
# re-padded on its own) at the shapes a rank's forward gives the kernels:
# (name, layout of the full weight R x K, split axis, groups, tp, M, GELU
# column of the shard, w8a8)
TP_SHARD_CASES = [
    ("linear1 col tp2", (21504, 3072), "r", (3072, 3072, 3072, 12288), 2,
     4608, 4608, True),
    ("linear1 col tp2 bf16-fused", (21504, 3072), "r",
     (3072, 3072, 3072, 12288), 2, 4608, 4608, False),
    ("linear2 row tp2", (3072, 15360), "k", (3072, 12288), 2, 4608, None,
     False),
    ("linear2 row tp4", (3072, 15360), "k", (3072, 12288), 4, 4608, None,
     False),
    ("proj row tp4 (K 768 pads to 1024)", (3072, 3072), "k", None, 4, 4096,
     None, True),
    ("img_mod gather tp2 split-K", (18432, 3072), "r", None, 2, 1, None,
     False),
    ("qkv col tp2", (9216, 3072), "r", (3072, 3072, 3072), 2, 4096, None,
     True),
]


@pytest.mark.parametrize("name,shape,axis,groups,tp,M,act,w8a8",
                         TP_SHARD_CASES, ids=[c[0] for c in TP_SHARD_CASES])
def test_tp_shard_shapes(cuda, name, shape, axis, groups, tp, M, act, w8a8):
    from comfyui_gguf_tpu_torch.models.testing import random_planar

    g = torch.Generator(device=cuda).manual_seed(tp * 1000 + M)
    full = random_planar(Q.Q4_K, shape, g, device=cuda)
    for r in (0, tp - 1):
        pq = planar.shard_planar(full, tp, axis, groups, index=r)
        R, K = pq.shape
        assert pq.padded_in % 512 == 0 and pq.padded_out % 128 == 0
        if w8a8:
            _check_i8(cuda, requantize_i8(pq), M, True, act, seed=r)
        else:
            _check_qmm(cuda, pq, M, K, R, True, act, seed=r)


def test_flash_kernel_tp_local_heads(cuda):
    """A rank's 12 of flux's 24 heads at the joint length, on column views
    of its local qkv projection."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, H, L, D = 1, 12, 4608, 128
    qkv = torch.randn((B, L, 3, H, D), generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = _build.LAUNCHES["flash_attn_d128"]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_d128"] == before + 1
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-2


# -- f16 and f32 attention (K7's and K6's f16 / f32 instances) -------------

FLOAT_DTYPES = [torch.float16, torch.float32]
# relative L2 against the plain version in the same dtype: f32 computes in
# f32 on both sides (only the order of the sums differs); f16 rounds P and
# the output as bf16 does, at eight times bf16's precision, so bf16's 1e-2
# is an upper bound for it
FLOAT_TOL = {torch.float16: 1e-2, torch.float32: 1e-5}


def _flux_model_d128(tmp_path, device):
    """A tiny flux (four heads of 128) written as a Q4_K GGUF, loaded on
    ``device``."""
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    dims = testing.TinyFluxDims(hidden=512, heads=4, axes_dim=(16, 56, 56))
    path = tmp_path / "flux_d128.gguf"
    if not path.exists():
        testing.write_flux_gguf(
            testing.flux_state_dict(dims, seed=0), str(path),
            lambda k, a: testing.flux_block_qtype(k, a, Q.Q4_K))
    return dims, load_diffusion_model(str(path), device=device)


@pytest.mark.parametrize("dt", FLOAT_DTYPES, ids=["f16", "f32"])
def test_flux_forward_f16_f32_activations_on_the_card(cuda, tmp_path, dt):
    """A tiny flux forward (head dim 128) given f16 or f32 activations runs
    on the card as on the CPU, within 3e-2, its attention on K7's instance
    of that dtype and on no bf16 one."""
    from comfyui_gguf_tpu_torch.models import testing

    outs = []
    for d in (cuda, "cpu"):
        dims, model = _flux_model_d128(tmp_path, d)
        inputs = testing.flux_example_inputs(dims, h_lat=16, w_lat=16,
                                             txt_len=16, seed=5, dtype=dt,
                                             device=d)
        before = dict(_build.LAUNCHES)
        with torch.no_grad():
            outs.append(model.forward(*inputs))
        if d == cuda:
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    name = "flash_attn_f16" if dt == torch.float16 else "flash_attn_f32"
    assert launched[name] == 4  # one joint attention a block
    assert launched["flash_attn"] == 0
    assert outs[0].dtype == dt and bool(torch.isfinite(outs[0]).all())
    assert _rel_l2(outs[0].cpu(), outs[1]) < 3e-2


FLOAT_ATTN_CASES = [
    # B, H, Lq, Lk: a ragged query and key tile; cross attention, Lq < Lk
    # over several key tiles
    (2, 2, 130, 130),
    (1, 3, 77, 300),
]


@pytest.mark.parametrize("B,H,Lq,Lk", FLOAT_ATTN_CASES, ids=str)
@pytest.mark.parametrize("D", [40, 64, 80, 96, 128, 160, 256, 384, 512])
@pytest.mark.parametrize("dt", FLOAT_DTYPES, ids=["f16", "f32"])
def test_flash_kernel_f16_f32_match_plain(cuda, dt, D, B, H, Lq, Lk):
    """K7's f16 and f32 instances at every head dim against
    plain_attention in the same dtype, counted under their dtype's counter
    only; the output keeps the dtype and the (B, Lq, H, D) storage, and two
    launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(D * 13 + Lk)
    q, k, v = (torch.randn((B, H, L, D), generator=g, device=cuda).to(dt)
               for L in (Lq, Lk, Lk))
    name = "flash_attn_f16" if dt == torch.float16 else "flash_attn_f32"
    before = dict(_build.LAUNCHES)
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before[name] + 1
    assert _build.LAUNCHES["flash_attn"] == before["flash_attn"]
    assert got.dtype == dt and got.shape == (B, H, Lq, D)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < FLOAT_TOL[dt]
    # no atomics: a second launch gives the same bits
    assert torch.equal(got, flash_attn_cuda(q, k, v, D ** -0.5))


@pytest.mark.parametrize("D", [64, 128, 384, 512])
@pytest.mark.parametrize("dt", FLOAT_DTYPES, ids=["f16", "f32"])
def test_flash_kernel_f16_f32_on_qkv_views(cuda, dt, D):
    """q/k/v as strided views of one fused (B, L, 3, H, D) projection, read
    in place."""
    B, L, H = 2, 200, 3
    qkv = torch.randn((B, L, 3, H, D), device=cuda).to(dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < FLOAT_TOL[dt]


@pytest.mark.parametrize("B,H,Lq,Lk", [
    # Lq ragged at the 64-row query tile (two tiles and 63 rows, one and
    # one row), Lk over several 128-key tiles with a ragged last one, and
    # one key past a tile
    (1, 1, 191, 1000), (2, 2, 65, 129)], ids=str)
@pytest.mark.parametrize("D", [384, 512])
def test_flash_f32_tiles_at_vae_head_dims(cuda, D, B, H, Lq, Lk):
    """K7's f32 (3xTF32) instances at the VAEs' head dims, where the
    scores are computed once for all of D and the output columns split
    over the two consumer warpgroups: within 1e-5 of plain_attention in
    f32, two launches equal."""
    g = torch.Generator(device=cuda).manual_seed(D + Lq + Lk)
    q, k, v = (torch.randn((B, H, L, D), generator=g, device=cuda)
               for L in (Lq, Lk, Lk))
    before = _build.LAUNCHES["flash_attn_f32"]
    got = flash_attn_cuda(q, k, v, D ** -0.5)
    again = flash_attn_cuda(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_f32"] == before + 2
    assert _rel_l2(got, plain_attention(q, k, v, D ** -0.5)) < 1e-5
    assert torch.equal(got, again)


def test_flash_f32_shared_memory_fits_a_block(cuda):
    """The dynamic shared memory of each f32 instance, as its C entry
    states it, fits the 232,448 bytes a block may have."""
    from comfyui_gguf_tpu_torch.nn.attention import FLASH_HEAD_DIMS

    lib = _build.lib()
    for D in FLASH_HEAD_DIMS:
        assert 0 < lib.flash_attn_f32_smem_bytes(D) <= 232448


def _check_i8attn_dtype(q, k, v, pv_int8):
    """K6 and its prep on q/k/v of q's dtype: the dtype's counters, the
    output in q's dtype, and the bf16 check's limits."""
    B, H, Lq, D = q.shape
    scale = D ** -0.5
    sfx = "_f16" if q.dtype == torch.float16 else "_f32"
    key = ("i8attn_pv" if pv_int8 else "i8attn_qk") + sfx
    before = dict(_build.LAUNCHES)
    got = i8_attention_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before[key] + 1
    assert _build.LAUNCHES["i8attn_prep" + sfx] == before[
        "i8attn_prep" + sfx] + 1
    assert all(_build.LAUNCHES[k] == before[k]
               for k in ("i8attn_pv", "i8attn_qk", "i8attn_prep"))
    assert got.shape == (B, H, Lq, D) and got.dtype == q.dtype
    assert got.permute(0, 2, 1, 3).is_contiguous()
    want = plain_i8_attention(q, k, v, scale=scale, pv_int8=pv_int8,
                              block_kv=kernel_block_kv(D))
    assert want.dtype == q.dtype
    assert _rel_l2(got, want) < 2e-3
    assert _rel_l2(got, plain_attention(q, k, v, scale)) < 3.5e-2


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv", "qk"])
@pytest.mark.parametrize("D", [128, 256, 384])
@pytest.mark.parametrize("B,H,Lq,Lk", [(1, 2, 250, 131), (2, 2, 512, 512)],
                         ids=str)
@pytest.mark.parametrize("dt", FLOAT_DTYPES, ids=["f16", "f32"])
def test_i8attn_kernel_f16_f32_match_plain(cuda, dt, B, H, Lq, Lk, D,
                                           pv_int8):
    """K6 and its prep on f16 and f32 q/k/v, both modes, at D = 128, 256
    and the split instance (384): the result in q's dtype."""
    q, k, v = (t.to(dt) for t in _qkv(cuda, B, H, Lq, Lk, D,
                                      Lq * 5 + Lk + D))
    _check_i8attn_dtype(q, k, v, pv_int8)


@pytest.mark.parametrize("dt", FLOAT_DTYPES, ids=["f16", "f32"])
def test_i8attn_f16_f32_on_qkv_views(cuda, dt):
    """f16 / f32 q/k/v as strided views of one fused projection."""
    B, L, H, D = 1, 520, 2, 128
    qkv = torch.randn((B, L, 3, H, D), device=cuda).to(dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for pv_int8 in (True, False):
        _check_i8attn_dtype(q, k, v, pv_int8)


def test_wan_vae_decode_f32_on_the_card(cuda):
    """A small Wan VAE decode with f32 compute: its mid-block attention
    (one head of the block's channels) takes K7's f32 instance and no bf16
    one, within 3e-2 of the CPU."""
    from comfyui_gguf_tpu_torch.models import testing, wan_vae
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

    sd = testing.wan_vae_state_dict(testing.WanVAEDims(), seed=1)
    cfg = wan_vae.WanVAEConfig.from_state_dict(sd)
    qcfg = QuantConfig(dequant_dtype=torch.float32,
                       compute_dtype=torch.float32)
    z = np.random.default_rng(2).standard_normal(
        (1, 2, 6, 8, cfg.z_channels)).astype(np.float32)
    before = dict(_build.LAUNCHES)
    outs = [wan_vae.decode({k: torch.from_numpy(v).to(d)
                            for k, v in sd.items()}, cfg,
                           torch.from_numpy(z).to(d), qcfg=qcfg)
            for d in (cuda, "cpu")]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_f32"] > before["flash_attn_f32"]
    assert _build.LAUNCHES["flash_attn"] == before["flash_attn"]
    assert bool(torch.isfinite(outs[0]).all())
    assert _rel_l2(outs[0].cpu(), outs[1]) < 3e-2
