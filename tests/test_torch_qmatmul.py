"""The port's plain fused dequant-matmul against the reference package.

The plain version (dequantize, f32-accumulated matmul, unfused epilogue)
is held against the reference's ``xla_qmm`` + ``_host_epilogue`` and
against its Pallas kernel run in interpret mode, on the same blocks and
inputs: formats Q4_K / Q4_0 (nib4) and Q8_0 (int8), K=512 and a padded
K=2432, M in {1, 37}, with and without bias, GELU on no column, all columns
or a tail. Tolerance: 1e-5 relative L2 with f32 dequant (only the summation
order differs), 1e-2 with bf16 operands and output (bf16 rounding points).

The CUDA kernels run only on the card, but what their wrapper decides on
the host is plain Python and is tested here: which of the two kernel bodies
takes a shape, the K split and shared memory of the split-K body, the tile
list of the wgmma body, and the nibble arithmetic both bodies unpack with,
each against a numpy statement of it; so is the tile plan of the w8a8
kernel (K4, ``i8mm_plan``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.ops import qmatmul as jqmm
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.ops.qmatmul import (_RESIDENT, I8MM_WIDTHS,
                                                N_SM, SMALL_M_MAX,
                                                WGMMA_SPLITS, i8mm_plan,
                                                plain_quantized_matmul,
                                                qmm_route, quantized_matmul,
                                                smallm_f32_plan, smallm_plan,
                                                wgmma_cost,
                                                wgmma_plan, wgmma_split_ok,
                                                wgmma_split_plan)
from comfyui_gguf_tpu_torch.quant import codecs

torch.set_num_threads(2)

R = 1024  # padded out-features 1024: the Pallas r-tile is 512
EPILOGUES = [(False, None), (True, 0), (True, 512), (False, 512)]


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _case(qtype, K, M, seed=0):
    rng = np.random.default_rng(seed + K + M + int(qtype))
    w = rng.standard_normal((R, K), dtype=np.float32)
    blocks = codecs.quantize(w, qtype)
    jp = jplanar.planarize(blocks, JQ(int(qtype)), (R, K))
    pq = params_from_numpy({"w": jp}, device="cpu")["w"]
    x = rng.standard_normal((M, K), dtype=np.float32)
    bias = (rng.standard_normal(R) * 0.5).astype(np.float32)
    return jp, pq, x, bias


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q8_0],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("K", [512, 2432])
@pytest.mark.parametrize("M", [1, 37])
@pytest.mark.parametrize("has_bias,act", EPILOGUES, ids=str)
def test_plain_matches_reference_xla(qtype, K, M, has_bias, act):
    jp, pq, x, bias = _case(qtype, K, M)
    b = bias if has_bias else None
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 1e-2)):
        want = jqmm._host_epilogue(
            jqmm.xla_qmm(jnp.asarray(x, jdt), jp, dequant_dtype=jdt),
            None if b is None else jnp.asarray(b), act)
        got = plain_quantized_matmul(
            _torch(x, dt), pq, dequant_dtype=dt,
            bias=None if b is None else torch.from_numpy(b),
            act_from_col=act)
        assert got.shape == (M, R) and got.dtype == dt
        assert _rel_l2(got.float(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q8_0],
                         ids=lambda q: q.name)
@pytest.mark.parametrize("K", [512, 2432])
def test_plain_matches_reference_kernel_interpret(qtype, K):
    jp, pq, x, bias = _case(qtype, K, 37, seed=5)
    want = jqmm.pallas_qmm(jnp.asarray(x), jp, dequant_dtype=jnp.float32,
                           interpret=True, bias=jnp.asarray(bias),
                           act_from_col=512)
    got = quantized_matmul(torch.from_numpy(x), pq,
                           dequant_dtype=torch.float32,
                           bias=torch.from_numpy(bias), act_from_col=512)
    assert _rel_l2(got, np.asarray(want)) < 1e-5


def test_cpu_dispatch_is_the_plain_version():
    jp, pq, x, bias = _case(Q.Q4_K, 512, 4)
    xt = _torch(x, torch.bfloat16)
    a = quantized_matmul(xt, pq, bias=torch.from_numpy(bias), act_from_col=0)
    b = plain_quantized_matmul(xt, pq, bias=torch.from_numpy(bias),
                               act_from_col=0)
    assert torch.equal(a, b)


# --- the host side of the two CUDA kernel bodies ---------------------------

# (M, K, R, layout) of every fused dequant-matmul on the main paths: flux
# modulations (M = batch), flux token-facing linears, T5-xxl linears
MAIN_PATH_SHAPES = [
    (1, 3072, 18432, "nib4", "smallm"), (1, 3072, 9216, "nib4", "smallm"),
    (2, 3072, 18432, "nib4", "smallm"), (4, 3072, 18432, "int8", "smallm"),
    (1, 3072, 6144, "int8", "smallm"),
    (4096, 3072, 9216, "nib4", "wgmma"), (512, 3072, 9216, "nib4", "wgmma"),
    (4608, 3072, 21504, "nib4", "wgmma"), (4608, 15360, 3072, "nib4", "wgmma"),
    (4608, 3072, 3072, "int8", "wgmma"), (512, 4096, 4096, "int8", "wgmma"),
    (512, 4096, 10240, "int8", "wgmma"), (512, 10240, 4096, "int8", "wgmma"),
]


@pytest.mark.parametrize("M,K,R,layout,want", MAIN_PATH_SHAPES, ids=str)
def test_dispatch_at_main_path_shapes(M, K, R, layout, want):
    kp = -(-K // 512) * 512
    assert qmm_route(M, kp, R, layout == "nib4") == want


@pytest.mark.parametrize("layout", ["nib4", "int8"])
def test_dispatch_edge_is_m_alone(layout):
    nib4 = layout == "nib4"
    for kp, r in ((512, 128), (3072, 18432), (15360, 3072), (10240, 4096)):
        assert qmm_route(SMALL_M_MAX, kp, r, nib4) == "smallm"
        assert qmm_route(SMALL_M_MAX + 1, kp, r, nib4) == "wgmma"
        assert smallm_plan(0, kp, r, nib4) is None
    # an x slice too long for shared memory even at the largest split goes
    # to the wgmma body instead of failing
    assert qmm_route(1, 1 << 20, 128, nib4) == "wgmma"


def _np_smallm_smem(kp, nib4, split):
    """Shared memory of the split-K body, stated on its own: the x slice
    (8 rows of bf16, one plane per nibble, 8 elements of padding a row) or
    the four row lanes' f32 partial sums, whichever is larger, plus one
    8 x 128 f32 tile of partial sums for the cluster."""
    rows = np.int64(kp // 2 if nib4 else kp) // split
    x_bytes = (2 if nib4 else 1) * 8 * (rows + 8) * 2
    return int(max(x_bytes, 4 * 8 * 128 * 4) + 8 * 128 * 4)


@pytest.mark.parametrize("M", [1, 3, SMALL_M_MAX])
@pytest.mark.parametrize("kp", [512, 2560, 3072, 4096, 10240, 15360])
@pytest.mark.parametrize("r", [128, 3000, 9216, 18432])
@pytest.mark.parametrize("layout", ["nib4", "int8"])
def test_smallm_plan_arithmetic(M, kp, r, layout):
    nib4 = layout == "nib4"
    split, smem = smallm_plan(M, kp, r, nib4)
    rows = kp // 2 if nib4 else kp
    assert 1 <= split <= 8  # a cluster holds at most 8 blocks
    assert rows % (16 * split) == 0  # whole 16-row units per block
    assert smem == _np_smallm_smem(kp, nib4, split) <= 96 * 1024
    strips = -(-r // 128)
    # the smallest split that gives every SM two blocks, else the largest
    # the shape allows
    ok = [s for s in range(1, 9) if rows % (16 * s) == 0
          and _np_smallm_smem(kp, nib4, s) <= 96 * 1024]
    filled = [s for s in ok if strips * s >= 2 * N_SM]
    assert split == (filled[0] if filled else ok[-1])


@pytest.mark.parametrize("M,kp,r,layout,plan", [
    # flux's modulation: 144 strips x 3 = 432 blocks, two rounds of a third
    # of a strip; x: 2 planes x 1 row x (512 + 4) f32 = 4128 > 4096 bytes
    # of partial sums, + 512 for the cluster
    (1, 3072, 18432, "nib4", (1, 3, 4640)),
    # the single blocks' at a CFG batch: 1024 rows, 2 x (1024 + 4) x 4 =
    # 8224, + 1024
    (2, 3072, 9216, "int8", (2, 3, 9248)),
    # one strip of 128 code rows: only 1, 2, 4, 8 cut it, 8 is cheapest;
    # the partial sums (8 x 4 x 128 x 4) outweigh x, + 2048
    (3, 256, 128, "nib4", (4, 8, 18432)),
    # 3 strips take 6 (256 rows); M = 5 computes 8 token rows
    (5, 3072, 328, "nib4", (8, 6, 36864)),
    (4, 3072, 8448, "nib4", (4, 4, 18432)),  # 66 strips: one round at 4
    (8, 3072, 16896, "int8", (8, 2, 53376)),  # 132 strips: one round at 2
    (1, 512, 33792, "int8", (1, 1, 4608)),  # 264 strips: one round at 1
    # 264 strips would take 1, but 8 rows of x fit 96 KB only from a split
    # of 6 (2560 rows: 8 x 2564 x 4 = 82048, + 4096)
    (8, 15360, 33792, "int8", (8, 6, 86144)),
], ids=str)
def test_smallm_f32_plan_arithmetic(M, kp, r, layout, plan):
    """The f32 split-K body's plan at hand-computed shapes: the token count
    is M rounded up to 1, 2, 4 or 8, the split the one of least modelled
    time (rounds of 264 blocks, each 1/split of a strip, plus 0.03 a block
    of the split) within 96 KB of shared memory, and the route is the
    split-K body's."""
    nib4 = layout == "nib4"
    assert smallm_f32_plan(M, kp, r, nib4) == plan
    assert qmm_route(M, kp, r, nib4, torch.float32) == "smallm"


@pytest.mark.parametrize("layout", ["nib4", "int8"])
def test_smallm_f32_plan_edges(layout):
    """M outside 1..8 has no f32 split-K plan (M > 8 takes the SIMT body),
    and an x slice too long for shared memory even at the largest split
    goes to the SIMT body instead of failing."""
    nib4 = layout == "nib4"
    for kp, r in ((512, 128), (3072, 18432), (15360, 3072)):
        assert smallm_f32_plan(0, kp, r, nib4) is None
        assert smallm_f32_plan(SMALL_M_MAX + 1, kp, r, nib4) is None
        assert qmm_route(SMALL_M_MAX + 1, kp, r, nib4,
                         torch.float32) == "simt"
    assert qmm_route(1, 1 << 20, 128, nib4, torch.float32) == "simt"
    # flux's modulation at M = 1 (a prompt) and M = 2 (a CFG batch): a
    # slice of x four times smaller than the bf16 body's 8-row one at
    # twice the element size; 144 strips split in 3 (432 blocks, two
    # rounds of a third of a strip), where 2 would leave a second round of
    # 24 blocks; 72 strips (the single blocks' 3072 -> 9216) also in 3
    for M in (1, 2):
        mt, split, smem = smallm_f32_plan(M, 3072, 18432, nib4)
        assert (mt, split) == (M, 3)
        assert smem < smallm_plan(M, 3072, 18432, nib4)[1]
        assert smallm_f32_plan(M, 3072, 9216, nib4)[1] == 3


@pytest.mark.parametrize("M,R", [(9, 18432), (131, 3000), (512, 4096),
                                 (512, 10240), (4096, 9216), (4608, 3072),
                                 (4608, 21504), (200, 328)], ids=str)
def test_wgmma_plan_covers_the_output_once(M, R):
    nt, m_tiles, r_tiles, blocks = wgmma_plan(M, R)
    assert nt in (1, 2) and (nt == 1 or M > 128)
    assert blocks == min(m_tiles * r_tiles, N_SM)
    # walk the tile list as the persistent blocks do and mark what is
    # written: every output element exactly once
    hit = np.zeros((M, R), dtype=np.int32)
    for b in range(blocks):
        for t in range(b, m_tiles * r_tiles, blocks):
            m0, r0 = (t % m_tiles) * 128 * nt, (t // m_tiles) * 128
            hit[m0: m0 + 128 * nt, r0: r0 + 128] += 1
    assert (hit == 1).all()
    # and the choice of nt is the smaller modelled time
    def waves(n):
        return -(-(-(-M // (128 * n)) * r_tiles) // N_SM)
    assert (nt == 2) == (M > 128 and waves(2) * 3.5 < waves(1) * 2.5)
    # every (nt, K split) the body takes covers the output and K once
    for kp in (2048,):
        for n in (1, 2):
            for split in WGMMA_SPLITS:
                if wgmma_split_ok(kp, n, split):
                    _walk_wgmma(M, R, kp, n, split)


def _walk_wgmma(M, R, kp, nt, split):
    """The wgmma body's walk, stated on its own: split == 1, persistent
    blocks over the tile list; else ``split`` blocks a tile (a cluster),
    rank b % split walking its 1/split of the K steps and then summing and
    storing its 1/split of the tile's accumulator groups (group a: rows
    128 (a // 16) + 8 (a % 16) .. + 7 of the tile, all 128 columns).
    Every K step of every tile is walked once and every output element is
    stored once."""
    m_tiles, r_tiles = -(-M // (128 * nt)), -(-R // 128)
    n_tiles, n_steps = m_tiles * r_tiles, kp // 64
    grid = n_tiles * split if split > 1 else min(n_tiles, N_SM)
    spb, per = n_steps // split, 16 * nt // split
    walked = np.zeros((n_tiles, n_steps), np.int32)
    hit = np.zeros((m_tiles * 128 * nt, r_tiles * 128), np.int32)
    for b in range(grid):
        rank = b % split
        for t in range(b // split, n_tiles, grid // split):
            walked[t, rank * spb:(rank + 1) * spb] += 1
            m0, r0 = (t % m_tiles) * 128 * nt, (t // m_tiles) * 128
            for a in range(rank * per, (rank + 1) * per):
                m = m0 + (a // 16) * 128 + 8 * (a % 16)
                hit[m: m + 8, r0: r0 + 128] += 1
    assert (walked == 1).all(), (nt, split)
    assert (hit == 1).all(), (nt, split)


# the encoders' linears: Pile-T5-XL and the Gemma-shaped llama at 256
# tokens, Qwen2.5-VL-7B, T5-xxl at 512
ENCODER_SHAPES = [(256, 2048, 2048), (256, 2048, 5120), (256, 2304, 2048),
                  (256, 2304, 9216), (256, 3584, 3584), (256, 3584, 18944),
                  (512, 4096, 4096), (512, 4096, 10240), (512, 10240, 4096)]


@pytest.mark.parametrize("M,K,R", ENCODER_SHAPES, ids=str)
def test_wgmma_split_fills_the_card_at_encoder_shapes(M, K, R):
    """Where the persistent plan leaves most SMs idle (fewer than half
    busy: 32 blocks for 132 SMs at M = 256, R = 2048), the plan splits K
    over a cluster and at least doubles the busy SMs; nowhere does it run
    fewer blocks or take longer by the model than the persistent plan, and
    its pick is the least modelled time of every pair the body takes."""
    kp = -(-K // 512) * 512
    nt, split = wgmma_split_plan(M, kp, R)
    assert wgmma_split_ok(kp, nt, split)
    blocks = -(-M // (128 * nt)) * -(-R // 128) * split
    old_nt, _, _, old_blocks = wgmma_plan(M, R)
    assert blocks >= old_blocks
    if old_blocks < 0.5 * N_SM:
        assert split > 1 and min(blocks, _RESIDENT[split]) >= 2 * old_blocks
    cost = wgmma_cost(M, kp, R, nt, split)
    assert cost <= wgmma_cost(M, kp, R, old_nt, 1)
    assert cost == min(wgmma_cost(M, kp, R, n, s) for n in (1, 2)
                       for s in WGMMA_SPLITS if wgmma_split_ok(kp, n, s))


@pytest.mark.parametrize("M,K,R", [(4096, 3072, 9216), (4608, 3072, 21504),
                                   (4360, 3072, 8192), (4352, 2304, 6912)],
                         ids=str)
def test_wgmma_no_split_where_tiles_fill_the_card(M, K, R):
    """The DiT linears (thousands of tokens) have tiles for several waves:
    no cluster, persistent blocks at 256-token tiles, as before."""
    assert wgmma_split_plan(M, -(-K // 512) * 512, R) == (2, 1)


# (M, R, the width the plan must pick): flux's w8a8 linears, text stream
# (M = 512) and image stream / single blocks (M = 4096, 4608), and small
# ragged shapes
I8MM_PLANS = [(512, 9216, 128), (512, 12288, 128), (512, 3072, 128),
              (4096, 9216, 256), (4096, 12288, 256), (4096, 3072, 256),
              (4608, 21504, 256), (4608, 3072, 256), (1, 256, 128),
              (300, 328, 128), (129, 200, 128)]


@pytest.mark.parametrize("M,R,bn", I8MM_PLANS, ids=str)
def test_i8mm_plan_picks_by_waves(M, R, bn):
    width, m_tiles, n_tiles, blocks = i8mm_plan(M, R)
    assert width == bn and width in I8MM_WIDTHS
    assert (m_tiles, n_tiles) == (-(-M // 128), -(-R // width))
    assert blocks == min(m_tiles * n_tiles, N_SM)
    # the pick is never modelled slower than the other width: waves of
    # tiles, a 256-wide tile costing 2 and a 128-wide one 1.2
    def cost(w):
        return -(-(m_tiles * -(-R // w)) // N_SM) * (2 if w == 256 else 1.2)
    assert cost(width) <= cost(384 - width)
    # and the persistent walk writes every output element exactly once
    hit = np.zeros((M, R), dtype=np.int32)
    for b in range(blocks):
        for t in range(b, m_tiles * n_tiles, blocks):
            m0, r0 = (t % m_tiles) * 128, (t // m_tiles) * width
            hit[m0: m0 + 128, r0: r0 + width] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q8_0, Q.Q6_K],
                         ids=lambda q: q.name)
def test_kernel_unpack_arithmetic_is_the_plain_dequant(qtype):
    """The kernels turn a code into 2^23 + code by byte permutation and then
    use f32 operations only: (f - (2^23 + zp)) * s [+ o], or for nibble
    codes with offsets fma(s, f, -s * 2^23) + o. Both must give the plain
    version's weight bit for bit, before and after the bf16 rounding."""
    from comfyui_gguf_tpu_torch.quant import planar

    rng = np.random.default_rng(int(qtype))
    w = rng.standard_normal((128, 512), dtype=np.float32)
    pq = planar.planarize(codecs.quantize(w, qtype), qtype, (128, 512))
    want = planar.dequantize_padded(pq).numpy()
    codes = planar.unpack_codes(pq).numpy().astype(np.int64)
    s = np.repeat(pq.scales.numpy(), pq.group_size, axis=0)
    magic = np.float32(2.0 ** 23)
    if pq.layout == "int8":
        f = (np.uint32(0x4B000000) | (codes + 128).astype(np.uint32)).view(
            np.float32)
        got = (f - np.float32(magic + 128)) * s
    else:
        f = (np.uint32(0x4B000000) | codes.astype(np.uint32)).view(np.float32)
        if pq.offsets is None:
            got = (f - np.float32(magic + pq.zero_point)) * s
        else:
            assert pq.zero_point == 0  # what the fused form relies on
            # fma with one rounding, in float64: s * f is exact there
            got = (s.astype(np.float64) * f.astype(np.float64)
                   - s.astype(np.float64) * float(magic)).astype(np.float32)
    if pq.offsets is not None:
        got = got + np.repeat(pq.offsets.numpy(), pq.group_size, axis=0)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16),
                       torch.from_numpy(want).to(torch.bfloat16))


def test_nib4_rows_pair_with_x_columns_half_apart():
    """A nib4 code row j feeds k = j (low nibble) and k = j + Kp/2 (high
    nibble): summing the two half-products, as the kernels do with two x
    tiles, is the whole product."""
    jp, pq, x, _ = _case(Q.Q4_K, 2432, 5, seed=11)
    from comfyui_gguf_tpu_torch.quant import planar

    w = planar.dequantize_padded(pq).numpy().astype(np.float64)  # (Kp, Rp)
    kp = w.shape[0]
    xp = np.zeros((5, kp))
    xp[:, :2432] = x  # x is zero past K, as the kernels' loads fill it
    lo = xp[:, : kp // 2] @ w[: kp // 2]
    hi = xp[:, kp // 2:] @ w[kp // 2:]
    want = plain_quantized_matmul(torch.from_numpy(x), pq,
                                  dequant_dtype=torch.float32).numpy()
    assert _rel_l2((lo + hi)[:, :R], want) < 1e-5


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_plain_with_bf16_scales_matches_reference(qtype):
    """The reference's ``test_pallas_qmm_with_bf16_scales``: bf16 scale
    planes through the port's plain version, the reference's ``xla_qmm``
    and its kernel in interpret mode, on the same blocks (f32 dequant)."""
    K, M = 512, 16
    rng = np.random.default_rng(8)
    w = rng.standard_normal((R, K), dtype=np.float32)
    blocks = codecs.quantize(w, qtype)
    jp = jplanar.planarize(blocks, JQ(int(qtype)), (R, K),
                           scale_dtype=jnp.bfloat16)
    pq = params_from_numpy({"w": jp}, device="cpu")["w"]
    assert pq.scales.dtype == torch.bfloat16
    x = rng.standard_normal((M, K), dtype=np.float32)
    got = plain_quantized_matmul(_torch(x, torch.float32), pq,
                                 dequant_dtype=torch.float32).numpy()
    want = np.asarray(jqmm.xla_qmm(jnp.asarray(x), jp,
                                   dequant_dtype=jnp.float32))
    assert _rel_l2(got, want) < 1e-5
    kern = np.asarray(jqmm.pallas_qmm(jnp.asarray(x), jp,
                                      dequant_dtype=jnp.float32,
                                      interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-3, atol=1e-3)
