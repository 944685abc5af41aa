"""int8 flash attention (PyTorch port of comfyui_gguf_tpu/ops/i8attn.py).

SageAttention-style: both attention products run on int8 operands.

* K is smoothed by its per-(batch, head) token mean before quantization:
  ``s_ij = q_i·(k_j − k̄) + q_i·k̄`` and the second term is constant across j
  for a fixed query row, so the softmax is exactly invariant.
* Q and K quantize per token row (symmetric, scale = rowmax/127); the
  softmax scale folds into the Q scales. The s32 QK sum is exact.
* The online-softmax probabilities ``p = exp(s − m) ∈ [0, 1]`` quantize at
  the static scale 127; V quantizes per output channel, so the products
  factor as ``(1/127)·vs_d·Σ_j pq_ij·vq_jd`` (mode "pv"). Mode "qk" keeps
  the PV product in bf16.
* m, l, the rescales and the accumulator stay f32.

``quantize_attn_inputs`` is the plain prep (torch ops); ``kernel_operands``
turns its operands into the layout the kernel reads (k and v's scales
padded to the key tile; in mode "pv" v transposed to (BH, D, Lkp), keys
contiguous and permuted inside every 16-key group, see ``KEY_ORDER``), and
``plain_operands`` turns them back.

* ``i8_attention_cuda`` — the prep kernel ``csrc/i8attn_prep.cu``
  (``prep_cuda``, which computes ``kernel_operands(quantize_attn_inputs(...))``
  in two launches), then ``i8_attention_cuda_q``, the wrapper of the
  hand-written CUDA kernel ``csrc/i8attn.cu`` (K6), at every head dim the
  gate admits (a multiple of 128), on bf16, f16 or f32 q/k/v
  (``I8ATTN_DTYPES``), the result in q's dtype.
* ``plain_i8_attention`` — the plain prep, then ``plain_i8_attention_q``, the
  plain PyTorch version of the kernel. ``block_kv=None``
  is the reference's ``xla_i8_attention`` (one global row maximum);
  ``block_kv=n`` reproduces the tiled order of operations of a kernel that
  walks the keys n at a time: p is quantized against the RUNNING row
  maximum, so the result depends on the tile size, and a kernel is held
  against the plain version at its own tile size (``kernel_block_kv``).

``i8_dot_product_attention`` dispatches by device alone. The feature is off
by default (nn/attention.py ``attention_i8``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

_SCALE_FLOOR = 1e-20
_NEG = -1e30
LANE = 128  # the reference's tiling unit, kept in the gate (see below)
# Position 4t + e of every 16-key group of the kernel's Vᵀ holds key
# {2t, 2t+1, 8+2t, 9+2t}[e]: the keys whose scores thread t of a quad holds
# in the s32 accumulator of Q·Kᵀ, so it packs them into one s8 A register of
# the P·V product as they are (csrc/i8attn.cu).
KEY_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)
BLOCK_Q = 512
BLOCK_KV = 1536


# The reference's kernel wrapper runs under jit, where XLA turns ``/ 127.0``
# into a multiply by the f32 reciprocal and folds ``(1/127)·scale`` into one
# f32 constant, while ``xf / xs`` stays a true division. The port computes
# exactly that, so both packages feed their kernels identical integers and
# scales (the reference's eager same-math path differs from its own kernel
# by one ulp in the scales).
_INV127 = np.float32(1.0) / np.float32(127.0)


def _quant(xf: torch.Tensor, dim: int):
    """Symmetric int8 along ``dim`` of an f32 tensor: (codes s8, scales
    f32, the clamped abs-max the scales come from); round-half-even."""
    amax = xf.abs().amax(dim=dim, keepdim=True).clamp_min(_SCALE_FLOOR)
    xs = amax * float(_INV127)
    return torch.round(xf / xs).to(torch.int8), xs, amax


def quantize_attn_inputs(q, k, v, scale: float, pv_int8: bool = True):
    """Shared prep for the kernel and the plain version.

    q/k/v: (B, H, L, D) -> flattened (BH, ...) integer operands:
      qq (BH, Lq, D) s8, qs (BH, Lq, 1) f32 (softmax scale folded in),
      kq (BH, Lk, D) s8, ks (BH, 1, Lk) f32,
      vq (BH, Lk, D) s8, vs (BH, 1, D) f32.
    K is mean-smoothed over tokens first (softmax-invariant).
    ``pv_int8=False``: v passes through as bf16 (vs is all-ones).

    The reference hands its kernel k transposed, (BH, D, L); here k stays
    (BH, L, D), which is the layout the tensor-core instruction wants. The
    integers are the same numbers.
    """
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    # strided (B, H, L, D) views are gathered once here: the integer
    # operands are contiguous (BH, L, D)
    q3 = q.reshape(B * H, Lq, D).contiguous()
    k3 = k.reshape(B * H, Lk, D).contiguous().to(torch.float32)
    v3 = v.reshape(B * H, Lk, D).contiguous()
    k3 = k3 - k3.mean(dim=1, keepdim=True)
    qq, _, qmax = _quant(q3.to(torch.float32), -1)  # per token row
    qs = qmax * float(np.float32(_INV127 * np.float32(scale)))
    kq, ks, _ = _quant(k3, -1)
    if pv_int8:
        vq, vs, _ = _quant(v3.to(torch.float32), 1)  # per output channel
    else:
        vq = v3.to(torch.bfloat16)
        vs = torch.ones((B * H, 1, D), dtype=torch.float32, device=q.device)
    return qq, qs, kq, ks.reshape(B * H, 1, Lk), vq, vs


def kernel_block_kv(D: int) -> int:
    """The key tile of csrc/i8attn.cu's instance for head dim D: 128 keys
    at D = 128; 64 at D = 256, where the f32 accumulator takes 128
    registers a thread and leaves room for the scores of 64 keys; 64 in the
    split instance of every wider multiple of 128, whose blocks own 128
    output columns each."""
    if D <= 0 or D % LANE:
        raise ValueError(f"head dim {D}: the int8 attention kernel takes "
                         f"multiples of {LANE}")
    return 128 if D == 128 else 64


def _key_order(Lkp: int, device) -> torch.Tensor:
    """Key held at each position of a permuted key axis of length Lkp."""
    base = torch.arange(0, Lkp, 16, device=device).reshape(-1, 1)
    return (base + torch.tensor(KEY_ORDER, device=device)).reshape(-1)


def kernel_operands(qq, qs, kq, ks, vq, vs, *, pv_int8: bool = True):
    """The operands of ``quantize_attn_inputs`` in the layout the kernel
    reads: qq (BH, Lq, D) and kq (BH, Lk, D) s8 as they are (K-major for
    S = Q·Kᵀ), qs (BH, Lq) f32, ks (BH, Lkp) f32 zero-padded to the key tile,
    vs (BH, D) f32, and v: in mode "pv" Vᵀ (BH, D, Lkp) s8, keys contiguous
    (s8 ``wgmma`` reads only K-major B operands, and P·V contracts over the
    keys), zero-padded and permuted by ``KEY_ORDER`` inside every 16-key
    group; in mode "qk" the bf16 (BH, Lk, D) v as it is."""
    BH, Lq, D = qq.shape
    Lk = kq.shape[1]
    bkv = kernel_block_kv(D)
    Lkp = -(-Lk // bkv) * bkv
    ks_p = torch.zeros((BH, Lkp), dtype=torch.float32, device=qq.device)
    ks_p[:, :Lk] = ks.reshape(BH, Lk)
    if pv_int8:
        vt = torch.zeros((BH, D, Lkp), dtype=torch.int8, device=qq.device)
        vt[:, :, :Lk] = vq.transpose(1, 2)
        v = vt[:, :, _key_order(Lkp, qq.device)].contiguous()
    else:
        v = vq
    return qq, qs.reshape(BH, Lq), kq, ks_p, v, vs.reshape(BH, D)


def plain_operands(qq, qs, kq, ks, v, vs, *, pv_int8: bool = True):
    """``kernel_operands``' result (or the prep kernel's) back in the
    layout of ``quantize_attn_inputs``, which ``plain_i8_attention_q``
    reads."""
    BH, Lq, D = qq.shape
    Lk = kq.shape[1]
    if pv_int8:
        vt = torch.empty_like(v)
        vt[:, :, _key_order(v.shape[2], v.device)] = v
        v = vt[:, :, :Lk].transpose(1, 2)
    else:
        v = v.reshape(BH, Lk, D)
    return (qq, qs.reshape(BH, Lq, 1), kq, ks[:, :Lk].reshape(BH, 1, Lk), v,
            vs.reshape(BH, 1, D))


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of int8-valued tensors as a float matmul: float32
    while every partial sum stays below 2^24, float64 beyond that. Runs on
    any device."""
    dt = (torch.float32 if a.shape[-1] * 127 * 127 < (1 << 24)
          else torch.float64)
    return torch.matmul(a.to(dt), b.to(dt))


def plain_i8_attention_q(qq, qs, kq, ks, vq, vs, *, pv_int8: bool = True,
                         block_kv: int | None = None) -> torch.Tensor:
    """The plain version of the kernel proper, over the operands of
    ``quantize_attn_inputs`` (``plain_operands`` brings the kernel's layout
    back to it): exact integer products, f32 online softmax over key tiles
    of ``block_kv`` (None: one tile), static-127 p quantization.
    -> (BH, Lq, D) float32."""
    BH, Lq, D = qq.shape
    Lk = kq.shape[1]
    bkv = Lk if block_kv is None else int(block_kv)
    m = torch.full((BH, Lq, 1), _NEG, dtype=torch.float32, device=qq.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((BH, Lq, D), dtype=torch.float32, device=qq.device)
    for j0 in range(0, Lk, bkv):
        j1 = min(j0 + bkv, Lk)
        s32 = _int_matmul(qq, kq[:, j0:j1].transpose(1, 2))
        s = s32.to(torch.float32) * qs * ks[:, :, j0:j1]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if pv_int8:
            pq = torch.round(p * 127.0)
            pv = _int_matmul(pq, vq[:, j0:j1]).to(torch.float32)
        else:
            pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32),
                              vq[:, j0:j1].to(torch.float32))
        acc = acc * alpha + pv
        m = m_new
    if not pv_int8:
        return acc / l
    if block_kv is None:  # the reference's order for the untiled form
        return acc / 127.0 / l * vs
    return acc * ((1.0 / 127.0) / l) * vs


def plain_i8_attention(q, k, v, *, scale: float, pv_int8: bool = True,
                       block_kv: int | None = None) -> torch.Tensor:
    """Same-math path: the shared prep, then ``plain_i8_attention_q``.
    (B, H, L, D) -> (B, H, L, D) in q's dtype."""
    B, H, Lq, D = q.shape
    ops = quantize_attn_inputs(q, k, v, scale, pv_int8=pv_int8)
    out = plain_i8_attention_q(*ops, pv_int8=pv_int8, block_kv=block_kv)
    return out.to(q.dtype).reshape(B, H, Lq, D)


def _prep_chunks(BH: int, Lk: int) -> int:
    """Key chunks of the prep's reduction pass: about two blocks a SM of
    the H100 (132), at least 128 keys a chunk."""
    return max(1, min(-(-Lk // 128), -(-264 // BH)))


# q/k/v dtype -> (the kind the C entries take: the prep's input and the
# kernel's output type, the launch counters' suffix)
I8ATTN_DTYPES = {torch.bfloat16: (0, ""), torch.float16: (1, "_f16"),
                 torch.float32: (2, "_f32")}


def i8attn_instance(dtype, pv_int8: bool = True):
    """(type kind, prep counter, kernel counter) of q/k/v of ``dtype``;
    ``NotImplementedError`` for a dtype without instances."""
    if dtype not in I8ATTN_DTYPES:
        raise NotImplementedError(
            f"{dtype}: the int8 attention kernel and its prep have instances "
            f"for "
            f"{', '.join(str(d).replace('torch.', '') for d in I8ATTN_DTYPES)}"
            f" q/k/v (CPU tensors take plain_i8_attention)")
    kind, sfx = I8ATTN_DTYPES[dtype]
    return (kind, "i8attn_prep" + sfx,
            ("i8attn_pv" if pv_int8 else "i8attn_qk") + sfx)


def prep_cuda(q, k, v, *, scale: float, pv_int8: bool = True):
    """Launch the prep kernel (``csrc/i8attn_prep.cu``): what
    ``kernel_operands(quantize_attn_inputs(q, k, v, scale, pv_int8))``
    computes, read from (B, H, L, D) CUDA views of one dtype of
    ``I8ATTN_DTYPES`` (strided views are fine) -> (qq, qs, kq, ks, v, vs) in
    the kernel's layout; in mode "qk" v is the given view (row-aligned),
    rounded to bf16 as ``quantize_attn_inputs`` rounds it."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not q.is_cuda:
        raise ValueError("prep_cuda takes CUDA tensors")
    kind, counter, _ = i8attn_instance(q.dtype, pv_int8)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype} {k.dtype} {v.dtype} "
                         f"differ")
    if k.shape != (B, H, Lk, D) or v.shape != (B, H, Lk, D) or Lk < 1:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    bkv = kernel_block_kv(D)
    BH, Lkp = B * H, -(-Lk // bkv) * bkv
    q, k, v = (_build.row_aligned(t) for t in (q, k, v))
    dev = q.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    qq, qs = empty((BH, Lq, D), torch.int8), empty((BH, Lq), torch.float32)
    kq, ks = empty((BH, Lk, D), torch.int8), empty((BH, Lkp), torch.float32)
    vt = empty((BH, D, Lkp), torch.int8) if pv_int8 else None
    vs = empty((BH, D), torch.float32)
    n_chunks = _prep_chunks(BH, Lk)
    part = empty((BH, n_chunks, 2, D), torch.float32)
    qscale = float(np.float32(_INV127 * np.float32(scale)))
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    rc = _build.lib().i8attn_prep_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, B, H, Lq, Lk, Lkp,
        D, 1 if pv_int8 else 0, qscale, qq.data_ptr(), qs.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), None if vt is None else vt.data_ptr(),
        vs.data_ptr(), part.data_ptr(), n_chunks, kind,
        ctypes.c_void_p(_build.stream_handle(dev)))
    _build.check(rc, "i8attn_prep_launch")
    _build.count(counter)
    if not pv_int8 and v.dtype != torch.bfloat16:
        v = _build.row_aligned(v.to(torch.bfloat16))
    return qq, qs, kq, ks, (vt if pv_int8 else v), vs


def i8_attention_cuda_q(qq, qs, kq, ks, v, vs, *, B: int, H: int,
                        pv_int8: bool = True,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the int8 flash-attention kernel (K6) on operands in the layout
    of ``kernel_operands``: qq (BH, Lq, D) s8, qs (BH, Lq) f32, kq (BH, Lk,
    D) s8, ks (BH, Lkp) f32, vs (BH, D) f32, all contiguous, D a multiple of
    128, Lkp a multiple of ``kernel_block_kv(D)``; v is Vᵀ (BH, D, Lkp) s8 in
    mode "pv", a bf16 (BH, Lk, D) tensor or (B, H, Lk, D) view with unit
    stride along D in mode "qk". Returns (B, H, Lq, D) in ``out_dtype`` (q's
    dtype, one of ``I8ATTN_DTYPES``) whose storage is (B, Lq, H, D), so
    merging heads afterwards is free."""
    BH, Lq, D = qq.shape
    Lk = kq.shape[1]
    if not qq.is_cuda:
        raise ValueError("i8_attention_cuda_q takes CUDA tensors")
    kind, _, counter = i8attn_instance(out_dtype, pv_int8)
    bkv = kernel_block_kv(D)
    Lkp = ks.shape[-1]
    if (BH != B * H or kq.shape != (BH, Lk, D) or Lk < 1
            or qs.shape != (BH, Lq) or ks.shape != (BH, Lkp)
            or Lkp % bkv or Lkp < Lk or vs.shape != (BH, D)):
        raise ValueError(f"operand shapes {tuple(qq.shape)} {tuple(qs.shape)}"
                         f" {tuple(kq.shape)} {tuple(ks.shape)} "
                         f"{tuple(vs.shape)} for B={B} H={H}: want the "
                         f"layout of kernel_operands")
    if pv_int8:
        if (v.shape != (BH, D, Lkp) or v.dtype != torch.int8
                or not v.is_contiguous()):
            raise ValueError(f"v {v.dtype} {tuple(v.shape)}: want the "
                             f"contiguous s8 Vᵀ ({BH}, {D}, {Lkp})")
        st_v = (0, 0, 0)
    else:
        if v.dim() == 3:
            v = v.reshape(B, H, Lk, D)
        if v.shape != (B, H, Lk, D) or v.dtype != torch.bfloat16:
            raise ValueError(f"v {v.dtype} {tuple(v.shape)}: want bf16 "
                             f"({B}, {H}, {Lk}, {D})")
        v = _build.row_aligned(v)
        st_v = v.stride()[:3]
    for t, dt in ((qq, torch.int8), (qs, torch.float32), (kq, torch.int8),
                  (ks, torch.float32), (vs, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError("prepared operands must be contiguous s8 codes "
                             "and f32 scales")
    out = torch.empty((B, Lq, H, D), dtype=out_dtype,
                      device=qq.device).permute(0, 2, 1, 3)
    if Lq:
        strides = (ctypes.c_longlong * 6)(*st_v, *out.stride()[:3])
        rc = _build.lib().i8attn_launch(
            qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
            v.data_ptr(), vs.data_ptr(), out.data_ptr(), B, H, Lq, Lk, Lkp,
            D, 1 if pv_int8 else 0, strides, kind,
            ctypes.c_void_p(_build.stream_handle(qq.device)))
        _build.check(rc, "i8attn_launch")
        _build.count(counter)
    return out


def i8_attention_cuda(q, k, v, *, scale: float,
                      pv_int8: bool = True) -> torch.Tensor:
    """The prep kernel, then the attention kernel. q: (B, H, Lq, D), k/v:
    (B, H, Lk, D) CUDA tensors of one dtype of ``I8ATTN_DTYPES`` (strided
    views are fine), D a multiple of 128 -> (B, H, Lq, D) in q's dtype,
    stored (B, Lq, H, D)."""
    B, H = q.shape[:2]
    if not q.is_cuda:
        raise ValueError("i8_attention_cuda takes CUDA tensors")
    i8attn_instance(q.dtype, pv_int8)
    ops = prep_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    return i8_attention_cuda_q(*ops, B=B, H=H, pv_int8=pv_int8,
                               out_dtype=q.dtype)


def _pick_blocks(Lq, Lk, block_kv=None):
    bq = next((b for b in (BLOCK_Q, 256, 128) if Lq % b == 0), None)
    Lkp = Lk + (-Lk % LANE)
    bkv = next((b for b in (block_kv or BLOCK_KV, 1024, 512, 256, 128)
                if Lkp % b == 0), None)
    return bq, bkv, Lkp


def i8_attention_ok(q, k) -> bool:
    """Gate: self-attention, 128-tileable length, head dim a multiple of
    128. The 128-multiples are the reference's tiling rule for its own
    hardware, not this kernel's (which masks a ragged key tile itself);
    the gate is kept letter for letter so both packages take the same
    route on the same input. The kernel runs every D it admits
    (``kernel_block_kv``)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if Lq != Lk or D % LANE or Lq < 512 or Lk > 8192:
        return False
    bq, bkv, _ = _pick_blocks(Lq, Lk)
    return bq is not None and bkv is not None


def i8_dot_product_attention(q, k, v, *, scale: float,
                             pv_int8: bool = True) -> torch.Tensor:
    """CUDA tensors launch the kernel; CPU tensors take the plain version
    (the reference's same-math form, one global row maximum)."""
    if q.is_cuda:
        return i8_attention_cuda(q, k, v, scale=scale, pv_int8=pv_int8)
    return plain_i8_attention(q, k, v, scale=scale, pv_int8=pv_int8)
