#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``comfyui_gguf_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--depth-double N] [--depth-single N] [--steps N]
                          [--t5-layers N]

It drives the port's main paths — the flux denoise of ``bench.py``'s
configuration, and flux text-to-image end to end (tokenizers, T5-xxl and
CLIP-L encode, denoise, VAE decode) — on the card through the entry points
a user calls, and fails (non-zero exit, no result line) on any failed phase:

1. device: name, count, ``nvidia-smi`` name and power limit; no CUDA device
   is a failure;
2. build: the CUDA kernels are compiled from ``comfyui_gguf_tpu_torch/csrc``
   (one nvcc per source, in parallel) and loaded; ``ptxas`` registers (and,
   for the int8 attention, its prep and the GEMM probes, spills; for the
   fused matmuls each instance's registers and spills, the LoRA instances
   beside the unpatched ones) and the dynamic shared memory of the TMA-fed
   kernels are printed;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the main paths' shapes, with its time (CUDA events over a CUDA
   graph of many launches), the plain version's time, the time of one
   PyTorch library call computing the same product, and the bound (the
   larger of bytes over 3.35 TB/s and operations over the H100 SXM peak).
   K1/K2 run through both of their bodies (split-K for M <= 8, wgmma
   above), and the split-K body must give the same bits twice; K4 runs at
   both of its tile widths, the one ``i8mm_plan`` picks giving the row's
   time, and its library call reads the int8 weight in the TN form
   cuBLASLt's int8 path takes; K6 runs at head dims 128, 256 and 512 (its
   split instance) on the operands of its prep kernel, which is held against the plain prep (q
   and v codes and their scales equal, k codes within one step, two
   launches equal) and timed beside it. The LoRA instances of K1/K2 (both
   bodies) and K4 (the rank term h @ upᵀ in the epilogue) run at the main
   path's shapes against their plain versions with the same rank operands,
   timed beside the unpatched instance; at strength 0 (up scaled by 0) each
   must equal the unpatched launch;
4. tiny end to end, card against CPU: (a) a small flux GGUF mixing Q4_K,
   Q8_0 and Q6_K tensors through ``load_diffusion_model`` and a few Euler
   steps, planar and after ``requantize_i8()``; then with a LoRA of every
   patch type (rank patches on every block linear, LoCon mid, LoHa, GLoRA)
   through ``apply_lora``, planar and after ``requantize_i8()`` and
   ``stack()``; then ``unapply_loras()``, which must give the unpatched
   stacked model's latent exactly; (b) a tiny ``FluxPipeline``
   (flux GGUF, 2-layer T5 Q8_0 GGUF with tokenizer metadata, CLIP and VAE
   safetensors with ``vocab.json``/``merges.txt``, all written by the port's
   own writers) through ``FluxPipeline.load`` and ``generate``, with and
   without ``attention_i8`` at a size inside the int8 gate, then img2img,
   inpainting and a Kontext reference once each, then with the text
   encoders' slices of a LoRA file (``t5.apply_lora``,
   ``clip_l.apply_lora``), and a textual-inversion embedding through an
   ``EmbeddingSet`` on CLIP-L;
5. denoise path: flux-dev width (hidden 3072, 24 heads, 4096 image + 512
   text tokens at 1024²) with random Q4_K weights from a seed, full depth
   (19 + 38 blocks) and bench.py's 20 Euler steps on ``flux_schedule``
   unless the flags cut them, for two requests, on the bf16-fused tree and
   on the w8a8 tree; a w8a8 final latent more than 2e-2 (relative L2) from
   the bf16-fused one of the same request fails. One more forward of each
   tree runs under ``torch.profiler`` for the device-time breakdown;
6. text-to-image path: a ``FluxPipeline`` of seed-made parts at published
   widths — the w8a8 flux-dev tree of phase 5, T5-v1.1-xxl (24 layers,
   Q8_0, made on the card), CLIP-L, the 16-channel AutoencoderKL, synthetic
   32128-piece and 49408-entry vocabularies — generates two prompts at
   1024² with the default attention, then the second again under
   ``attention_i8("pv")`` and ``attention_i8("qk")``. Stage times, peak
   memory and launch counts are printed; a missing launch fails, and so
   does an int8-attention latent or image more than 3e-2 (relative L2)
   from the default-attention one of the same request. One forward under
   ``attention_i8("pv")`` runs under ``torch.profiler`` beside phase 5's;
7. LoRA at full width: a seed-made kohya rank-16 LoRA over the 304 block
   linears of flux-dev (modulations included), written with the port's
   safetensors writer, applied at strength 0.8 to a flat Q4_K tree of
   phase 5's seed, then ``requantize_i8()`` and ``stack()``; phase 6's
   pipeline generates its second prompt with it. The same LoRA at strength
   0 must leave one forward equal to the unpatched model's; the LoRA image
   must launch the LoRA instances of K4 (228 a step) and of the split-K
   body (76 a step) and nothing unpatched in their place, and differ from
   the unpatched image (latent rel L2 > 1e-3). apply_lora seconds, s/step,
   s/image beside the unpatched image's, peak memory and launches are
   printed;
8. the GEMM probe tool ``tools_i8_microbench_cuda.py`` runs as a user runs
   it.

Launch counts are set to 0 just before each driven path and read just
after. The last lines are the card's ``nvidia-smi`` name and power limit,
the kernel table as JSON, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from comfyui_gguf_tpu_torch._timing import (  # noqa: E402
    event_ms, graph_ms, rel_l2)

# H100 SXM published peaks (dense): HBM bytes/s, bf16 and int8 tensor rates
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12

# most relative L2 allowed between the w8a8 and bf16-fused final latents
LATENT_DELTA_MAX = 2e-2
# most relative L2 allowed between an int8-attention final latent or image
# and the default-attention one of the same request
I8ATTN_DELTA_MAX = 3e-2
# special-function results (exp) per SM per clock, compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic-instruction throughput table)
SFU_PER_SM_CLK = 16

PROMPTS = ("a photo of a cat sitting on the moon",
           "an oil painting of a lighthouse in a storm at night")

SOURCES = {
    "qmm_nib4": ("comfyui_gguf_tpu_torch/csrc/qmm.cu",
                 "comfyui_gguf_tpu/ops/qmatmul.py:97"),
    "qmm_int8": ("comfyui_gguf_tpu_torch/csrc/qmm_int8.cu",
                 "comfyui_gguf_tpu/ops/qmatmul.py:169"),
    "qmm_nib4_smallm": ("comfyui_gguf_tpu_torch/csrc/qmm_smallm.cu",
                        "comfyui_gguf_tpu/ops/qmatmul.py:97"),
    "qmm_int8_smallm": ("comfyui_gguf_tpu_torch/csrc/qmm_smallm.cu",
                        "comfyui_gguf_tpu/ops/qmatmul.py:169"),
    "i8mm": ("comfyui_gguf_tpu_torch/csrc/i8mm.cu",
             "comfyui_gguf_tpu/ops/i8mm.py:70"),
    # the LoRA instances: the rank term of the Pallas bodies' epilogues
    "qmm_nib4_lora": ("comfyui_gguf_tpu_torch/csrc/qmm_lora.cu",
                      "comfyui_gguf_tpu/ops/qmatmul.py:117"),
    "qmm_int8_lora": ("comfyui_gguf_tpu_torch/csrc/qmm_int8_lora.cu",
                      "comfyui_gguf_tpu/ops/qmatmul.py:181"),
    "qmm_nib4_smallm_lora": ("comfyui_gguf_tpu_torch/csrc/qmm_smallm.cu",
                             "comfyui_gguf_tpu/ops/qmatmul.py:117"),
    "qmm_int8_smallm_lora": ("comfyui_gguf_tpu_torch/csrc/qmm_smallm.cu",
                             "comfyui_gguf_tpu/ops/qmatmul.py:181"),
    "i8mm_lora": ("comfyui_gguf_tpu_torch/csrc/i8mm_lora.cu",
                  "comfyui_gguf_tpu/ops/i8mm.py:81"),
    "flash_attn": ("comfyui_gguf_tpu_torch/csrc/flash_attn.cu",
                   "comfyui_gguf_tpu/nn/attention.py:168"),
    "i8attn_pv": ("comfyui_gguf_tpu_torch/csrc/i8attn.cu",
                  "comfyui_gguf_tpu/ops/i8attn.py:113"),
    "i8attn_qk": ("comfyui_gguf_tpu_torch/csrc/i8attn.cu",
                  "comfyui_gguf_tpu/ops/i8attn.py:113"),
    "i8attn_prep": ("comfyui_gguf_tpu_torch/csrc/i8attn_prep.cu",
                    "comfyui_gguf_tpu/ops/i8attn.py:76"),
    "gemm_probe_bf16": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                        "tools_i8_microbench.py:37"),
    "gemm_probe_s8": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                      "tools_i8_microbench.py:37"),
    "gemm_probe_w8a8": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                        "tools_i8_microbench.py:66"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# sources whose ptxas lines phase 2 prints per instance: the LoRA
# instances and the unpatched instances beside them
LORA_SOURCES = ("qmm.cu", "qmm_int8.cu", "qmm_lora.cu", "qmm_int8_lora.cu",
                "qmm_smallm.cu", "i8mm.cu", "i8mm_lora.cu", "gemm_probe.cu")


def bound(nbytes: float, ops: float, peak_ops: float):
    return bound_t(nbytes, ops / peak_ops)


def bound_t(nbytes: float, t_ops: float):
    """(ms, "bytes" | "operations") from the bytes moved and the seconds
    the operations take at the card's peak for their types."""
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_ms(fn):
    """Time of one PyTorch library call, or None where this PyTorch build
    refuses the shape (the yardstick is optional; the port never uses
    it)."""
    try:
        return graph_ms([fn])
    except RuntimeError as e:
        log(f"    library call unavailable: {e}".splitlines()[0])
        return None


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(dev, sfu_per_s):
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.nn.attention import (flash_attn_cuda,
                                                     plain_attention)
    from comfyui_gguf_tpu_torch.ops import gemm_probe as gp
    from comfyui_gguf_tpu_torch.ops.i8attn import (i8_attention_cuda_q,
                                                   kernel_block_kv,
                                                   kernel_operands,
                                                   plain_i8_attention_q,
                                                   plain_operands,
                                                   prep_cuda,
                                                   quantize_attn_inputs)
    from comfyui_gguf_tpu_torch.ops.i8mm import i8mm_cuda_q, plain_i8mm
    from comfyui_gguf_tpu_torch.ops.qmatmul import (I8MM_WIDTHS, SMALL_M_MAX,
                                                    i8mm_plan,
                                                    plain_quantized_matmul,
                                                    qmm_cuda, qmm_route)
    from comfyui_gguf_tpu_torch.quant.i8 import quantize_rows, requantize_i8
    from comfyui_gguf_tpu_torch.quant.planar import dequantize_kmajor

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def qmm_case(name, kernel, qtype, M, K, R, act, n_copies, tol,
                 with_bias=True):
        """K1/K2 through the body the dispatch picks for M (``kernel`` must
        name it); the split-K body is also launched twice and must give the
        same bits."""
        ws = [random_planar(qtype, (R, K), gen, device=dev)
              for _ in range(n_copies)]
        small = qmm_route(M, ws[0].padded_in, R,
                          ws[0].layout == "nib4") == "smallm"
        if small != kernel.endswith("_smallm"):
            raise SystemExit(f"{name}: the dispatch did not pick {kernel}")
        x = randn(M, K)
        bias = (torch.randn(R, generator=gen, device=dev) * 0.1
                if with_bias else None)
        got = qmm_cuda(x, ws[0], bias=bias, act_from_col=act)
        want = plain_quantized_matmul(x, ws[0], bias=bias, act_from_col=act)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        ok = bool(torch.isfinite(got).all()) and err <= tol
        if small:
            again = qmm_cuda(x, ws[0], bias=bias, act_from_col=act)
            ok = ok and torch.equal(got, again)
        ms = graph_ms([lambda w=w: qmm_cuda(x, w, bias=bias,
                                            act_from_col=act) for w in ws])
        plain = event_ms(lambda: plain_quantized_matmul(
            x, ws[0], bias=bias, act_from_col=act))
        wd = dequantize_kmajor(ws[0], torch.bfloat16).contiguous()
        lib = library_ms(lambda: torch.matmul(x, wd))
        del wd
        nbytes = (ws[0].nbytes_packed + 2 * M * K + 2 * M * R
                  + (4 * R if with_bias else 0))
        b_ms, b_by = bound(nbytes, 2.0 * M * K * R, PEAK_BF16)
        rows.append(dict(name=name, kernel=kernel, shape=f"M={M} K={K} R={R}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, tol=f"rel L2 <= {tol}", ok=ok, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library="torch.matmul on the dequantized bf16 "
                                 "weight",
                         bound_ms=b_ms, bound_by=b_by))

    def i8_case(name, M, K, R, act):
        """K4 at both tile widths (each within 1 bf16 ulp of the plain
        version); the row's time is the width ``i8mm_plan`` picks."""
        ip = requantize_i8(random_planar(Q.Q4_K, (R, K), gen, device=dev))
        x = randn(M, K)
        bias = torch.randn(R, generator=gen, device=dev) * 0.1
        xq, xs = quantize_rows(x)
        want = plain_i8mm(x, ip, bias=bias, act_from_col=act)
        wf = want.float()
        n_over, err, rel = 0, 0.0, 0.0
        ok = True
        for bn in I8MM_WIDTHS:
            got = i8mm_cuda_q(xq, xs, ip, bias=bias, act_from_col=act, bn=bn)
            torch.cuda.synchronize()
            gf = got.float()
            _, e = torch.frexp(torch.maximum(gf.abs(), wf.abs()))
            ulp = torch.ldexp(torch.ones_like(gf), e - 8)
            n_over += int(((gf - wf).abs() > ulp).sum())
            err = max(err, float((gf - wf).abs().max()))
            rel = max(rel, rel_l2(got, want))
            ok = ok and bool(torch.isfinite(got).all())
        ok = ok and n_over == 0
        tile_ms = {bn: graph_ms([lambda bn=bn: i8mm_cuda_q(
            xq, xs, ip, bias=bias, act_from_col=act, bn=bn)])
            for bn in I8MM_WIDTHS}
        pick = i8mm_plan(M, R)[0]
        plain = event_ms(lambda: plain_i8mm(x, ip, bias=bias,
                                            act_from_col=act))
        # the fair yardstick: B in the TN form cuBLASLt's int8 path reads,
        # the (R, K) K-contiguous codes seen as (K, R); no copy
        w_rk = ip.qs[:R, :K]
        lib = library_ms(lambda: torch._int_mm(xq, w_rk.t()))
        nbytes = M * K + 4 * M + ip.nbytes_packed + 4 * R + 2 * M * R
        b_ms, b_by = bound(nbytes, 2.0 * M * K * R, PEAK_INT8)
        rows.append(dict(name=name, kernel="i8mm",
                         shape=f"M={M} K={K} R={R} bn={pick}",
                         max_abs_err=err, rel_l2=rel, over_1ulp=n_over,
                         tol="<= 1 bf16 ulp at both widths", ok=ok,
                         ms=tile_ms[pick], tile_ms=tile_ms, plain_ms=plain,
                         library_ms=lib,
                         library="torch._int_mm(xq, w_rk.t()) (s8 x s8 -> "
                                 "s32 only, TN)",
                         bound_ms=b_ms, bound_by=b_by))

    def lora_operands(M, R, rank, unpatched):
        """h (M, rank) and the scale-folded upᵀ (rank, R), bf16, as
        lora.rank_factorize gives them; up sized so that the term's RMS is
        a tenth of the unpatched output's, whatever the format's scale: a
        kernel that left the term out would read about 1e-1, twenty times
        the rows' limit."""
        h = randn(M, rank)
        std = 0.1 * float(unpatched.float().pow(2).mean().sqrt()) / rank ** 0.5
        upt = (torch.randn((rank, R), generator=gen, device=dev) * std).to(
            torch.bfloat16)
        return h, upt

    def lora_row(name, kernel, shape, got, want, unpatched, zero_ok, tol,
                 ms, base_ms, plain, lib, nbytes, t_ops, extra_ok=True,
                 act=None):
        gf, wf = got.float(), want.float()
        # what a kernel that left the term out would read: a row that
        # cannot see its own term fails (three times its rel-L2 limit)
        term_rel = rel_l2(want, unpatched)
        ok = (bool(torch.isfinite(got).all()) and zero_ok and extra_ok
              and term_rel >= 3 * (5e-3 if tol == "ulp" else tol))
        row = dict(name=name, kernel=kernel, shape=shape,
                   max_abs_err=float((gf - wf).abs().max()),
                   rel_l2=rel_l2(got, want), term_rel=term_rel,
                   strength0_equal=zero_ok, ms=ms, unpatched_ms=base_ms,
                   plain_ms=plain, library_ms=lib,
                   library="the unpatched row's library call + "
                           "torch.matmul(h, upᵀ)")
        if tol == "ulp":
            # the tensor cores add the rank term onto the rescaled
            # accumulator in their own order and precision: a result moves
            # by one ulp now and then, by more where it is tiny beside its
            # addends or under GELU (1 + tanh cancels for a large negative
            # input). Held to the fused matmuls' rel-L2 limit, at most one
            # value in a thousand beyond one ulp; the counts are recorded
            _, e = torch.frexp(torch.maximum(gf.abs(), wf.abs()))
            over = (gf - wf).abs() > torch.ldexp(torch.ones_like(gf), e - 8)
            n = gf.shape[1] if act is None else act
            row.update(over_1ulp=int(over[:, :n].sum()),
                       over_1ulp_gelu_columns=int(over[:, n:].sum()),
                       tol="rel L2 <= 5e-3, <= 1e-3 of the values over 1 "
                           "bf16 ulp; strength 0 equal to the unpatched "
                           "launch; term >= 3x the rel-L2 limit")
            row["ok"] = (ok and row["rel_l2"] <= 5e-3
                         and float(over.float().mean()) <= 1e-3)
        else:
            row.update(tol=f"rel L2 <= {tol} against an f32 epilogue "
                           f"rounded once; strength 0 equal to the "
                           f"unpatched launch; term >= 3x the limit")
            row["ok"] = ok and row["rel_l2"] <= tol
        row["bound_ms"], row["bound_by"] = bound_t(nbytes, t_ops)
        rows.append(row)

    def qmm_lora_case(name, kernel, qtype, M, K, R, act, rank, n_copies):
        """K1/K2's LoRA instance in the body the dispatch picks for M; the
        unpatched instance is timed at the same shape (the cost of the
        term) and must equal the LoRA instance at strength 0. The plain
        version runs its epilogue in f32 and rounds once, as the kernel
        (and the Pallas kernel's ``_epilogue``) do."""
        ws = [random_planar(qtype, (R, K), gen, device=dev)
              for _ in range(n_copies)]
        x = randn(M, K)
        bias = torch.randn(R, generator=gen, device=dev) * 0.1
        kw = dict(bias=bias, act_from_col=act)
        base = qmm_cuda(x, ws[0], **kw)
        h, upt = lora_operands(M, R, rank, base)
        before = _build.LAUNCHES[kernel]
        got = qmm_cuda(x, ws[0], lora_h=h, lora_up=upt, **kw)
        if _build.LAUNCHES[kernel] != before + 1:
            raise SystemExit(f"{name}: the dispatch did not pick {kernel}")
        want = plain_quantized_matmul(
            x, ws[0], lora_h=h, lora_up=upt, out_dtype=torch.float32,
            **kw).to(torch.bfloat16)
        zero = qmm_cuda(x, ws[0], lora_h=h, lora_up=upt * 0, **kw)
        again = qmm_cuda(x, ws[0], lora_h=h, lora_up=upt, **kw)
        torch.cuda.synchronize()
        ms = graph_ms([lambda w=w: qmm_cuda(x, w, lora_h=h, lora_up=upt,
                                            **kw) for w in ws])
        base_ms = graph_ms([lambda w=w: qmm_cuda(x, w, **kw) for w in ws])
        plain = event_ms(lambda: plain_quantized_matmul(
            x, ws[0], lora_h=h, lora_up=upt, out_dtype=torch.float32,
            **kw).to(torch.bfloat16))
        wd = dequantize_kmajor(ws[0], torch.bfloat16).contiguous()
        lib = library_ms(lambda: (torch.matmul(x, wd), torch.matmul(h, upt)))
        del wd
        nbytes = (ws[0].nbytes_packed + 2 * M * K + 2 * M * R + 4 * R
                  + 2 * rank * (M + R))
        t_ops = (2.0 * M * K * R + 2.0 * M * R * rank) / PEAK_BF16
        lora_row(name, kernel, f"M={M} K={K} R={R} r={rank}", got, want,
                 base, torch.equal(zero, base), 5e-3, ms, base_ms, plain,
                 lib, nbytes, t_ops,
                 extra_ok=not kernel.endswith("smallm_lora")
                 or torch.equal(got, again))

    def i8_lora_case(name, M, K, R, act, rank):
        """K4's LoRA instance at the width i8mm_plan picks, within one bf16
        ulp of the plain version; strength 0 equal to the unpatched
        launch."""
        ip = requantize_i8(random_planar(Q.Q4_K, (R, K), gen, device=dev))
        x = randn(M, K)
        bias = torch.randn(R, generator=gen, device=dev) * 0.1
        xq, xs = quantize_rows(x)
        kw = dict(bias=bias, act_from_col=act)
        base = i8mm_cuda_q(xq, xs, ip, **kw)
        h, upt = lora_operands(M, R, rank, base)
        got = i8mm_cuda_q(xq, xs, ip, lora_h=h, lora_up=upt, **kw)
        want = plain_i8mm(x, ip, lora_h=h, lora_up=upt, **kw)
        zero = i8mm_cuda_q(xq, xs, ip, lora_h=h, lora_up=upt * 0, **kw)
        torch.cuda.synchronize()
        ms = graph_ms([lambda: i8mm_cuda_q(xq, xs, ip, lora_h=h,
                                           lora_up=upt, **kw)])
        base_ms = graph_ms([lambda: i8mm_cuda_q(xq, xs, ip, **kw)])
        plain = event_ms(lambda: plain_i8mm(x, ip, lora_h=h, lora_up=upt,
                                            **kw))
        w_rk = ip.qs[:R, :K]
        lib = library_ms(lambda: (torch._int_mm(xq, w_rk.t()),
                                  torch.matmul(h, upt)))
        nbytes = (M * K + 4 * M + ip.nbytes_packed + 4 * R + 2 * M * R
                  + 2 * rank * (M + R))
        t_ops = 2.0 * M * K * R / PEAK_INT8 + 2.0 * M * R * rank / PEAK_BF16
        lora_row(name, "i8mm_lora",
                 f"M={M} K={K} R={R} r={rank} bn={i8mm_plan(M, R)[0]}", got,
                 want, base, torch.equal(zero, base), "ulp", ms, base_ms,
                 plain, lib, nbytes, t_ops, act=act)

    def attn_case(name, B, H, Lq, Lk, D):
        q, k, v = randn(B, H, Lq, D), randn(B, H, Lk, D), randn(B, H, Lk, D)
        scale = D ** -0.5
        got = flash_attn_cuda(q, k, v, scale)
        want = plain_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        ok = bool(torch.isfinite(got).all()) and err <= 1e-2
        ms = graph_ms([lambda: flash_attn_cuda(q, k, v, scale)])
        plain = event_ms(lambda: plain_attention(q, k, v, scale), reps=2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = library_ms(lambda: sdpa(q, k, v, scale=scale))
        nbytes = 2 * B * H * D * (2 * Lq + 2 * Lk)
        b_ms, b_by = bound(nbytes, 4.0 * B * H * Lq * Lk * D, PEAK_BF16)
        rows.append(dict(name=name, kernel="flash_attn",
                         shape=f"B={B} H={H} Lq={Lq} Lk={Lk} D={D}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, tol="rel L2 <= 1e-2", ok=ok, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library="scaled_dot_product_attention",
                         bound_ms=b_ms, bound_by=b_by))

    def i8attn_case(name, mode, B, H, L, D=128):
        """K6 on the operands of its prep kernel, against the plain version
        at the kernel's own key tile; the prep kernel and the plain prep
        (``quantize_attn_inputs``) are timed beside it."""
        pv, bkv = mode == "pv", kernel_block_kv(D)
        q, v = randn(B, H, L, D), randn(B, H, L, D)
        k = randn(B, H, L, D) + 1.0  # a token mean for the prep to remove
        scale = D ** -0.5
        ops = prep_cuda(q, k, v, scale=scale, pv_int8=pv)
        got = i8_attention_cuda_q(*ops, B=B, H=H, pv_int8=pv)
        pops = plain_operands(*ops, pv_int8=pv)
        want = plain_i8_attention_q(
            *pops, pv_int8=pv, block_kv=bkv).to(
                torch.bfloat16).reshape(B, H, L, D)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        exact = rel_l2(got, plain_attention(q, k, v, scale))
        ok = (bool(torch.isfinite(got).all()) and err <= 2e-3
              and exact <= 3.5e-2)
        ms = graph_ms([lambda: i8_attention_cuda_q(*ops, B=B, H=H,
                                                   pv_int8=pv)])
        prep = graph_ms([lambda: prep_cuda(q, k, v, scale=scale,
                                           pv_int8=pv)])
        prep_plain = graph_ms([lambda: quantize_attn_inputs(
            q, k, v, scale, pv_int8=pv)])
        plain = event_ms(lambda: plain_i8_attention_q(
            *pops, pv_int8=pv, block_kv=bkv), reps=2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = library_ms(lambda: sdpa(q, k, v, scale=scale))
        BH = B * H
        # s8 q and k, s8 or bf16 v, the f32 scales, the bf16 output
        nbytes = (BH * L * D * (2 + (1 if pv else 2)) + 4 * BH * (2 * L + D)
                  + 2 * BH * L * D)
        half = 2.0 * BH * L * L * D
        t_ops = half / PEAK_INT8 + half / (PEAK_INT8 if pv else PEAK_BF16)
        b_ms, b_by = bound_t(nbytes, t_ops)
        rows.append(dict(name=name, kernel=f"i8attn_{mode}",
                         shape=f"B={B} H={H} L={L} D={D}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, rel_l2_vs_exact=exact,
                         tol=f"rel L2 <= 2e-3 vs plain at {bkv}-key tiles, "
                             f"<= 3.5e-2 vs exact attention",
                         ok=ok, ms=ms, prep_ms=prep,
                         prep_plain_ms=prep_plain, plain_ms=plain,
                         library_ms=lib,
                         library="scaled_dot_product_attention on the bf16 "
                                 "q/k/v",
                         bound_ms=b_ms, bound_by=b_by,
                         exp_floor_ms=BH * L * L / sfu_per_s * 1e3))

    def prep_case(name, mode, B, H, L, D=128):
        """The prep kernel against the plain prep: q and v codes and their
        scales equal, k codes within one step (torch sums k's mean in
        another order; the share that differs is recorded), two launches
        equal."""
        pv = mode == "pv"
        q, v = randn(B, H, L, D), randn(B, H, L, D)
        k = randn(B, H, L, D) + 1.0
        scale = D ** -0.5
        got = prep_cuda(q, k, v, scale=scale, pv_int8=pv)
        again = prep_cuda(q, k, v, scale=scale, pv_int8=pv)
        want = kernel_operands(*quantize_attn_inputs(q, k, v, scale,
                                                     pv_int8=pv),
                               pv_int8=pv)
        torch.cuda.synchronize()
        dk = (got[2].int() - want[2].int()).abs()
        k_share = float(dk.count_nonzero()) / dk.numel()
        ks_rel = float(((got[3] - want[3]).abs()
                        / want[3].abs().clamp_min(1e-30)).max())
        v_eq = (torch.equal(got[4], want[4]) if pv else
                torch.equal(got[4].reshape(want[4].shape), want[4]))
        ok = (all(torch.equal(a, b) for a, b in zip(got, again))
              and torch.equal(got[0], want[0])
              and torch.equal(got[1], want[1])
              and torch.equal(got[5], want[5]) and v_eq
              and int(dk.max()) <= 1 and k_share <= 1e-3
              and ks_rel <= 1e-6)
        ms = graph_ms([lambda: prep_cuda(q, k, v, scale=scale, pv_int8=pv)])
        plain = graph_ms([lambda: quantize_attn_inputs(q, k, v, scale,
                                                       pv_int8=pv)])
        BH = B * H
        # q, k and ("pv") v read once (bf16); the s8 codes, the scales
        # written once
        nbytes = (2 * BH * L * D * (3 if pv else 2)
                  + BH * L * D * (3 if pv else 2) + 4 * BH * (2 * L + D))
        b_ms, b_by = bound_t(nbytes, 0.0)
        rows.append(dict(name=name, kernel="i8attn_prep",
                         shape=f"B={B} H={H} L={L} D={D}",
                         max_abs_err=float(dk.max()), rel_l2=0.0,
                         k_codes_off_by_one=k_share, ks_max_rel=ks_rel,
                         tol="q, v codes and qs, vs equal; k codes within 1 "
                             "on <= 1e-3 of them, ks within 1e-6 relative; "
                             "two launches equal",
                         ok=ok, ms=ms, plain_ms=plain, library_ms=None,
                         library="none (no one PyTorch call quantizes)",
                         bound_ms=b_ms, bound_by=b_by))

    def probe_case(name, kernel, run, want, exact, lib_fn, lib, nbytes,
                   peak):
        """K8 at both block-tile widths; the faster one is the row's time."""
        M, K, R = 4096, 3072, 12288
        got = {bn: run(bn) for bn in gp.TILES}
        torch.cuda.synchronize()
        errs = {bn: rel_l2(o, want) for bn, o in got.items()}
        ok = all(bool(torch.isfinite(o).all()) for o in got.values()) and (
            all(torch.equal(o, want) for o in got.values()) if exact
            else max(errs.values()) <= 5e-3)
        tile_ms = {bn: graph_ms([lambda bn=bn: run(bn)]) for bn in gp.TILES}
        best = min(tile_ms, key=tile_ms.get)
        b_ms, b_by = bound(nbytes, 2.0 * M * K * R, peak)
        rows.append(dict(name=name, kernel=kernel,
                         shape=f"M={M} K={K} R={R} bn={best}",
                         max_abs_err=max(float((o.float() - want.float())
                                               .abs().max())
                                         for o in got.values()),
                         rel_l2=max(errs.values()),
                         tol="equal" if exact else "rel L2 <= 5e-3", ok=ok,
                         ms=tile_ms[best], tile_ms=tile_ms,
                         plain_ms=None, library_ms=library_ms(lib_fn),
                         library=lib, bound_ms=b_ms, bound_by=b_by))
        return rows[-1]

    def probe_cases():
        M, K, R = 4096, 3072, 12288
        xb, wb = randn(M, K), randn(K, R)
        x8 = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        w8 = torch.randint(-127, 128, (K, R), generator=gen, device=dev,
                           dtype=torch.int8)
        # the s8 probes read w (R, K), K contiguous (the model's int8 weight
        # layout), and so does the library yardstick, seen as (K, R): TN
        w8_rk = w8.t().contiguous()
        xs = torch.rand((M, 128), generator=gen, device=dev) * 1e-3 + 1e-3
        ws = torch.rand((1, R), generator=gen, device=dev) * 1e-3 + 1e-3
        r = probe_case("gemm_probe_bf16", "gemm_probe_bf16",
                       lambda bn: gp.probe_bf16(xb, wb, bn=bn),
                       gp.plain_probe_bf16(xb, wb), False,
                       lambda: torch.matmul(xb, wb), "torch.matmul",
                       2 * (M * K + K * R + M * R), PEAK_BF16)
        r["plain_ms"] = event_ms(lambda: gp.plain_probe_bf16(xb, wb))
        r = probe_case("gemm_probe_s8", "gemm_probe_s8",
                       lambda bn: gp.probe_s8(x8, w8_rk, bn=bn),
                       gp.plain_probe_s8(x8, w8_rk), True,
                       lambda: torch._int_mm(x8, w8_rk.t()),
                       "torch._int_mm(x8, w8_rk.t()) (s8 x s8 -> s32, TN, "
                       "no bf16 cast)",
                       M * K + K * R + 2 * M * R, PEAK_INT8)
        r["plain_ms"] = event_ms(lambda: gp.plain_probe_s8(x8, w8_rk))
        r = probe_case("gemm_probe_w8a8", "gemm_probe_w8a8",
                       lambda bn: gp.probe_w8a8(x8, w8_rk, xs, ws, bn=bn),
                       gp.plain_probe_w8a8(x8, w8_rk, xs, ws), True,
                       lambda: torch._int_mm(x8, w8_rk.t()),
                       "torch._int_mm(x8, w8_rk.t()) (s8 x s8 -> s32 only, "
                       "TN, no rescale)",
                       M * K + K * R + 4 * (M + R) + 2 * M * R, PEAK_INT8)
        r["plain_ms"] = event_ms(lambda: gp.plain_probe_w8a8(x8, w8_rk, xs,
                                                             ws))

    # K1 split-K body: the double-block modulation at M=1 (weights cold:
    # enough copies to exceed the L2), batched at M=2 and at the limit, and
    # the single-block modulation
    qmm_case("qmm_nib4 mod M=1 3072->18432 Q4_K", "qmm_nib4_smallm", Q.Q4_K,
             1, 3072, 18432, None, 4, 5e-3)
    qmm_case("qmm_nib4 mod M=2 3072->18432 Q4_K", "qmm_nib4_smallm", Q.Q4_K,
             2, 3072, 18432, None, 2, 5e-3)
    qmm_case(f"qmm_nib4 mod M={SMALL_M_MAX} 3072->18432 Q4_K",
             "qmm_nib4_smallm", Q.Q4_K, SMALL_M_MAX, 3072, 18432, None, 2,
             5e-3)
    qmm_case("qmm_nib4 mod M=1 3072->9216 Q4_K", "qmm_nib4_smallm", Q.Q4_K,
             1, 3072, 9216, None, 4, 5e-3)
    qmm_case("qmm_nib4 ragged M=3 2992->3000 Q4_K gelu@1500",
             "qmm_nib4_smallm", Q.Q4_K, 3, 2992, 3000, 1500, 2, 5e-3)
    # K2 split-K body: a Q6_K modulation of a mixed file
    qmm_case("qmm_int8 mod M=1 3072->18432 Q6_K", "qmm_int8_smallm", Q.Q6_K,
             1, 3072, 18432, None, 2, 5e-3)
    qmm_case("qmm_int8 ragged M=3 2992->3000 Q5_K gelu@1500",
             "qmm_int8_smallm", Q.Q5_K, 3, 2992, 3000, 1500, 2, 5e-3)
    # the wgmma body at its smallest M, and ragged (odd M, R no multiple of
    # 128, K < Kp)
    qmm_case(f"qmm_nib4 mod M={SMALL_M_MAX + 1} 3072->18432 Q4_K",
             "qmm_nib4", Q.Q4_K, SMALL_M_MAX + 1, 3072, 18432, None, 2, 5e-3)
    qmm_case("qmm_nib4 ragged M=131 2992->3000 Q4_K gelu@1500", "qmm_nib4",
             Q.Q4_K, 131, 2992, 3000, 1500, 1, 5e-3)
    qmm_case("qmm_int8 ragged M=131 2992->3000 Q5_K gelu@1500", "qmm_int8",
             Q.Q5_K, 131, 2992, 3000, 1500, 1, 5e-3)
    # K1 on the bf16-fused path: img qkv and the single-block linear1
    qmm_case("qmm_nib4 qkv M=4096 3072->9216 Q4_K", "qmm_nib4", Q.Q4_K,
             4096, 3072, 9216, None, 1, 5e-3)
    qmm_case("qmm_nib4 linear1 M=4608 3072->21504 Q4_K gelu@9216",
             "qmm_nib4", Q.Q4_K, 4608, 3072, 21504, 9216, 1, 5e-3)
    # K2: Q8_0 at M=4608, 3072->3072
    qmm_case("qmm_int8 M=4608 3072->3072 Q8_0", "qmm_int8", Q.Q8_0,
             4608, 3072, 3072, None, 1, 5e-3)
    # K4: the w8a8 block linears
    i8_case("i8mm linear1 M=4608 3072->21504 gelu@9216", 4608, 3072, 21504,
            9216)
    i8_case("i8mm linear2 M=4608 15360->3072", 4608, 15360, 3072, None)
    i8_case("i8mm img qkv M=4096 3072->9216", 4096, 3072, 9216, None)
    i8_case("i8mm img mlp.0 M=4096 3072->12288 gelu", 4096, 3072, 12288, 0)
    # K4 on the text stream of the double blocks (512 tokens)
    i8_case("i8mm txt qkv M=512 3072->9216", 512, 3072, 9216, None)
    i8_case("i8mm txt mlp.0 M=512 3072->12288 gelu", 512, 3072, 12288, 0)
    # the LoRA instances at the main path's shapes: K4 on the single-block
    # linear1 (one LoRA, and two stacked: 16 + 64) and the text qkv; K1's
    # split-K body on the double-block modulation and its wgmma body on the
    # bf16-fused img qkv; K2 on a T5 projection and a Q6_K modulation
    i8_lora_case("i8mm_lora linear1 M=4608 3072->21504 gelu@9216 r=16",
                 4608, 3072, 21504, 9216, 16)
    i8_lora_case("i8mm_lora linear1 M=4608 3072->21504 gelu@9216 r=16+64",
                 4608, 3072, 21504, 9216, 80)
    i8_lora_case("i8mm_lora txt qkv M=512 3072->9216 r=16", 512, 3072, 9216,
                 None, 16)
    qmm_lora_case("qmm_nib4_smallm_lora mod M=1 3072->18432 Q4_K r=16",
                  "qmm_nib4_smallm_lora", Q.Q4_K, 1, 3072, 18432, None, 16,
                  4)
    qmm_lora_case("qmm_nib4_lora qkv M=4096 3072->9216 Q4_K r=16",
                  "qmm_nib4_lora", Q.Q4_K, 4096, 3072, 9216, None, 16, 1)
    qmm_lora_case("qmm_int8_lora T5 q M=512 4096->4096 Q8_0 r=16",
                  "qmm_int8_lora", Q.Q8_0, 512, 4096, 4096, None, 16, 4)
    qmm_lora_case("qmm_int8_smallm_lora mod M=1 3072->18432 Q6_K r=16",
                  "qmm_int8_smallm_lora", Q.Q6_K, 1, 3072, 18432, None, 16,
                  2)
    # K7: flux joint attention, an odd length at D=64, and Lq != Lk
    attn_case("flash_attn flux L=4608 D=128", 1, 24, 4608, 4608, 128)
    attn_case("flash_attn odd L=4250 D=64", 1, 24, 4250, 4250, 64)
    attn_case("flash_attn cross Lq=4096 Lk=512 D=128", 1, 24, 4096, 512,
              128)
    # K2 at the T5-xxl shapes (M = 512 tokens, no bias; enough copies of
    # each weight to exceed the L2 cache, as 24 layers of them do)
    qmm_case("qmm_int8 T5 q/k/v/o M=512 4096->4096 Q8_0", "qmm_int8", Q.Q8_0,
             512, 4096, 4096, None, 4, 5e-3, with_bias=False)
    qmm_case("qmm_int8 T5 wi M=512 4096->10240 Q8_0", "qmm_int8", Q.Q8_0,
             512, 4096, 10240, None, 2, 5e-3, with_bias=False)
    qmm_case("qmm_int8 T5 wo M=512 10240->4096 Q8_0", "qmm_int8", Q.Q8_0,
             512, 10240, 4096, None, 2, 5e-3, with_bias=False)
    # K6: the flux joint shape, a gated length that is no multiple of a
    # 512- or 1024-key tile, a small batched shape, head dim 256 at the flux
    # length (12 heads of the same width), and head dim 512 (the split
    # instance of every head dim past 256; no ported model has one, so a
    # small shape); both modes. Its prep kernel against the plain prep at
    # the flux shape and at D = 256 and 512.
    for mode in ("pv", "qk"):
        i8attn_case(f"i8attn_{mode} flux L=4608 D=128", mode, 1, 24, 4608)
        i8attn_case(f"i8attn_{mode} L=4480 D=128", mode, 1, 24, 4480)
        i8attn_case(f"i8attn_{mode} B=2 H=4 L=512 D=128", mode, 2, 4, 512)
        i8attn_case(f"i8attn_{mode} H=12 L=4608 D=256", mode, 1, 12, 4608,
                    256)
        i8attn_case(f"i8attn_{mode} H=4 L=2048 D=512", mode, 1, 4, 2048, 512)
        prep_case(f"i8attn_prep {mode} flux L=4608 D=128", mode, 1, 24, 4608)
    prep_case("i8attn_prep pv H=12 L=4608 D=256", "pv", 1, 12, 4608, 256)
    prep_case("i8attn_prep pv H=4 L=2048 D=512", "pv", 1, 4, 2048, 512)
    # K8: the probes at the tool's problem size
    probe_cases()
    return rows


# ---------------------------------------------------------------------------
# phase 4: tiny end to end through the normal entry, card against CPU
# ---------------------------------------------------------------------------

def tiny_e2e_phase(dev):
    import torch

    from comfyui_gguf_tpu_torch import _build, _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
    from comfyui_gguf_tpu_torch.sampling import euler_sample, flux_schedule

    dims = testing.TinyFluxDims(hidden=512, heads=4, depth_double=2,
                                depth_single=2, axes_dim=(16, 56, 56))

    def mixed(key, arr):  # a Q4_K_M-like mix with Q8_0 and Q6_K tensors
        q = testing.flux_block_qtype(key, arr, Q.Q4_K)
        if q is None:
            return None
        if "img_mod" in key or ".modulation." in key or "attn.proj" in key:
            return Q.Q8_0
        if "mlp.2" in key or "linear2" in key:
            return Q.Q6_K
        return q

    out = {}
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "tiny_flux_mixed.gguf")
    testing.write_flux_gguf(testing.flux_state_dict(dims, seed=0), path,
                            mixed)
    # a LoRA of every patch type: rank patches on every block linear, the
    # modulations included; a LoCon mid, a LoHa (the unfused path), a GLoRA
    lora_path = os.path.join(tmp.name, "tiny_lora.safetensors")
    _safetensors.save_file(testing.flux_mixed_lora_state_dict(dims, seed=7),
                           lora_path)
    gpu = load_diffusion_model(path)
    cpu = load_diffusion_model(path, device="cpu")
    steps, h_lat = 3, 16
    inputs = {d: testing.flux_example_inputs(dims, h_lat=h_lat, w_lat=h_lat,
                                             txt_len=16, seed=5, device=d)
              for d in ("cuda", "cpu")}
    sigmas = flux_schedule(steps, (h_lat // 2) ** 2)

    def run(model, dev_name):
        img, ids, txt, tids, _, y, g = inputs[dev_name]

        def vel(x, s):
            return model.forward(x, ids, txt, tids, s.expand(x.shape[0]), y,
                                 g)
        return euler_sample(vel, img, sigmas)

    def both(tree):
        _build.reset_launch_counts()
        a = run(gpu, "cuda")
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        b = run(cpu, "cpu")
        err = rel_l2(a.float().cpu(), b.float())
        finite = bool(torch.isfinite(a).all())
        out[tree] = dict(rel_l2_vs_cpu=err, launches=counts, finite=finite)
        log(f"  tiny {tree}: {steps} Euler steps, card vs CPU plain rel L2 "
            f"{err:.3e}, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not finite or err > 3e-2:
            raise SystemExit(f"tiny end to end ({tree}) disagrees with the "
                             f"CPU plain path: rel L2 {err}")
        return a

    base = both("planar")
    models = (gpu, cpu)
    gpu, cpu = (m.requantize_i8() for m in (
        load_diffusion_model(path), load_diffusion_model(path,
                                                         device="cpu")))
    both("w8a8")
    gpu = gpu.stack()
    _build.reset_launch_counts()
    unpatched = run(gpu, "cuda")  # the stacked w8a8 tree, no LoRA
    torch.cuda.synchronize()
    out["w8a8_stacked"] = dict(launches=dict(_build.LAUNCHES))
    # the user's order: apply_lora, then requantize_i8() and stack()
    gpu, cpu = models
    for m in models:
        m.apply_lora(lora_path, strength=0.8)
    moved = rel_l2(both("planar_lora").float(), base.float())
    out["planar_lora"]["rel_l2_vs_unpatched"] = moved
    gpu, cpu = (m.requantize_i8().stack() for m in models)
    both("w8a8_lora_stacked")
    gpu.unapply_loras()
    _build.reset_launch_counts()
    a = run(gpu, "cuda")
    torch.cuda.synchronize()
    out["w8a8_unapplied"] = dict(launches=dict(_build.LAUNCHES),
                                 equal_to_unpatched=torch.equal(a, unpatched))
    tmp.cleanup()
    log(f"  tiny LoRA: the planar latent moved by rel L2 {moved:.3e}; after "
        f"unapply_loras() the stacked w8a8 latent equals the unpatched "
        f"model's: {out['w8a8_unapplied']['equal_to_unpatched']}")
    if not moved > 1e-3:
        raise SystemExit(f"tiny LoRA did not move the latent ({moved})")
    if not out["w8a8_unapplied"]["equal_to_unpatched"]:
        raise SystemExit("unapply_loras() did not restore the unpatched "
                         "latent")
    # Q4_K txt_mod and Q8_0 img_mod at M=1 take the split-K bodies, the
    # token-facing Q4_K / Q8_0 / Q6_K linears the wgmma bodies; patched,
    # their LoRA instances (the LoHa'd linear2 of the single blocks takes
    # the unfused path, the unpatched instance)
    need = {"planar": ("qmm_nib4", "qmm_int8", "qmm_nib4_smallm",
                       "qmm_int8_smallm", "flash_attn"),
            "planar_lora": ("qmm_nib4_lora", "qmm_int8_lora",
                            "qmm_nib4_smallm_lora", "qmm_int8_smallm_lora",
                            "qmm_int8"),
            "w8a8_lora_stacked": ("i8mm_lora", "qmm_nib4_smallm_lora",
                                  "qmm_int8_smallm_lora", "i8mm"),
            "w8a8": ("qmm_nib4_smallm", "qmm_int8_smallm", "i8mm",
                     "flash_attn")}
    for tree, kernels in need.items():
        for k in kernels:
            if out[tree]["launches"][k] == 0:
                raise SystemExit(f"tiny {tree} run launched no {k}")
    if any(n for k, n in out["w8a8_unapplied"]["launches"].items()
           if k.endswith("_lora")):
        raise SystemExit("the unapplied model still launched a LoRA "
                         "instance")
    return out


def tiny_pipeline_phase(dev):
    """A tiny FluxPipeline from files written by the port's own writers,
    through ``FluxPipeline.load`` and ``generate``; card against CPU."""
    import numpy as np
    import torch

    import dataclasses

    from comfyui_gguf_tpu_torch import _build, _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import clip as clip_model
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.attention import attention_i8
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline
    from comfyui_gguf_tpu_torch.textual_inversion import (TOKEN_TABLE_KEY,
                                                          EmbeddingSet)

    # head dim 128 and 256 image + 256 text tokens: inside the int8 gate
    dims = testing.TinyFluxDims(hidden=512, heads=4, ctx=512, vec=64,
                                depth_double=1, depth_single=2,
                                axes_dim=(16, 56, 56))
    size, t5_len, steps = 256, 256, 2
    n_attn = (dims.depth_double + dims.depth_single) * steps
    with tempfile.TemporaryDirectory() as tmp:
        unet = os.path.join(tmp, "tiny_flux.gguf")
        testing.write_flux_gguf(
            testing.flux_state_dict(dims, seed=0), unet,
            lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
        t5 = os.path.join(tmp, "tiny_t5.gguf")
        testing.write_t5_gguf(
            testing.t5_state_dict(testing.T5Dims(
                d_model=dims.ctx, d_kv=64, n_heads=8, d_ff=1024, n_layers=2,
                vocab=128), seed=1),
            t5, qtype=Q.Q8_0, tokenizer=testing.unigram_spec(128))
        clip_dir = os.path.join(tmp, "clip")
        os.mkdir(clip_dir)
        clip = os.path.join(clip_dir, "clip_l.safetensors")
        _safetensors.save_file(testing.clip_state_dict(testing.CLIPDims(
            hidden=128, n_layers=2, n_heads=2, intermediate=256, vocab=600,
            max_positions=77, proj=dims.vec), seed=2), clip)
        testing.write_clip_vocab(clip_dir, *testing.clip_vocab(600))
        vae = os.path.join(tmp, "tiny_ae.safetensors")
        _safetensors.save_file(testing.vae_state_dict(testing.VAEDims(
            z_channels=dims.in_ch // 4, base_ch=32), seed=3), vae)
        gpu = FluxPipeline.load(unet, t5, clip, vae)
        cpu = FluxPipeline.load(unet, t5, clip, vae, device="cpu")

    kw = dict(width=size, height=size, steps=steps, max_t5_len=t5_len)
    img = gpu.generate(PROMPTS[0], seed=3, **kw)  # the user's call
    if img.shape != (size, size, 3) or not bool((img == img).all()):
        raise SystemExit("tiny pipeline: generate gave a misshapen or "
                         "non-finite image")
    noise = torch.randn((1, size // 8, size // 8, dims.in_ch // 4),
                        generator=torch.Generator().manual_seed(3))
    out = {}
    for mode in ("", "pv", "qk"):
        with attention_i8(mode):
            _build.reset_launch_counts()
            a = gpu.generate_from_noise(PROMPTS[0], noise, **kw)
            counts = dict(_build.LAUNCHES)
            b = cpu.generate_from_noise(PROMPTS[0], noise, **kw)
        err = rel_l2(torch.from_numpy(a), torch.from_numpy(b))
        out[mode or "bf16"] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  tiny pipeline attention_i8({mode!r}): {size}² image, card vs "
            f"CPU plain rel L2 {err:.3e}, launches {counts}")
        if not err <= 3e-2:
            raise SystemExit(f"tiny pipeline ({mode!r}) disagrees with the "
                             f"CPU plain path: rel L2 {err}")
        want = {"flash_attn": 0 if mode else n_attn,
                "i8attn_pv": n_attn if mode == "pv" else 0,
                "i8attn_qk": n_attn if mode == "qk" else 0,
                "i8attn_prep": n_attn if mode else 0}
        for k, n in want.items():
            if counts[k] != n:
                raise SystemExit(f"tiny pipeline ({mode!r}): {counts[k]} "
                                 f"launches of {k}, expected {n}")
        if counts["qmm_int8"] < 14:  # 7 linears x 2 T5 layers
            raise SystemExit("tiny pipeline: the T5 launched no qmm_int8")

    # the other request kinds once each (the VAE encode runs on the card):
    # img2img, inpainting with handed-in step noise, a Kontext reference
    rng = torch.Generator().manual_seed(4)
    init = torch.rand((size, size, 3), generator=rng).numpy()
    mask = np.zeros((size, size), dtype=np.float32)
    mask[: size // 2] = 1.0

    def step_noise(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            100 + i))

    kinds = {"img2img": dict(init_image=init, denoise=0.5),
             "inpaint": dict(init_image=init, denoise=1.0, inpaint_mask=mask,
                             step_noise=step_noise),
             "kontext": dict(ref_images=[init])}
    kw["steps"] = 4
    for kind, extra in kinds.items():
        _build.reset_launch_counts()
        a = gpu.generate_from_noise(PROMPTS[1], noise, **kw, **extra)
        counts = dict(_build.LAUNCHES)
        b = cpu.generate_from_noise(PROMPTS[1], noise, **kw, **extra)
        err = rel_l2(torch.from_numpy(a), torch.from_numpy(b))
        out[kind] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  tiny pipeline {kind}: card vs CPU plain rel L2 {err:.3e}, "
            f"{counts['flash_attn']} flash_attn launches")
        if not err <= 3e-2 or counts["flash_attn"] == 0:
            raise SystemExit(f"tiny pipeline {kind} disagrees with the CPU "
                             f"plain path: rel L2 {err}")

    # the text encoders' slices of a LoRA file (lora_te1_ on CLIP-L,
    # lora_te3_ on the Q8_0 T5, whose patched linears launch K2's LoRA
    # instance), then a textual-inversion embedding on CLIP-L
    with tempfile.TemporaryDirectory() as tmp:
        te_path = os.path.join(tmp, "te_lora.safetensors")
        sd = testing.kohya_lora_state_dict(
            testing.encoder_lora_targets(cpu.clip_l.params), rank=8,
            alpha=8.0, seed=5, std=0.2, prefix="lora_te1_")
        t5_targets = testing.encoder_lora_targets(cpu.t5.params)
        sd.update(testing.kohya_lora_state_dict(
            t5_targets, rank=16, alpha=16.0, seed=6, std=0.05,
            prefix="lora_te3_"))
        _safetensors.save_file(sd, te_path)
        emb_path = os.path.join(tmp, "cat.safetensors")
        _safetensors.save_file({"clip_l": torch.randn(
            (2, cpu.clip_l.config.hidden),
            generator=torch.Generator().manual_seed(9))}, emb_path)
        kw["steps"] = 2
        for p in (gpu, cpu):
            p.t5.apply_lora(te_path, strength=0.8)
            p.clip_l.apply_lora(te_path, strength=0.8)
        _build.reset_launch_counts()
        a = gpu.generate_from_noise(PROMPTS[0], noise, **kw)
        counts = dict(_build.LAUNCHES)
        b = cpu.generate_from_noise(PROMPTS[0], noise, **kw)
        err = rel_l2(torch.from_numpy(a), torch.from_numpy(b))
        out["te_lora"] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  tiny pipeline with text-encoder LoRA ({len(t5_targets)} T5 "
            f"and {len(sd) // 3 - len(t5_targets)} CLIP linears patched): "
            f"card vs CPU plain rel L2 {err:.3e}, "
            f"{counts['qmm_int8_lora']} qmm_int8_lora launches")
        if not err <= 3e-2:
            raise SystemExit(f"tiny pipeline with text-encoder LoRA "
                             f"disagrees with the CPU: rel L2 {err}")
        if counts["qmm_int8_lora"] != len(t5_targets):
            raise SystemExit(f"the patched T5 launched "
                             f"{counts['qmm_int8_lora']} qmm_int8_lora, "
                             f"expected {len(t5_targets)}")
        pooled = []
        for p in (gpu, cpu):
            es = EmbeddingSet(p.clip_l.params, hidden=p.clip_l.config.hidden,
                              slot="clip_l")
            es.register("cat", emb_path)
            ids = es.encode(p.clip_l.tokenizer,
                            "a photo of embedding:cat on the moon", 77)
            # pool at the first EOS: the embedding's ids lie above it
            cfg = dataclasses.replace(
                p.clip_l.config, eos_token_id=p.clip_l.tokenizer.eos_id)
            with torch.no_grad():
                pooled.append(clip_model.encode(
                    es.params, cfg, torch.as_tensor(ids).to(
                        es.params[TOKEN_TABLE_KEY].device),
                    qcfg=p.clip_l.qcfg)["pooled"].float().cpu())
        err = rel_l2(*pooled)
        out["embedding"] = dict(rel_l2_vs_cpu=err, ids=ids.tolist(),
                                launches={})
        log(f"  textual inversion on CLIP-L: ids {ids[0, :10].tolist()}..., "
            f"pooled card vs CPU rel L2 {err:.3e}")
        if not err <= 3e-2 or int(ids.max()) < cpu.clip_l.config.vocab_size:
            raise SystemExit(f"textual inversion: rel L2 {err}, ids {ids}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the denoise path at flux-dev width
# ---------------------------------------------------------------------------

def main_path_phase(dev, depth_double, depth_single, steps):
    import dataclasses

    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel
    from comfyui_gguf_tpu_torch.sampling import euler_sample, flux_schedule

    dims = dataclasses.replace(testing.FLUX_DEV_DIMS,
                               depth_double=depth_double,
                               depth_single=depth_single)
    log(f"  flux-dev width, depth {depth_double} double + {depth_single} "
        f"single (of 19 + 38), 1024² = 4096 image + 512 text tokens, "
        f"{steps} Euler steps, 2 requests")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = testing.flux_random_stacked_params(dims, qtype=Q.Q4_K, seed=0,
                                                device=dev)
    torch.cuda.synchronize()
    model = DiffusionModel(arch="flux", params=params, config=dims.config(),
                           qcfg=QuantConfig(), device=torch.device(dev))
    log(f"  random Q4_K tree built on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    requests = [testing.flux_example_inputs(dims, batch=1, h_lat=128,
                                            w_lat=128, txt_len=512,
                                            seed=seed, device=dev)
                for seed in (1, 2)]
    sigmas = flux_schedule(steps, requests[0][0].shape[1])

    def denoise(inputs):
        img, ids, txt, tids, _, y, g = inputs

        def vel(x, s):
            return model.forward(x, ids, txt, tids, s.expand(x.shape[0]), y,
                                 g)
        t = time.perf_counter()
        out = euler_sample(vel, img, sigmas)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    res = {"depth_double": depth_double, "depth_single": depth_single,
           "steps": steps}
    _build.reset_launch_counts()
    finals = {}
    for tree in ("bf16_fused", "w8a8"):
        if tree == "w8a8":
            t = time.perf_counter()
            model.requantize_i8()
            torch.cuda.synchronize()
            res["requantize_s"] = time.perf_counter() - t
            log(f"  requantize_i8: {res['requantize_s']:.3f}s")
        before = dict(_build.LAUNCHES)
        outs, secs = [], []
        for inputs in requests:
            o, s = denoise(inputs)
            outs.append(o)
            secs.append(s)
            if o.shape != inputs[0].shape or not bool(torch.isfinite(o).all()):
                raise SystemExit(f"{tree}: non-finite or misshapen latent")
        finals[tree] = outs
        res[tree] = dict(
            request_s=secs, s_per_step=[s / steps for s in secs],
            launches={k: _build.LAUNCHES[k] - before[k]
                      for k in _build.LAUNCHES})
        log(f"  {tree}: request times {', '.join(f'{s:.3f}s' for s in secs)}"
            f" -> {secs[-1] / steps * 1e3:.1f} ms/step (second request); "
            f"launches {res[tree]['launches']}")
        before = dict(_build.LAUNCHES)  # the profiled forward is not a path
        res[f"profile_{tree}_forward"] = profile_forward(
            model, requests[0], secs[-1] / steps, tree)
        _build.LAUNCHES.update(before)
    launches = dict(_build.LAUNCHES)
    res["launches"] = launches
    res["latent_rel_delta_w8a8_vs_bf16"] = [
        rel_l2(a.float(), b.float())
        for a, b in zip(finals["w8a8"], finals["bf16_fused"])]
    res["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  final-latent rel delta w8a8 vs bf16-fused: "
        f"{res['latent_rel_delta_w8a8_vs_bf16']}; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB; launches {launches}")
    for k in ("qmm_nib4", "qmm_nib4_smallm", "i8mm", "flash_attn"):
        if launches[k] == 0:
            raise SystemExit(f"main path launched no {k}")
    # the accuracy cost of 8-bit activations at full width (PERF.md §2)
    worst = max(res["latent_rel_delta_w8a8_vs_bf16"])
    if not worst <= LATENT_DELTA_MAX:
        raise SystemExit(f"w8a8 final latent differs from bf16-fused by rel "
                         f"L2 {worst} > {LATENT_DELTA_MAX}")
    return res, model, requests[0]


def profile_forward(model, inputs, step_s, tree):
    """Device time of one forward of ``tree`` by kernel family, from
    torch.profiler; busy share = kernel time / the timed step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    img, ids, txt, tids, ts, y, g = inputs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.forward(img, ids, txt, tids, ts, y, g)
        torch.cuda.synchronize()
    fams = {"qmm_wgmma_kernel": "K1/K2 qmm (wgmma)",
            "qmm_smallm_kernel": "K1/K2 qmm (split-K)",
            "gemm_wgmma_kernel": "K4 i8mm",
            "flash_fwd_kernel": "K7 flash_attn",
            "i8attn_kernel": "K6 i8attn",
            "prep_reduce_kernel": "K6 prep",
            "prep_quant_kernel": "K6 prep",
            "prep_fold_kernel": "K6 prep",
            "prep_quant_wide_kernel": "K6 prep"}
    by_fam, others = {}, {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us <= 0 or getattr(e, "device_type", None) not in (
                None, torch.autograd.DeviceType.CUDA):
            continue
        fam = next((v for k, v in fams.items() if k in e.key), None)
        if fam is None:
            low = e.key.lower()
            fam = ("dense GEMM (cuBLAS)" if any(
                t in low for t in ("gemm", "gemv", "cutlass", "xmma"))
                else "other (elementwise, norms, rope, quantize, copies)")
            others[e.key[:90]] = others.get(e.key[:90], 0.0) + us / 1e3
        by_fam[fam] = by_fam.get(fam, 0.0) + us / 1e3
    total = sum(by_fam.values())
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profiled {tree} forward: device {total:.1f} ms of a "
        f"{step_s * 1e3:.1f} ms step (busy share "
        f"{total / (step_s * 1e3):.2f})")
    for fam, ms in sorted(by_fam.items(), key=lambda kv: -kv[1]):
        log(f"    {fam}: {ms:.1f} ms")
    for name, ms in top:
        log(f"    other kernel {ms:.1f} ms: {name}")
    return dict(device_ms=total, step_ms=step_s * 1e3, by_family_ms=by_fam,
                top_other_ms=dict(top))


# ---------------------------------------------------------------------------
# phase 6: text to image at published widths
# ---------------------------------------------------------------------------

def text_to_image_phase(dev, model, request, steps, t5_layers):
    """``FluxPipeline.generate`` over seed-made full-width parts: the w8a8
    flux tree of phase 5, T5-xxl Q8_0, CLIP-L and the 16-channel VAE; then
    one forward of phase 5's ``request`` under ``attention_i8("pv")``
    profiled."""
    import dataclasses

    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import clip, t5, testing, vae
    from comfyui_gguf_tpu_torch.nn.attention import attention_i8
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline, TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer
    from comfyui_gguf_tpu_torch.tokenizer.clip_bpe import CLIPBPETokenizer

    device = torch.device(dev)
    t0 = time.perf_counter()
    t5_dims = dataclasses.replace(testing.T5_XXL_DIMS, n_layers=t5_layers)
    t5_params = testing.t5_random_params(t5_dims, qtype=Q.Q8_0, seed=10,
                                         device=dev)
    t5_enc = TextEncoder(
        "t5", t5_params, t5.T5Config.from_state_dict(t5_params),
        UnigramTokenizer(testing.unigram_spec(t5_dims.vocab)), QuantConfig(),
        device)
    clip_params = testing.clip_random_params(testing.CLIP_L_DIMS, seed=11,
                                             device=dev)
    clip_cfg = clip.CLIPTextConfig.from_state_dict(clip_params)
    clip_enc = TextEncoder(
        "clip_l", clip_params, clip_cfg,
        CLIPBPETokenizer(*testing.clip_vocab(testing.CLIP_L_DIMS.vocab)),
        QuantConfig(), device)
    vae_params = testing.vae_random_params(testing.FLUX_VAE_DIMS, seed=12,
                                           device=dev)
    vae_cfg = vae.VAEConfig.from_state_dict(vae_params)
    torch.cuda.synchronize()
    pipe = FluxPipeline(model, t5_enc, clip_enc, vae_params, vae_cfg)
    n_blocks = model.config.depth_double + model.config.depth_single
    log(f"  T5-xxl width, {t5_layers} of 24 layers Q8_0; CLIP-L "
        f"{clip_cfg.n_layers} layers (pooling at eos id "
        f"{clip_cfg.eos_token_id}); VAE z={vae_cfg.z_channels} base "
        f"{vae_cfg.base_ch} x {vae_cfg.ch_mult}; flux {n_blocks} blocks "
        f"w8a8; built in {time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights")

    res = {"steps": steps, "t5_layers": t5_layers, "runs": []}
    launches = {k: 0 for k in _build.LAUNCHES}
    base = {}
    for mode in ("", "pv", "qk"):
        for pi, prompt in enumerate(PROMPTS):
            if mode and pi == 0:
                continue  # int8 attention: the second prompt only
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            with attention_i8(mode):
                img = pipe.generate(prompt, width=1024, height=1024,
                                    steps=steps, seed=pi)
            counts = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            lat = pipe.last_latent.float()
            tm = dict(pipe.last_timings)
            img_t = torch.from_numpy(img)
            if (img.shape != (1024, 1024, 3) or lat.shape != (1, 128, 128, 16)
                    or not bool(torch.isfinite(img_t).all())
                    or not bool(torch.isfinite(lat).all())
                    or float(img_t.min()) < 0 or float(img_t.max()) > 1):
                raise SystemExit(f"text to image ({mode!r}, prompt {pi}): "
                                 f"misshapen or non-finite output")
            run = dict(mode=mode or "bf16", prompt=pi, timings_s=tm,
                       s_per_step=tm["denoise_s"] / steps,
                       peak_gib=peak, launches=counts,
                       image_std=float(img_t.std()))
            if mode:
                run["latent_rel_delta_vs_bf16_attn"] = rel_l2(lat, base[pi][0])
                run["image_rel_delta_vs_bf16_attn"] = rel_l2(img_t,
                                                             base[pi][1])
            else:
                base[pi] = (lat, img_t)
            res["runs"].append(run)
            for k, n in counts.items():
                launches[k] += n
            log(f"  attention {mode or 'bf16'} prompt {pi}: tokenize "
                f"{tm['tokenize_s']:.4f}s, T5 {tm['t5_s']:.4f}s, CLIP "
                f"{tm['clip_s']:.4f}s, denoise {tm['denoise_s']:.3f}s "
                f"({run['s_per_step'] * 1e3:.1f} ms/step), VAE decode "
                f"{tm['vae_s']:.4f}s, image {tm['total_s']:.3f}s; peak "
                f"{peak:.2f} GiB; launches {counts}"
                + (f"; vs bf16 attention: latent rel L2 "
                   f"{run['latent_rel_delta_vs_bf16_attn']:.3e}, image "
                   f"{run['image_rel_delta_vs_bf16_attn']:.3e}"
                   if mode else ""))
            n_attn = n_blocks * steps
            want = {"flash_attn": 0 if mode else n_attn,
                    "i8attn_pv": n_attn if mode == "pv" else 0,
                    "i8attn_qk": n_attn if mode == "qk" else 0,
                    "i8attn_prep": n_attn if mode else 0}
            for k, n in want.items():
                if counts[k] != n:
                    raise SystemExit(
                        f"text to image ({mode!r}): {counts[k]} launches of "
                        f"{k}, expected {n}")
            if counts["qmm_int8"] < 7 * t5_layers:
                raise SystemExit(
                    f"text to image: {counts['qmm_int8']} launches of "
                    f"qmm_int8, the T5 alone needs {7 * t5_layers}")
            for k in ("qmm_nib4_smallm", "i8mm"):
                if counts[k] == 0:
                    raise SystemExit(f"text to image launched no {k}")
            worst = max(run.get("latent_rel_delta_vs_bf16_attn", 0.0),
                        run.get("image_rel_delta_vs_bf16_attn", 0.0))
            if not worst <= I8ATTN_DELTA_MAX:
                raise SystemExit(
                    f"attention_i8({mode!r}) moved the result by rel L2 "
                    f"{worst} > {I8ATTN_DELTA_MAX}")
            if mode == "pv":
                # where the int8-attention step goes (phase 5 profiles the
                # default attention); the profiled forward is not a path
                before = dict(_build.LAUNCHES)
                with attention_i8(mode):
                    res["profile_w8a8_i8attn_pv_forward"] = profile_forward(
                        model, request, run["s_per_step"],
                        "w8a8 attention_i8('pv')")
                _build.LAUNCHES.update(before)
    # the decode alone: its time and the memory it adds over the weights
    lat = pipe.last_latent
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dec_ms = event_ms(lambda: vae.decode_auto(vae_params, vae_cfg, lat),
                      reps=1)
    res["vae_decode_ms"] = dec_ms
    res["vae_decode_peak_over_held_gib"] = (
        torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  VAE decode 1024² untiled alone: {dec_ms:.1f} ms, peak "
        f"{res['vae_decode_peak_over_held_gib']:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held")
    res["launches"] = launches
    base_run = next(r for r in res["runs"]
                    if r["mode"] == "bf16" and r["prompt"] == 1)
    return res, pipe, base[1][0], base_run


# ---------------------------------------------------------------------------
# phase 7: a LoRA over every block linear of flux-dev, at full width
# ---------------------------------------------------------------------------

def lora_phase(dev, pipe, request, base_latent, base_run, steps):
    """A seed-made kohya rank-16 LoRA (alpha 16) over all 304 block linears
    of flux-dev (10 a double block, 3 a single block, the modulations
    included), applied at strength 0.8 to a flat Q4_K tree from phase 5's
    seed, then ``requantize_i8()`` and ``stack()``: phase 6's pipeline
    generates its second prompt with it. First the same LoRA at strength 0
    must leave one forward of phase 5's request equal to the unpatched
    model's."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build, _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel

    cfg, qcfg = pipe.model.config, pipe.model.qcfg
    dims = dataclasses.replace(testing.FLUX_DEV_DIMS,
                               depth_double=cfg.depth_double,
                               depth_single=cfg.depth_single)
    targets = testing.flux_lora_targets(dims)
    res = {"patched_linears": len(targets), "rank": 16, "alpha": 16.0,
           "strength": 0.8}
    with torch.no_grad():
        want0 = pipe.model.forward(*request)
    pipe.model = None  # the unpatched flux: phase 6's image stands for it
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "flux_dev_lora_r16.safetensors")
    t = time.perf_counter()
    _safetensors.save_file(testing.kohya_lora_state_dict(
        targets, rank=16, alpha=16.0, seed=21), path)
    res["write_s"] = time.perf_counter() - t
    res["file_mib"] = os.path.getsize(path) / 2**20

    def patched_model(strength):
        sp = testing.flux_random_stacked_params(dims, qtype=Q.Q4_K, seed=0,
                                                device=dev)
        model = DiffusionModel(arch="flux", params=testing.flux_flat_views(
            sp), config=cfg, qcfg=qcfg, device=torch.device(dev))
        del sp
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.apply_lora(path, strength=strength)
        torch.cuda.synchronize()
        t_apply = time.perf_counter() - t
        model.requantize_i8()
        model = model.stack()
        torch.cuda.synchronize()
        return model, t_apply, time.perf_counter() - t - t_apply

    # strength 0: every patched linear runs its LoRA instance, adding exact
    # zeros, so the forward equals the unpatched one value for value
    model, _, _ = patched_model(0.0)
    _build.reset_launch_counts()
    with torch.no_grad():
        got0 = model.forward(*request)
    torch.cuda.synchronize()
    res["strength0_forward_equal"] = bool(torch.equal(got0, want0))
    res["strength0_launches"] = dict(_build.LAUNCHES)
    del model, got0, want0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, res["apply_lora_s"], res["requantize_stack_s"] = patched_model(0.8)
    tmp.cleanup()
    pipe.model = model
    res["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    img = pipe.generate(PROMPTS[1], width=1024, height=1024, steps=steps,
                        seed=1)
    counts = dict(_build.LAUNCHES)
    tm = dict(pipe.last_timings)
    lat = pipe.last_latent.float()
    # where the LoRA step goes (phase 5 profiles the unpatched one); the
    # profiled forward is not a path
    res["profile_w8a8_lora_forward"] = profile_forward(
        model, request, tm["denoise_s"] / steps, "w8a8 LoRA")
    _build.LAUNCHES.update(counts)
    res.update(timings_s=tm, s_per_step=tm["denoise_s"] / steps,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts,
               unpatched_s_per_step=base_run["s_per_step"],
               unpatched_image_s=base_run["timings_s"]["total_s"],
               latent_rel_delta_vs_unpatched=rel_l2(lat, base_latent),
               image_std=float(img.std()))
    log(f"  {len(targets)} patched linears (rank 16, alpha 16, strength "
        f"0.8); file {res['file_mib']:.1f} MiB written in "
        f"{res['write_s']:.2f}s; apply_lora {res['apply_lora_s']:.3f}s, "
        f"requantize_i8 + stack {res['requantize_stack_s']:.3f}s")
    log(f"  strength 0: one forward equal to the unpatched model's: "
        f"{res['strength0_forward_equal']}")
    log(f"  LoRA image (prompt 1): denoise {tm['denoise_s']:.3f}s "
        f"({res['s_per_step'] * 1e3:.1f} ms/step; unpatched "
        f"{base_run['s_per_step'] * 1e3:.1f}), image {tm['total_s']:.3f}s "
        f"(unpatched {res['unpatched_image_s']:.3f}s); peak "
        f"{res['peak_gib']:.2f} GiB (unpatched "
        f"{base_run['peak_gib']:.2f}; {res['build_peak_gib']:.2f} while "
        f"the patched tree was built); latent rel L2 vs the unpatched image's "
        f"{res['latent_rel_delta_vs_unpatched']:.3e}; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if (img.shape != (1024, 1024, 3) or not bool(torch.isfinite(lat).all())
            or not bool(np.isfinite(img).all())):
        raise SystemExit("LoRA image: misshapen or non-finite output")
    if not res["strength0_forward_equal"]:
        raise SystemExit("a strength-0 LoRA changed the full-width forward")
    if not res["latent_rel_delta_vs_unpatched"] > 1e-3:
        raise SystemExit("the LoRA image equals the unpatched one: the "
                         "patches did nothing")
    n_blocks = cfg.depth_double + cfg.depth_single
    want = {"i8mm_lora": (8 * cfg.depth_double + 2 * cfg.depth_single)
            * steps,
            "qmm_nib4_smallm_lora": (2 * cfg.depth_double + cfg.depth_single)
            * steps,
            "i8mm": 0, "qmm_nib4_smallm": 0, "flash_attn": n_blocks * steps}
    for k, n in want.items():
        if counts[k] != n:
            raise SystemExit(f"LoRA image: {counts[k]} launches of {k}, "
                             f"expected {n}")
    return res


# ---------------------------------------------------------------------------
# phase 8: the GEMM probe tool, as a user runs it
# ---------------------------------------------------------------------------

def probe_tool_phase():
    from comfyui_gguf_tpu_torch import _build
    import tools_i8_microbench_cuda as tool

    _build.reset_launch_counts()
    rc = tool.main()
    counts = dict(_build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"tools_i8_microbench_cuda.py exited with {rc}")
    for k in ("gemm_probe_bf16", "gemm_probe_s8", "gemm_probe_w8a8"):
        if counts[k] == 0:
            raise SystemExit(f"the probe tool launched no {k}")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-double", type=int, default=19)
    ap.add_argument("--depth-single", type=int, default=38)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--t5-layers", type=int, default=24)
    args = ap.parse_args()

    import torch

    from comfyui_gguf_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    def nvidia_smi(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    smi = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_SM_CLK * n_sm * sm_mhz * 1e6
    log(f"[1 device] {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; {n_sm} SMs, max SM "
        f"clock {sm_mhz:.0f} MHz -> {sfu_per_s / 1e12:.2f} T exp/s")

    log("[2 build]")
    _build.lib()
    rep = _build.BUILD_REPORT
    if rep.get("cached"):
        log(f"  reused {rep['path']}")
    else:
        log(f"  nvcc {rep['compile_s']:.2f}s (parallel), total "
            f"{rep['total_s']:.2f}s")
        for src, lines in rep["ptxas"].items():
            spills = [ln.strip() for ln in lines if "spill" in ln]
            if src in LORA_SOURCES:
                # registers and spills of each instance, by its template
                # arguments (LoRA instances: the last argument is 1)
                for inst, used, spill in _build.ptxas_entries(lines):
                    log(f"  {src}: {inst}: {used}; {spill}")
                continue
            for ln in lines:
                if "Used" in ln:
                    log(f"  {src}: {ln.split(':', 1)[1].strip()}")
            if src in ("i8attn.cu", "i8attn_prep.cu", "gemm_probe.cu"):
                for ln in spills:
                    log(f"  {src}: {ln}")
            elif any(not ln.startswith("0 bytes stack frame, 0 bytes spill "
                                       "stores, 0 bytes spill loads")
                     for ln in spills):
                log(f"  {src}: spills or stack: {spills}")
    lib = _build.lib()
    log("  dynamic shared memory a block: i8mm.cu and gemm_probe.cu (one "
        "body, gemm_wgmma.cuh) "
        + ", ".join(f"bn={bn} {lib.i8mm_smem_bytes(bn)} B" for bn in (256, 128))
        + "; flash_attn.cu "
        + ", ".join(f"D={d} {lib.flash_attn_smem_bytes(d)} B"
                    for d in (128, 64))
        + "; i8attn.cu "
        + ", ".join(f"D={d} {m} {lib.i8attn_smem_bytes(d, m == 'pv')} B"
                    for d in (128, 256, 512) for m in ("pv", "qk"))
        + " (i8attn_prep.cu: static shared memory only, in the ptxas "
          "lines); the LoRA instances use their unpatched instances' "
          "layouts (i8mm_lora.cu as i8mm.cu, qmm_lora.cu / "
          "qmm_int8_lora.cu as qmm.cu / qmm_int8.cu, qmm_smallm.cu's as "
          "its own): the rank chunks stream through the same ring")

    log("[3 kernels vs plain at the main paths' shapes]")
    rows = kernel_phase(dev, sfu_per_s)
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        extra = ""
        if "prep_ms" in r:
            extra = (f" | prep kernel {r['prep_ms']:.4f} ms (plain prep "
                     f"{r['prep_plain_ms']:.4f} ms), exp floor "
                     f"{r['exp_floor_ms']:.4f} ms, vs exact attention "
                     f"{r['rel_l2_vs_exact']:.2e}")
        if "k_codes_off_by_one" in r:
            extra = (f" | k codes one step off: share "
                     f"{r['k_codes_off_by_one']:.3e}, ks max rel "
                     f"{r['ks_max_rel']:.2e}")
        if "tile_ms" in r:
            extra = " | by tile width " + ", ".join(
                f"bn={bn}: {ms:.4f} ms" for bn, ms in r["tile_ms"].items())
        if "unpatched_ms" in r:
            if "over_1ulp" in r:
                extra = (f" | over 1 ulp: {r['over_1ulp']} (GELU columns "
                         f"{r['over_1ulp_gelu_columns']})")
            extra += (f" | unpatched instance {r['unpatched_ms']:.4f} ms, "
                     f"the term moves the output by rel L2 "
                     f"{r['term_rel']:.2e}, strength 0 equal: "
                     f"{r['strength0_equal']}")
        log(f"  {r['name']}: {'ok' if r['ok'] else 'FAIL'} "
            f"rel_l2={r['rel_l2']:.2e} max_abs={r['max_abs_err']:.3e} "
            f"({r['tol']}) | kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    log("[4a tiny end to end: mixed Q4_K/Q8_0/Q6_K GGUF, card vs CPU]")
    tiny = tiny_e2e_phase(dev)
    log("[4b tiny FluxPipeline from files, card vs CPU, with and without "
        "attention_i8]")
    tiny_pipe = tiny_pipeline_phase(dev)

    log("[5 denoise path at flux-dev width]")
    main_res, model, request = main_path_phase(dev, args.depth_double,
                                               args.depth_single, args.steps)

    log("[6 text to image at published widths]")
    t2i, pipe, base_latent, base_run = text_to_image_phase(
        dev, model, request, args.steps, args.t5_layers)
    del model

    log("[7 a rank-16 LoRA over every block linear of flux-dev, at full "
        "width]")
    lora_res = lora_phase(dev, pipe, request, base_latent, base_run,
                          args.steps)
    del pipe
    torch.cuda.empty_cache()

    log("[8 the GEMM probe tool]")
    tool_counts = probe_tool_phase()

    # launches of each kernel over the driven paths (every path had its
    # counts set to 0 just before it and read just after)
    launches = {k: 0 for k in _build.LAUNCHES}
    for counts in (*(v["launches"] for v in tiny.values()),
                   *(v["launches"] for v in tiny_pipe.values()),
                   main_res["launches"], t2i["launches"],
                   lora_res["launches"], tool_counts):
        for k, n in counts.items():
            launches[k] += n
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise SystemExit(f"no driven path launched {idle}")
    kernels = []
    for r in rows:
        src, replaces = SOURCES[r["kernel"]]
        kernels.append(dict(
            name=r["name"], route="cuda", source=src, replaces=replaces,
            launches=launches[r["kernel"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    log(f"wall {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
