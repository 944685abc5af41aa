#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``comfyui_gguf_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--depth-double N] [--depth-single N] [--steps N]
                          [--t5-layers N] [--sd3-depth N] [--sd3-steps N]
                          [--unet-steps N]

It drives the port's main paths — the flux denoise of ``bench.py``'s
configuration, flux text-to-image end to end (tokenizers, T5-xxl and
CLIP-L encode, denoise, VAE decode), SD3.5-large and the SD1/SDXL UNets —
on the card through the entry points a user calls, and fails (non-zero
exit, no result line) on any failed phase:

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
   it;
9. serving at flux-dev width and depth, on phase 6's w8a8 stacked tree
   (run before phase 7, which replaces that tree): (a) ``flux_engine``
   (Euler, max_batch 4) serves six 1024² requests of ``--steps`` steps on
   seed-made published-width conds (T5 512 x 4096, pooled 768), four
   arriving one a tick and two at tick 5, which join the pool beside
   requests near their end; every request must finish, each tick must
   launch one forward's kernels (228 K4, 57 K7 and 76 split-K at full
   depth), and two results must be within 1e-2 (relative L2) of
   ``sample_flow`` at batch 1; s/tick by bucket, occupancy, steps/s,
   images/min, latency and peak memory are printed, and one b = 4 forward
   is profiled; (b) ``sampler="dpmpp_2m"``: two requests, each within 1e-2
   of ``sample_flow(..., "dpmpp_2m")``; (c) ``snapshot()`` after two ticks,
   ``restore()`` into a fresh engine, within 1e-3 of the uninterrupted run,
   and ``pipeline_depth=4`` equal to depth 1; (d) ``ResidentModelServer``
   with this tree and a 4 + 4-block flux-dev-width tree under a budget that
   holds one: the LRU eviction must free at least 90% of the evicted tree's
   bytes (``memory_allocated``) and the re-placed tree must give its first
   result again. (b)-(d) run min(``--steps``, 4) steps;
10. the SD3.5-large denoise: ``SD35_LARGE_DIMS`` (hidden 2432, 38 heads of
   64, 38 joint blocks unless ``--sd3-depth`` cuts them), seed-made Q4_K
   stacked, 1024² (4096 image + 77 + 512 context tokens), ``--sd3-steps``
   (28) Euler steps on ``shift_sigmas(linear_schedule(n), 3.0)`` with CFG
   4.5 (two forwards a step), on the bf16-fused tree and then on the w8a8
   stacked tree; the w8a8 final latent more than 2e-2 from the bf16-fused
   one fails. s/step, peak memory, launches a forward and one profiled
   forward of each tree are printed;
11. SD3.5-large text to image: an ``SD3Pipeline`` of phase 10's w8a8 tree,
   CLIP-L, CLIP-G (1280 x 32 layers), phase 6's T5-xxl and 16-channel VAE
   generates one prompt against a negative prompt at 1024² (stage times);
   then ``sd3_engine(max_batch=2)`` serves three such requests for
   min(``--steps``, 4) steps, each within 1e-2 of ``sample_flow`` at
   batch 1;
12. the UNets: SDXL (``SDXL_DIMS``, Q4_K then ``requantize_i8()``) through
   ``SDXLPipeline.generate_from_ids`` at 1024² and SD1 (``SD1_DIMS``, Q4_K)
   through ``SD1Pipeline`` at 512², ``--unet-steps`` (20) Euler steps on
   the normal schedule with CFG 7 and a 4-channel VAE; SD1 must launch K7's
   40-, 80- and 160-wide instances, 10, 10 and 12 times a forward; then
   ``unet_engine(max_batch=4)`` serves three SDXL requests (CFG 7, 5, 3)
   for min(``--steps``, 4) steps, each within 1e-2 of the same step at
   batch 1.

Phase 4c runs every ``FLOW_SAMPLERS`` and ``FLOW_STOCHASTIC_SAMPLERS`` name
through phase 4a's tiny flux GGUF (Q4_K) on the card and on the CPU with the
same noise, within 3e-2 (relative L2). Phase 4d does the same for the SD
paths from files the port's writers make: three tiny SD3 variants (qk-norm,
a dual-attention prefix, neither) planar and w8a8 stacked, a tiny
``SD3Pipeline`` (negative prompt, img2img, inpainting, a kohya LoRA), tiny
SD1 and SDXL pipelines and the refiner, and ``sd3_engine`` and
``unet_engine`` with three requests each. Phase 3 also times K4, K7 and the
split-K body at the serving shapes of four stacked requests, K7 at SD1's
head dims 40, 80 and 160 and the sd3.5-large joint length, and K4 and the
split-K body at the sd3.5-large and SD1 shapes.

Launch counts are set to 0 just before each driven path and read just
after. The last lines are the card's ``nvidia-smi`` name and power limit,
the kernel table as JSON, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
# most relative L2 allowed between a sampler's latent on the card and on
# the CPU (phase 4c), the tiny end-to-end limit of phase 4
SAMPLER_DELTA_MAX = 3e-2
# most relative L2 allowed between a served request's latent and the same
# request sampled alone at batch 1 (phase 9), and between a restored
# engine's and an uninterrupted one's
ENGINE_DELTA_MAX = 1e-2
RESTORE_DELTA_MAX = 1e-3
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
    **{f"flash_attn_d{d}": ("comfyui_gguf_tpu_torch/csrc/flash_attn.cu",
                            "comfyui_gguf_tpu/nn/attention.py:168")
       for d in (40, 64, 80, 128, 160)},
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
        rows.append(dict(name=name, kernel=f"flash_attn_d{D}",
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
    # the serving path's shapes (phase 9): four requests stacked per tick —
    # K4 at M = 4 x 4608 / 4096 / 512 tokens, K7 at B = 4, the split-K
    # body on the modulations at M = 4
    i8_case("i8mm linear1 b=4 M=18432 3072->21504 gelu@9216", 18432, 3072,
            21504, 9216)
    i8_case("i8mm img qkv b=4 M=16384 3072->9216", 16384, 3072, 9216, None)
    i8_case("i8mm txt qkv b=4 M=2048 3072->9216", 2048, 3072, 9216, None)
    qmm_case("qmm_nib4 mod b=4 M=4 3072->18432 Q4_K", "qmm_nib4_smallm",
             Q.Q4_K, 4, 3072, 18432, None, 4, 5e-3)
    attn_case("flash_attn flux b=4 B=4 L=4608 D=128", 4, 24, 4608, 4608,
              128)
    # K7: flux joint attention, an odd length at D=64, and Lq != Lk
    attn_case("flash_attn flux L=4608 D=128", 1, 24, 4608, 4608, 128)
    attn_case("flash_attn odd L=4250 D=64", 1, 24, 4250, 4250, 64)
    attn_case("flash_attn cross Lq=4096 Lk=512 D=128", 1, 24, 4096, 512,
              128)
    # K7 at SD1's head dims (8 heads over 320, 640 and 1280 channels at
    # 512²: 4096, 1024, 256 and the mid block's 64 tokens, cross attention
    # over CLIP's 77), on the padded instances; and the sd3.5-large joint
    # length (4096 image + 77 + 512 text tokens, 38 heads of 64)
    attn_case("flash_attn SD1 L=4096 D=40", 1, 8, 4096, 4096, 40)
    attn_case("flash_attn SD1 cross Lq=4096 Lk=77 D=40", 1, 8, 4096, 77, 40)
    attn_case("flash_attn SD1 L=1024 D=80", 1, 8, 1024, 1024, 80)
    attn_case("flash_attn SD1 cross Lq=1024 Lk=77 D=80", 1, 8, 1024, 77, 80)
    attn_case("flash_attn SD1 L=256 D=160", 1, 8, 256, 256, 160)
    attn_case("flash_attn SD1 mid L=64 D=160", 1, 8, 64, 64, 160)
    attn_case("flash_attn SD1 cross Lq=256 Lk=77 D=160", 1, 8, 256, 77, 160)
    attn_case("flash_attn sd3.5-large joint L=4685 D=64", 1, 38, 4685, 4685,
              64)
    # K4 at the sd3.5-large shapes after requantize_i8 (the x stream's 4096
    # tokens, the context stream's 77 + 512) and at SD1's narrowest linear
    # (K = 320 padded to 512, N = 320); the split-K body on the sd3.5-large
    # adaLN modulation and on SD1's emb_layers (N = 320) at M = batch
    i8_case("i8mm sd3.5 x qkv M=4096 2432->7296", 4096, 2432, 7296, None)
    i8_case("i8mm sd3.5 fc1 M=4096 2432->9728 gelu", 4096, 2432, 9728, 0)
    i8_case("i8mm sd3.5 fc2 M=4096 9728->2432", 4096, 9728, 2432, None)
    i8_case("i8mm sd3.5 ctx qkv M=589 2432->7296", 589, 2432, 7296, None)
    i8_case("i8mm SD1 attn q M=4096 320->320", 4096, 320, 320, None)
    qmm_case("qmm_nib4 sd3.5 mod M=1 2432->14592 Q4_K", "qmm_nib4_smallm",
             Q.Q4_K, 1, 2432, 14592, None, 4, 5e-3)
    qmm_case("qmm_nib4 SD1 emb_layers M=1 1280->320 Q4_K", "qmm_nib4_smallm",
             Q.Q4_K, 1, 1280, 320, None, 8, 5e-3)
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


def sampler_menu_phase(dev):
    """Every flow sampler (``FLOW_SAMPLERS``, and ``FLOW_STOCHASTIC_SAMPLERS``
    with the same noise on both devices) through phase 4a's tiny flux GGUF,
    on the card and on the CPU."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
    from comfyui_gguf_tpu_torch.sampling import flow_match as fm

    dims = testing.TinyFluxDims(hidden=512, heads=4, depth_double=2,
                                depth_single=2, axes_dim=(16, 56, 56))
    devs = (dev, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny_flux_q4k.gguf")
        testing.write_flux_gguf(
            testing.flux_state_dict(dims, seed=0), path,
            lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
        models = [load_diffusion_model(path, device=d) for d in devs]
    steps, h_lat = 3, 16
    inputs = [testing.flux_example_inputs(dims, h_lat=h_lat, w_lat=h_lat,
                                          txt_len=16, seed=6, device=d)
              for d in devs]
    sigmas = fm.flux_schedule(steps, (h_lat // 2) ** 2)

    def run(name, i):
        d = devs[i]
        img, ids, txt, tids, _, y, g = inputs[i]
        model = models[i]

        def vel(x, s):
            return model.forward(x, ids, txt, tids, s.expand(x.shape[0]), y,
                                 g)
        with torch.no_grad():
            if name in fm.FLOW_SAMPLERS:
                return fm.sample_flow(vel, img, sigmas, sampler=name)
            gen = torch.Generator().manual_seed(11)  # the same draws

            def noise(shape):
                return torch.randn(tuple(shape), generator=gen).to(d)
            return fm.FLOW_STOCHASTIC_SAMPLERS[name](vel, img, sigmas, noise)

    out, launches = {}, {k: 0 for k in _build.LAUNCHES}
    for name in sorted(fm.FLOW_SAMPLERS) + sorted(fm.FLOW_STOCHASTIC_SAMPLERS):
        _build.reset_launch_counts()
        a = run(name, 0)
        torch.cuda.synchronize()
        for k, n in _build.LAUNCHES.items():
            launches[k] += n
        b = run(name, 1)
        err = rel_l2(a.float().cpu(), b.float())
        out[name] = err
        if not bool(torch.isfinite(a).all()) or not err <= SAMPLER_DELTA_MAX:
            raise SystemExit(f"sampler {name}: card vs CPU rel L2 {err}")
    log(f"  {len(out)} samplers, {steps} steps each, card vs CPU plain rel "
        f"L2 (limit {SAMPLER_DELTA_MAX}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    log(f"  launches {dict((k, n) for k, n in launches.items() if n)}")
    for k in ("qmm_nib4", "qmm_nib4_smallm", "flash_attn"):
        if launches[k] == 0:
            raise SystemExit(f"the sampler menu launched no {k}")
    return dict(rel_l2_vs_cpu=out, launches=launches)


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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.forward(*inputs)
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
# phase 9: serving at flux-dev width and depth
# ---------------------------------------------------------------------------

def serving_phase(dev, pipe, steps, base_run, h_lat=128, txt_len=512):
    """``flux_engine`` over the w8a8 stacked flux-dev tree of phases 5/6:
    (a) Euler, max_batch 4, six requests at 1024² arriving over the first
    ticks, launch counts per tick, two results against ``sample_flow`` at
    batch 1; (b) per-lane DPM-Solver++(2M) against ``sample_flow(...,
    "dpmpp_2m")``; (c) snapshot/restore into a fresh engine and
    ``pipeline_depth=4`` against an uninterrupted depth-1 run; (d)
    ``ResidentModelServer`` with this tree and a smaller flux-dev-width one
    under a budget that holds one. Returns the results and the tree to
    hand back to the pipeline (the server re-placed it)."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import tree_bytes
    from comfyui_gguf_tpu_torch.models import flux as flux_model
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel, flux_engine
    from comfyui_gguf_tpu_torch.sampling import flux_schedule, sample_flow
    from comfyui_gguf_tpu_torch.serving import ResidentModelServer

    model = pipe.model
    cfg = model.config
    dims = testing.TinyFluxDims(
        hidden=cfg.hidden, heads=cfg.n_heads, ctx=cfg.context_dim,
        vec=cfg.vec_dim, in_ch=cfg.in_channels, depth_double=cfg.depth_double,
        depth_single=cfg.depth_single, axes_dim=cfg.axes_dim)
    H = W = h_lat  # 128: a 1024² latent, 4096 image tokens
    TXT = txt_len
    sigmas = flux_schedule(steps, (H // 2) * (W // 2))
    short = min(steps, 4)
    sig_short = flux_schedule(short, (H // 2) * (W // 2))
    per_tick = {"i8mm": 8 * cfg.depth_double + 2 * cfg.depth_single,
                "flash_attn": cfg.depth_double + cfg.depth_single,
                "qmm_nib4_smallm": 2 * cfg.depth_double + cfg.depth_single}

    def request(seed):
        img, _, txt, _, _, y, g = testing.flux_example_inputs(
            dims, batch=1, h_lat=H, w_lat=W, txt_len=TXT, seed=seed,
            device=dev)
        return img[0], {"txt": txt[0], "y": y[0], "guidance": g[0]}

    def direct(latent, cond, sig, sampler, mdl=model):
        img_ids = torch.as_tensor(np.array(flux_model.make_img_ids(
            H // 2, W // 2, 1)), device=dev)
        txt_ids = torch.zeros((1, TXT, 3), dtype=torch.int32, device=dev)

        def vel(x, s):
            return mdl.forward(x, img_ids, cond["txt"][None], txt_ids,
                               s.expand(1), cond["y"][None],
                               cond["guidance"].reshape(1))
        with torch.no_grad():
            out = sample_flow(vel, latent[None], sig, sampler=sampler)
        return out[0].float().cpu().numpy()

    def compare(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                bool(np.array_equal(a, b)))

    res = {"steps": steps, "short_steps": short}
    launches = {k: 0 for k in _build.LAUNCHES}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) six requests, euler, max_batch 4: r0..r3 arrive one a tick, r4
    # and r5 at tick 5 and join the pool as slots free, beside requests
    # near their end (a mixed-progress pool)
    reqs_in = [request(100 + i) for i in range(6)]
    arrivals = {0: [0], 1: [1], 2: [2], 3: [3], 5: [4, 5]}
    eng = flux_engine(model, H, W, TXT, max_batch=4, sampler="euler")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    handles, ticks = {}, []
    t0 = time.perf_counter()
    tick = 0
    while tick <= max(arrivals) or eng.active or not eng.queue.empty():
        for i in arrivals.get(tick, []):
            handles[i] = eng.submit(*reqs_in[i], sigmas)
        st0 = dataclasses.replace(eng.stats)
        t = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        live = eng.stats.steps_executed - st0.steps_executed
        pad = eng.stats.total_padding_lanes - st0.total_padding_lanes
        if live:
            ticks.append((live + pad, live, dt))
        tick += 1
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    add(counts)
    n_ticks = len(ticks)
    st = eng.stats.snapshot()
    by_bucket = {}
    for b, _, dt in ticks:
        by_bucket.setdefault(b, []).append(dt)
    res["a"] = dict(
        requests=6, ticks=n_ticks, wall_s=wall,
        s_per_tick={b: float(np.mean(v)) for b, v in sorted(
            by_bucket.items())},
        s_per_tick_min={b: float(np.min(v)) for b, v in sorted(
            by_bucket.items())},
        ticks_by_bucket={b: len(v) for b, v in sorted(by_bucket.items())},
        mean_batch_occupancy=eng.stats.mean_batch_occupancy,
        steps_per_s=eng.stats.steps_executed / wall,
        images_per_min=60.0 * eng.stats.completed / wall,
        mean_latency_s=st["mean_latency_s"],
        latency_s=[handles[i].latency_s for i in range(6)],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=counts, stats=st)
    errs = [h.error for h in handles.values() if h.error is not None]
    if errs or not all(h.finished for h in handles.values()):
        raise SystemExit(f"serving (a): failed or unfinished requests: "
                         f"{errs}")
    for k, n in per_tick.items():
        if counts[k] != n * n_ticks:
            raise SystemExit(f"serving (a): {counts[k]} launches of {k} "
                             f"over {n_ticks} ticks, expected {n} a tick")
    for i in (0, 5):
        err, eq = compare(handles[i].result,
                          direct(*reqs_in[i], sigmas, "euler"))
        res["a"][f"r{i}_vs_direct"] = dict(rel_l2=err, bits_equal=eq)
        if not err <= ENGINE_DELTA_MAX:
            raise SystemExit(f"serving (a): request {i} differs from "
                             f"sample_flow at batch 1 by rel L2 {err}")
    b1 = base_run["s_per_step"]
    a = res["a"]
    log(f"  (a) euler, max_batch 4, 6 requests x {steps} steps at {8 * H}²: "
        f"{n_ticks} ticks in {wall:.3f}s; s/tick by bucket "
        + ", ".join(f"b={b}: {a['s_per_tick'][b]:.4f} (min "
                    f"{a['s_per_tick_min'][b]:.4f}, {a['ticks_by_bucket'][b]}"
                    f" ticks)" for b in a["s_per_tick"])
        + f"; phase 6's b=1 s/step {b1:.4f}; occupancy "
        f"{a['mean_batch_occupancy']:.3f}, {a['steps_per_s']:.3f} steps/s, "
        f"{a['images_per_min']:.3f} images/min (b=1 at phase 6's s/step: "
        f"{60.0 / (b1 * steps):.3f}), mean latency "
        f"{a['mean_latency_s']}s, peak {a['peak_gib']:.2f} GiB")
    log(f"  (a) launches a tick: "
        + ", ".join(f"{k} {counts[k] / n_ticks:g}" for k in per_tick)
        + f"; vs sample_flow at batch 1: "
        + ", ".join(f"r{i} rel L2 {a[f'r{i}_vs_direct']['rel_l2']:.3e} "
                    f"(bits equal {a[f'r{i}_vs_direct']['bits_equal']})"
                    for i in (0, 5)))
    # where a b = 4 tick's device time goes: one forward of four stacked
    # requests under torch.profiler (not a path: its launches are not
    # counted)
    before = dict(_build.LAUNCHES)
    inputs4 = testing.flux_example_inputs(dims, batch=4, h_lat=H, w_lat=W,
                                          txt_len=TXT, seed=120, device=dev)
    res["a"]["profile_b4_forward"] = profile_forward(
        model, inputs4, a["s_per_tick"][max(a["s_per_tick"])],
        "w8a8 b=4 tick")
    del inputs4
    _build.LAUNCHES.update(before)

    # (b) per-lane DPM-Solver++(2M): two requests of different lengths
    eng = flux_engine(model, H, W, TXT, max_batch=4, sampler="dpmpp_2m")
    _build.reset_launch_counts()
    rb = [(reqs_in[0], sig_short), (reqs_in[1], flux_schedule(
        short + 1, (H // 2) * (W // 2)))]
    hb = [eng.submit(*r, sig) for r, sig in rb]
    eng.run_until_drained()
    add(_build.LAUNCHES)
    res["b"] = {}
    for i, ((r, sig), h) in enumerate(zip(rb, hb)):
        if h.error is not None or not h.finished:
            raise SystemExit(f"serving (b): request {i} failed: {h.error}")
        err, eq = compare(h.result, direct(*r, sig, "dpmpp_2m"))
        res["b"][f"r{i}"] = dict(steps=len(sig) - 1, rel_l2=err,
                                 bits_equal=eq)
        if not err <= ENGINE_DELTA_MAX:
            raise SystemExit(f"serving (b): dpmpp_2m request {i} differs "
                             f"from sample_flow by rel L2 {err}")
    log("  (b) dpmpp_2m, 2 requests (" + ", ".join(
        f"{v['steps']} steps: rel L2 vs sample_flow {v['rel_l2']:.3e}, bits "
        f"equal {v['bits_equal']}" for v in res["b"].values()) + ")")

    # (c) snapshot after 2 ticks, restored into a fresh engine; and
    # pipeline_depth=4 against depth 1 on the same requests
    rc = [(reqs_in[i], flux_schedule(short + i - 2, (H // 2) * (W // 2)))
          for i in (2, 3, 4)]

    def serve(depth=1, interrupt=False):
        _build.reset_launch_counts()
        e = flux_engine(model, H, W, TXT, max_batch=2, pipeline_depth=depth)
        hs = [e.submit(*r, sig) for r, sig in rc]
        if interrupt:
            e.tick()
            e.tick()
            snap = e.snapshot()
            # the snapshot holds the unfinished requests, pool then queue:
            # here submission order
            open_ = [i for i, h in enumerate(hs) if not h.done_event.is_set()]
            e2 = flux_engine(model, H, W, TXT, max_batch=2)
            for i, h in zip(open_, e2.restore(snap)):
                hs[i] = h
            e = e2
        e.run_until_drained()
        add(_build.LAUNCHES)
        if any(h.error is not None or not h.finished for h in hs):
            raise SystemExit("serving (c): a request failed")
        return [h.result for h in hs]

    whole = serve()
    restored = serve(interrupt=True)
    deep = serve(depth=4)
    cmp_r = [compare(a_, b_) for a_, b_ in zip(restored, whole)]
    res["c"] = dict(restored_rel_l2=[c[0] for c in cmp_r],
                    restored_bits_equal=[c[1] for c in cmp_r],
                    depth4_equal=all(np.array_equal(a_, b_)
                                     for a_, b_ in zip(deep, whole)))
    log(f"  (c) snapshot after 2 ticks -> restore: rel L2 vs uninterrupted "
        f"{[f'{c[0]:.2e}' for c in cmp_r]}, bits equal "
        f"{res['c']['restored_bits_equal']}; pipeline_depth=4 equal to "
        f"depth 1: {res['c']['depth4_equal']}")
    if max(c[0] for c in cmp_r) > RESTORE_DELTA_MAX:
        raise SystemExit("serving (c): the restored engine diverged")
    if not res["c"]["depth4_equal"]:
        raise SystemExit("serving (c): pipeline_depth=4 differs from 1")

    # (d) two models under a budget that holds one: this tree (A) and a
    # flux-dev-width tree of 4 + 4 blocks (B), both w8a8
    small = dataclasses.replace(dims, depth_double=4, depth_single=4)
    model_b = DiffusionModel(
        arch="flux", params=testing.flux_random_stacked_params(
            small, qtype=Q.Q4_K, seed=3, device=dev),
        config=small.config(), qcfg=model.qcfg,
        device=torch.device(dev)).requantize_i8()
    bytes_a, bytes_b = tree_bytes(model.params), tree_bytes(model_b.params)
    budget = int(1.05 * max(bytes_a, bytes_b))
    srv = ResidentModelServer(hbm_budget=budget, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for name, mdl in (("flux_a", model), ("flux_b", model_b)):
        srv.register(name, mdl.params,
                     lambda provider, mdl=mdl: flux_engine(
                         mdl, H, W, TXT, max_batch=2,
                         params_provider=provider))
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t
    del model_b

    def run_one(name, r):
        _build.reset_launch_counts()
        h = srv.submit(name, *r, sig_short)
        t = time.perf_counter()
        srv.run_until_drained()
        torch.cuda.synchronize()
        add(_build.LAUNCHES)
        if h.error is not None or not h.finished:
            raise SystemExit(f"serving (d): {name} failed: {h.error}")
        return h.result, time.perf_counter() - t

    first_a, s_a1 = run_one("flux_a", reqs_in[0])
    held_a = torch.cuda.memory_allocated()
    _, s_b = run_one("flux_b", reqs_in[1])  # LRU evicts A to place B
    held_b = torch.cuda.memory_allocated()
    evicted = not srv.stats["models"]["flux_a"]["resident"]
    again_a, s_a2 = run_one("flux_a", reqs_in[0])  # re-places A
    drop = held_a - (held_b - bytes_b)
    res["d"] = dict(bytes_a=bytes_a, bytes_b=bytes_b, budget=budget,
                    register_s=register_s, a_first_s=s_a1, b_s=s_b,
                    a_replaced_s=s_a2, evicted=evicted,
                    memory_drop_bytes=drop,
                    drop_share=drop / bytes_a,
                    replaced_equal=bool(np.array_equal(again_a, first_a)),
                    stats=srv.stats)
    log(f"  (d) ResidentModelServer: A {bytes_a / 2**30:.2f} GiB (this "
        f"tree), B {bytes_b / 2**30:.2f} GiB (4 + 4 blocks), budget "
        f"{budget / 2**30:.2f} GiB; register (host copies) {register_s:.2f}s;"
        f" {short} steps: A {s_a1:.2f}s, B {s_b:.2f}s (A evicted: {evicted};"
        f" memory_allocated fell by {drop / 2**30:.2f} GiB = "
        f"{drop / bytes_a:.3f} of A), A re-placed {s_a2:.2f}s, result equal "
        f"to its first: {res['d']['replaced_equal']}")
    if not evicted or drop < 0.9 * bytes_a:
        raise SystemExit("serving (d): no eviction freed A's memory")
    if not res["d"]["replaced_equal"]:
        raise SystemExit("serving (d): the re-placed model's result "
                         "changed")
    res["launches"] = launches
    params_a = srv.manager.resident_params("flux_a")
    return res, params_a


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


# ---------------------------------------------------------------------------
# phase 4d: tiny SD3 / SD1 / SDXL end to end, card against CPU
# ---------------------------------------------------------------------------

# tiny encoders that the loader tells apart by width (CLIP-G is 1280 wide),
# sized so CLIP-L ⊕ CLIP-G (128 + 1280) fits the tiny MMDiT's context
TINY_CLIP_L = dict(hidden=128, n_layers=2, n_heads=2, intermediate=256,
                   vocab=600, max_positions=77, proj=64)
TINY_CLIP_G = dict(hidden=1280, n_layers=2, n_heads=20, intermediate=5120,
                   vocab=600, max_positions=77, proj=64)


def _write_sd_files(tmp):
    """The tiny SD3 (three variants), SD1, SDXL and refiner GGUFs, a T5
    GGUF, CLIP-L and CLIP-G safetensors with one vocabulary, and 16- and
    4-channel VAEs, written by the port's writers under ``tmp``."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    f = {}
    for name, extra in (("large", {}), ("medium", {"dual_prefix": 1}),
                        ("sd3", {"qk_norm": False})):
        dims = testing.TinySD3Dims(hidden=512, heads=8, depth=3,
                                   ctx_dim=1536, pooled=128, pos_max=16,
                                   **extra)
        f[f"sd3_{name}"] = (os.path.join(tmp, f"sd3_{name}.gguf"), dims)
        testing.write_gguf(testing.sd3_flat_state_dict(dims, seed=0),
                           f[f"sd3_{name}"][0],
                           lambda k, v: testing.sd3_block_qtype(k, v, Q.Q4_K),
                           "sd3")
    unets = {
        # SD1: 8 heads over 320 and 640 channels, head dims 40 and 80
        "sd1": testing.SDXLDims(model_channels=320, channel_mult=(1, 2),
                                num_res_blocks=1, depths=(1, 1), ctx=128,
                                adm=None),
        "sdxl": testing.SDXLDims(model_channels=64, channel_mult=(1, 2),
                                 num_res_blocks=1, depths=(0, 1),
                                 ctx=128 + 1280, adm=64 + 6 * 256),
        "refiner": testing.SDXLDims(model_channels=64, channel_mult=(1, 2),
                                    num_res_blocks=1, depths=(0, 1),
                                    ctx=1280, adm=64 + 5 * 256)}
    for name, dims in unets.items():
        f[name] = (os.path.join(tmp, f"{name}.gguf"), dims)
        testing.write_gguf(
            testing.unet_state_dict(dims, seed=1), f[name][0],
            lambda k, v: testing.unet_block_qtype(k, v, Q.Q4_K),
            "sd1" if name == "sd1" else "sdxl")
    f["t5"] = os.path.join(tmp, "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=1536, d_kv=64, n_heads=8, d_ff=1024, n_layers=2,
            vocab=128), seed=2), f["t5"], qtype=Q.Q8_0,
        tokenizer=testing.unigram_spec(128))
    clip_dir = os.path.join(tmp, "clip")
    os.mkdir(clip_dir)
    for name, dims, seed in (("clip_l", TINY_CLIP_L, 3),
                             ("clip_g", TINY_CLIP_G, 4)):
        f[name] = os.path.join(clip_dir, f"{name}.safetensors")
        _safetensors.save_file(testing.clip_state_dict(
            testing.CLIPDims(**dims), seed=seed), f[name])
    testing.write_clip_vocab(clip_dir, *testing.clip_vocab(600))
    for name, z in (("vae16", 16), ("vae4", 4)):
        f[name] = os.path.join(tmp, f"{name}.safetensors")
        _safetensors.save_file(testing.vae_state_dict(testing.VAEDims(
            z_channels=z, base_ch=32), seed=5), f[name])
    return f


def sd_tiny_phase(dev):
    """Phase 4d: the SD3 and UNet paths at tiny widths from files written
    by the port's writers, on the card and on the CPU with the same noise,
    within 3e-2 (relative L2). (a) three tiny SD3 GGUFs (sd3.5-large-like:
    qk-norm; sd3.5-medium-like: a dual-attention prefix; sd3-medium-like: no
    qk-norm) through ``load_diffusion_model``, planar, then
    ``requantize_i8()`` + ``stack()``; (b) ``SD3Pipeline.load(...)
    .generate`` with a negative prompt, img2img and inpainting, and a kohya
    LoRA on the MMDiT; (c) ``SD1Pipeline`` and ``SDXLPipeline`` (CFG 3),
    the SDXL refiner once; (d) ``sd3_engine`` and ``unet_engine`` serving
    three tiny requests each."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build, _safetensors
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import (
        SD1Pipeline, SD3Pipeline, SDXLPipeline, load_diffusion_model,
        load_vae, sd3_engine, unet_engine)
    from comfyui_gguf_tpu_torch.sampling import (euler_sample,
                                                 linear_schedule)
    from comfyui_gguf_tpu_torch.sampling import kdiffusion as kd

    devs = (dev, "cpu")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    f = _write_sd_files(tmp.name)

    def as_f32(t):
        return (t.float().cpu() if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.asarray(t, np.float32)))

    def check(name, a, b, need=(), counts=None, lim=SAMPLER_DELTA_MAX):
        a, b = as_f32(a), as_f32(b)
        err = rel_l2(a, b)
        out[name] = dict(rel_l2_vs_cpu=err, launches=counts or {})
        log(f"  {name}: card vs CPU plain rel L2 {err:.3e}"
            + (f", launches { {k: n for k, n in counts.items() if n} }"
               if counts else ""))
        if not bool(torch.isfinite(a).all()) or not err <= lim:
            raise SystemExit(f"{name}: card vs CPU rel L2 {err} > {lim}")
        for k in need:
            if not counts or counts[k] == 0:
                raise SystemExit(f"{name} launched no {k}")

    def on_card(fn):
        """fn(device index) on the card with fresh launch counts, then on
        the CPU: (card result, CPU result, card launches)."""
        _build.reset_launch_counts()
        a = fn(0)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        return a, fn(1), counts

    # (a) the three MMDiT variants, 3 Euler steps on example inputs
    for name in ("large", "medium", "sd3"):
        path, dims = f[f"sd3_{name}"]
        models = [load_diffusion_model(path, device=d) for d in devs]
        inputs = [testing.sd3_example_inputs(dims, h_lat=32, w_lat=32,
                                             ctx_len=16, seed=5, device=d)
                  for d in devs]
        sig = linear_schedule(3)

        def run(i):
            lat, ctx, pooled, _ = inputs[i]
            m = models[i]
            with torch.no_grad():
                return euler_sample(lambda x, s: m.forward(
                    x, ctx, pooled, s.expand(1)), lat, sig).cpu()

        a, b, c = on_card(run)
        check(f"tiny sd3 {name} planar", a, b, counts=c,
              need=("qmm_nib4", "qmm_nib4_smallm", "flash_attn_d64"))
        models = [m.requantize_i8().stack() for m in models]
        if not models[0].is_stacked:
            raise SystemExit(f"tiny sd3 {name}: stack() did not stack")
        a, b, c = on_card(run)
        check(f"tiny sd3 {name} w8a8 stacked", a, b, counts=c,
              need=("i8mm", "qmm_nib4_smallm", "flash_attn_d64"))
        del models

    # (b) SD3Pipeline from files: txt2img with a negative prompt (CFG, two
    # forwards a step), img2img, inpainting, then a kohya LoRA
    pipes = [SD3Pipeline.load(f["sd3_large"][0], f["clip_l"], f["clip_g"],
                              f["t5"], f["vae16"], device=d) for d in devs]
    if (pipes[0].clip_g.kind, pipes[0].clip_g.config.act) != ("clip_g",
                                                              "gelu"):
        raise SystemExit("SD3Pipeline.load did not take the 1280-wide CLIP "
                         "as CLIP-G")
    size = 256
    noise = torch.randn((1, size // 8, size // 8, 16),
                        generator=torch.Generator().manual_seed(7))
    init = torch.rand((size, size, 3),
                      generator=torch.Generator().manual_seed(8)).numpy()
    mask = np.zeros((size, size), np.float32)
    mask[: size // 2] = 1.0

    def step_noise(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            200 + i))

    kinds = {"txt2img": {}, "img2img": dict(init_image=init, denoise=0.5),
             "inpaint": dict(init_image=init, denoise=1.0,
                             inpaint_mask=mask)}
    for kind, extra in kinds.items():
        a, b, c = on_card(lambda i: pipes[i].generate(
            PROMPTS[0], negative_prompt="rain", width=size, height=size,
            steps=3, cfg_scale=4.5, noise=noise, step_noise=step_noise,
            max_t5_len=64, **extra))
        check(f"tiny SD3Pipeline {kind}", a, b, counts=c,
              need=("qmm_nib4", "qmm_int8", "flash_attn_d64"))
    lora_path = os.path.join(tmp.name, "sd3_lora.safetensors")
    sd = testing.sd3_flat_state_dict(f["sd3_large"][1], seed=0)
    targets = [(k, *v.shape) for k, v in sd.items()
               if k.startswith("joint_blocks.") and v.ndim == 2
               and ".ln_" not in k]
    _safetensors.save_file(testing.kohya_lora_state_dict(
        targets, rank=8, alpha=8.0, seed=9, std=0.05), lora_path)
    for p in pipes:
        p.model.apply_lora(lora_path, strength=0.8)
    a, b, c = on_card(lambda i: pipes[i].generate(
        PROMPTS[0], negative_prompt="rain", width=size, height=size,
        steps=3, cfg_scale=4.5, noise=noise, max_t5_len=64))
    check("tiny SD3Pipeline with a kohya LoRA", a, b, counts=c,
          need=("qmm_nib4_lora", "qmm_nib4_smallm_lora"))
    clip_l = [p.clip_l for p in pipes]
    clip_g = [p.clip_g for p in pipes]
    del pipes

    # (c) SD1 and SDXL pipelines over the same encoders, and the refiner
    vaes = [load_vae(f["vae4"], device=d)[1:] for d in devs]
    ids = {text: clip_l[1].tokenizer.encode_batch([text], max_length=77)[0]
           for text in (PROMPTS[0], "rain")}
    unet_noise = torch.randn((1, size // 8, size // 8, 4),
                             generator=torch.Generator().manual_seed(9))
    sd1 = [SD1Pipeline(load_diffusion_model(f["sd1"][0], device=d),
                       clip_l[i], *vaes[i]) for i, d in enumerate(devs)]
    a, b, c = on_card(lambda i: sd1[i].generate_from_ids(
        ids[PROMPTS[0]], ids["rain"], width=size, height=size, steps=3,
        cfg_scale=3.0, noise=unet_noise))
    check("tiny SD1Pipeline", a, b, counts=c,
          need=("qmm_nib4", "flash_attn_d40", "flash_attn_d80"))
    sdxl = [SDXLPipeline(load_diffusion_model(f["sdxl"][0], device=d),
                         clip_l[i], clip_g[i], *vaes[i])
            for i, d in enumerate(devs)]
    a, b, c = on_card(lambda i: sdxl[i].generate_from_ids(
        ids[PROMPTS[0]], ids[PROMPTS[0]], ids["rain"], ids["rain"],
        width=size, height=size, steps=3, cfg_scale=3.0, noise=unet_noise,
        sampler="dpmpp_2m"))
    check("tiny SDXLPipeline", a, b, counts=c, need=("flash_attn_d64",))
    refiner = [load_diffusion_model(f["refiner"][0], device=d)
               for d in devs]
    base = unet_noise[0]  # a base latent (h/8, w/8, 4) to refine
    a, b, c = on_card(lambda i: sdxl[i].refine_from_ids(
        base, ids[PROMPTS[0]], ids["rain"], refiner=refiner[i], width=size,
        height=size, steps=4, cfg_scale=2.0, denoise=0.5,
        noise=unet_noise))
    check("tiny SDXL refiner", a, b, counts=c, need=("flash_attn_d64",))

    # (d) the engines: three requests each, mixed schedules, on both
    # devices
    sd3m = [load_diffusion_model(f["sd3_medium"][0], device=d).stack()
            for d in devs]
    dims = f["sd3_medium"][1]
    rng = np.random.default_rng(11)
    sd3_reqs = [(rng.standard_normal((16, 16, 16)).astype(np.float32),
                 {"ctx": rng.standard_normal((24, dims.ctx_dim)).astype(
                      np.float32),
                  "pooled": rng.standard_normal(dims.pooled).astype(
                      np.float32)}, linear_schedule(2 + i))
                for i in range(3)]
    xdims = f["sdxl"][1]
    sig = kd.make_schedule("normal", 3, kd.ddpm_sigmas())
    unet_reqs = [((rng.standard_normal((16, 16, 4)) * sig[0]).astype(
                     np.float32),
                  {"ctx": rng.standard_normal((77, xdims.ctx)).astype(
                       np.float32),
                   "nctx": rng.standard_normal((77, xdims.ctx)).astype(
                       np.float32),
                   "adm": rng.standard_normal(xdims.adm).astype(np.float32),
                   "cfg_scale": np.float32(scale)},
                  kd.make_schedule("normal", 2 + i, kd.ddpm_sigmas()))
                 for i, scale in enumerate((5.0, 1.5, 3.0))]
    for name, mk, models, reqs in (
            ("sd3_engine", sd3_engine, sd3m, sd3_reqs),
            ("unet_engine", unet_engine, [s.model for s in sdxl],
             unet_reqs)):
        def serve(i):
            eng = mk(models[i], max_batch=2, sampler="dpmpp_2m")
            hs = [eng.submit(x.copy(), cond, s) for x, cond, s in reqs]
            eng.run_until_drained()
            if any(h.error is not None or not h.finished for h in hs):
                raise SystemExit(f"tiny {name}: a request failed")
            return np.stack([h.result for h in hs])
        a, b, c = on_card(serve)
        check(f"tiny {name} (3 requests, dpmpp_2m)", a, b, counts=c)
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# phase 10: the SD3.5-large denoise at published width and full depth
# ---------------------------------------------------------------------------

def sd3_denoise_phase(dev, depth, steps):
    """``SD35_LARGE_DIMS`` (hidden 2432, 38 heads of 64, context 4096,
    pooled 2048, pos grid 192), seed-made Q4_K, stacked; 1024² (4096 image
    + 77 + 512 context tokens), Euler on ``shift_sigmas(linear_schedule(
    steps), 3.0)``, CFG 4.5 (two forwards a step), on the bf16-fused tree
    and then on the w8a8 stacked tree; their final latents within 2e-2."""
    import dataclasses

    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel
    from comfyui_gguf_tpu_torch.sampling import (euler_sample,
                                                 linear_schedule,
                                                 shift_sigmas)

    dims = dataclasses.replace(testing.SD35_LARGE_DIMS, depth=depth)
    cfg_scale = 4.5
    log(f"  sd3.5-large width, {depth} of 38 joint blocks, 1024² = 4096 "
        f"image + 589 context tokens, {steps} Euler steps, CFG {cfg_scale}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DiffusionModel(
        arch="sd3", params=testing.sd3_random_stacked_params(
            dims, qtype=Q.Q4_K, seed=0, device=dev),
        config=dims.config(), qcfg=QuantConfig(), device=torch.device(dev))
    torch.cuda.synchronize()
    log(f"  random Q4_K stacked tree built on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    lat, ctx, pooled, _ = testing.sd3_example_inputs(
        dims, h_lat=128, w_lat=128, ctx_len=77 + 512, seed=1, device=dev)
    _, nctx, npooled, _ = testing.sd3_example_inputs(
        dims, h_lat=8, w_lat=8, ctx_len=77 + 512, seed=2, device=dev)
    sigmas = shift_sigmas(linear_schedule(steps), 3.0)

    def vel(x, s):
        t = s.expand(1)
        v_c = model.forward(x, ctx, pooled, t)
        v_u = model.forward(x, nctx, npooled, t)
        return v_u + cfg_scale * (v_c - v_u)

    res = {"depth": depth, "steps": steps, "cfg_scale": cfg_scale}
    finals = {}
    launches = {k: 0 for k in _build.LAUNCHES}
    for tree in ("bf16_fused", "w8a8"):
        if tree == "w8a8":
            t = time.perf_counter()
            model.requantize_i8()
            torch.cuda.synchronize()
            res["requantize_s"] = time.perf_counter() - t
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            out = euler_sample(vel, lat, sigmas)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(_build.LAUNCHES)
        if out.shape != lat.shape or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"sd3 {tree}: non-finite or misshapen latent")
        finals[tree] = out.float()
        per_fwd = {k: n / (2 * steps) for k, n in counts.items() if n}
        res[tree] = dict(request_s=secs, s_per_step=secs / steps,
                         launches=counts, launches_per_forward=per_fwd)
        log(f"  {tree}: {secs:.3f}s, {secs / steps * 1e3:.1f} ms/step (two "
            f"forwards); launches a forward {per_fwd}")
        before = dict(_build.LAUNCHES)  # the profiled forward is no path
        res[f"profile_{tree}_forward"] = profile_forward(
            model, (lat, ctx, pooled, torch.full((1,), 0.7, device=dev)),
            secs / steps / 2, f"sd3.5-large {tree}")
        _build.LAUNCHES.update(before)
        # a forward: one joint attention and two adaLN projections (the
        # split-K body at M = 1) a block, the token linears on K1 (bf16-
        # fused) or K4 (w8a8)
        want = {"flash_attn_d64": depth, "qmm_nib4_smallm": 2 * depth}
        want["i8mm" if tree == "w8a8" else "qmm_nib4"] = 1
        for k, n in want.items():
            if per_fwd.get(k, 0) < n:
                raise SystemExit(f"sd3 {tree}: {per_fwd.get(k, 0)} launches "
                                 f"of {k} a forward, expected {n} or more")
        for k, n in counts.items():
            launches[k] += n
    res["launches"] = launches
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    res["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2**30)
    log(f"  requantize_i8 {res['requantize_s']:.3f}s; final-latent rel "
        f"delta w8a8 vs bf16-fused {res['latent_rel_delta_w8a8_vs_bf16']:.3e}"
        f"; max_memory_allocated {res['max_memory_allocated_gib']:.2f} GiB")
    if not res["latent_rel_delta_w8a8_vs_bf16"] <= LATENT_DELTA_MAX:
        raise SystemExit(f"sd3 w8a8 final latent differs from bf16-fused "
                         f"by rel L2 {res['latent_rel_delta_w8a8_vs_bf16']}")
    return res, model


def _published_clips(dev):
    """CLIP-L and CLIP-G at their published widths (seed-made, dense f32),
    with the 49408-entry synthetic vocabulary."""
    import torch

    from comfyui_gguf_tpu_torch.models import clip, testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer.clip_bpe import CLIPBPETokenizer

    vocab = testing.clip_vocab(testing.CLIP_L_DIMS.vocab)
    encs = []
    for kind, dims, seed in (("clip_l", testing.CLIP_L_DIMS, 11),
                             ("clip_g", testing.CLIP_G_DIMS, 13)):
        params = testing.clip_random_params(dims, seed=seed, device=dev)
        encs.append(TextEncoder(kind, params,
                                clip.CLIPTextConfig.from_state_dict(params),
                                CLIPBPETokenizer(*vocab), QuantConfig(),
                                torch.device(dev)))
    return encs


# ---------------------------------------------------------------------------
# phase 11: SD3.5-large text to image at published widths, and sd3_engine
# ---------------------------------------------------------------------------

def sd3_t2i_phase(dev, model, t5_enc, vae_params, vae_cfg, steps,
                  engine_steps):
    """``SD3Pipeline.generate`` over seed-made parts at published widths:
    phase 10's w8a8 stacked tree, CLIP-L, CLIP-G (1280 x 32 layers), phase
    6's T5-xxl Q8_0 and the 16-channel VAE; one prompt with a negative
    prompt at 1024², CFG 4.5. Then ``sd3_engine(max_batch=2)`` serves three
    requests at this width for ``engine_steps`` steps, each within 1e-2 of
    ``sample_flow`` at batch 1."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import SD3Pipeline, sd3_engine
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)

    t0 = time.perf_counter()
    clip_l, clip_g = _published_clips(dev)
    torch.cuda.synchronize()
    g = clip_g.config
    log(f"  CLIP-G {g.hidden} wide, {g.n_layers} layers, {g.n_heads} heads, "
        f"{g.act}; CLIP-L {clip_l.config.n_layers} layers; T5-xxl "
        f"{t5_enc.config.n_layers} layers Q8_0; VAE z={vae_cfg.z_channels} "
        f"(scale {vae_cfg.scale_factor}, shift {vae_cfg.shift_factor}); "
        f"built in {time.perf_counter() - t0:.2f}s")
    pipe = SD3Pipeline(model, clip_l, clip_g, t5_enc, vae_params, vae_cfg)
    depth = model.config.depth
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    img = pipe.generate(PROMPTS[0], negative_prompt=PROMPTS[1], width=1024,
                        height=1024, steps=steps, cfg_scale=4.5, seed=0)
    counts = dict(_build.LAUNCHES)
    tm = dict(pipe.last_timings)
    lat = pipe.last_latent.float()
    res = dict(steps=steps, timings_s=tm, s_per_step=tm["denoise_s"] / steps,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=dict(counts), image_std=float(img.std()))
    log(f"  prompt + negative prompt, 1024², {steps} steps, CFG 4.5: encode "
        f"(CLIP-L, CLIP-G, T5, twice) {tm['encode_s']:.4f}s, denoise "
        f"{tm['denoise_s']:.3f}s ({res['s_per_step'] * 1e3:.1f} ms/step, two "
        f"forwards), VAE decode {tm['vae_s']:.4f}s, image "
        f"{tm['total_s']:.3f}s; peak {res['peak_gib']:.2f} GiB; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if (img.shape != (1024, 1024, 3) or lat.shape != (1, 128, 128, 16)
            or not bool(np.isfinite(img).all())
            or not bool(torch.isfinite(lat).all())
            or img.min() < 0 or img.max() > 1):
        raise SystemExit("sd3 text to image: misshapen or non-finite output")
    # the MMDiT's joint attention, two forwards a step (the CLIP towers'
    # causal attention is written out); the T5's 7 linears a layer, for
    # the prompt and the negative prompt
    want = {"flash_attn_d64": 2 * depth * steps,
            "qmm_int8": 2 * 7 * t5_enc.config.n_layers}
    for k, n in want.items():
        if counts[k] < n:
            raise SystemExit(f"sd3 text to image: {counts[k]} launches of "
                             f"{k}, expected {n} or more")
    if counts["i8mm"] == 0:
        raise SystemExit("sd3 text to image launched no i8mm")

    # sd3_engine at this width: three requests, CLIP + T5 conds of 589
    # tokens, the third arriving with the first two in the pool
    sig = shift_sigmas(linear_schedule(engine_steps), 3.0)
    gen = torch.Generator(device=dev).manual_seed(30)
    reqs = []
    for i in range(3):
        x = torch.randn((128, 128, 16), generator=gen, device=dev).to(
            torch.bfloat16)
        ctx, pooled = pipe._condition(*(torch.as_tensor(
            enc.tokenizer.encode_batch([PROMPTS[i % 2]], max_length=L)[0],
            device=dev) for enc, L in ((clip_l, 77), (clip_g, 77),
                                       (t5_enc, 512))))
        reqs.append((x, {"ctx": ctx[0], "pooled": pooled[0]}))
    eng = sd3_engine(model, max_batch=2)
    _build.reset_launch_counts()
    t = time.perf_counter()
    hs = [eng.submit(x, c, sig) for x, c in reqs]
    eng.run_until_drained()
    torch.cuda.synchronize()
    res["engine"] = dict(wall_s=time.perf_counter() - t,
                         ticks=eng.stats.batches_executed,
                         launches=dict(_build.LAUNCHES))
    for k, n in _build.LAUNCHES.items():
        counts[k] += n
    errs = []
    for (x, c), h in zip(reqs, hs):
        if h.error is not None or not h.finished:
            raise SystemExit(f"sd3_engine: a request failed: {h.error}")

        def vel(xc, s, c=c):
            return model.forward(xc, c["ctx"][None].to(torch.bfloat16),
                                 c["pooled"][None].to(torch.bfloat16),
                                 s.expand(1))
        with torch.no_grad():
            want_x = sample_flow(vel, x[None], sig)[0]
        errs.append(rel_l2(torch.from_numpy(np.asarray(
            h.result, np.float32)), want_x.float().cpu()))
    res["engine"]["rel_l2_vs_direct"] = errs
    log(f"  sd3_engine(max_batch=2): 3 requests x {engine_steps} steps at "
        f"1024² in {res['engine']['ticks']} ticks, "
        f"{res['engine']['wall_s']:.3f}s; vs sample_flow at batch 1: rel L2 "
        + ", ".join(f"{e:.3e}" for e in errs))
    if not max(errs) <= ENGINE_DELTA_MAX:
        raise SystemExit(f"sd3_engine: a served request differs from "
                         f"sample_flow by rel L2 {max(errs)}")
    res["launches"] = counts
    return res, clip_l, clip_g


# ---------------------------------------------------------------------------
# phase 12: SDXL and SD1 at published widths, and unet_engine
# ---------------------------------------------------------------------------

def unet_phase(dev, clip_l, clip_g, steps, engine_steps):
    """SDXL (``SDXL_DIMS``, seed-made Q4_K, then ``requantize_i8()``)
    through ``SDXLPipeline.generate_from_ids`` at 1024², ``steps`` Euler
    steps on the normal schedule, CFG 7; SD1 (``SD1_DIMS``, Q4_K planar) at
    512² the same way, where K7 must launch its 40-, 80- and 160-wide
    instances; then ``unet_engine`` serves three SDXL-width requests for
    ``engine_steps`` steps, each within 1e-2 of the direct per-request
    step."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing, unet, vae
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (DiffusionModel, SD1Pipeline,
                                                 SDXLPipeline,
                                                 _size_embedding,
                                                 unet_engine)
    from comfyui_gguf_tpu_torch.sampling import kdiffusion as kd

    device = torch.device(dev)
    sd_vae = testing.VAEDims(z_channels=4, base_ch=128, ch_mult=(1, 2, 4, 4),
                             num_res_blocks=2)
    vp = testing.vae_random_params(sd_vae, seed=14, device=dev)
    vc = vae.VAEConfig.from_state_dict(vp)
    launches = {k: 0 for k in _build.LAUNCHES}
    res = {"steps": steps}

    def ids(enc, text):
        return enc.tokenizer.encode_batch([text], max_length=77)[0]

    def build(dims, arch, w8a8):
        t = time.perf_counter()
        params = testing.sdxl_random_params(dims, qtype=Q.Q4_K, seed=0,
                                            device=dev)
        m = DiffusionModel(arch=arch, params=params,
                           config=unet.UNetConfig.from_state_dict(params),
                           qcfg=QuantConfig(), device=device)
        if w8a8:
            m.requantize_i8()
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    for name, dims, size, w8a8 in (("sdxl", testing.SDXL_DIMS, 1024, True),
                                   ("sd1", testing.SD1_DIMS, 512, False)):
        model, build_s = build(dims, name, w8a8)
        if name == "sdxl":
            pipe = SDXLPipeline(model, clip_l, clip_g, vp, vc)
            args = (ids(clip_l, PROMPTS[0]), ids(clip_g, PROMPTS[0]),
                    ids(clip_l, PROMPTS[1]), ids(clip_g, PROMPTS[1]))
        else:
            pipe = SD1Pipeline(model, clip_l, vp, vc)
            args = (ids(clip_l, PROMPTS[0]), ids(clip_l, PROMPTS[1]))
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = pipe.generate_from_ids(*args, width=size, height=size,
                                     steps=steps, cfg_scale=7.0, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(_build.LAUNCHES)
        for k, n in counts.items():
            launches[k] += n
        res[name] = dict(build_s=build_s, image_s=secs, launches=counts,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         tree="w8a8" if w8a8 else "Q4_K planar")
        log(f"  {name} ({res[name]['tree']}, built in {build_s:.2f}s): "
            f"{size}², {steps} Euler steps, CFG 7 (two forwards a step): "
            f"image {secs:.3f}s ({secs / steps * 1e3:.1f} ms a step with "
            f"CLIP and VAE decode); peak {res[name]['peak_gib']:.2f} GiB; "
            f"launches { {k: n for k, n in counts.items() if n} }")
        if (img.shape != (size, size, 3) or not bool(np.isfinite(img).all())
                or img.min() < 0 or img.max() > 1):
            raise SystemExit(f"{name}: misshapen or non-finite image")
        # where a forward's device time goes (not a path: its launches are
        # not counted)
        gp = torch.Generator(device=dev).manual_seed(50)
        inputs = (torch.randn((1, size // 8, size // 8, 4), generator=gp,
                              device=dev).to(torch.bfloat16),
                  torch.tensor([500.0], device=dev),
                  torch.randn((1, 77, dims.ctx), generator=gp,
                              device=dev).to(torch.bfloat16),
                  None if dims.adm is None else torch.randn(
                      (1, dims.adm), generator=gp, device=dev).to(
                          torch.bfloat16))
        before = dict(_build.LAUNCHES)
        with torch.no_grad():
            res[name]["profile_forward"] = profile_forward(
                model, inputs, secs / steps / 2, f"{name} {res[name]['tree']}")
        _build.LAUNCHES.update(before)
        fwd = 2 * steps
        if name == "sd1":
            # 8 heads: levels 0, 1, 2 (320 / 640 / 1280 channels) have two
            # transformers down and three up, the mid block one; self and
            # cross attention in each
            want = {"flash_attn_d40": 10 * fwd, "flash_attn_d80": 10 * fwd,
                    "flash_attn_d160": 12 * fwd, "qmm_nib4": 1,
                    "qmm_nib4_smallm": 1}
        else:
            want = {"flash_attn_d64": 1, "i8mm": 1, "qmm_nib4_smallm": 1}
        for k, n in want.items():
            if counts[k] < n:
                raise SystemExit(f"{name}: {counts[k]} launches of {k}, "
                                 f"expected {n} or more")
        if name == "sd1":
            for k in ("flash_attn_d40", "flash_attn_d80", "flash_attn_d160"):
                if counts[k] != want[k]:
                    raise SystemExit(f"sd1: {counts[k]} launches of {k}, "
                                     f"expected {want[k]}")
            del model, pipe
            continue
        sdxl = model
    torch.cuda.empty_cache()

    # unet_engine at SDXL width: three requests with the encoders' conds
    # and per-request CFG scales, against the same step at batch 1
    sig = kd.make_schedule("normal", engine_steps, kd.ddpm_sigmas())
    table = kd.ddpm_sigmas()
    gen = torch.Generator(device=dev).manual_seed(40)
    reqs = []
    with torch.no_grad():
        for i, scale in enumerate((7.0, 5.0, 3.0)):
            l_out, g_out = (enc.encode(torch.as_tensor(
                ids(enc, PROMPTS[i % 2]), device=dev))
                for enc in (clip_l, clip_g))
            nl_out, ng_out = (enc.encode(torch.as_tensor(
                ids(enc, ""), device=dev)) for enc in (clip_l, clip_g))
            adm = torch.cat([g_out["pooled"], _size_embedding(
                [1024, 1024, 0, 0, 1024, 1024], g_out["pooled"])], dim=-1)
            x = (torch.randn((128, 128, 4), generator=gen, device=dev)
                 * float(sig[0]))
            reqs.append((x, {
                "ctx": torch.cat([l_out["penultimate"],
                                  g_out["penultimate"]], -1)[0],
                "nctx": torch.cat([nl_out["penultimate"],
                                   ng_out["penultimate"]], -1)[0],
                "adm": adm[0], "cfg_scale": torch.tensor(scale)}))
    eng = unet_engine(sdxl, max_batch=4)
    _build.reset_launch_counts()
    t = time.perf_counter()
    hs = [eng.submit(x, c, sig) for x, c in reqs]
    eng.run_until_drained()
    torch.cuda.synchronize()
    res["engine"] = dict(wall_s=time.perf_counter() - t,
                         ticks=eng.stats.batches_executed,
                         launches=dict(_build.LAUNCHES))
    for k, n in _build.LAUNCHES.items():
        launches[k] += n

    def direct(x, c):
        """The engine's step (k-diffusion eps parameterization, CFG as two
        forwards) for one request at batch 1."""
        x = x[None].to(torch.bfloat16)
        ctx, nctx, adm = (c[k][None].to(torch.bfloat16)
                          for k in ("ctx", "nctx", "adm"))
        with torch.no_grad():
            for i in range(len(sig) - 1):
                s = torch.tensor([sig[i]], device=dev)
                c_in = 1.0 / torch.sqrt(1.0 + s ** 2)
                xs = (x.float() * c_in).to(torch.bfloat16)
                t_ = kd.sigma_to_t(s, table)
                e_c, e_u = (sdxl.forward(xs, t_, cc, adm).float()
                            for cc in (ctx, nctx))
                eps = e_u + float(c["cfg_scale"]) * (e_c - e_u)
                x = (x.float() + float(sig[i + 1] - sig[i]) * eps).to(
                    torch.bfloat16)
        return x[0].float().cpu()

    errs = []
    for (x, c), h in zip(reqs, hs):
        if h.error is not None or not h.finished:
            raise SystemExit(f"unet_engine: a request failed: {h.error}")
        errs.append(rel_l2(torch.from_numpy(np.asarray(h.result,
                                                       np.float32)),
                           direct(x, c)))
    res["engine"]["rel_l2_vs_direct"] = errs
    log(f"  unet_engine(max_batch=4): 3 SDXL requests x {engine_steps} "
        f"steps at 1024², CFG 7 / 5 / 3, in {res['engine']['ticks']} ticks, "
        f"{res['engine']['wall_s']:.3f}s; vs the step at batch 1: rel L2 "
        + ", ".join(f"{e:.3e}" for e in errs))
    if not max(errs) <= ENGINE_DELTA_MAX:
        raise SystemExit(f"unet_engine: a served request differs from the "
                         f"direct step by rel L2 {max(errs)}")
    res["launches"] = launches
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-double", type=int, default=19)
    ap.add_argument("--depth-single", type=int, default=38)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--t5-layers", type=int, default=24)
    ap.add_argument("--sd3-depth", type=int, default=38)
    ap.add_argument("--sd3-steps", type=int, default=28)
    ap.add_argument("--unet-steps", type=int, default=20)
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
                    for d in (40, 64, 80, 128, 160))
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
    log("[4c every flow sampler through the tiny flux, card vs CPU]")
    menu = sampler_menu_phase(dev)
    log("[4d tiny SD3 / SD1 / SDXL from files, card vs CPU]")
    sd_tiny = sd_tiny_phase(dev)

    log("[5 denoise path at flux-dev width]")
    main_res, model, request = main_path_phase(dev, args.depth_double,
                                               args.depth_single, args.steps)

    log("[6 text to image at published widths]")
    t2i, pipe, base_latent, base_run = text_to_image_phase(
        dev, model, request, args.steps, args.t5_layers)
    del model

    # phase 9 runs on phase 6's flux tree before phase 7 replaces it
    log("[9 serving at flux-dev width and depth: flux_engine, "
        "ResidentModelServer]")
    serve_res, params_a = serving_phase(dev, pipe, args.steps, base_run)
    pipe.model = dataclasses.replace(pipe.model, params=params_a)
    del params_a
    gc.collect()  # the server's host copies (its engines hold a cycle)
    torch.cuda.empty_cache()

    log("[7 a rank-16 LoRA over every block linear of flux-dev, at full "
        "width]")
    lora_res = lora_phase(dev, pipe, request, base_latent, base_run,
                          args.steps)
    # phase 11 takes phase 6's T5-xxl and 16-channel VAE; the flux goes
    t5_enc, vae_params, vae_cfg = pipe.t5, pipe.vae_params, pipe.vae_config
    del pipe
    torch.cuda.empty_cache()

    log("[8 the GEMM probe tool]")
    tool_counts = probe_tool_phase()

    log("[10 the sd3.5-large denoise at published width]")
    sd3_res, sd3_model = sd3_denoise_phase(dev, args.sd3_depth,
                                           args.sd3_steps)
    log("[11 sd3.5-large text to image at published widths, sd3_engine]")
    sd3_t2i, clip_l, clip_g = sd3_t2i_phase(
        dev, sd3_model, t5_enc, vae_params, vae_cfg, args.sd3_steps,
        min(args.steps, 4))
    del sd3_model, t5_enc, vae_params
    torch.cuda.empty_cache()
    log("[12 SDXL and SD1 at published widths, unet_engine]")
    unet_res = unet_phase(dev, clip_l, clip_g, args.unet_steps,
                          min(args.steps, 4))

    # launches of each kernel over the driven paths (every path had its
    # counts set to 0 just before it and read just after)
    launches = {k: 0 for k in _build.LAUNCHES}
    for counts in (*(v["launches"] for v in tiny.values()),
                   *(v["launches"] for v in tiny_pipe.values()),
                   *(v["launches"] for v in sd_tiny.values()),
                   menu["launches"], main_res["launches"], t2i["launches"],
                   serve_res["launches"], lora_res["launches"], tool_counts,
                   sd3_res["launches"], sd3_t2i["launches"],
                   unet_res["launches"]):
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
