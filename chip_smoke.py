#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``comfyui_gguf_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--depth-double N] [--depth-single N] [--steps N]
                          [--t5-layers N] [--sd3-depth N] [--sd3-steps N]
                          [--unet-steps N] [--aura-depth-single N]
                          [--aura-steps N] [--lumina-depth N]
                          [--lumina-steps N] [--llama-layers N]
                          [--qwen-depth N] [--qwen-steps N]
                          [--qwen-encoder-layers N] [--qwen-vision-layers N]
                          [--hidream-depth-double N]
                          [--hidream-depth-single N] [--hidream-steps N]
                          [--hidream-t5-layers N] [--hidream-llama-layers N]
                          [--hidream-budget-blocks DOUBLE SINGLE]
                          [--wan-depth N] [--wan-steps N] [--umt5-layers N]
                          [--cosmos-depth N] [--cosmos-steps N]
                          [--cosmos-t5-layers N] [--hyvid-depth-double N]
                          [--hyvid-depth-single N] [--hyvid-steps N]
                          [--hyvid-llama-layers N] [--ltxv-depth N]
                          [--ltxv-steps N] [--ltxv-t5-layers N]
                          [--tools-depth-double N] [--tools-depth-single N]
                          [--tools-steps N] [--scripts-steps N]
    python3 chip_smoke.py --only PHASE [PHASE ...] [the flags above]

It drives the port's main paths — the flux denoise of ``bench.py``'s
configuration, flux text-to-image end to end (tokenizers, T5-xxl and
CLIP-L encode, denoise, VAE decode), SD3.5-large, the SD1/SDXL UNets,
AuraFlow v0.3, Lumina Image 2.0, Qwen-Image (with Qwen-Image-Edit and the
Qwen2.5-VL vision tower), HiDream-I1, Wan 2.1 t2v, HunyuanVideo and
LTX-Video (each with its causal 3-D VAE) and Cosmos — on the card through the entry points a user calls, and fails
(non-zero exit, no result line) on any failed phase:

1. device: name, count, ``nvidia-smi`` name and power limit; no CUDA device
   is a failure;
2. build: the CUDA kernels are compiled from ``comfyui_gguf_tpu_torch/csrc``
   (one nvcc per source, in parallel) and loaded; ``ptxas`` registers (and,
   for the int8 attention, its prep and the GEMM probes, spills; for the
   fused matmuls each instance's registers and spills, the LoRA instances
   beside the unpatched ones; for flash attention each head-dim instance's)
   and the dynamic shared memory of the TMA-fed kernels are printed; the
   host block codecs (``native/quant_kernels.cc``) are built with the host
   C++ compiler, and the compiler, its flags, the build seconds,
   the thread count and the CPU model are printed; a
   ``wgmma`` serialization advisory (ptxas C751x) or a spill in any K1/K2
   or K7 instance fails (K7's f32 instances, the 3xTF32 wgmma body,
   among them), and the wgmma body's resident blocks per K-split cluster
   size are printed beside the plan's;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the main paths' shapes, with its time (CUDA events over a CUDA
   graph of many launches), the plain version's time, the time of one
   PyTorch library call computing the same product, and the bound (the
   larger of bytes over 3.35 TB/s and operations over the H100 SXM peak).
   K1/K2 run through both of their bodies (split-K for M <= 8, wgmma
   above, its K split over a cluster where the plan says so), on float32
   and, at the flux modulation and the T5-xxl projection, bfloat16 scale
   planes, and every launch must give the same bits twice; at the encoder
   shapes and flux's qkv and linear1 the wgmma body also runs at the other
   (token tiles, K split) pairs, each checked and timed as a row of its
   own beside the plan's pick; K4 runs at
   both of its tile widths, the one ``i8mm_plan`` picks giving the row's
   time, and its library call reads the int8 weight in the TN form
   cuBLASLt's int8 path takes; K6 runs at head dims 128, 256 and 512 (its
   split instance) on the operands of its prep kernel, which is held
   against the plain prep (q
   and v codes and their scales equal, k codes within one step, two
   launches equal) and timed beside it. The LoRA instances of K1/K2 (both
   bodies) and K4 (the rank term h @ upᵀ in the epilogue) run at the main
   path's shapes against their plain versions with the same rank operands,
   timed beside the unpatched instance; at strength 0 (up scaled by 0) each
   must equal the unpatched launch. The f16 and f32 instances of K1/K2
   (dequant_dtype float16 / float32) run at flux's modulation (the split-K
   body, nib4 and int8), flux's qkv (K1: the wgmma body at f16, the f32
   FMA body) and the T5-xxl q projection (K2), with and without a rank-16
   LoRA in the dequant dtype, against the plain version in the same dtype
   (f16 ≤ 2e-3, f32 ≤ 1e-5), their library call one ``torch.matmul`` in
   that dtype, and the f32 split-K body also at M = 2 (a CFG batch); K7
   at D = 128 at Wan 2.1's self- and cross-attention and Cosmos's, and at
   D = 384 and 512 (the wide-head body: the scores once) at the Wan and
   HunyuanVideo VAEs' mid-blocks (3 frames of 60 x 104), every K7 row
   launched twice for the same bits. K7's f16 and f32 instances run at
   flux's joint attention (f16 within bf16's 1e-2, f32 within 1e-5 of the
   plain version in the same dtype, their library call SDPA in that
   dtype), and at the two VAEs' mid-blocks; the f32 rows run with TF32
   matmuls off (the plain version and the K1/K2 library call in full f32,
   both settings printed) and print
   SDPA f32's own distance to the plain version beside the kernel's; K6
   "pv" and "qk" and its prep on f16 and f32 q/k/v at flux's shape, the
   output in q's dtype;
4. tiny end to end, card against CPU: (a) a small flux GGUF mixing Q4_K,
   Q8_0 and Q6_K tensors through ``load_diffusion_model`` and a few Euler
   steps, planar and after ``requantize_i8()``; then with a LoRA of every
   patch type (rank patches on every block linear, LoCon mid, LoHa, GLoRA)
   through ``apply_lora``, planar and after ``requantize_i8()`` and
   ``stack()``; then ``unapply_loras()``, which must give the unpatched
   stacked model's latent exactly; the same GGUF then loads with
   ``dequant_dtype="float16"`` and ``"float32"`` (``patch_dtype`` float16)
   and runs planar and with the LoRA, each launching that dtype's instances
   of both bodies over both layouts and no bf16 one; (b) a tiny
   ``FluxPipeline``
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
   tree runs under ``torch.profiler`` for the device-time breakdown, and
   one forward of the bf16-fused tree at ``QuantConfig(dequant_dtype=
   torch.float32)`` (the loader's Advanced knob: K1/K2's f32 bodies) is
   timed and its launches counted as a path of its own;
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
   batch 1;
13. AuraFlow v0.3: ``AURA_V03_DIMS`` (hidden 3072, 12 heads of 256, 4
   double + 32 single layers unless ``--aura-depth-single`` cuts them),
   seed-made Q4_K stacked, with Pile-T5-XL (24 layers, Q8_0) through
   ``AuraPipeline.generate`` at 1024² (4096 image + 256 text + 8 register
   tokens), ``--aura-steps`` (20) steps, CFG 3.5, shift 1.73, with a
   negative prompt, on the bf16-fused tree and then on the w8a8 tree;
   K7's 256-wide instance must launch 36 times a forward; then one
   forward of each tree runs with every kernel call also through its plain
   version on the same operands: K4 and K1/K2 within 2e-3, K7 within 1e-2,
   and each K4 call's control (its plain version with unrounded
   activations) above 2e-3; on the w8a8 tree every block, fed the
   bf16-fused tree's inputs to it, within 1e-1 of the bf16-fused block;
   the w8a8 tree's distance from the bf16-fused one over a forward and in
   the final latent is recorded (the random stack carries a last-bit
   difference on through the int8 activation codes and grows it: PERF.md,
   Findings, PR 9); a bf16-fused forward under ``attention_i8("pv")`` at
   a 248-token prompt (4352 tokens, inside the int8 gate) takes K6's
   256-wide instance in every layer, each K6 call within 1e-2 of its plain
   version and every block within 3e-2 of the same block with the default
   attention; then
   ``aura_engine(max_batch=2)`` serves two requests for min(steps, 4)
   steps, each within 1e-2 of ``sample_flow`` at batch 1;
14. Lumina Image 2.0: ``LUMINA2_DIMS`` (dim 2304, 24 heads of 96, 26 layers
   unless ``--lumina-depth`` cuts them, 2 + 2 refiners), seed-made Q4_K
   stacked, with the llama graph at Gemma-2-2b's shapes (Q8_0,
   ``--llama-layers`` (26) layers, its 256000-row embedding through the
   loader's big-embed guard) through ``Lumina2Pipeline.generate`` at 1024²,
   ``--lumina-steps`` (20) steps, CFG 4.0, shift 6.0; the same two trees,
   checks and records as phase 13; K7's 96-wide launches (the 128-wide
   instance) must be 30 a forward; then ``lumina2_engine`` as phase 13's
   engine. Phases 13
   and 14 free their trees (``lifecycle.free_tree``) when they end;
15. Qwen-Image: ``QWEN_IMAGE_20B_DIMS`` (hidden 3072, 24 heads of 128, 30
   of its 60 blocks by default, ``--qwen-depth``), seed-made Q4_K stacked, with
   the llama graph at Qwen2.5-VL-7B's shapes (Q8_0, 28 layers, 28 heads /
   4 kv heads of 128, q/k/v biases, its 152064-row embedding through the
   big-embed guard; the config built as the reference's own test builds
   it: 28 heads, rope theta 1e6, M-RoPE (16, 24, 24), eps 1e-6) through
   ``QwenImagePipeline.generate`` at 1024² with the reference's defaults
   (20 steps, CFG 4.0, shift 2.2, 256 tokens, negative " "), on the
   bf16-fused tree and then on the w8a8 tree (img_mod / txt_mod planar): K7
   once a block a forward, two forwards a step, and phase 13's gates and
   records; the Qwen2.5-VL vision tower (1280 wide, 32 blocks of 16 heads ×
   80, windowed, full blocks 7/15/23/31, merged to 3584) on a 448² image
   spliced through ``qwen_vl_encode_with_image``, then ``generate_edit``
   with one 128 × 128 × 16 reference latent for 4 steps on it (about 8480
   tokens); ``qwen_image_engine`` as phase 13's engine;
16. HiDream-I1: ``HIDREAM_I1_DIMS`` (hidden 2560, 20 heads of 128, 8 + 16
   of its 16 + 32 blocks by default, ``--hidream-depth-double`` /
   ``--hidream-depth-single``, FFN 6912, 4 routed experts top-2 plus the shared one), seed-made
   Q4_K stacked, with CLIP-L, CLIP-G, T5-xxl (Q8_0) and the llama graph at
   Llama-3.1-8B's shapes (Q8_0, 32 layers, 128256 rows through the guard)
   through ``HiDreamPipeline.generate_from_ids`` at 1024², 20 steps (one
   forward a step), 128 T5 + 128 llama tokens, both trees: K7 once a block
   a forward, phase 13's gates (each block's top-2 routing recorded on both
   trees: the tokens whose sets differ), w8a8 forwards in "capacity"
   dispatch with each block also run in "dense" dispatch on the same
   inputs, at the default capacity factor 1.5 (overflows recorded) and at
   E/k = 2, where no expert can overflow (each block within 1e-2),
   ``hidream_engine`` as phase 13's engine; then a ``--hidream-budget-
   blocks`` (2 + 4) tree at published width converts on the card and, a
   fresh one, under a budget of its planar bytes plus 60% of the full
   conversion's byte delta with ``host_stage=True``: the planned share and
   the card's peak during each conversion are printed. Phases 15 and 16
   free their trees when they end;
17. Wan 2.1 14B: ``WAN_14B_DIMS`` (dim 5120, 40 heads of 128, ffn 13824,
   20 of its 40 blocks by default, ``--wan-depth``), seed-made Q4_K stacked,
   with the UMT5-xxl-shaped encoder (Q8_0, ``--umt5-layers`` (24) layers, a
   relative-bias table in each, 256384 rows) and the Wan 2.1 VAE at its
   published widths (base 96, z 16, mult 1/2/4/4) through
   ``WanPipeline.generate`` at 480×832 with 9 pixel frames (a 3 × 60 × 104
   latent, 4680 tokens; 512 UMT5 tokens with the padded positions
   zeroed), shift 5.0, CFG 5.0, ``--wan-steps`` (20) steps and a dispatch
   window of 4, decoded to 9 frames (the VAE's mid-block attention on K7's
   f32 instance at D = 384), on the bf16-fused tree and then on the w8a8 tree,
   with phase 13's gates (K7 D = 128 twice a block a forward) and
   records, and the VAE decode timed alone (``vae_decode_ms``: five
   decodes of the last latent, each between CUDA events);
   ``wan_engine`` as phase 13's engine (two steps). Published Wan 480p is
   81 frames (32760 tokens): the frame count is the cut;
18. Cosmos: ``COSMOS_7B_DIMS`` (dim 4096, 32 heads of 128, 28 blocks unless
   ``--cosmos-depth`` cuts them), seed-made Q4_K stacked, with a T5
   encoder of output width 1024 (t5-v1_1-large widths, Q8_0,
   ``--cosmos-t5-layers`` (24) layers) through ``CosmosPipeline.generate``
   at 1024² (one 128 × 128 latent frame, 4096 tokens; 256 T5 tokens),
   shift 1.0, CFG 4.0, ``--cosmos-steps`` (20) steps, both trees, phase
   13's gates and records (the adaLN modulations planar: the split-K body
   3 times a block), ``cosmos_engine`` (two steps). Phases 17 and 18 free
   their trees when they end;
19. HunyuanVideo 13B: ``HYVID_13B_DIMS`` (hidden 3072, 24 heads of 128, 2
   refiner blocks, 20 double + 40 single blocks unless
   ``--hyvid-depth-double`` / ``--hyvid-depth-single`` cut them), seed-made
   Q4_K stacked, with the Llama-3.1-8B-shaped llama encoder (Q8_0,
   ``--hyvid-llama-layers`` (32) layers, 128256 rows through the guard)
   and the HunyuanVideo VAE at its published widths (128/256/512/512, z
   16) through ``HyVidPipeline.generate`` at 480×832 with 9 pixel frames (a
   3 × 60 × 104 latent, 4680 + 256 tokens), guidance 6.0, shift 7.0,
   ``--hyvid-steps`` (20) steps, one forward a step, decoded to 9 frames
   (the VAE's mid-block attention on K7's f32 instance at D = 512), both
   trees
   (img_mod / txt_mod / modulation planar: the split-K body), phase 13's
   gates (K7 D = 128 62 times a forward) and records, the VAE decode
   timed alone as in phase 17; ``hyvid_engine`` (two steps). The reference's default is 9 latent frames (33 pixel
   frames): the frame count is the cut;
20. LTX-Video 2B: ``LTXV_2B_DIMS`` (dim 2048, 32 heads of 64, 28 blocks
   unless ``--ltxv-depth`` cuts them), seed-made Q4_K stacked, with T5-xxl
   (Q8_0, ``--ltxv-t5-layers`` (24) layers) and the LTX-Video 0.9 VAE
   (128/256/512/512, 128 latent channels) through ``LTXVPipeline.generate``
   at the published 768×512 and 121 frames (16 × 16 × 24 = 6144 voxels;
   256 T5 tokens), CFG 3.0, shift 3.0, ``--ltxv-steps`` (20) steps,
   decoded to 121 × 512 × 768, both trees, phase 13's gates (K7 D = 64 56
   times a forward, self and cross) and records; ``ltxv_engine`` (two
   steps). Phases 19 and 20 free their trees when they end;
21. the host block codecs at published widths, on the card machine's
   host: ``native.quantize`` Q4_K over one flux-dev double block's and one
   single block's weights (M parameters a second, the 19 / 38 blocks of
   the full model by extrapolation, the first rows of each weight equal
   to numpy), then one 3072 × 12288 tensor per covered operation (encode
   Q4_0 / Q8_0 / Q4_K / Q5_K / Q6_K on f32 and on bf16-rounded input,
   decode Q4_0 / Q8_0 / Q4_K / Q6_K, extract Q2_K-Q6_K, the nib4 pack and
   the int8 transpose), each byte-equal to its numpy function and timed
   beside it (a difference fails the phase). Then the offline tools as a
   user runs them (on the library for every covered qtype): a
   flux-dev-width checkpoint
   (3072, 24 heads of 128, context 4096, vec 768, guidance embed; depth
   ``--tools-depth-double`` 1 + ``--tools-depth-single`` 2) with the
   published BFL key names in bf16, written by the port's safetensors
   writer under a ComfyUI-style root and found through ``ModelRegistry``;
   ``tools.convert`` (BF16 GGUF) and ``tools.quantize`` Q4_K_M (seconds,
   GB/s, M parameters a second on the host, beside the numpy-only
   quantizer's figures at 2 + 4 blocks in PERF.md §5), ``read_tensors``' census held
   to the recipe over the names (Q4_K, Q5_K qkv, the no-quant list float),
   ``validate_checkpoint`` clean (exit 0, no unexpected key), then
   ``load_diffusion_model(..., "cuda")`` (seconds; one leaf of each qtype
   dequantized on the card equal to ``codecs.dequantize`` of the file's
   payload). On the bf16-fused tree and then the w8a8 one: one 1024²
   forward under phase 13's kernel-call gates (and the block gate for
   w8a8), one under ``observability.trace`` read back by
   ``tools.read_trace`` (its launches by family equal to what the census
   and the depth imply and to the launch counters, its family sums within
   1% of ``profile_forward``'s), and a ``--tools-steps`` (4) Euler
   denoise (ms a step, peak memory). Between the trees, ``ops.autotune``
   over the tree's planar shapes at m = 4608, 4096 and 512: every legal
   candidate timed (one that fails to launch fails the phase), each
   within 2e-3 of the plain version and equal on two launches, the table
   saved, cleared and loaded back equal, the forward under the gates with
   it, and its device time beside the plan's in turns (plan, tuned,
   tuned, plan) of 16 forwards each, with the difference's two standard
   errors;
22. parallelism: two ranks share the card over gloo (``parallel.launch``;
   the parent has built the kernel library, the ranks load it and return
   their launch counts): flux-dev at published width and depth, seed-made
   Q4_K, sharded on the card at tp = 2 (``shard_packed_params``, both
   layouts), a 1024² forward of ``tp_spec.tp_flux_forward`` and of
   ``tp_flux.tp_forward_stacked`` on the bf16-fused and on the w8a8 tree
   (every kernel call of a spec forward against its plain version; both TP
   forwards within 3e-2 of the unsharded forward of the same codes; a w8a8
   TP single block within 1e-1 of the unsharded w8a8 block), then
   ``flux_engine`` with the tp mesh (2 requests × ``--parallel-steps`` (4)
   Euler steps, within 1e-2 of the TP direct sampler) and with a dp mesh
   (within 1e-2 of each request alone at batch 1; bit-equality recorded),
   the 38 single blocks over two pipeline stages (batch 2 in 2
   microbatches, within 1e-2 of the sequential walk), a HiDream-I1 MoE FFN
   over ep = 2 against dense dispatch, ring attention at Wan 2.1 14B's
   self-attention shape against K7 on the whole sequence and one Wan block
   under ``sequence_parallel`` against the unsharded block (each within
   1e-2), and every ``tp_spec`` wrapper (nine archs) at a tiny size on the
   card against the same ranks on the CPU (within 3e-2), with bf16 and
   again with f32 activations (each arch's f32 pass must launch K7's f32
   instance). Each rank logs ms a forward, ms in collectives, bytes staged
   through the host, launches a forward and its peak memory;
23. the six entry scripts of ``examples/`` (run inside phase 21's
   directory, on its Q4_K_M flux-dev file and its BF16 GGUF, beside a
   T5-xxl-width Q8_0 GGUF with a tokenizer, CLIP-L, CLIP-G, the flux VAE,
   an sd3.5-large-width file of 2 blocks, Qwen-Image of 1 block and
   HiDream-I1 of 1 + 1, all seed-made at published widths), at 1024² and
   ``--scripts-steps`` (4) steps: ``torch_generate_flux``,
   ``torch_serve_flux --i8 --preview-every 2 --max-batch 2``,
   ``torch_serve_multi`` and ``torch_serve_sd3`` in this process
   (``runpy``; their launches counted), ``torch_serve_qwen_tp`` and
   ``torch_serve_hidream_tp --i8`` at tp = 2 with ``--smoke`` as
   subprocesses; each must exit 0 and write finite files, the txt2img
   image must equal ``FluxPipeline.generate`` of the same seed bit for
   bit, and K1/K2/K4/K7 must have launched. Each script's wall is logged.

Phase 4i runs attention in q's dtype through the models, card against
CPU within 3e-2: a tiny flux forward (four heads of 128) at f16 and at f32
activations, plain and under ``attention_i8("pv")`` / ``("qk")`` at 512
joint tokens, each launching its dtype's K7 instance (or K6 and its prep)
once a block and no bf16 attention instance; a small Wan VAE decode at
f32 compute (K7 f32); and the Wan 2.1 and HunyuanVideo VAEs at published
widths decoding one 8 x 8 latent frame in f32 (K7's f32 instance, as the
pipelines hand their f32 latents) and in bf16 (the bf16 D = 384 / 512
instances).

Phase 4c runs every ``FLOW_SAMPLERS`` and ``FLOW_STOCHASTIC_SAMPLERS`` name
through phase 4a's tiny flux GGUF (Q4_K) on the card and on the CPU with the
same noise, within 3e-2 (relative L2). Phase 4d does the same for the SD
paths from files the port's writers make: three tiny SD3 variants (qk-norm,
a dual-attention prefix, neither) planar and w8a8 stacked, a tiny
``SD3Pipeline`` (negative prompt, img2img, inpainting, a kohya LoRA), tiny
SD1 and SDXL pipelines and the refiner, and ``sd3_engine`` and
``unet_engine`` with three requests each. Phase 4e does it for tiny
AuraFlow (two heads of 256) and Lumina 2 (16 heads of 96) GGUFs with a
2-layer T5 and a 2-layer llama-family encoder (65536 tokens, so its
embedding takes the big-embed guard): both pipelines with a negative
prompt on the planar trees, then both engines on the w8a8 stacked trees.
Phase 4f does it for tiny Qwen-Image and HiDream GGUFs (4 heads of 128,
HiDream's 4 experts top-2) with a 2-layer qwen2vl encoder GGUF whose tiny
mmproj sidecar sits beside it, a 2-layer T5 and tiny CLIP-L / CLIP-G:
``QwenImagePipeline.generate`` and ``generate_edit`` (on an image through
``qwen_vl_encode_with_image``), ``HiDreamPipeline.generate_from_ids`` in
dense and capacity dispatch, then both engines on the w8a8 stacked trees,
each request also within 1e-2 of the direct sampler on the card. Phase 4g
does it for tiny Wan 2.1 and Cosmos GGUFs (4 heads of 128) with 2-layer
UMT5 and T5 GGUFs and a small Wan VAE safetensors file (its middle 64
wide, its attention on K7's f32 instance): ``WanPipeline.generate`` (CFG, latent statistics, the VAE decode, a
dispatch window) and ``CosmosPipeline.generate``, then ``wan_engine`` and
``cosmos_engine`` on the w8a8 stacked trees, each request within 1e-2 of
the direct sampler on the card and a snapshot after one tick restored
into a fresh engine within 1e-3 of the uninterrupted run. Phase 4h does it
for tiny HunyuanVideo (4 heads of 128) and LTX-Video (8 heads of 64)
GGUFs with phase 4e's 2-layer llama-family encoder, a 2-layer T5 and
small HunyuanVideo (its middle 64 wide, K7 f32) and LTX-Video VAE safetensors
files: ``HyVidPipeline.generate`` and ``LTXVPipeline.generate`` with
their VAEs and without, both VAEs' decode and encode → decode, then
``hyvid_engine`` and ``ltxv_engine`` on the w8a8 stacked trees, each
request within 1e-2 of the direct sampler on the card.
Phase 3 also times K4, K7 and the split-K body at the serving shapes of
four stacked requests, K7 at SD1's head dims 40, 80 and 160 and the
sd3.5-large joint length, K4 and the split-K body at the sd3.5-large and
SD1 shapes, and K7 (96 and 256), K4, K1/K2 and K6 (256) at the AuraFlow,
Lumina 2, Pile-T5-XL and Gemma-shaped encoder shapes, K4, K1's
split-K body, K2 and K7 at the Qwen-Image, HiDream and Qwen2.5-VL encoder
shapes, and K7 at the Wan, Cosmos, HunyuanVideo (joint D = 128, the VAE's
D = 512) and LTX-Video (self and cross D = 64) shapes.

Phases 13, 14, 18, 19 and 20 default to half depth (AuraFlow 16 single
layers, Lumina 2 13, Cosmos 14, HunyuanVideo 10 + 20, LTX-Video 14) and
15, 16, 17 and 21 too (Qwen-Image 30, HiDream 8 + 16, Wan 20, the tools'
file 1 + 2), for the time limit; the flags restore the published depths.

Launch counts are set to 0 just before each driven path and read just
after. The last lines are the card's ``nvidia-smi`` name and power limit,
the kernel table as JSON, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import statistics
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
# f32 FMAs outside the tensor cores (the f32 instances of K1/K2)
PEAK_F32 = 67e12
# TF32 on the tensor cores: K7's f32 instances run each f32 product as three
# TF32 products (3xTF32), so their bound is 3 x operations / PEAK_TF32
PEAK_TF32 = 495e12

# most relative L2 allowed between the w8a8 and bf16-fused final latents
LATENT_DELTA_MAX = 2e-2
# most relative L2 allowed between an int8-attention final latent or image
# and the default-attention one of the same request
I8ATTN_DELTA_MAX = 3e-2
# most relative L2 allowed between a sampler's latent on the card and on
# the CPU (phase 4c), the tiny end-to-end limit of phase 4
SAMPLER_DELTA_MAX = 3e-2
# most relative L2 allowed between a kernel call of a full-width forward
# and its plain version on the same operands (phases 13-14: every call of
# one forward of each tree and under attention_i8). A call, not a forward
# or a block: a w8a8 stack carries any last-bit difference on by moving
# int8 activation codes a step, and each moved code moves the next
# linear's rows and their codes in turn, so two forwards, and two runs of
# one block already, drift apart by up to the int8 rounding noise itself
# (PERF.md, Findings, PR 9). Set from readings (H100, PR 9): K4 read 0 (it
# takes its plain version's int8 codes and sums them exactly) and its
# control, the plain version with the activations left unrounded, 7.4e-3
# at the least, which every K4 call's control must stay above; K1/K2 read
# 2.7e-4 at most; K7 and K6 1.1e-3 and 4.2e-3, under phase 3's 1e-2
CALL_PLAIN_DELTA_MAX = {"K4": 2e-3, "K1/K2": 2e-3, "K7": 1e-2, "K6": 1e-2}
# most relative L2 allowed between a w8a8 block and the bf16-fused block on
# the same inputs (phases 13-14): the accuracy cost of int8 activations and
# weights in one block, before later blocks carry it on. Set from readings
# (H100, PR 9): 5.7e-2 at most (AuraFlow's first block; Lumina 2 1.8e-2).
# It bounds the conversion's local cost and catches gross faults; the K4
# kernel is held by the call gate above, the conversion's arithmetic by the
# CPU tests against the reference. The final latents' distance is recorded
W8A8_BLOCK_DELTA_MAX = 1e-1
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

# the Pallas kernel (or its has_lora operands) an instance of K1/K2 replaces
_QMM_LINE = {("nib4", ""): 97, ("int8", ""): 169, ("nib4", "_lora"): 117,
             ("int8", "_lora"): 181}

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
       for d in (40, 64, 80, 96, 128, 160, 256)},
    # the wide-head body (scores once), instantiated from flash_attn.cu
    **{f"flash_attn_d{d}": (
        "comfyui_gguf_tpu_torch/csrc/flash_attn_wide.cuh",
        "comfyui_gguf_tpu/nn/attention.py:168") for d in (384, 512)},
    # the f16 and f32 instances (dequant_dtype float16 / float32): the
    # Pallas bodies run with compute_dtype = dequant_dtype
    **{f"qmm_{lay}{body}{lora}{dt}": (
        f"comfyui_gguf_tpu_torch/csrc/{src}",
        f"comfyui_gguf_tpu/ops/qmatmul.py:{_QMM_LINE[lay, lora]}")
       for lay in ("nib4", "int8") for lora in ("", "_lora")
       for body, dt, src in (
           ("", "_f16", f"qmm{'_int8' if lay == 'int8' else ''}"
                        f"{'_lora' if lora else ''}_f16.cu"),
           ("_smallm", "_f16", "qmm_smallm_f16.cu"),
           ("_smallm", "_f32", "qmm_smallm_f32.cu"),
           ("_simt", "_f32", "qmm_simt.cu"))},
    "i8attn_pv": ("comfyui_gguf_tpu_torch/csrc/i8attn.cu",
                  "comfyui_gguf_tpu/ops/i8attn.py:113"),
    "i8attn_qk": ("comfyui_gguf_tpu_torch/csrc/i8attn.cu",
                  "comfyui_gguf_tpu/ops/i8attn.py:113"),
    "i8attn_prep": ("comfyui_gguf_tpu_torch/csrc/i8attn_prep.cu",
                    "comfyui_gguf_tpu/ops/i8attn.py:76"),
    # K7's and K6's f16 / f32 instances (the reference computes attention
    # in q's dtype)
    "flash_attn_f16": ("comfyui_gguf_tpu_torch/csrc/flash_attn_f16.cu",
                       "comfyui_gguf_tpu/nn/attention.py:168"),
    "flash_attn_f32": ("comfyui_gguf_tpu_torch/csrc/flash_attn_f32.cu",
                       "comfyui_gguf_tpu/nn/attention.py:168"),
    **{f"i8attn_{m}_{dt}": ("comfyui_gguf_tpu_torch/csrc/i8attn.cu",
                            "comfyui_gguf_tpu/ops/i8attn.py:113")
       for m in ("pv", "qk") for dt in ("f16", "f32")},
    **{f"i8attn_prep_{dt}": ("comfyui_gguf_tpu_torch/csrc/i8attn_prep.cu",
                             "comfyui_gguf_tpu/ops/i8attn.py:76")
       for dt in ("f16", "f32")},
    "gemm_probe_bf16": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                        "tools_i8_microbench.py:37"),
    "gemm_probe_s8": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                      "tools_i8_microbench.py:37"),
    "gemm_probe_w8a8": ("comfyui_gguf_tpu_torch/csrc/gemm_probe.cu",
                        "tools_i8_microbench.py:66"),
    # K9 replaces no Pallas kernel: XLA fused the norms and RoPE there
    "qk_norm_rope": ("comfyui_gguf_tpu_torch/csrc/qk_norm_rope.cu",
                     "none (XLA-fused: comfyui_gguf_tpu/models/flux.py "
                     "_qknorm, apply_rope; models/wan.py)"),
}


_T0 = [None]  # main()'s start: phase headers carry the wall so far


def log(msg: str) -> None:
    if _T0[0] is not None and msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _T0[0]:.1f}s)"
    print(msg, flush=True)


# sources whose ptxas lines phase 2 prints per named instance: the LoRA
# instances and the unpatched instances beside them, and flash attention's
# head-dim instances
# the fused dequant-matmul's sources (K1/K2: every instance's ptxas lines
# are printed, and a C751x advisory or a spill in any of them fails)
QMM_SOURCES = ("qmm.cu", "qmm_int8.cu", "qmm_lora.cu", "qmm_int8_lora.cu",
               "qmm_f16.cu", "qmm_int8_f16.cu", "qmm_lora_f16.cu",
               "qmm_int8_lora_f16.cu", "qmm_smallm.cu", "qmm_smallm_f16.cu",
               "qmm_smallm_f32.cu", "qmm_simt.cu")
# K7's sources; a C751x advisory or a spill in any instance fails too (the
# bf16 / f16 wgmma body and the f32 3xTF32 one)
FLASH_SOURCES = ("flash_attn.cu", "flash_attn_f16.cu", "flash_attn_f32.cu")
NAMED_SOURCES = QMM_SOURCES + ("i8mm.cu", "i8mm_lora.cu",
                               "gemm_probe.cu") + FLASH_SOURCES


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


# K9 at the cells' shapes: (name, B, [(q rows, k rows) a part], heads,
# per-head gain, table, launches a denoise step in the cells)
QKROPE_CASES = (
    ("qk_norm_rope flux double B=4 txt 512 + img 4096 H=24 D=128", 4,
     [(512, 512), (4096, 4096)], 24, True, True,
     "19 a serve step (B = 4) and a t2i step (B = 1)"),
    ("qk_norm_rope flux single B=4 L=4608 H=24 D=128 (linear1 view)", 4,
     [(4608, 4608)], 24, True, True,
     "38 a serve step (B = 4) and a t2i step (B = 1)"),
    ("qk_norm_rope wan self L=32760 H=12 G=1536", 1, [(32760, 32760)], 12,
     False, True, "60 a Wan step (30 a forward, CFG: 2 forwards)"),
    ("qk_norm_rope wan cross Lq=32760 Lk=512 G=1536 (no table)", 1,
     [(32760, 512)], 12, False, False, "60 a Wan step"),
)


def qkrope_rows(dev, dtype=None):
    """K9 against the plain composition at the cells' shapes: q, k (and v)
    read as views of one fused projection a part (flux: qkv; its single
    block: linear1's first 3 x 3072 of 21504 columns), gains in f32, the
    joint table of flux's prelude or Wan's 3-D table. ms: CUDA graph of
    the launch; bound: its bytes (q, k and a joined v read and written
    once, the table and gains read once) at 3.35 TB/s; plain: the
    composition (rms_norm, apply_rope, torch.cat) it replaces; for the
    double block also the ``torch.cat`` of v alone (``v_cat_ms``), what
    joining v in the launch saves besides."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch.models import flux, wan
    from comfyui_gguf_tpu_torch.ops import qkrope

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for name, B, lens, H, per_head, rope, per_step in QKROPE_CASES:
        D, W = 128, H * 128
        single = "linear1" in name
        parts, v_views = [], []
        for Lq, Lk in lens:
            width = 7 * W if single else 3 * W
            x = torch.randn((B, Lq, width), generator=gen, device=dev).to(
                dtype)
            kv = x if Lk == Lq else torch.randn(
                (B, Lk, 3 * W), generator=gen, device=dev).to(dtype)
            G = D if per_head else W
            gq, gk = (1.0 + 0.3 * torch.randn(G, generator=gen, device=dev)
                      for _ in range(2))
            parts.append((x[..., :W], kv[..., W:2 * W], kv[..., 2 * W:3 * W],
                          gq, gk))
            v_views.append(kv[..., 2 * W:3 * W])
        Lq = sum(a for a, _ in lens)
        pe = None
        if rope and H == 24:
            img = torch.as_tensor(np.array(flux.make_img_ids(64, 64, B)),
                                  device=dev)
            txt = torch.zeros((B, Lq - 4096, 3), dtype=torch.int32,
                              device=dev)
            pe = flux.rope_freqs(torch.cat([txt, img], dim=1), (16, 56, 56))
        elif rope:
            pe = wan.rope_3d(21, 30, 52, (44, 42, 42), device=dev)
        got = qkrope.qk_norm_rope_cuda(parts, H, pe)
        want = qkrope.plain_qk_norm_rope(parts, H, pe)
        torch.cuda.synchronize()
        err = max(rel_l2(g, w) for g, w in zip(got, want))
        mad = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        ok = all(bool(torch.isfinite(g).all()) for g in got) and err <= 1e-3
        ms = graph_ms([lambda: qkrope.qk_norm_rope_cuda(parts, H, pe)])
        plain = event_ms(lambda: qkrope.plain_qk_norm_rope(parts, H, pe))
        es = torch.finfo(dtype).bits // 8
        Lk = sum(b for _, b in lens)
        moved = (Lq + Lk + (Lk if len(parts) > 1 else 0)) * B * W * es
        nbytes = 2 * moved + (pe.numel() * 4 if pe is not None else 0) \
            + 4 * len(parts) * 2 * (D if per_head else W)
        b_ms, b_by = bound(nbytes, 0.0, PEAK_BF16)
        row = dict(name=name, kernel="qk_norm_rope",
                   shape=f"B={B} L={lens} H={H} D={D} "
                         f"{str(dtype).replace('torch.', '')}",
                   max_abs_err=mad, rel_l2=err, tol="rel L2 <= 1e-3", ok=ok,
                   ms=ms, plain_ms=plain, library_ms=None, library="none",
                   bound_ms=b_ms, bound_by=b_by, launches_a_step=per_step)
        if len(parts) > 1:
            row["v_cat_ms"] = graph_ms([lambda: torch.cat(v_views, dim=1)])
        rows.append(row)
        log(f"  {name}: {ms:.4f} ms (bound {b_ms:.4f}, plain {plain:.3f}) "
            f"rel L2 {err:.2e} max abs {mad:.3g} ok={ok}"
            + (f" v cat {row['v_cat_ms']:.4f} ms" if "v_cat_ms" in row
               else ""))
        del parts, v_views, got, want
    return rows


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
                                                    qmm_cuda, qmm_route,
                                                    smallm_plan,
                                                    wgmma_split_plan)
    from comfyui_gguf_tpu_torch.quant.i8 import quantize_rows, requantize_i8
    from comfyui_gguf_tpu_torch.quant.planar import dequantize_kmajor

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    sweep_rows = []  # the wgmma body at other (nt, split): phase 3's sweep

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def bf16_planes(pq):
        """The same weight with bfloat16 scale and offset planes (what
        ``planarize(scale_dtype=torch.bfloat16)`` and the loader under
        GGUF_TPU_BF16_SCALES=1 store)."""
        return dataclasses.replace(
            pq, scales=pq.scales.to(torch.bfloat16),
            offsets=(None if pq.offsets is None
                     else pq.offsets.to(torch.bfloat16)))

    def qmm_case(name, kernel, qtype, M, K, R, act, n_copies, tol,
                 with_bias=True, bf16_scales=False, sweep=()):
        """K1/K2 through the body the dispatch picks for M (``kernel`` must
        name it), launched twice for the same bits; ``bf16_scales``: the
        weight with bf16 scale planes. ``sweep``: (token sub-tiles, K
        split) pairs of the wgmma body each checked the same way and timed
        as a row of its own beside the plan's pick."""
        ws = [random_planar(qtype, (R, K), gen, device=dev)
              for _ in range(n_copies)]
        if bf16_scales:
            ws = [bf16_planes(w) for w in ws]
        kp = ws[0].padded_in
        small = qmm_route(M, kp, R, ws[0].layout == "nib4") == "smallm"
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
        again = qmm_cuda(x, ws[0], bias=bias, act_from_col=act)
        ok = ok and torch.equal(got, again)
        for tiles in sweep:
            t_got = qmm_cuda(x, ws[0], bias=bias, act_from_col=act,
                             tiles=tiles)
            t_again = qmm_cuda(x, ws[0], bias=bias, act_from_col=act,
                               tiles=tiles)
            torch.cuda.synchronize()
            t_err = rel_l2(t_got, want)
            t_ms = graph_ms([lambda w=w: qmm_cuda(
                x, w, bias=bias, act_from_col=act, tiles=tiles)
                for w in ws])
            sweep_rows.append(dict(
                name=f"{name} nt={tiles[0]} split={tiles[1]}",
                kernel=kernel, ms=t_ms, rel_l2=t_err,
                max_abs_err=float((t_got.float() - want.float()).abs()
                                  .max()),
                pick=tuple(tiles) == wgmma_split_plan(M, kp, R),
                ok=(bool(torch.isfinite(t_got).all()) and t_err <= tol
                    and torch.equal(t_got, t_again))))
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
        pick = ("split-K " + str(smallm_plan(M, kp, R, ws[0].layout
                                             == "nib4")[0]) if small
                else "nt={} split={}".format(*wgmma_split_plan(M, kp, R)))
        rows.append(dict(name=name, kernel=kernel,
                         shape=f"M={M} K={K} R={R} {pick}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, tol=f"rel L2 <= {tol}, two launches "
                                         f"equal", ok=ok, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library="torch.matmul on the dequantized bf16 "
                                 "weight",
                         bound_ms=b_ms, bound_by=b_by))
        for r in sweep_rows[len(sweep_rows) - len(sweep):]:
            r.update(shape=rows[-1]["shape"], plain_ms=plain, library_ms=lib,
                     library=rows[-1]["library"], bound_ms=b_ms,
                     bound_by=b_by, tol=rows[-1]["tol"])

    def qmm_dt_case(name, kernel, qtype, M, K, R, act, n_copies, dt, tol,
                    rank=0):
        """K1/K2 at dequant dtype ``dt`` (float16 or float32) through the
        body and instance the dispatch picks (``kernel`` must name it): x
        and the weight rounded to ``dt``, an f32 output, against the plain
        version computing in ``dt``, launched twice for the same bits; with
        ``rank`` the LoRA instance, rank operands in ``dt``. The library
        call is one torch.matmul in ``dt`` on the dequantized weight."""
        ws = [random_planar(qtype, (R, K), gen, device=dev)
              for _ in range(n_copies)]
        x = randn(M, K)
        kw = dict(bias=torch.randn(R, generator=gen, device=dev) * 0.1,
                  act_from_col=act, out_dtype=torch.float32,
                  dequant_dtype=dt)
        if rank:
            base = qmm_cuda(x, ws[0], **kw)
            h, upt = lora_operands(M, R, rank, base)
            kw.update(lora_h=h.to(dt), lora_up=upt.to(dt))
        before = _build.LAUNCHES[kernel]
        got = qmm_cuda(x, ws[0], **kw)
        if _build.LAUNCHES[kernel] != before + 1:
            raise SystemExit(f"{name}: the dispatch did not pick {kernel}")
        again = qmm_cuda(x, ws[0], **kw)
        want = plain_quantized_matmul(x, ws[0], **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        ok = (bool(torch.isfinite(got).all()) and err <= tol
              and torch.equal(got, again))
        if rank:  # the term is really there: far off without it
            ok = ok and rel_l2(base, want) >= 3 * tol
        ms = graph_ms([lambda w=w: qmm_cuda(x, w, **kw) for w in ws])
        plain = event_ms(lambda: plain_quantized_matmul(x, ws[0], **kw))
        wd = dequantize_kmajor(ws[0], dt).contiguous()
        xd = x.to(dt)
        lib = library_ms(lambda: torch.matmul(xd, wd))
        del wd
        es = 2 if dt == torch.float16 else 4
        nbytes = (ws[0].nbytes_packed + es * M * K + 4 * M * R + 4 * R
                  + es * rank * (M + R))
        peak = PEAK_BF16 if dt == torch.float16 else PEAK_F32
        b_ms, b_by = bound(nbytes, 2.0 * M * R * (K + rank), peak)
        rows.append(dict(name=name + (f" LoRA r={rank}" if rank else ""),
                         kernel=kernel,
                         shape=f"M={M} K={K} R={R} {dt}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, tol=f"rel L2 <= {tol} against the plain "
                                         f"version in {dt}, two launches "
                                         f"equal", ok=ok, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library=f"torch.matmul in {dt} on the dequantized "
                                 f"weight",
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
        # the (R, K) K-contiguous codes seen as (K, R), no copy; then the
        # f32 rescale and the bf16 cast. _int_mm refuses M <= 16, so there
        # the quantized activation is padded to 32 rows (the same weight
        # bytes are read)
        w_rk, ws = ip.qs[:R, :K], ip.scales[:, :R]
        xq_l, xs_l = ((torch.cat([xq, xq.new_zeros(32 - M, K)]),
                       torch.cat([xs, xs.new_zeros(32 - M, 1)]))
                      if M <= 16 else (xq, xs))
        lib = library_ms(lambda: (torch._int_mm(xq_l, w_rk.t()) * xs_l
                                  * ws).to(torch.bfloat16))
        nbytes = M * K + 4 * M + ip.nbytes_packed + 4 * R + 2 * M * R
        b_ms, b_by = bound(nbytes, 2.0 * M * K * R, PEAK_INT8)
        rows.append(dict(name=name, kernel="i8mm",
                         shape=f"M={M} K={K} R={R} bn={pick}",
                         max_abs_err=err, rel_l2=rel, over_1ulp=n_over,
                         tol="<= 1 bf16 ulp at both widths", ok=ok,
                         ms=tile_ms[pick], tile_ms=tile_ms, plain_ms=plain,
                         library_ms=lib,
                         library="torch._int_mm(xq, w_rk.t()) (s8 x s8 -> "
                                 "s32 only, TN) * xs * ws -> bf16"
                                 + (f" (xq padded from {M} to 32 rows)"
                                    if M <= 16 else ""),
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
        w_rk, ws = ip.qs[:R, :K], ip.scales[:, :R]
        lib = library_ms(lambda: (torch._int_mm(xq, w_rk.t()) * xs * ws
                                  + torch.matmul(h, upt)).to(torch.bfloat16))
        nbytes = (M * K + 4 * M + ip.nbytes_packed + 4 * R + 2 * M * R
                  + 2 * rank * (M + R))
        t_ops = 2.0 * M * K * R / PEAK_INT8 + 2.0 * M * R * rank / PEAK_BF16
        lora_row(name, "i8mm_lora",
                 f"M={M} K={K} R={R} r={rank} bn={i8mm_plan(M, R)[0]}", got,
                 want, base, torch.equal(zero, base), "ulp", ms, base_ms,
                 plain, lib, nbytes, t_ops, act=act)

    # K7's instances by q/k/v dtype: launch counter, rel-L2 limit against
    # the plain version in that dtype, the peak of its products (f16 on the
    # tensor cores at the bf16 rate, f32 as 3xTF32: three TF32 products
    # each)
    attn_dtypes = {
        torch.bfloat16: (None, 1e-2, PEAK_BF16),
        torch.float16: ("flash_attn_f16", 1e-2, PEAK_BF16),
        torch.float32: ("flash_attn_f32", 1e-5, PEAK_TF32 / 3)}

    def attn_case(name, B, H, Lq, Lk, D, dtype=torch.bfloat16):
        q, k, v = (randn(B, H, L, D).to(dtype) for L in (Lq, Lk, Lk))
        scale = D ** -0.5
        kernel, tol, peak = attn_dtypes[dtype]
        got = flash_attn_cuda(q, k, v, scale)
        again = flash_attn_cuda(q, k, v, scale)
        want = plain_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        ok = (bool(torch.isfinite(got).all()) and got.dtype == dtype
              and err <= tol and torch.equal(got, again))
        ms = graph_ms([lambda: flash_attn_cuda(q, k, v, scale)])
        plain = event_ms(lambda: plain_attention(q, k, v, scale), reps=2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = library_ms(lambda: sdpa(q, k, v, scale=scale))
        nbytes = q.element_size() * B * H * D * (2 * Lq + 2 * Lk)
        b_ms, b_by = bound(nbytes, 4.0 * B * H * Lq * Lk * D, peak)
        extra = {}
        if dtype == torch.float32:  # the library's own distance, a control
            extra["sdpa_rel_l2"] = rel_l2(sdpa(q, k, v, scale=scale), want)
        rows.append(dict(name=name, kernel=kernel or f"flash_attn_d{D}",
                         shape=f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
                               f"{str(dtype).replace('torch.', '')}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, tol=f"rel L2 <= {tol:g}, two launches "
                                         f"equal", ok=ok, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library="scaled_dot_product_attention in the same "
                                 "dtype",
                         bound_ms=b_ms, bound_by=b_by, **extra))

    def i8attn_case(name, mode, B, H, L, D=128, dtype=torch.bfloat16):
        """K6 on the operands of its prep kernel, against the plain version
        at the kernel's own key tile, its result in q's dtype; the prep
        kernel and the plain prep (``quantize_attn_inputs``) are timed
        beside it."""
        pv, bkv = mode == "pv", kernel_block_kv(D)
        q, v = randn(B, H, L, D).to(dtype), randn(B, H, L, D).to(dtype)
        # a token mean for the prep to remove
        k = (randn(B, H, L, D) + 1.0).to(dtype)
        scale = D ** -0.5
        sfx = {torch.bfloat16: "", torch.float16: "_f16",
               torch.float32: "_f32"}[dtype]
        ops = prep_cuda(q, k, v, scale=scale, pv_int8=pv)
        got = i8_attention_cuda_q(*ops, B=B, H=H, pv_int8=pv,
                                  out_dtype=dtype)
        pops = plain_operands(*ops, pv_int8=pv)
        want = plain_i8_attention_q(
            *pops, pv_int8=pv, block_kv=bkv).to(dtype).reshape(B, H, L, D)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        exact = rel_l2(got, plain_attention(q, k, v, scale))
        ok = (bool(torch.isfinite(got).all()) and got.dtype == dtype
              and err <= 2e-3 and exact <= 3.5e-2)
        ms = graph_ms([lambda: i8_attention_cuda_q(*ops, B=B, H=H,
                                                   pv_int8=pv,
                                                   out_dtype=dtype)])
        prep = graph_ms([lambda: prep_cuda(q, k, v, scale=scale,
                                           pv_int8=pv)])
        prep_plain = graph_ms([lambda: quantize_attn_inputs(
            q, k, v, scale, pv_int8=pv)])
        plain = event_ms(lambda: plain_i8_attention_q(
            *pops, pv_int8=pv, block_kv=bkv), reps=2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = library_ms(lambda: sdpa(q, k, v, scale=scale))
        BH = B * H
        # s8 q and k, s8 or bf16 v, the f32 scales, the output in q's dtype
        nbytes = (BH * L * D * (2 + (1 if pv else 2)) + 4 * BH * (2 * L + D)
                  + q.element_size() * BH * L * D)
        half = 2.0 * BH * L * L * D
        t_ops = half / PEAK_INT8 + half / (PEAK_INT8 if pv else PEAK_BF16)
        b_ms, b_by = bound_t(nbytes, t_ops)
        rows.append(dict(name=name, kernel=f"i8attn_{mode}{sfx}",
                         shape=f"B={B} H={H} L={L} D={D} "
                               f"{str(dtype).replace('torch.', '')}",
                         max_abs_err=float((got.float() - want.float())
                                           .abs().max()),
                         rel_l2=err, rel_l2_vs_exact=exact,
                         tol=f"rel L2 <= 2e-3 vs plain at {bkv}-key tiles, "
                             f"<= 3.5e-2 vs exact attention",
                         ok=ok, ms=ms, prep_ms=prep,
                         prep_plain_ms=prep_plain, plain_ms=plain,
                         library_ms=lib,
                         library="scaled_dot_product_attention on the "
                                 "same q/k/v",
                         bound_ms=b_ms, bound_by=b_by,
                         exp_floor_ms=BH * L * L / sfu_per_s * 1e3))

    def prep_case(name, mode, B, H, L, D=128, dtype=torch.bfloat16):
        """The prep kernel against the plain prep: q and v codes and their
        scales equal, k codes within one step (torch sums k's mean in
        another order; the share that differs is recorded), two launches
        equal."""
        pv = mode == "pv"
        q, v = randn(B, H, L, D).to(dtype), randn(B, H, L, D).to(dtype)
        k = (randn(B, H, L, D) + 1.0).to(dtype)
        scale = D ** -0.5
        sfx = {torch.bfloat16: "", torch.float16: "_f16",
               torch.float32: "_f32"}[dtype]
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
        # q, k and ("pv") v read once (in their dtype); the s8 codes, the
        # scales written once
        nbytes = (q.element_size() * BH * L * D * (3 if pv else 2)
                  + BH * L * D * (3 if pv else 2) + 4 * BH * (2 * L + D))
        b_ms, b_by = bound_t(nbytes, 0.0)
        rows.append(dict(name=name, kernel=f"i8attn_prep{sfx}",
                         shape=f"B={B} H={H} L={L} D={D} "
                               f"{str(dtype).replace('torch.', '')}",
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
    # K1 on the bf16-fused path: img qkv and the single-block linear1 (the
    # persistent tiles beside a 2-block K split)
    qmm_case("qmm_nib4 qkv M=4096 3072->9216 Q4_K", "qmm_nib4", Q.Q4_K,
             4096, 3072, 9216, None, 1, 5e-3, sweep=((2, 2),))
    qmm_case("qmm_nib4 linear1 M=4608 3072->21504 Q4_K gelu@9216",
             "qmm_nib4", Q.Q4_K, 4608, 3072, 21504, 9216, 1, 5e-3,
             sweep=((2, 2),))
    # both bodies on bf16 scale planes: the split-K body at the flux
    # modulation (bound by the planes' bytes too) and the wgmma body at the
    # T5-xxl projection
    qmm_case("qmm_nib4 mod M=1 3072->18432 Q4_K bf16 scales",
             "qmm_nib4_smallm", Q.Q4_K, 1, 3072, 18432, None, 4, 5e-3,
             bf16_scales=True)
    qmm_case("qmm_int8 T5 q/k/v/o M=512 4096->4096 Q8_0 bf16 scales",
             "qmm_int8", Q.Q8_0, 512, 4096, 4096, None, 4, 5e-3,
             with_bias=False, bf16_scales=True)
    # K2: Q8_0 at M=4608, 3072->3072
    qmm_case("qmm_int8 M=4608 3072->3072 Q8_0", "qmm_int8", Q.Q8_0,
             4608, 3072, 3072, None, 1, 5e-3)
    # K2 at the Q4_K_M recipe's fused qkv (Q5_K; phase 21): the image
    # stream's 4096 tokens and the text stream's 512, over 4 copies of the
    # weight (past the L2, as a forward's layers are)
    qmm_case("qmm_int8 qkv M=4096 3072->9216 Q5_K", "qmm_int8", Q.Q5_K,
             4096, 3072, 9216, None, 4, 5e-3)
    qmm_case("qmm_int8 txt qkv M=512 3072->9216 Q5_K", "qmm_int8", Q.Q5_K,
             512, 3072, 9216, None, 4, 5e-3)
    # phase 22's per-shard shapes at tp = 2 (flux-dev over two ranks): the
    # w8a8 single-block linear1 column shard (heads and mlp halved, GELU
    # from the local mlp tail), the bf16-fused linear2 row shard (K halved)
    # and a double block's modulation gather shard (18432 / 2) on the
    # split-K body
    i8_case("i8mm tp2 linear1 col shard M=4608 3072->10752 gelu@4608", 4608,
            3072, 10752, 4608)
    qmm_case("qmm_nib4 tp2 linear2 row shard M=4608 7680->3072 Q4_K",
             "qmm_nib4", Q.Q4_K, 4608, 7680, 3072, None, 1, 5e-3)
    qmm_case("qmm_nib4 tp2 img_mod gather shard M=1 3072->9216 Q4_K",
             "qmm_nib4_smallm", Q.Q4_K, 1, 3072, 9216, None, 4, 5e-3)
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
    # phase 22: a rank's local heads at tp = 2 (12 of flux's 24)
    attn_case("flash_attn tp2 local heads H=12 L=4608 D=128", 1, 12, 4608,
              4608, 128)
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
             512, 4096, 4096, None, 4, 5e-3, with_bias=False,
             sweep=((1, 1), (2, 1), (2, 2), (2, 4), (2, 8)))
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
    # AuraFlow v0.3 and Lumina 2 at 1024² (phases 13 and 14). K7 at
    # AuraFlow's joint length (4096 image + 256 Pile-T5 + 8 register tokens,
    # 12 heads of 256, the 256-wide instance) and Lumina 2's three lengths
    # (26 main layers over 256 caption + 4096 image tokens, the noise
    # refiner over 4096, the context refiner over 256; 24 heads of 96 on
    # the 128-wide instance)
    attn_case("flash_attn aura joint L=4360 D=256", 1, 12, 4360, 4360, 256)
    attn_case("flash_attn lumina2 joint L=4352 D=96", 1, 24, 4352, 4352, 96)
    attn_case("flash_attn lumina2 noise refiner L=4096 D=96", 1, 24, 4096,
              4096, 96)
    attn_case("flash_attn lumina2 context refiner L=256 D=96", 1, 24, 256,
              256, 96)
    # K4 after requantize_i8: AuraFlow's image-stream projection, its
    # single layers' gated MLP over the joint length, and modC (no
    # modulation key by the reference's rule, so int8 at M = batch: ROADMAP
    # queue 3); Lumina 2's fused qkv and FFN over the joint length
    i8_case("i8mm aura w2q M=4096 3072->3072", 4096, 3072, 3072, None)
    i8_case("i8mm aura c_fc1 M=4360 3072->8192", 4360, 3072, 8192, None)
    i8_case("i8mm aura c_proj M=4360 8192->3072", 4360, 8192, 3072, None)
    i8_case("i8mm aura modC M=1 3072->18432", 1, 3072, 18432, None)
    i8_case("i8mm lumina2 qkv M=4352 2304->6912", 4352, 2304, 6912, None)
    i8_case("i8mm lumina2 w1 M=4352 2304->6144", 4352, 2304, 6144, None)
    i8_case("i8mm lumina2 w2 M=4352 6144->2304", 4352, 6144, 2304, None)
    # K1's split-K body on Lumina 2's adaLN (kept planar on the w8a8
    # tree); K1's wgmma body on the bf16-fused trees; K2 on the Pile-T5-XL
    # and the Gemma-shaped llama-graph linears at 256 tokens (enough copies
    # to exceed the L2 cache, as their 24 and 26 layers do)
    qmm_case("qmm_nib4 lumina2 adaLN M=1 2304->9216 Q4_K", "qmm_nib4_smallm",
             Q.Q4_K, 1, 2304, 9216, None, 4, 5e-3)
    qmm_case("qmm_nib4 aura c_fc1 M=4360 3072->8192 Q4_K", "qmm_nib4",
             Q.Q4_K, 4360, 3072, 8192, None, 1, 5e-3, with_bias=False)
    qmm_case("qmm_nib4 lumina2 qkv M=4352 2304->6912 Q4_K", "qmm_nib4",
             Q.Q4_K, 4352, 2304, 6912, None, 1, 5e-3, with_bias=False)
    qmm_case("qmm_int8 Pile-T5 q/k/v/o M=256 2048->2048 Q8_0", "qmm_int8",
             Q.Q8_0, 256, 2048, 2048, None, 8, 5e-3, with_bias=False,
             sweep=((1, 1), (2, 1), (2, 2), (2, 4), (2, 8)))
    qmm_case("qmm_int8 Pile-T5 wi M=256 2048->5120 Q8_0", "qmm_int8", Q.Q8_0,
             256, 2048, 5120, None, 4, 5e-3, with_bias=False)
    qmm_case("qmm_int8 llama q M=256 2304->2048 Q8_0", "qmm_int8", Q.Q8_0,
             256, 2304, 2048, None, 8, 5e-3, with_bias=False,
             sweep=((1, 1), (2, 2), (2, 4)))
    qmm_case("qmm_int8 llama gate/up M=256 2304->9216 Q8_0", "qmm_int8",
             Q.Q8_0, 256, 2304, 9216, None, 2, 5e-3, with_bias=False)
    # K6's 256-wide instance at AuraFlow's joint attention: the int8 gate
    # admits 128-multiple lengths only, so a 248-token prompt (4352 tokens
    # with the image and register tokens; the default 256 gives 4360, which
    # the gate refuses)
    i8attn_case("i8attn_pv aura H=12 L=4352 D=256", "pv", 1, 12, 4352, 256)
    # Qwen-Image and HiDream-I1 at 1024² (phases 15 and 16): K4 on
    # Qwen-Image's image-stream MLP (GELU in the epilogue) and projections,
    # and on HiDream's routed-expert SwiGLU over the single blocks' joint
    # length (dense dispatch: every expert on every token); K1's split-K
    # body on HiDream's double-block adaLN (kept planar); K2 on the
    # Qwen2.5-VL-7B-shaped encoder's linears at 256 tokens (q/k/v biases);
    # K7 at both joint lengths (256 + 4096 tokens, 24 and 20 heads of 128)
    i8_case("i8mm qwen_image img_mlp.0 M=4096 3072->12288 gelu", 4096, 3072,
            12288, 0)
    i8_case("i8mm qwen_image img_mlp.2 M=4096 12288->3072", 4096, 12288,
            3072, None)
    i8_case("i8mm qwen_image to_q M=4096 3072->3072", 4096, 3072, 3072, None)
    i8_case("i8mm hidream expert w1 M=4352 2560->6912", 4352, 2560, 6912,
            None)
    i8_case("i8mm hidream expert w2 M=4352 6912->2560", 4352, 6912, 2560,
            None)
    qmm_case("qmm_nib4 hidream adaLN M=1 2560->30720 Q4_K",
             "qmm_nib4_smallm", Q.Q4_K, 1, 2560, 30720, None, 4, 5e-3)
    qmm_case("qmm_int8 qwen2.5-vl q M=256 3584->3584 Q8_0", "qmm_int8",
             Q.Q8_0, 256, 3584, 3584, None, 8, 5e-3,
             sweep=((1, 1), (2, 2), (2, 4)))
    qmm_case("qmm_int8 qwen2.5-vl gate M=256 3584->18944 Q8_0", "qmm_int8",
             Q.Q8_0, 256, 3584, 18944, None, 2, 5e-3, with_bias=False,
             sweep=((2, 1), (2, 2), (2, 4)))
    attn_case("flash_attn qwen_image joint L=4352 D=128", 1, 24, 4352, 4352,
              128)
    attn_case("flash_attn hidream joint L=4352 D=128", 1, 20, 4352, 4352,
              128)
    # the f32 rows' oracle in full f32: no TF32 in matmuls (a TF32 product
    # keeps about three decimal digits, far from the f32 rows' 1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    prec = torch.get_float32_matmul_precision()
    log(f"  f32 oracle: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"float32_matmul_precision={prec!r}")
    if prec != "highest":
        raise SystemExit(f"float32 matmul precision {prec!r}, not 'highest'")
    # the f16 and f32 instances of K1/K2 (dequant_dtype float16 / float32:
    # f16 operands on the tensor cores, f32 on FMAs), flux's modulation
    # (the split-K body at M = 1, nib4 and int8), flux's qkv (K1's wgmma
    # body at f16, the f32 SIMT body) and the T5-xxl q projection (K2);
    # their LoRA instances with rank operands in the dequant dtype
    for dt, tol in ((torch.float16, 2e-3), (torch.float32, 1e-5)):
        sfx = "_f16" if dt == torch.float16 else "_f32"
        body = "" if dt == torch.float16 else "_simt"
        for lora in (0, 16):
            lt = "_lora" if lora else ""
            qmm_dt_case(f"qmm_nib4 {sfx[1:]} flux mod M=1 3072->18432 Q4_K",
                        f"qmm_nib4_smallm{lt}{sfx}", Q.Q4_K, 1, 3072, 18432,
                        None, 4, dt, tol, lora)
            qmm_dt_case(f"qmm_int8 {sfx[1:]} flux img_mod M=1 3072->18432 "
                        f"Q8_0", f"qmm_int8_smallm{lt}{sfx}", Q.Q8_0, 1,
                        3072, 18432, None, 2, dt, tol, lora)
            if dt == torch.float32:
                # the f32 split-K body's M = 2 instance: a CFG batch
                qmm_dt_case("qmm_nib4 f32 flux mod M=2 3072->18432 Q4_K",
                            f"qmm_nib4_smallm{lt}{sfx}", Q.Q4_K, 2, 3072,
                            18432, None, 4, dt, tol, lora)
                qmm_dt_case("qmm_int8 f32 flux img_mod M=2 3072->18432 "
                            "Q8_0", f"qmm_int8_smallm{lt}{sfx}", Q.Q8_0, 2,
                            3072, 18432, None, 2, dt, tol, lora)
                # the single blocks' modulation (72 strips)
                qmm_dt_case("qmm_nib4 f32 flux single mod M=1 3072->9216 "
                            "Q4_K", f"qmm_nib4_smallm{lt}{sfx}", Q.Q4_K, 1,
                            3072, 9216, None, 6, dt, tol, lora)
            qmm_dt_case(f"qmm_nib4 {sfx[1:]} flux qkv M=4096 3072->9216 "
                        f"Q4_K", f"qmm_nib4{body}{lt}{sfx}", Q.Q4_K, 4096,
                        3072, 9216, None, 1, dt, tol, lora)
            qmm_dt_case(f"qmm_int8 {sfx[1:]} T5-xxl q M=512 4096->4096 "
                        f"Q8_0", f"qmm_int8{body}{lt}{sfx}", Q.Q8_0, 512,
                        4096, 4096, None, 4, dt, tol, lora)
    # Wan 2.1 14B and Cosmos at their phases' sizes: K7's D = 128 instance
    # at Wan's self-attention (40 heads over 3 x 30 x 52 = 4680 tokens) and
    # cross-attention (512 UMT5 tokens), Cosmos's self-attention (32 heads
    # over 64 x 64 = 4096 tokens); the D = 384 instance at the Wan VAE's
    # mid-block (one head of 384 channels over a 60 x 104 latent frame, 3
    # frames)
    attn_case("flash_attn wan self L=4680 D=128", 1, 40, 4680, 4680, 128)
    attn_case("flash_attn wan cross Lq=4680 Lk=512 D=128", 1, 40, 4680, 512,
              128)
    attn_case("flash_attn cosmos self L=4096 D=128", 1, 32, 4096, 4096, 128)
    attn_case("flash_attn wan vae mid B=3 L=6240 D=384", 3, 1, 6240, 6240,
              384)
    # HunyuanVideo and LTX-Video at phases 19-20's sizes: K7's D = 128
    # instance at HunyuanVideo's joint length (24 heads over 3 x 30 x 52 =
    # 4680 image + 256 text tokens), its D = 512 instance at the HunyuanVideo
    # VAE's mid-block (one head of 512 channels over a 60 x 104 latent
    # frame, 3 frames), the D = 64 instance at LTX-Video's self-attention
    # (32 heads over 16 x 16 x 24 = 6144 voxels) and cross-attention (256
    # T5 tokens)
    attn_case("flash_attn hyvid joint L=4936 D=128", 1, 24, 4936, 4936, 128)
    attn_case("flash_attn hyvid vae mid B=3 L=6240 D=512", 3, 1, 6240, 6240,
              512)
    # K7's and K6's f16 and f32 instances: at flux's joint
    # attention, and K7 f32 at the two VAEs' mid-blocks, whose q/k/v keep
    # the f32 of the latents the pipelines decode
    for dt, tag in ((torch.float16, "f16"), (torch.float32, "f32")):
        attn_case(f"flash_attn_{tag} flux L=4608 D=128", 1, 24, 4608, 4608,
                  128, dt)
    attn_case("flash_attn_f32 wan vae mid B=3 L=6240 D=384", 3, 1, 6240,
              6240, 384, torch.float32)
    attn_case("flash_attn_f32 hyvid vae mid B=3 L=6240 D=512", 3, 1, 6240,
              6240, 512, torch.float32)
    # the wide-head body's f16 instances at the same two mid-blocks
    attn_case("flash_attn_f16 wan vae mid B=3 L=6240 D=384", 3, 1, 6240,
              6240, 384, torch.float16)
    attn_case("flash_attn_f16 hyvid vae mid B=3 L=6240 D=512", 3, 1, 6240,
              6240, 512, torch.float16)
    for dt, tag in ((torch.float16, "f16"), (torch.float32, "f32")):
        for mode in ("pv", "qk"):
            i8attn_case(f"i8attn_{mode}_{tag} flux L=4608 D=128", mode, 1,
                        24, 4608, 128, dt)
        prep_case(f"i8attn_prep_{tag} pv flux L=4608 D=128", "pv", 1, 24,
                  4608, 128, dt)
    attn_case("flash_attn ltxv self L=6144 D=64", 1, 32, 6144, 6144, 64)
    attn_case("flash_attn ltxv cross Lq=6144 Lk=256 D=64", 1, 32, 6144, 256,
              64)
    # K8: the probes at the tool's problem size
    probe_cases()
    # K9: the q/k norms, RoPE and joint concat before each attention call
    rows.extend(qkrope_rows(dev))
    return rows + sweep_rows


# ---------------------------------------------------------------------------
# phase 4: tiny end to end through the normal entry, card against CPU
# ---------------------------------------------------------------------------

def _tiny_mixed_files(tmp):
    """Phase 4a's files in directory ``tmp``: a tiny flux GGUF mixing
    Q4_K, Q8_0 and Q6_K tensors and a LoRA of every patch type. → (dims,
    GGUF path, LoRA path)."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

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

    path = os.path.join(tmp, "tiny_flux_mixed.gguf")
    testing.write_flux_gguf(testing.flux_state_dict(dims, seed=0), path,
                            mixed)
    # a LoRA of every patch type: rank patches on every block linear, the
    # modulations included; a LoCon mid, a LoHa (the unfused path), a GLoRA
    lora_path = os.path.join(tmp, "tiny_lora.safetensors")
    _safetensors.save_file(testing.flux_mixed_lora_state_dict(dims, seed=7),
                           lora_path)
    return dims, path, lora_path


def _tiny_flux_run(dims, dev, steps=3, h_lat=16):
    """Phase 4a's run: ``steps`` Euler steps of a tiny flux model from the
    same seed-made inputs on ``dev`` and on the CPU. → run(model, device
    name)."""
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.sampling import euler_sample, flux_schedule

    inputs = {d: testing.flux_example_inputs(dims, h_lat=h_lat, w_lat=h_lat,
                                             txt_len=16, seed=5, device=d)
              for d in {dev, "cpu"}}
    sigmas = flux_schedule(steps, (h_lat // 2) ** 2)

    def run(model, dev_name):
        img, ids, txt, tids, _, y, g = inputs[dev_name]

        def vel(x, s):
            return model.forward(x, ids, txt, tids, s.expand(x.shape[0]), y,
                                 g)
        return euler_sample(vel, img, sigmas)
    return run


def tiny_e2e_phase(dev):
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    out = {}
    tmp = tempfile.TemporaryDirectory()
    dims, path, lora_path = _tiny_mixed_files(tmp.name)
    gpu = load_diffusion_model(path)
    cpu = load_diffusion_model(path, device="cpu")
    steps = 3
    run = _tiny_flux_run(dims, dev, steps)

    def both(tree):
        _build.reset_launch_counts()
        a = run(gpu, dev)
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
    unpatched = run(gpu, dev)  # the stacked w8a8 tree, no LoRA
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
    a = run(gpu, dev)
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


def tiny_dtype_phase(dev):
    """Phase 4a at dequant_dtype float16 and float32: the same tiny mixed
    GGUF through ``load_diffusion_model(..., device="cuda",
    dequant_dtype=..., patch_dtype="float16")`` and on the CPU with the same
    knobs, three Euler steps planar and then with the LoRA of every patch
    type (f16 rank factors, which the kernels round to the dequant dtype,
    as the reference's ``_prep_lora`` does), card vs CPU within 3e-2 each.
    Each run must launch that dtype's instances of both bodies over both
    layouts (at f32 the SIMT body in the wgmma body's place), the LoRA runs
    their LoRA instances, and no bf16 instance of the fused matmul."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    out = {}
    tmp = tempfile.TemporaryDirectory()
    dims, path, lora_path = _tiny_mixed_files(tmp.name)
    run = _tiny_flux_run(dims, dev)
    bf16_keys = ("qmm_nib4", "qmm_int8", "qmm_nib4_smallm",
                 "qmm_int8_smallm", "qmm_nib4_lora", "qmm_int8_lora",
                 "qmm_nib4_smallm_lora", "qmm_int8_smallm_lora")
    for name in ("float16", "float32"):
        sfx = "_f16" if name == "float16" else "_f32"
        wide = "" if name == "float16" else "_simt"
        models = [load_diffusion_model(path, device=d, dequant_dtype=name,
                                       patch_dtype="float16")
                  for d in (dev, "cpu")]
        for lora in ("", "_lora"):
            if lora:
                for m in models:
                    m.apply_lora(lora_path, strength=0.8)
            _build.reset_launch_counts()
            a = run(models[0], dev)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            b = run(models[1], "cpu")
            err = rel_l2(a.float().cpu(), b.float())
            key = f"{name}{lora or '_planar'}"
            out[key] = dict(rel_l2_vs_cpu=err, launches=counts)
            log(f"  tiny {key}: card vs CPU plain rel L2 {err:.3e}, "
                f"launches { {k: n for k, n in counts.items() if n} }")
            if not bool(torch.isfinite(a).all()) or not err <= 3e-2:
                raise SystemExit(f"tiny {key}: card vs CPU rel L2 {err}")
            need = [f"qmm_{lay}{body}{lora}{sfx}" for lay in ("nib4", "int8")
                    for body in (wide, "_smallm")]
            idle = [k for k in need if counts[k] == 0]
            if idle or any(counts[k] for k in bf16_keys):
                raise SystemExit(f"tiny {key}: launched none of {idle} or a "
                                 f"bf16 instance: "
                                 f"{ {k: counts[k] for k in bf16_keys} }")
    tmp.cleanup()
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
# phase 4g: tiny Wan / Cosmos from files, card against CPU
# ---------------------------------------------------------------------------

VIDEO_TINY = dict(dim=512, n_heads=4, n_layers=2, in_ch=16, text_dim=512)


def _write_video_files(tmp):
    """Tiny Wan and Cosmos GGUFs (Q4_K, four heads of 128), 2-layer Q8_0
    UMT5 (a relative-bias table in each layer) and T5 GGUFs with unigram
    tokenizers, and a small Wan VAE (16 latent channels, its middle 64
    wide: K7's D = 64 instance) as safetensors, all by the port's writers.
    → their paths."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    out = {}
    for name, dims, spec in (
            ("wan", testing.WanDims(ffn_dim=1024, **VIDEO_TINY),
             testing.wan_shape_spec),
            ("cosmos", testing.CosmosDims(**VIDEO_TINY),
             testing.cosmos_shape_spec)):
        out[name] = os.path.join(tmp, f"{name}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0),
            out[name], name, Q.Q4_K)
    for name, per_layer in (("umt5", True), ("t5", False)):
        out[name] = os.path.join(tmp, f"{name}.gguf")
        testing.write_t5_gguf(
            testing.t5_state_dict(testing.T5Dims(
                d_model=512, d_kv=64, n_heads=8, d_ff=1024, n_layers=2,
                vocab=64, per_layer_bias=per_layer), seed=2),
            out[name], qtype=Q.Q8_0, tokenizer=testing.unigram_spec(64))
    out["vae"] = os.path.join(tmp, "wan_vae.safetensors")
    _safetensors.save_file(testing.wan_vae_state_dict(testing.WanVAEDims(
        base=16, z=16, mult=(1, 2, 4), num_res=1,
        temporal_down=(True, False)), seed=3), out["vae"])
    return out


def video_tiny_phase(dev):
    """Phase 4g: Wan 2.1 and Cosmos at tiny widths from files, on the card
    and on the CPU with the same noise, within 3e-2 (relative L2):
    ``load_diffusion_model``, ``load_text_encoder`` (UMT5, T5), ``load_vae``
    (kind "wan"), ``WanPipeline.generate`` (CFG 5, the padded positions
    zeroed, ``latents_mean``/``latents_std``, the causal VAE decode with its
    mid-block attention on K7, a dispatch window of 2) and
    ``CosmosPipeline.generate`` (CFG 4) on the planar trees; then
    ``wan_engine`` and ``cosmos_engine`` serving two requests each (CFG and
    1, different lengths) on the w8a8 stacked trees, card vs CPU, each
    request on the card within 1e-2 of the direct sampler at batch 1, and a
    snapshot after one tick restored into a fresh engine within 1e-3 of
    the uninterrupted run."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import (
        CosmosPipeline, WanPipeline, cosmos_engine, load_diffusion_model,
        load_text_encoder, load_vae, wan_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow)

    devs = (dev, "cpu")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    f = _write_video_files(tmp.name)

    def check(name, a, b, counts, need):
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        err = rel_l2(a, b)
        out[name] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  {name}: card vs CPU plain rel L2 {err:.3e}, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not bool(torch.isfinite(a).all()) or not err <= SAMPLER_DELTA_MAX:
            raise SystemExit(f"{name}: card vs CPU rel L2 {err} > "
                             f"{SAMPLER_DELTA_MAX}")
        for k in need:
            if counts[k] == 0:
                raise SystemExit(f"{name} launched no {k}")

    def on_card(fn):
        _build.reset_launch_counts()
        a = fn(0)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        return a, fn(1), counts

    models = {a: [load_diffusion_model(f[a], device=d) for d in devs]
              for a in ("wan", "cosmos")}
    umt5 = [load_text_encoder(f["umt5"], device=d) for d in devs]
    t5 = [load_text_encoder(f["t5"], device=d) for d in devs]
    vaes = [load_vae(f["vae"], device=d) for d in devs]
    if vaes[0][0] != "wan":
        raise SystemExit(f"load_vae read a Wan VAE as {vaes[0][0]!r}")
    rng = np.random.default_rng(12)
    mean = (rng.standard_normal(16) * 0.1).astype(np.float32)
    std = (1.0 + rng.random(16) * 0.5).astype(np.float32)
    wan = [WanPipeline(models["wan"][i], umt5[i], vae_params=vaes[i][1],
                       latents_mean=mean, latents_std=std)
           for i in range(2)]
    cos = [CosmosPipeline(models["cosmos"][i], t5[i]) for i in range(2)]
    noise = torch.randn((1, 3, 8, 8, 16),
                        generator=torch.Generator().manual_seed(7))
    a, b, c = on_card(lambda i: wan[i].generate(
        PROMPTS[0], "rain", latent_frames=3, latent_height=8,
        latent_width=8, steps=3, max_t5_len=32, dispatch_window=2,
        noise=noise))
    if a.shape != (5, 32, 32, 3):
        raise SystemExit(f"tiny WanPipeline: a video of shape {a.shape}")
    # the VAE's mid-block attention takes the f32 q/k/v of the f32 latent
    check("tiny WanPipeline (CFG 5, VAE decode)", a, b, c,
          ("flash_attn_d128", "flash_attn_f32", "qmm_nib4", "qmm_int8"))
    a, b, c = on_card(lambda i: cos[i].generate(
        PROMPTS[0], latent_frames=2, latent_height=8, latent_width=8,
        steps=3, negative_prompt="rain", max_len=32, noise=noise[:, :2]))
    check("tiny CosmosPipeline (CFG 4)", a, b, c,
          ("flash_attn_d128", "qmm_nib4", "qmm_nib4_smallm", "qmm_int8"))

    # the engines on the w8a8 stacked trees
    for arch, mk in (("wan", wan_engine), ("cosmos", cosmos_engine)):
        ms = [m.requantize_i8().stack() for m in models[arch]]
        cfg = ms[0].config
        reqs = [(rng.standard_normal((2, 8, 8, cfg.in_channels)).astype(
                     np.float32),
                 {"ctx": rng.standard_normal((24, cfg.text_dim)).astype(
                     np.float32),
                  "nctx": rng.standard_normal((24, cfg.text_dim)).astype(
                      np.float32),
                  "cfg_scale": np.float32(scale)}, linear_schedule(2 + i))
                for i, scale in enumerate((4.0, 1.0))]

        def serve(i, interrupt=False, ms=ms, mk=mk, reqs=reqs):
            eng = mk(ms[i], max_batch=2)
            hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
            if interrupt:
                eng.tick()
                snap = eng.snapshot()
                open_ = [j for j, h in enumerate(hs)
                         if not h.done_event.is_set()]
                eng2 = mk(ms[i], max_batch=2)
                for j, h in zip(open_, eng2.restore(snap)):
                    hs[j] = h
                eng = eng2
            eng.run_until_drained()
            if any(h.error is not None or not h.finished for h in hs):
                raise SystemExit(f"tiny {arch} engine: a request failed")
            return np.stack([h.result for h in hs])
        a, b, c = on_card(serve)
        name = f"tiny {mk.__name__} w8a8 stacked (2 requests)"
        check(name, a, b, c, ("i8mm", "flash_attn_d128"))

        def direct(x, cond, sig, m=ms[0]):
            def vel(xc, sg):
                ts = sg.to(torch.float32).expand(1)
                v_c = m.forward(xc, torch.as_tensor(cond["ctx"], device=dev)
                                [None].to(torch.bfloat16), ts)
                v_u = m.forward(xc, torch.as_tensor(cond["nctx"], device=dev)
                                [None].to(torch.bfloat16), ts)
                return v_u.float() + float(cond["cfg_scale"]) * (
                    v_c.float() - v_u.float())
            x0 = torch.as_tensor(x, device=dev)[None].to(torch.bfloat16)
            with torch.no_grad():
                return sample_flow(vel, x0, sig)[0].float().cpu()
        vs_direct = [rel_l2(torch.from_numpy(np.asarray(r, np.float32)),
                            direct(*req)) for r, req in zip(a, reqs)]
        restored = serve(0, interrupt=True)
        vs_whole = rel_l2(torch.from_numpy(restored.astype(np.float32)),
                          torch.from_numpy(a.astype(np.float32)))
        out[name].update(rel_l2_vs_direct=vs_direct,
                         restored_rel_l2=vs_whole)
        log(f"  {name}: vs the direct sampler rel L2 "
            f"{', '.join(f'{e:.3e}' for e in vs_direct)}; snapshot after a "
            f"tick -> restore vs uninterrupted {vs_whole:.3e}")
        if not max(vs_direct) <= ENGINE_DELTA_MAX:
            raise SystemExit(f"{name}: a served request differs from the "
                             f"direct sampler by {max(vs_direct)}")
        if not vs_whole <= RESTORE_DELTA_MAX:
            raise SystemExit(f"{name}: the restored engine diverged "
                             f"({vs_whole})")
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# phase 4h: tiny HunyuanVideo / LTX-Video from files, card against CPU
# ---------------------------------------------------------------------------

# HunyuanVideo: four heads of 128 (K7's D = 128), conditioned by phase 4e's
# tiny llama-family encoder (1024 wide); LTX-Video: eight heads of 64 (D =
# 64) over 128-channel voxels, conditioned by a 512-wide T5
TINY_HYVID = dict(hidden=512, n_heads=4, depth_double=2, depth_single=2,
                  refiner_depth=2, in_ch=16, text_dim=1024)
TINY_LTXV = dict(dim=512, n_layers=2, in_ch=128, caption_dim=512)


def _write_video2_files(tmp):
    """Tiny HunyuanVideo and LTX-Video GGUFs (Q4_K, quantized as published
    files are), a 2-layer Q8_0 llama GGUF with gpt2-BPE metadata, a 2-layer
    Q8_0 T5 GGUF with a unigram tokenizer, and small HunyuanVideo (16
    latent channels, its middle 64 wide: K7's D = 64) and LTX-Video (128
    latent channels) VAEs as safetensors, all by the port's writers. →
    their paths."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    out = {}
    for name, dims, spec in (
            ("hyvid", testing.HyVidDims(**TINY_HYVID),
             testing.hyvid_shape_spec),
            ("ltxv", testing.LTXVDims(**TINY_LTXV), testing.ltxv_shape_spec)):
        out[name] = os.path.join(tmp, f"{name}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0),
            out[name], name, Q.Q4_K)
    out["llama"] = os.path.join(tmp, "llama.gguf")
    ld = testing.LlamaDims(**TINY_LLAMA)
    testing.write_llama_gguf(testing.llama_state_dict(ld, seed=3),
                             out["llama"], qtype=Q.Q8_0,
                             tokenizer=testing.bpe_spec(ld.vocab))
    out["t5"] = os.path.join(tmp, "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=TINY_LTXV["caption_dim"], d_kv=64, n_heads=8, d_ff=1024,
            n_layers=2, vocab=64), seed=2),
        out["t5"], qtype=Q.Q8_0, tokenizer=testing.unigram_spec(64))
    out["hyvid_vae"] = os.path.join(tmp, "hyvid_vae.safetensors")
    _safetensors.save_file(testing.hyvid_vae_state_dict(
        testing.HyVidVAEDims(), seed=4), out["hyvid_vae"])
    out["ltxv_vae"] = os.path.join(tmp, "ltxv_vae.safetensors")
    _safetensors.save_file(testing.ltxv_vae_state_dict(
        testing.LTXVVAEDims(latent=TINY_LTXV["in_ch"]), seed=5),
        out["ltxv_vae"])
    return out


def video2_tiny_phase(dev):
    """Phase 4h: HunyuanVideo and LTX-Video at tiny widths from files, on
    the card and on the CPU with the same noise, within 3e-2 (relative
    L2): ``load_diffusion_model``, ``load_text_encoder`` (llama, T5),
    ``load_vae`` (kinds "hyvid" and "ltxv"); ``HyVidPipeline.generate``
    (guidance 6.0, one forward a step, a dispatch window of 2) with the
    HunyuanVideo VAE (its mid-block attention on K7) and without it;
    ``LTXVPipeline.generate`` (CFG 3.0) through the LTX-Video VAE and
    without it; both VAEs' ``decode``, and ``encode`` → ``decode`` of a
    video in [-1, 1] (within 3e-2, or within 1.5 times the CPU's own bf16
    vs f32 distance of that round trip where that is larger); then
    ``hyvid_engine`` and ``ltxv_engine`` serving two requests each (guidance
    6 and 1; CFG 3 and 1) on the w8a8 stacked trees, card vs CPU, each
    request on the card within 1e-2 of the direct sampler at batch 1."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.models import hyvid_vae, ltxv_vae
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (
        HyVidPipeline, LTXVPipeline, hyvid_engine, load_diffusion_model,
        load_text_encoder, load_vae, ltxv_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow)

    devs = (dev, "cpu")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    f = _write_video2_files(tmp.name)

    def check(name, a, b, counts, need, limit=SAMPLER_DELTA_MAX):
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        err = rel_l2(a, b)
        out[name] = dict(rel_l2_vs_cpu=err, limit=limit, launches=counts)
        log(f"  {name}: card vs CPU plain rel L2 {err:.3e} (limit "
            f"{limit:.3e}), launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not bool(torch.isfinite(a).all()) or not err <= limit:
            raise SystemExit(f"{name}: card vs CPU rel L2 {err} > {limit}")
        for k in need:
            if counts[k] == 0:
                raise SystemExit(f"{name} launched no {k}")

    def on_card(fn):
        _build.reset_launch_counts()
        a = fn(0)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        return a, fn(1), counts

    models = {a: [load_diffusion_model(f[a], device=d) for d in devs]
              for a in ("hyvid", "ltxv")}
    llama = [load_text_encoder(f["llama"], device=d) for d in devs]
    t5 = [load_text_encoder(f["t5"], device=d) for d in devs]
    vaes = {a: [load_vae(f[f"{a}_vae"], device=d) for d in devs]
            for a in ("hyvid", "ltxv")}
    for a, v in vaes.items():
        if v[0][0] != a:
            raise SystemExit(f"load_vae read a {a} VAE as {v[0][0]!r}")
    hy = [HyVidPipeline(models["hyvid"][i], llama[i],
                        vae_params=vaes["hyvid"][i][1]) for i in range(2)]
    lt = [LTXVPipeline(models["ltxv"][i], t5[i],
                       vae_params=vaes["ltxv"][i][1]) for i in range(2)]
    gen = torch.Generator().manual_seed(17)
    hy_noise = torch.randn((1, 2, 8, 8, 16), generator=gen)
    lt_noise = torch.randn((1, 2 * 2 * 3, 128), generator=gen)
    for vae in (True, False):
        if not vae:
            for p in hy + lt:
                p.vae_params = None
        a, b, c = on_card(lambda i: hy[i].generate(
            PROMPTS[0], latent_frames=2, latent_height=8, latent_width=8,
            steps=3, guidance=6.0, max_len=32, dispatch_window=2,
            noise=hy_noise))
        if a.shape != ((5, 32, 32, 3) if vae else (2, 8, 8, 16)):
            raise SystemExit(f"tiny HyVidPipeline: an output of shape "
                             f"{a.shape}")
        check(f"tiny HyVidPipeline (guidance 6, "
              f"{'VAE decode' if vae else 'latent'})", a, b, c,
              ("flash_attn_d128", "qmm_nib4", "qmm_nib4_smallm", "qmm_int8")
              + (("flash_attn_f32",) if vae else ()))
        a, b, c = on_card(lambda i: lt[i].generate(
            PROMPTS[0], latent_frames=2, latent_height=2, latent_width=3,
            steps=3, cfg_scale=3.0, negative_prompt="rain", max_t5_len=32,
            noise=lt_noise))
        if a.shape != ((9, 64, 96, 3) if vae else (2, 2, 3, 128)):
            raise SystemExit(f"tiny LTXVPipeline: an output of shape "
                             f"{a.shape}")
        check(f"tiny LTXVPipeline (CFG 3, "
              f"{'VAE decode' if vae else 'latent'})", a, b, c,
              ("flash_attn_d64", "qmm_nib4", "qmm_int8"))

    # both VAEs alone: decode of a latent, and encode → decode of a video
    # in [-1, 1] (the CPU's float32 decode of that latent, clamped): the
    # round trip is held to 3e-2 or to 1.5 times the distance bfloat16
    # compute itself puts between the CPU's bf16 and f32 round trips,
    # whichever is larger. The convolutions' bf16 roundings compound
    # through encoder and decoder: with the HunyuanVideo VAE's mid-block
    # attention in f32 the CPU's own distance still reads 2.7e-2 and the
    # card's round trip 3.7e-2 (H100 80GB HBM3, 700 W; PERF.md); the
    # LTX-Video VAE, without attention, 4.1e-2 and 3.5e-2
    f32 = QuantConfig(dequant_dtype=torch.float32,
                      compute_dtype=torch.float32)
    for arch, mod, z_shape in (("hyvid", hyvid_vae, (1, 2, 6, 8, 16)),
                               ("ltxv", ltxv_vae, (1, 2, 2, 3, 128))):
        z = torch.randn(z_shape, generator=gen)
        with torch.no_grad():
            video = mod.decode(*vaes[arch][1][1:], z, qcfg=f32).clamp(-1, 1)

        def vae_run(i, mod=mod, z=z, video=video, arch=arch,
                    roundtrip=False, qcfg=QuantConfig()):
            _, params, cfg = vaes[arch][i]
            with torch.no_grad():
                if roundtrip:
                    out = mod.decode(params, cfg, mod.encode(
                        params, cfg, video.to(devs[i]), qcfg=qcfg),
                        qcfg=qcfg)
                else:
                    out = mod.decode(params, cfg, z.to(devs[i]), qcfg=qcfg)
            return out.float().cpu().numpy()
        need = ("flash_attn_f32",) if arch == "hyvid" else ()
        a, b, c = on_card(vae_run)
        check(f"tiny {arch} VAE decode", a, b, c, need)
        a, b, c = on_card(lambda i, r=vae_run: r(i, roundtrip=True))
        yard = rel_l2(torch.from_numpy(b), torch.from_numpy(
            vae_run(1, roundtrip=True, qcfg=f32)))
        check(f"tiny {arch} VAE encode -> decode", a, b, c, need,
              limit=max(SAMPLER_DELTA_MAX, 1.5 * yard))
        out[f"tiny {arch} VAE encode -> decode"]["cpu_bf16_vs_f32"] = yard

    # the engines on the w8a8 stacked trees
    rng = np.random.default_rng(13)
    hcfg = models["hyvid"][0].config
    lcfg = models["ltxv"][0].config
    L = 2 * 2 * 3
    pos = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(3),
                               indexing="ij"), axis=-1).reshape(L, 3)
    engines = {
        "hyvid": (hyvid_engine, [
            (rng.standard_normal((2, 8, 8, hcfg.in_channels)).astype(
                np.float32),
             {"txt": rng.standard_normal((24, hcfg.text_dim)).astype(
                 np.float32), "guidance": np.float32(g)},
             linear_schedule(2 + i)) for i, g in enumerate((6.0, 1.0))]),
        "ltxv": (ltxv_engine, [
            (rng.standard_normal((L, lcfg.in_channels)).astype(np.float32),
             {"ids": pos.astype(np.int32),
              "ctx": rng.standard_normal((24, lcfg.caption_dim)).astype(
                  np.float32),
              "nctx": rng.standard_normal((24, lcfg.caption_dim)).astype(
                  np.float32), "cfg_scale": np.float32(s)},
             linear_schedule(2 + i)) for i, s in enumerate((3.0, 1.0))])}
    for arch, (mk, reqs) in engines.items():
        ms = [m.requantize_i8().stack() for m in models[arch]]

        def serve(i, ms=ms, mk=mk, reqs=reqs, arch=arch):
            eng = mk(ms[i], max_batch=2)
            hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
            eng.run_until_drained()
            if any(h.error is not None or not h.finished for h in hs):
                raise SystemExit(f"tiny {arch} engine: a request failed")
            return np.stack([h.result for h in hs])
        a, b, c = on_card(serve)
        name = f"tiny {mk.__name__} w8a8 stacked (2 requests)"
        check(name, a, b, c, ("i8mm", "flash_attn_d128" if arch == "hyvid"
                              else "flash_attn_d64"))

        def direct(x, cond, sig, m=ms[0], arch=arch):
            def vel(xc, sg):
                ts = sg.to(torch.float32).expand(1)
                if arch == "hyvid":
                    txt = torch.as_tensor(cond["txt"], device=dev)[None]
                    g = torch.full((1,), float(cond["guidance"]) * 1000.0,
                                   device=dev)
                    return m.forward(xc, txt.to(torch.bfloat16), ts, g)
                ids = torch.as_tensor(cond["ids"], device=dev)[None]
                v_c, v_u = (m.forward(xc, ids, torch.as_tensor(
                    cond[k], device=dev)[None].to(torch.bfloat16), ts)
                    for k in ("ctx", "nctx"))
                return v_u.float() + float(cond["cfg_scale"]) * (
                    v_c.float() - v_u.float())
            x0 = torch.as_tensor(x, device=dev)[None].to(torch.bfloat16)
            with torch.no_grad():
                return sample_flow(vel, x0, sig)[0].float().cpu()
        vs_direct = [rel_l2(torch.from_numpy(np.asarray(r, np.float32)),
                            direct(*req)) for r, req in zip(a, reqs)]
        out[name]["rel_l2_vs_direct"] = vs_direct
        log(f"  {name}: vs the direct sampler rel L2 "
            f"{', '.join(f'{e:.3e}' for e in vs_direct)}")
        if not max(vs_direct) <= ENGINE_DELTA_MAX:
            raise SystemExit(f"{name}: a served request differs from the "
                             f"direct sampler by {max(vs_direct)}")
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# phase 4i: f16 and f32 attention end to end, card against CPU
# ---------------------------------------------------------------------------

def dtype_attention_phase(dev):
    """Phase 4i: attention in q's dtype through the models, card vs CPU.

    (a) One forward of a tiny flux (four heads of 128, 1 + 1 blocks) from a
    Q4_K GGUF, given f16 and then f32 activations, at 512 joint tokens
    (256 image + 256 text: inside the int8 gate), plain and under
    ``attention_i8("pv")`` / ``("qk")``: within 3e-2 of the CPU, each
    launching its dtype's K7 instance (or K6 and its prep) once a block and
    no bf16 attention instance. (b) A small Wan VAE decode at f32 compute:
    K7's f32 instance, no bf16 one. (c) The Wan 2.1 and HunyuanVideo VAEs
    at published widths (mid-blocks 384 and 512 wide) decoding one small
    latent frame in f32, as the pipelines hand it (K7 f32), and in bf16
    (K7's bf16 D = 384 / 512 instances). → {case: {rel_l2_vs_cpu,
    launches}}"""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import hyvid_vae, testing, wan_vae
    from comfyui_gguf_tpu_torch.nn.attention import attention_i8
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    out = {}
    attn_keys = ("flash_attn", "flash_attn_f16", "flash_attn_f32",
                 "i8attn_pv", "i8attn_qk", "i8attn_prep", "i8attn_pv_f16",
                 "i8attn_qk_f16", "i8attn_prep_f16", "i8attn_pv_f32",
                 "i8attn_qk_f32", "i8attn_prep_f32")

    def check(name, run, want):
        """run(device) on the card, then on the CPU; ``want``: the exact
        launches of every attention counter (others must stay 0)."""
        _build.reset_launch_counts()
        with torch.no_grad():
            a = run(dev)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            b = run("cpu")
        err = rel_l2(a.float().cpu(), b.float())
        out[name] = dict(rel_l2_vs_cpu=err, launches=counts)
        attn = {k: counts[k] for k in attn_keys if counts[k]}
        log(f"  {name}: card vs CPU rel L2 {err:.3e}, attention launches "
            f"{attn}")
        if not bool(torch.isfinite(a).all()) or not err <= SAMPLER_DELTA_MAX:
            raise SystemExit(f"4i {name}: card vs CPU rel L2 {err}")
        bad = {k: counts[k] for k in attn_keys
               if counts[k] != want.get(k, 0)}
        if bad or any(counts[k] != n for k, n in want.items()):
            raise SystemExit(f"4i {name}: attention launches {attn}, "
                             f"expected {want}")

    dims = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                                depth_single=1, axes_dim=(16, 56, 56))
    n_attn = dims.depth_double + dims.depth_single
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flux_d128.gguf")
        testing.write_flux_gguf(
            testing.flux_state_dict(dims, seed=0), path,
            lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
        models = {d: load_diffusion_model(path, device=d)
                  for d in (dev, "cpu")}
    for dt, tag in ((torch.float16, "f16"), (torch.float32, "f32")):
        for mode in ("", "pv", "qk"):
            def run(d, dt=dt, mode=mode):
                x = testing.flux_example_inputs(dims, h_lat=32, w_lat=32,
                                                txt_len=256, seed=5,
                                                dtype=dt, device=d)
                with attention_i8(mode):
                    got = models[d].forward(*x)
                if got.dtype != dt:
                    raise SystemExit(f"4i: a {dt} forward gave {got.dtype}")
                return got
            want = ({f"i8attn_{mode}_{tag}": n_attn,
                     f"i8attn_prep_{tag}": n_attn} if mode
                    else {f"flash_attn_{tag}": n_attn})
            check(f"tiny flux forward {tag}"
                  + (f" attention_i8({mode!r})" if mode else ""), run, want)
    del models

    # (b) a small Wan VAE (mid-block 64 wide) at f32 compute
    f32 = QuantConfig(dequant_dtype=torch.float32,
                      compute_dtype=torch.float32)
    sd = testing.wan_vae_state_dict(testing.WanVAEDims(), seed=1)
    small = {d: {k: torch.from_numpy(v).to(d) for k, v in sd.items()}
             for d in (dev, "cpu")}
    cfg = wan_vae.WanVAEConfig.from_state_dict(small["cpu"])
    z = torch.randn((1, 2, 6, 8, cfg.z_channels),
                    generator=torch.Generator().manual_seed(3))
    check("tiny Wan VAE decode, f32 compute",
          lambda d: wan_vae.decode(small[d], cfg, z.to(d), qcfg=f32),
          {"flash_attn_f32": 1})  # the mid-block, its frames batched
    del small

    # (c) the published VAEs' mid-blocks: an f32 latent (the pipelines')
    # and a bf16 one, one frame of 8 x 8
    for arch, mod, params_of, vdims, cfg_cls in (
            ("Wan 2.1", wan_vae, testing.wan_vae_random_params,
             testing.WAN21_VAE_DIMS, wan_vae.WanVAEConfig),
            ("HunyuanVideo", hyvid_vae, testing.hyvid_vae_random_params,
             testing.HYVID_VAE_DIMS, hyvid_vae.HyVidVAEConfig)):
        cpu_p = params_of(vdims, seed=2, device="cpu")
        ps = {"cpu": cpu_p, dev: {k: v.to(dev) for k, v in cpu_p.items()}}
        vcfg = cfg_cls.from_state_dict(cpu_p)
        D = 384 if arch == "Wan 2.1" else 512
        z = torch.randn((1, 1, 8, 8, vdims.z),
                        generator=torch.Generator().manual_seed(4))
        for zdt, want in ((torch.float32, {"flash_attn_f32": 1}),
                          (torch.bfloat16, {"flash_attn": 1,
                                            f"flash_attn_d{D}": 1})):
            check(f"{arch} VAE (published widths) decode of a "
                  f"{str(zdt).replace('torch.', '')} latent",
                  lambda d, ps=ps, z=z, zdt=zdt, mod=mod, vcfg=vcfg:
                  mod.decode(ps[d], vcfg, z.to(device=d, dtype=zdt)),
                  want)
        del ps, cpu_p
        torch.cuda.empty_cache()
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
        if tree == "bf16_fused":
            # the same packed tree at dequant_dtype float32: a path of its
            # own (counts from 0), kept apart from this phase's counts
            f32_s, f32_counts = f32_forward(model, requests[0])
            res["f32_forward"] = dict(s=f32_s, launches=f32_counts)
            log(f"  one forward at QuantConfig(dequant_dtype=float32), "
                f"bf16 activations: {f32_s:.4f}s (bf16-fused step "
                f"{secs[-1] / steps:.4f}s); K1/K2 f32 launches "
                + str({k: n for k, n in f32_counts.items()
                       if n and k.endswith("_f32")}))
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


def f32_forward(model, inputs):
    """One flux forward of ``model``'s packed tree at
    ``QuantConfig(dequant_dtype=torch.float32)`` with bf16 activations, as
    the loader's Advanced knob runs it: every planar linear at M > 8 on
    K1/K2's f32 body, the modulation (M = 1) on the split-K body's f32
    instances, attention on K7's bf16 instances. A warm-up forward, then
    one timed on the host clock around a synchronize; (seconds, launches of
    the timed forward, counted from 0)."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

    f32 = dataclasses.replace(
        model, qcfg=QuantConfig(dequant_dtype=torch.float32))
    f32.forward(*inputs)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    out = f32.forward(*inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("f32 forward: non-finite output")
    return secs, dict(_build.LAUNCHES)


def family_ms(prof):
    """(device ms by kernel family, device ms of each kernel outside the
    port's kernels and the dense GEMMs) from a finished torch.profiler
    run; families are ``tools/read_trace._label``'s, the non-kernel ones
    merged into one "other" family. Annotated regions are left out."""
    import torch

    from comfyui_gguf_tpu_torch.tools.read_trace import (NON_KERNEL_FAMILIES,
                                                         _label)

    by_fam, others = {}, {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        # an annotated region's span on the card is no kernel of its own
        if (us <= 0 or getattr(e, "is_user_annotation", False)
                or getattr(e, "device_type", None) not in (
                    None, torch.autograd.DeviceType.CUDA)):
            continue
        fam = _label(e.key)
        if fam in NON_KERNEL_FAMILIES:
            fam = "other (elementwise, norms, rope, quantize, copies)"
            others[e.key[:90]] = others.get(e.key[:90], 0.0) + us / 1e3
        by_fam[fam] = by_fam.get(fam, 0.0) + us / 1e3
    return by_fam, others


def profile_forward(model, inputs, step_s, tree):
    """Device time of one forward of ``tree`` by kernel family, from
    torch.profiler; busy share = kernel time / the timed step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.forward(*inputs)
        torch.cuda.synchronize()
    by_fam, others = family_ms(prof)
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
# phase 4e: tiny AuraFlow and Lumina 2 end to end, card against CPU
# ---------------------------------------------------------------------------

# AuraFlow: two heads of 256 (K7's 256-wide instance); Lumina 2: 16 heads
# of 96 (the 128-wide instance on zero-filled columns); linears wide enough
# to load as packed leaves (K >= 512); a llama-family encoder of 65536
# tokens, so that its embedding takes the loader's big-embed guard
TINY_AURA = dict(hidden=512, depth_double=2, depth_single=2, mlp=1024,
                 in_ch=4, cond_dim=512, n_register_tokens=8, max_tokens=256)
TINY_LUMINA2 = dict(dim=1536, n_heads=16, n_layers=2, n_refiner=1,
                    n_context_refiner=1, ffn=4096, in_ch=16, cap_dim=1024)
TINY_LLAMA = dict(hidden=1024, n_layers=2, n_heads=32, n_kv_heads=8,
                  head_dim=32, intermediate=2048, vocab=65536)


def _write_dit_files(tmp):
    """The tiny AuraFlow and Lumina 2 GGUFs (Q4_K, quantized as published
    files are), a 2-layer Q8_0 T5 GGUF with tokenizer metadata and a
    2-layer Q8_0 llama GGUF with gpt2-BPE metadata, written by the port's
    writers under ``tmp``."""
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    f = {}
    for arch, dims, spec in (
            ("aura", testing.AuraDims(**TINY_AURA), testing.aura_shape_spec),
            ("lumina2", testing.Lumina2Dims(**TINY_LUMINA2),
             testing.lumina2_shape_spec)):
        f[arch] = (os.path.join(tmp, f"{arch}.gguf"), dims)
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0),
            f[arch][0], arch, Q.Q4_K)
    f["t5"] = os.path.join(tmp, "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=TINY_AURA["cond_dim"], d_kv=64, n_heads=8, d_ff=1024,
            n_layers=2, vocab=128), seed=2), f["t5"], qtype=Q.Q8_0,
        tokenizer=testing.unigram_spec(128))
    f["llama"] = os.path.join(tmp, "llama.gguf")
    ld = testing.LlamaDims(**TINY_LLAMA)
    testing.write_llama_gguf(testing.llama_state_dict(ld, seed=3),
                             f["llama"], qtype=Q.Q8_0,
                             tokenizer=testing.bpe_spec(ld.vocab))
    return f


def dit_tiny_phase(dev):
    """Phase 4e: AuraFlow and Lumina 2 at tiny widths from files written by
    the port's writers, on the card and on the CPU with the same noise,
    within 3e-2 (relative L2): ``load_diffusion_model``,
    ``load_text_encoder`` (T5; the llama graph), ``AuraPipeline.generate``
    and ``Lumina2Pipeline.generate`` with a negative prompt (CFG) on the
    planar trees, then ``aura_engine`` and ``lumina2_engine`` serving two
    requests each on the w8a8 stacked trees."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import (
        AuraPipeline, Lumina2Pipeline, aura_engine, load_diffusion_model,
        load_text_encoder, lumina2_engine)
    from comfyui_gguf_tpu_torch.sampling import linear_schedule

    devs = (dev, "cpu")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    f = _write_dit_files(tmp.name)

    def check(name, a, b, counts, need):
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        err = rel_l2(a, b)
        out[name] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  {name}: card vs CPU plain rel L2 {err:.3e}, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not bool(torch.isfinite(a).all()) or not err <= SAMPLER_DELTA_MAX:
            raise SystemExit(f"{name}: card vs CPU rel L2 {err} > "
                             f"{SAMPLER_DELTA_MAX}")
        for k in need:
            if counts[k] == 0:
                raise SystemExit(f"{name} launched no {k}")

    def on_card(fn):
        _build.reset_launch_counts()
        a = fn(0)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        return a, fn(1), counts

    size = 128
    models = {arch: [load_diffusion_model(f[arch][0], device=d)
                     for d in devs] for arch in ("aura", "lumina2")}
    t5 = [load_text_encoder(f["t5"], device=d) for d in devs]
    text = [load_text_encoder(f["llama"], device=d) for d in devs]
    if text[0].kind != "llama" or text[0].tokenizer is None:
        raise SystemExit("load_text_encoder did not build the llama graph "
                         "with its tokenizer")
    if not isinstance(text[0].params["model.embed_tokens.weight"],
                      torch.Tensor):
        raise SystemExit("the 65536-row embedding did not take the "
                         "big-embed guard")
    pipes = {"aura": [AuraPipeline(models["aura"][i], t5[i])
                      for i in range(2)],
             "lumina2": [Lumina2Pipeline(models["lumina2"][i], text[i])
                         for i in range(2)]}
    need = {"aura": ("flash_attn_d256", "qmm_nib4", "qmm_int8"),
            "lumina2": ("flash_attn_d96", "qmm_nib4", "qmm_nib4_smallm",
                        "qmm_int8")}
    for arch, cfg_scale in (("aura", 3.5), ("lumina2", 4.0)):
        C = models[arch][0].config.in_channels
        noise = torch.randn((1, size // 8, size // 8, C),
                            generator=torch.Generator().manual_seed(7))
        a, b, c = on_card(lambda i: pipes[arch][i].generate(
            PROMPTS[0], width=size, height=size, steps=2,
            cfg_scale=cfg_scale, negative_prompt="rain", max_len=32,
            noise=noise))
        check(f"tiny {type(pipes[arch][0]).__name__} (CFG {cfg_scale})", a,
              b, c, need[arch])

    # the engines on the w8a8 stacked trees: two requests each, at CFG 4
    # and 1, of different lengths
    rng = np.random.default_rng(11)
    for arch, mk, ck, nk in (("aura", aura_engine, "ctx", "nctx"),
                             ("lumina2", lumina2_engine, "cap", "ncap")):
        ms = [m.requantize_i8().stack() for m in models[arch]]
        cfg = ms[0].config
        width = cfg.cond_dim if arch == "aura" else cfg.cap_dim
        reqs = [(rng.standard_normal((16, 16, cfg.in_channels)).astype(
                     np.float32),
                 {ck: rng.standard_normal((24, width)).astype(np.float32),
                  nk: rng.standard_normal((24, width)).astype(np.float32),
                  "cfg_scale": np.float32(scale)}, linear_schedule(2 + i))
                for i, scale in enumerate((4.0, 1.0))]

        def serve(i):
            eng = mk(ms[i], max_batch=2)
            hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
            eng.run_until_drained()
            if any(h.error is not None or not h.finished for h in hs):
                raise SystemExit(f"tiny {arch} engine: a request failed")
            return np.stack([h.result for h in hs])
        a, b, c = on_card(serve)
        check(f"tiny {mk.__name__} w8a8 stacked (2 requests)", a, b, c,
              ("i8mm", f"flash_attn_d{256 if arch == 'aura' else 96}"))
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# phase 4f: tiny Qwen-Image and HiDream from files, card against CPU
# ---------------------------------------------------------------------------

# head dim 128 (K7's instance of both archs); widths of 512 and up, so every
# block linear is a packed leaf; the qwen2vl encoder doubles as HiDream's
# llama-graph encoder
TINY_QWEN_IMAGE = dict(hidden=512, n_heads=4, n_layers=2, in_ch=64,
                       context_dim=1024)
TINY_QWEN2VL = dict(hidden=1024, n_layers=2, n_heads=32, n_kv_heads=8,
                    head_dim=32, intermediate=2048, vocab=1024,
                    qkv_bias=True)
TINY_VISION = dict(dim=160, n_layers=2, out_dim=1024, intermediate=320,
                   patch=14)
TINY_HIDREAM = dict(hidden=512, heads=4, depth_double=2, depth_single=2,
                    ffn=1024, n_experts=4, top_k=2, t5_dim=512,
                    llama_dim=1024, pooled=128)
TINY_PAD_ID = 1023  # the tiny vocabulary's <|image_pad|>


def _write_qh_files(tmp):
    """The tiny Qwen-Image and HiDream GGUFs (Q4_K, quantized as published
    files are), a 2-layer Q8_0 qwen2vl encoder GGUF with gpt2-BPE metadata
    and its mmproj sidecar beside it, a 2-layer Q8_0 T5 GGUF and tiny CLIP-L
    / CLIP-G safetensors with a vocabulary, written by the port's writers
    under ``tmp``."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    f = {}
    for arch, dims, spec in (
            ("qwen_image", testing.QwenImageDims(**TINY_QWEN_IMAGE),
             testing.qwen_image_shape_spec),
            ("hidream", testing.TinyHiDreamDims(**TINY_HIDREAM),
             testing.hidream_shape_spec)):
        f[arch] = os.path.join(tmp, f"{arch}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0), f[arch],
            arch, Q.Q4_K)
    f["qwen2vl"] = os.path.join(tmp, "qwen2.5-vl-tiny-Q8_0.gguf")
    ld = testing.LlamaDims(**TINY_QWEN2VL)
    testing.write_llama_gguf(testing.llama_state_dict(ld, seed=3),
                             f["qwen2vl"], qtype=Q.Q8_0,
                             tokenizer=testing.bpe_spec(ld.vocab),
                             arch="qwen2vl")
    testing.write_mmproj_gguf(
        testing.qwen_vl_vision_state_dict(
            testing.QwenVLVisionDims(**TINY_VISION), seed=4),
        os.path.join(tmp, "mmproj-qwen2.5-vl-tiny-F16.gguf"))
    f["t5"] = os.path.join(tmp, "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=TINY_HIDREAM["t5_dim"], d_kv=64, n_heads=8, d_ff=1024,
            n_layers=2, vocab=128), seed=2), f["t5"], qtype=Q.Q8_0,
        tokenizer=testing.unigram_spec(128))
    clip_dir = os.path.join(tmp, "clip")
    os.mkdir(clip_dir)
    for name, dims, seed in (("clip_l", TINY_CLIP_L, 5),
                             ("clip_g", TINY_CLIP_G, 6)):
        f[name] = os.path.join(clip_dir, f"{name}.safetensors")
        _safetensors.save_file(testing.clip_state_dict(
            testing.CLIPDims(**dims), seed=seed), f[name])
    testing.write_clip_vocab(clip_dir, *testing.clip_vocab(600))
    return f


@contextlib.contextmanager
def _moe_dispatch(mode):
    """HiDream's MoE dispatch mode for the enclosed scope."""
    from comfyui_gguf_tpu_torch.models import hidream

    saved = hidream.MOE_DISPATCH
    hidream.MOE_DISPATCH = mode
    try:
        yield
    finally:
        hidream.MOE_DISPATCH = saved


def qh_tiny_phase(dev):
    """Phase 4f: Qwen-Image and HiDream at tiny widths from files written
    by the port's writers, on the card and on the CPU with the same noise,
    within 3e-2 (relative L2): ``load_diffusion_model``,
    ``load_text_encoder`` (the qwen2vl file merges its mmproj sidecar),
    ``QwenImagePipeline.generate`` (CFG) and ``generate_edit`` (a reference
    latent, the conditioning from ``qwen_vl_encode_with_image`` on an
    image), ``HiDreamPipeline.generate_from_ids`` in dense and capacity
    dispatch; then ``qwen_image_engine`` and ``hidream_engine`` serving two
    requests each on the w8a8 stacked trees, each request within 1e-2 of
    the direct sampler at batch 1 on the card."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import (
        HiDreamPipeline, QwenImagePipeline, hidream_engine,
        load_diffusion_model, load_text_encoder, qwen_image_engine,
        qwen_vl_encode_with_image)
    from comfyui_gguf_tpu_torch.models.flux import make_img_ids
    from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

    devs = (dev, "cpu")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    f = _write_qh_files(tmp.name)

    def check(name, a, b, counts, need):
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        err = rel_l2(a, b)
        out[name] = dict(rel_l2_vs_cpu=err, launches=counts)
        log(f"  {name}: card vs CPU plain rel L2 {err:.3e}, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not bool(torch.isfinite(a).all()) or not err <= SAMPLER_DELTA_MAX:
            raise SystemExit(f"{name}: card vs CPU rel L2 {err} > "
                             f"{SAMPLER_DELTA_MAX}")
        for k in need:
            if counts[k] == 0:
                raise SystemExit(f"{name} launched no {k}")

    def on_card(fn):
        _build.reset_launch_counts()
        a = fn(0)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        return a, fn(1), counts

    qi = [load_diffusion_model(f["qwen_image"], device=d) for d in devs]
    hd = [load_diffusion_model(f["hidream"], device=d) for d in devs]
    text = [load_text_encoder(f["qwen2vl"], device=d) for d in devs]
    if (text[0].kind != "llama" or text[0].tokenizer is None
            or "visual.merger.mlp.2.weight" not in text[0].params):
        raise SystemExit("load_text_encoder did not merge the qwen2vl "
                         "file's mmproj sidecar")
    t5 = [load_text_encoder(f["t5"], device=d) for d in devs]
    clip_l = [load_text_encoder(f["clip_l"], device=d) for d in devs]
    clip_g = [load_text_encoder(f["clip_g"], device=d) for d in devs]
    qpipes = [QwenImagePipeline(qi[i], text[i]) for i in range(2)]
    size, C = 128, qi[0].config.in_channels
    L = (size // 16) ** 2
    noise = torch.randn((1, L, C), generator=torch.Generator().manual_seed(7))
    kw = dict(width=size, height=size, steps=2, max_len=32, noise=noise)
    a, b, c = on_card(lambda i: qpipes[i].generate(
        PROMPTS[0], negative_prompt="rain", **kw))
    check("tiny QwenImagePipeline.generate (CFG 4)", a, b, c,
          ("flash_attn_d128", "qmm_nib4", "qmm_nib4_smallm", "qmm_int8"))

    # edit: one reference latent, the prompt's states from the vision tower
    rng = np.random.default_rng(8)
    ref = rng.standard_normal((size // 8, size // 8, 16)).astype(np.float32)
    image = rng.random((112, 112, 3)).astype(np.float32)  # 16 merged tokens
    ids = rng.integers(0, 1000, (1, 24))
    ids[0, 4:20] = TINY_PAD_ID

    def edit(i):
        txt = qwen_vl_encode_with_image(text[i], text[i].params, ids, image,
                                        TINY_PAD_ID)["last_hidden"]
        return qpipes[i].generate_edit("", [ref], txt_override=txt,
                                       negative_prompt="rain", **kw)

    a, b, c = on_card(edit)
    check("tiny QwenImagePipeline.generate_edit (vision tower, 1 ref)", a,
          b, c, ("flash_attn_d128", "qmm_nib4", "qmm_int8"))

    hpipes = [HiDreamPipeline(hd[i], clip_l[i], clip_g[i], t5[i], text[i])
              for i in range(2)]
    hids = (clip_l[0].tokenizer.encode_batch([PROMPTS[0]], 77)[0],
            clip_g[0].tokenizer.encode_batch([PROMPTS[0]], 77)[0],
            t5[0].tokenizer.encode_batch([PROMPTS[0]], 32)[0],
            text[0].tokenizer.encode_batch([PROMPTS[0]], 32)[0])
    hnoise = torch.randn((1, size // 8, size // 8, hd[0].config.in_channels),
                         generator=torch.Generator().manual_seed(9))
    for mode in ("dense", "capacity"):
        with _moe_dispatch(mode):
            a, b, c = on_card(lambda i: hpipes[i].generate_from_ids(
                *hids, width=size, height=size, steps=2, noise=hnoise))
        check(f"tiny HiDreamPipeline.generate_from_ids ({mode})", a, b, c,
              ("flash_attn_d128", "qmm_nib4", "qmm_nib4_smallm",
               "qmm_int8"))

    # the engines on the w8a8 stacked trees, each request against the
    # direct sampler on the card
    qm = [m.requantize_i8().stack() for m in qi]
    hm = [m.requantize_i8().stack() for m in hd]
    h_tok = size // 16
    img_ids = torch.as_tensor(np.array(make_img_ids(h_tok, h_tok, 1)))
    reqs = {"qwen_image": [], "hidream": []}
    for i in range(2):
        sig = linear_schedule(2 + i)
        reqs["qwen_image"].append((
            rng.standard_normal((L, C)).astype(np.float32),
            {"txt": rng.standard_normal((24, 1024)).astype(np.float32)},
            sig))
        reqs["hidream"].append((
            rng.standard_normal((size // 8, size // 8, 16)).astype(
                np.float32),
            {"t5": rng.standard_normal((16, 512)).astype(np.float32),
             "llama": rng.standard_normal((16, 1024)).astype(np.float32),
             "pooled": rng.standard_normal((128,)).astype(np.float32)},
            sig))

    def vel(arch, model, c, d):
        cond = {k: torch.as_tensor(v)[None].to(d, torch.bfloat16)
                for k, v in c.items()}

        def fn(xc, s):
            t = s.to(torch.float32).expand(1)
            if arch == "hidream":
                return model.forward(xc, cond["t5"], cond["llama"],
                                     cond["pooled"], t)
            ids_t = torch.zeros((1, 24, 3), dtype=torch.int32, device=d)
            return model.forward(xc, img_ids.to(d), cond["txt"], ids_t, t)
        return fn

    for arch, ms, mk in (("qwen_image", qm, lambda m: qwen_image_engine(
            m, h_tok, h_tok, 24, max_batch=2)),
                         ("hidream", hm, lambda m: hidream_engine(
                             m, max_batch=2))):
        def serve(i):
            eng = mk(ms[i])
            hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs[arch]]
            eng.run_until_drained()
            if any(h.error is not None or not h.finished for h in hs):
                raise SystemExit(f"tiny {arch} engine: a request failed")
            return np.stack([h.result for h in hs])

        a, b, c = on_card(serve)
        check(f"tiny {arch} engine w8a8 stacked (2 requests)", a, b, c,
              ("i8mm", "flash_attn_d128"))
        errs = []
        for (x, cd, sig), got in zip(reqs[arch], a):
            with torch.no_grad():
                direct = sample_flow(vel(arch, ms[0], cd, dev), torch.as_tensor(
                    x)[None].to(dev, torch.bfloat16), sig)[0]
            errs.append(rel_l2(torch.from_numpy(got), direct.float().cpu()))
        out[f"tiny {arch} engine w8a8 stacked (2 requests)"][
            "rel_l2_vs_direct"] = errs
        log(f"  tiny {arch} engine vs the direct sampler on the card: rel L2 "
            + ", ".join(f"{e:.3e}" for e in errs))
        if not max(errs) <= ENGINE_DELTA_MAX:
            raise SystemExit(f"tiny {arch} engine: a request differs from "
                             f"the direct sampler by {max(errs)}")
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


# ---------------------------------------------------------------------------
# phases 13-14: AuraFlow v0.3 and Lumina 2 at published width and depth
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper a forward reaches replaced by its plain PyTorch
    version, on the card's own tensors: the same arithmetic without the
    hand-written kernels, the full-width oracle of phases 13-16. The fused
    matmul's epilogue (LoRA term, bias, GELU) runs on the f32 product and
    rounds once, as the kernels and the Pallas kernels' ``_epilogue`` do.
    Fails if a kernel was launched inside the scope."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.nn import attention, layers
    from comfyui_gguf_tpu_torch.ops import i8attn
    from comfyui_gguf_tpu_torch.ops.i8mm import plain_i8mm
    from comfyui_gguf_tpu_torch.ops.qmatmul import plain_quantized_matmul
    from comfyui_gguf_tpu_torch.quant.i8 import I8Planar

    def packed(x, weight, cfg, **kw):
        if isinstance(weight, I8Planar):
            return plain_i8mm(x, weight, out_dtype=x.dtype, **kw)
        return plain_quantized_matmul(x, weight,
                                      dequant_dtype=cfg.dequant_dtype,
                                      out_dtype=torch.float32,
                                      **kw).to(x.dtype)

    saved = (layers._packed_matmul, attention.flash_attn_cuda,
             i8attn.i8_attention_cuda)
    layers._packed_matmul = packed
    attention.flash_attn_cuda = attention.plain_attention
    i8attn.i8_attention_cuda = i8attn.plain_i8_attention
    before = dict(_build.LAUNCHES)
    try:
        yield
    finally:
        (layers._packed_matmul, attention.flash_attn_cuda,
         i8attn.i8_attention_cuda) = saved
    # an oracle that reached a kernel would compare the kernel with itself
    moved = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()
             if n != before.get(k, 0)}
    if moved:
        raise SystemExit(f"a forward through the plain versions launched "
                         f"kernels: {moved}")


@contextlib.contextmanager
def _no_activation_rounding():
    """The control of the K4 call gate: the plain w8a8 matmul with its
    activations scaled per row but not rounded to int8 codes (a kernel that
    skipped the rounding would compute this)."""
    from comfyui_gguf_tpu_torch.ops import i8mm

    saved = i8mm.quantize_rows

    def unrounded(x2):
        _, xs = saved(x2)
        return x2.float() / xs, xs

    i8mm.quantize_rows = unrounded
    try:
        yield
    finally:
        i8mm.quantize_rows = saved


@contextlib.contextmanager
def _block_taps(arch, tap):
    """Every block call of an ``arch`` forward (flux's double and single
    blocks; AuraFlow's double and single layers; Lumina 2's refiner and main blocks; Qwen-Image's, Wan's,
    Cosmos's and LTX-Video's blocks; HiDream's and HunyuanVideo's double
    and single blocks) goes through
    ``tap(block, args)``;
    the forward carries on with what it returns."""
    from comfyui_gguf_tpu_torch.models import (aura, cosmos, flux, hidream,
                                               hyvid, ltxv, lumina2,
                                               qwen_image, wan)

    mod, names = {"flux": (flux, ("_double_block", "_single_block")),
                  "aura": (aura, ("_double_layer", "_single_layer")),
                  "lumina2": (lumina2, ("_block",)),
                  "qwen_image": (qwen_image, ("_block",)),
                  "wan": (wan, ("_block",)),
                  "cosmos": (cosmos, ("_block",)),
                  "hidream": (hidream, ("_double_block",
                                        "_single_block")),
                  "hyvid": (hyvid, ("_double_block", "_single_block")),
                  "ltxv": (ltxv, ("_block",))}[arch]
    saved = {n: getattr(mod, n) for n in names}
    for n, block in saved.items():
        setattr(mod, n, lambda *a, _block=block: tap(_block, a))
    try:
        yield
    finally:
        for n, block in saved.items():
            setattr(mod, n, block)


def _rel_out(got, want):
    """Relative L2 of a block's output: a tensor, or a pair of streams."""
    import torch

    if isinstance(got, tuple):
        got, want = (torch.cat([t.float().flatten() for t in ts])
                     for ts in (got, want))
    return rel_l2(got.float(), want.float())


@contextlib.contextmanager
def _kernel_calls(errs, control=False):
    """Every kernel wrapper a forward reaches also runs its plain version on
    the same operands (under ``plain_versions``); the relative L2 of each
    call goes to ``errs`` by kind ("K1/K2", "K4", "K7", "K6"). With
    ``control`` each K4 call also runs the plain version with its
    activations unrounded (→ ``errs["control"]``). The forward carries on
    with the kernels' outputs."""
    from comfyui_gguf_tpu_torch.nn import attention, layers
    from comfyui_gguf_tpu_torch.ops import i8attn
    from comfyui_gguf_tpu_torch.quant.i8 import I8Planar

    saved = (layers._packed_matmul, attention.flash_attn_cuda,
             i8attn.i8_attention_cuda)

    def packed(x, weight, cfg, **kw):
        out = saved[0](x, weight, cfg, **kw)
        kind = "K4" if isinstance(weight, I8Planar) else "K1/K2"
        with plain_versions():
            errs[kind].append(rel_l2(
                out.float(), layers._packed_matmul(x, weight, cfg,
                                                   **kw).float()))
            if control and kind == "K4":
                with _no_activation_rounding():
                    errs["control"].append(rel_l2(
                        out.float(), layers._packed_matmul(x, weight, cfg,
                                                           **kw).float()))
        return out

    def flash(q, k, v, scale):
        out = saved[1](q, k, v, scale)
        with plain_versions():
            errs["K7"].append(rel_l2(
                out.float(), attention.plain_attention(q, k, v,
                                                       scale).float()))
        return out

    def i8(q, k, v, **kw):
        out = saved[2](q, k, v, **kw)
        with plain_versions():
            errs["K6"].append(rel_l2(
                out.float(), i8attn.plain_i8_attention(q, k, v,
                                                       **kw).float()))
        return out

    (layers._packed_matmul, attention.flash_attn_cuda,
     i8attn.i8_attention_cuda) = packed, flash, i8
    try:
        yield
    finally:
        (layers._packed_matmul, attention.flash_attn_cuda,
         i8attn.i8_attention_cuda) = saved


def _call_gate(errs, what, fails):
    """Log the worst call of each kernel kind in ``errs`` and hold it to
    ``CALL_PLAIN_DELTA_MAX``; the control's least K4 call must read above
    the K4 limit."""
    kinds = [k for k in ("K1/K2", "K4", "K7", "K6") if errs[k]]
    log(f"  {what}: each kernel call vs its plain version on the same "
        f"operands, worst rel L2 "
        + ", ".join(f"{k} {_worst(errs[k]):.3e} ({len(errs[k])} calls)"
                    for k in kinds)
        + (f"; the control (K4 activations unrounded) least "
           f"{min(errs['control']):.3e}" if errs["control"] else ""))
    for k in kinds:
        if not _worst(errs[k]) <= CALL_PLAIN_DELTA_MAX[k]:
            fails.append(f"{what}: a {k} call differs from its plain "
                         f"version by rel L2 {_worst(errs[k])} > "
                         f"{CALL_PLAIN_DELTA_MAX[k]}")
    if errs["control"] and not min(errs["control"]) > CALL_PLAIN_DELTA_MAX[
            "K4"]:
        fails.append(f"{what}: the K4 gate cannot tell the control from the "
                     f"kernel (rel L2 {min(errs['control'])})")


def _call_errs():
    return {k: [] for k in ("K1/K2", "K4", "K7", "K6", "control")}


def _block_check(model, arch, inputs, recorded, replay):
    """One forward of ``model`` on ``inputs`` through ``_kernel_calls``
    (its errors → ``calls``), block by block. With ``replay`` false the
    blocks' inputs and outputs are appended to ``recorded``; with it true
    each block takes the inputs ``recorded`` holds for it instead and its
    output is held against the recorded one (→ ``vs_bf16``), and the K4
    calls also run the control. → the relative L2s."""
    import torch

    errs = {"calls": _call_errs(), "vs_bf16": []}
    rec = iter(list(recorded)) if replay else None

    def tap(block, a):
        if replay:
            rec_a, rec_out = next(rec)
            a = (a[0], *rec_a)
        out = block(*a)
        if replay:
            errs["vs_bf16"].append(_rel_out(out, rec_out))
        else:
            recorded.append((a[1:], out))
        return out

    with (torch.no_grad(), _block_taps(arch, tap),
          _kernel_calls(errs["calls"], control=replay)):
        model.forward(*inputs)
    return errs


def _worst(errs):
    return max(errs) if errs else float("nan")


def _guarded_embedding(vocab, hidden, seed, dev):
    """A random Q8_0 token embedding of ``vocab`` rows, as a llama.cpp file
    stores it, through the loader's big-embed guard (decoded to f16 on the
    host) and ``to_torch_params`` (a dense bf16 table on the card)."""
    import numpy as np

    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.loader import (QTensor, big_embed_guard,
                                               to_torch_params)

    rng = np.random.default_rng(seed)
    n = vocab * hidden // 32
    blocks = np.empty((n, 34), np.uint8)  # f16 scale + 32 s8 codes a block
    blocks[:, :2] = (rng.random(n, dtype=np.float32) * 2e-4 + 1e-4).astype(
        np.float16).view(np.uint8).reshape(n, 2)
    blocks[:, 2:] = rng.integers(-127, 128, (n, 32), dtype=np.int8).view(
        np.uint8)
    sd = big_embed_guard({"token_embd.weight": QTensor(
        name="token_embd.weight", qtype=Q.Q8_0, shape=(vocab, hidden),
        data=blocks)})
    if sd["token_embd.weight"].qtype != Q.F16:
        raise SystemExit("the big-embed guard left the embedding packed")
    return to_torch_params(sd, device=dev)["token_embd.weight"]


def _dit_encoder(dev, arch, enc_layers):
    """The published-width conditioning encoder of ``arch``, seed-made on
    the card: Pile-T5-XL (Q8_0) for AuraFlow; for Lumina 2 the llama graph
    at Gemma-2-2b's shapes (Q8_0, its 256000-row embedding through the
    big-embed guard) with a 256000-entry byte-level BPE vocabulary."""
    import torch

    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import llama, t5, testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer import (BPETokenizer,
                                                  UnigramTokenizer)

    device = torch.device(dev)
    if arch == "aura":
        dims = dataclasses.replace(testing.PILE_T5_XL_DIMS,
                                   n_layers=enc_layers)
        params = testing.t5_random_params(dims, qtype=Q.Q8_0, seed=20,
                                          device=dev)
        return TextEncoder("t5", params, t5.T5Config.from_state_dict(params),
                           UnigramTokenizer(testing.unigram_spec(dims.vocab)),
                           QuantConfig(), device)
    dims = dataclasses.replace(testing.GEMMA2_2B_LLAMA_DIMS,
                               n_layers=enc_layers)
    params = testing.llama_random_params(dims, qtype=Q.Q8_0, seed=21,
                                         device=dev)
    params["model.embed_tokens.weight"] = _guarded_embedding(
        dims.vocab, dims.hidden, 22, dev)
    return TextEncoder("llama", params,
                       llama.LlamaConfig.from_state_dict(params),
                       BPETokenizer(testing.bpe_spec(dims.vocab)),
                       QuantConfig(), device)


def _aura_i8attn_check(model, enc, x0, t, n_attn, res, fails):
    """AuraFlow on the bf16-fused tree under ``attention_i8("pv")``: K6's
    256-wide instance in every layer. The int8 gate takes 128-multiple
    lengths only, so a 248-token prompt (4352 tokens); at the default 256
    (4360) the gate refuses and K7 runs. One forward counts the launches;
    a second runs each block also with the default attention (within 3e-2,
    phase 6's limit) and through the plain versions (the block gate), on
    the same inputs; the whole forward's distance from the default
    attention is recorded. → its launches."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.nn.attention import attention_i8
    from comfyui_gguf_tpu_torch.pipeline import _text_states

    c248 = _text_states(enc, PROMPTS[0], 248)
    errs_default, calls = [], _call_errs()

    def tap(block, a):
        out = block(*a)
        with attention_i8(""):
            errs_default.append(_rel_out(out, block(*a)))
        return out

    with torch.no_grad():
        ref = model.forward(x0, c248, t)
        _build.reset_launch_counts()
        with attention_i8("pv"):
            got = model.forward(x0, c248, t)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        # the default-attention block inside the tap takes K7; its calls
        # are held to plain too
        with (attention_i8("pv"), _block_taps("aura", tap),
              _kernel_calls(calls)):
            model.forward(x0, c248, t)
        torch.cuda.synchronize()
    err = rel_l2(got.float(), ref.float())
    res["attention_i8_pv"] = dict(
        forward_rel_l2_vs_bf16_attn=err,
        block_rel_l2_vs_bf16_attn=errs_default,
        call_rel_l2_vs_plain=calls, launches=counts)
    log(f"  attention_i8('pv') at 4352 tokens (bf16-fused tree): a block "
        f"vs the default attention, worst rel L2 "
        f"{_worst(errs_default):.3e} (whole forward {err:.3e}); launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    _call_gate(calls, "aura attention_i8('pv')", fails)
    if counts["i8attn_pv"] != n_attn or counts["flash_attn_d256"] != 0:
        fails.append("aura attention_i8('pv') did not take K6 in every "
                     "layer")
    if not _worst(errs_default) <= I8ATTN_DELTA_MAX:
        fails.append(f"aura attention_i8('pv') moved a block by rel L2 "
                     f"{_worst(errs_default)} > {I8ATTN_DELTA_MAX}")
    return counts


def dit_full_phase(dev, arch, depth, steps, enc_layers, engine_steps):
    """AuraFlow v0.3 (``AURA_V03_DIMS``, 4 double + ``depth`` single layers)
    or Lumina 2 (``LUMINA2_DIMS``, ``depth`` main layers + 2 + 2 refiners),
    seed-made Q4_K stacked, with its encoder at published width
    (``_dit_encoder``), through ``AuraPipeline``/``Lumina2Pipeline.generate``
    at 1024² with the reference's defaults (20 steps; CFG 3.5, shift 1.73 /
    CFG 4.0, shift 6.0) and a negative prompt, on the bf16-fused tree and
    then on the w8a8 tree: finite latents of the right shape, K7 exactly
    its per-forward count (36 at 256 / 30 at 96) twice a step. Then one
    forward of each tree runs with every kernel call also through its plain
    version on the same operands (``_kernel_calls``), each within
    ``CALL_PLAIN_DELTA_MAX``; on the w8a8 tree each block takes the
    bf16-fused tree's inputs to it and must be within
    ``W8A8_BLOCK_DELTA_MAX`` of the bf16-fused block, and every K4 call's
    control (activations unrounded) must read above K4's limit. The w8a8
    tree's distance from the bf16-fused one over a whole forward and in the
    final latent is recorded. AuraFlow also runs the bf16-fused tree under
    ``attention_i8("pv")`` (``_aura_i8attn_check``). Then the arch's engine
    serves two requests for ``engine_steps`` steps, each within 1e-2 of the
    direct sampler at batch 1. The trees are freed at the end."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (
        AuraPipeline, DiffusionModel, Lumina2Pipeline, _text_states,
        aura_engine, lumina2_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)

    aura = arch == "aura"
    if aura:
        dims = dataclasses.replace(testing.AURA_V03_DIMS, depth_single=depth)
        params = testing.aura_random_stacked_params(dims, qtype=Q.Q4_K,
                                                    seed=0, device=dev)
        k7, n_attn = "flash_attn_d256", dims.depth_double + depth
        pipe_cls, mk, ck, nk, cfg_scale = (AuraPipeline, aura_engine, "ctx",
                                           "nctx", 3.5)
        log(f"  AuraFlow v0.3 width (hidden 3072, 12 heads of 256), "
            f"{dims.depth_double} double + {depth} single layers (of 4 + "
            f"32), 1024² = 4096 image + 256 text + 8 register tokens")
    else:
        dims = dataclasses.replace(testing.LUMINA2_DIMS, n_layers=depth)
        params = testing.lumina2_random_stacked_params(dims, qtype=Q.Q4_K,
                                                       seed=0, device=dev)
        k7 = "flash_attn_d96"
        n_attn = depth + dims.n_refiner + dims.n_context_refiner
        pipe_cls, mk, ck, nk, cfg_scale = (Lumina2Pipeline, lumina2_engine,
                                           "cap", "ncap", 4.0)
        log(f"  Lumina 2 width (dim 2304, 24 heads of 96), {depth} of 26 "
            f"layers + 2 noise + 2 context refiners, 1024² = 4096 image + "
            f"256 caption tokens")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DiffusionModel(arch=arch, params=params, config=dims.config(),
                           qcfg=QuantConfig(), device=torch.device(dev))
    enc = _dit_encoder(dev, arch, enc_layers)
    torch.cuda.synchronize()
    pipe = pipe_cls(model, enc)
    res = {"depth": depth, "steps": steps, "cfg_scale": cfg_scale,
           "shift": pipe.shift, "encoder_layers": enc_layers,
           "build_s": time.perf_counter() - t0}
    log(f"  random Q4_K stacked tree and {enc.kind} encoder ({enc_layers} "
        f"layers, Q8_0) built on the card in {res['build_s']:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    launches = {k: 0 for k in _build.LAUNCHES}
    fwds, recorded, fails = {}, [], []
    # one forward's inputs: noise at 1024², the prompt's states, t = 0.7
    gen = torch.Generator(device=dev).manual_seed(31)
    x0 = torch.randn((1, 128, 128, dims.in_ch), generator=gen,
                     device=dev).to(torch.bfloat16)
    cond = _text_states(enc, PROMPTS[0], 256)
    t = torch.full((1,), 0.7, device=dev)

    def check(tree):
        fwds[tree] = _tree_check(model, arch, (x0, cond, t), tree,
                                 res.setdefault(tree, {}), recorded, fails)
        if aura and tree == "bf16_fused":
            for k, n in _aura_i8attn_check(model, enc, x0, t, n_attn, res,
                                           fails).items():
                launches[k] += n

    def generate():
        lat = pipe.generate(PROMPTS[0], negative_prompt=PROMPTS[1],
                            width=1024, height=1024, steps=steps, seed=0)
        if lat.shape != (128, 128, dims.in_ch):
            raise SystemExit(f"{arch}: a latent of shape {lat.shape}")
        return lat, dict(pipe.last_timings)

    finals = _run_trees(
        arch, model, generate, check, k7, n_attn, steps, 2, res, launches,
        lambda tree: {"i8mm" if tree == "w8a8" else "qmm_nib4": 1,
                      "qmm_int8": 2 * 7 * enc_layers})
    # the accuracy cost of the w8a8 conversion carried through the stack
    # and the sampler: recorded (the block limit above is the gate); flux
    # and sd3.5 hold it under LATENT_DELTA_MAX in phases 5 and 10
    res["forward_rel_delta_w8a8_vs_bf16"] = rel_l2(fwds["w8a8"].float(),
                                                   fwds["bf16_fused"].float())
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    log(f"  requantize_i8 {res['requantize_s']:.3f}s (peak "
        f"{res['requantize_peak_gib']:.2f} GiB); w8a8 vs bf16-fused: one "
        f"forward rel L2 {res['forward_rel_delta_w8a8_vs_bf16']:.3e}, final "
        f"latent {res['latent_rel_delta_w8a8_vs_bf16']:.3e} (flux's and "
        f"sd3.5's phases 5 and 10 hold this under {LATENT_DELTA_MAX})")

    # where a w8a8 forward's device time goes (not a path: its launches are
    # not counted)
    before = dict(_build.LAUNCHES)
    res["profile_w8a8_forward"] = profile_forward(
        model, (x0, cond, t), res["w8a8"]["s_per_step"] / 2, f"{arch} w8a8")
    _build.LAUNCHES.update(before)

    # the engine: two requests (CFG cfg_scale and 1), against the direct
    # sampler at batch 1 with the same f32 CFG mix
    sig = shift_sigmas(linear_schedule(engine_steps), pipe.shift)
    gen = torch.Generator(device=dev).manual_seed(30)
    nctx = _text_states(enc, PROMPTS[1], 256)
    reqs = [(torch.randn((128, 128, dims.in_ch), generator=gen,
                         device=dev).to(torch.bfloat16),
             {ck: cond[0], nk: nctx[0],
              "cfg_scale": torch.tensor(scale, device=dev)}, sig)
            for scale in (cfg_scale, 1.0)]

    def direct(x, c, s):
        def vel(xc, sg):
            ts = sg.to(torch.float32).expand(1)
            v_c = model.forward(xc, c[ck][None].to(torch.bfloat16), ts)
            v_u = model.forward(xc, c[nk][None].to(torch.bfloat16), ts)
            return v_u.float() + float(c["cfg_scale"]) * (v_c.float()
                                                          - v_u.float())
        return sample_flow(vel, x[None], s)[0]

    _engine_check(lambda: mk(model, max_batch=2), reqs, direct, res,
                  launches, fails)
    if fails:
        raise SystemExit(f"{arch}: " + "; ".join(fails))
    res["launches"] = launches
    free_tree(model.params)
    free_tree(enc.params)
    del model, enc, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 15-16: Qwen-Image and HiDream-I1 at published width and depth
# ---------------------------------------------------------------------------

QWEN_PAD_ID = 151655  # Qwen2.5-VL's <|image_pad|>


def _llama_encoder(dev, dims, layers, seed, **cfg):
    """A llama-graph encoder of ``dims`` (``layers`` of its layers), seed-
    made on the card at Q8_0, its embedding through the big-embed guard,
    with a byte-level BPE vocabulary of its size; ``cfg`` overrides
    ``LlamaConfig.from_state_dict``'s reading (heads, rope theta) and then
    the config's other fields."""
    import torch

    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import llama, testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer import BPETokenizer

    dims = dataclasses.replace(dims, n_layers=layers)
    params = testing.llama_random_params(dims, qtype=Q.Q8_0, seed=seed,
                                         device=dev)
    params["model.embed_tokens.weight"] = _guarded_embedding(
        dims.vocab, dims.hidden, seed + 1, dev)
    read = {k: cfg.pop(k) for k in ("n_heads", "rope_theta") if k in cfg}
    config = dataclasses.replace(
        llama.LlamaConfig.from_state_dict(params, **read), **cfg)
    return TextEncoder("llama", params, config,
                       BPETokenizer(testing.bpe_spec(dims.vocab)),
                       QuantConfig(), torch.device(dev))


def _tree_check(model, arch, inputs, tree, run, recorded, fails):
    """One forward of ``model`` on ``inputs`` with every kernel call also
    through its plain version (``_block_check``; not a path: its launches
    are not counted), held to ``CALL_PLAIN_DELTA_MAX``. The bf16-fused tree
    records its blocks' inputs and outputs in ``recorded``; the w8a8 tree's
    blocks take those inputs, each is held within ``W8A8_BLOCK_DELTA_MAX``
    of the bf16-fused block, and its K4 calls run the control. → the plain
    forward's output."""
    import torch

    from comfyui_gguf_tpu_torch import _build

    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        out = model.forward(*inputs)
    errs = _block_check(model, arch, inputs, recorded, tree == "w8a8")
    torch.cuda.synchronize()
    _build.LAUNCHES.update(before)
    run["call_rel_l2_vs_plain"] = errs["calls"]
    if not bool(torch.isfinite(out).all()):
        fails.append(f"{arch} {tree}: a non-finite forward")
    _call_gate(errs["calls"], f"{arch} {tree}", fails)
    if tree == "w8a8":
        # blocks whose linears all stay dense (Lumina 2's refiners) are
        # equal in both trees: no int8
        q = [e for e in errs["vs_bf16"] if e > 0]
        run["block_rel_l2_vs_bf16"] = errs["vs_bf16"]
        log(f"  w8a8: a block vs the bf16-fused block on the same inputs, "
            f"worst rel L2 {_worst(q):.3e} (median "
            f"{statistics.median(q):.3e}, {len(q)} blocks)")
        if not _worst(q) <= W8A8_BLOCK_DELTA_MAX:
            fails.append(f"{arch}: a w8a8 block differs from the bf16-fused "
                         f"block by rel L2 {_worst(q)} > "
                         f"{W8A8_BLOCK_DELTA_MAX}")
        recorded.clear()
    return out


def _run_trees(arch, model, generate, check, k7, n_k7, steps, fwd_per_step,
               res, launches, want_launches):
    """Text to image on the bf16-fused tree, then ``requantize_i8()`` (its
    seconds and peak memory) and the same on the w8a8 tree; each tree's
    ``check`` runs its gates (the w8a8 one before its image, so that the
    recorded blocks are gone when the image's peak memory is read). K7's
    instance ``k7`` must launch ``n_k7`` times a forward; the latents must
    be finite. → the final latents by tree."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build

    finals = {}
    for tree in ("bf16_fused", "w8a8"):
        if tree == "w8a8":
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model.requantize_i8()
            torch.cuda.synchronize()
            res["requantize_s"] = time.perf_counter() - t0
            res["requantize_peak_gib"] = (torch.cuda.max_memory_allocated()
                                          / 2**30)
            check(tree)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        lat, tm = generate()
        counts = dict(_build.LAUNCHES)
        run = res.setdefault(tree, {})
        run.update(timings_s=tm, s_per_step=tm["denoise_s"] / steps,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=counts)
        log(f"  {tree}: {steps} steps, {fwd_per_step} forward(s) a step: "
            f"encode {tm['encode_s']:.4f}s, denoise {tm['denoise_s']:.3f}s "
            f"({run['s_per_step'] * 1e3:.1f} ms/step), image "
            f"{tm['total_s']:.3f}s; peak {run['peak_gib']:.2f} GiB; "
            f"launches { {k: n for k, n in counts.items() if n} }")
        if not bool(np.isfinite(lat).all()):
            raise SystemExit(f"{arch} {tree}: a non-finite latent")
        finals[tree] = torch.from_numpy(lat)
        if counts[k7] != n_k7 * fwd_per_step * steps:
            raise SystemExit(f"{arch} {tree}: {counts[k7]} launches of "
                             f"{k7}, expected {n_k7} a forward")
        for k, n in want_launches(tree).items():
            if counts[k] < n:
                raise SystemExit(f"{arch} {tree}: {counts[k]} launches of "
                                 f"{k}, expected {n} or more")
        for k, n in counts.items():
            launches[k] += n
        if tree == "bf16_fused":
            check(tree)
    return finals


def _engine_check(mk_engine, reqs, direct, res, launches, fails):
    """Two requests through an engine (max_batch 2), each against the
    direct sampler at batch 1 (``direct(x, cond)``)."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build

    eng = mk_engine()
    _build.reset_launch_counts()
    t1 = time.perf_counter()
    hs = [eng.submit(x, c, s) for x, c, s in reqs]
    eng.run_until_drained()
    torch.cuda.synchronize()
    res["engine"] = dict(wall_s=time.perf_counter() - t1,
                         ticks=eng.stats.batches_executed,
                         launches=dict(_build.LAUNCHES))
    for k, n in _build.LAUNCHES.items():
        launches[k] += n
    errs = []
    for (x, c, s), h in zip(reqs, hs):
        if h.error is not None or not h.finished:
            raise SystemExit(f"engine: a request failed: {h.error}")
        with torch.no_grad():
            want = direct(x, c, s)
        errs.append(rel_l2(torch.from_numpy(np.asarray(h.result,
                                                       np.float32)),
                           want.float().cpu()))
    res["engine"]["rel_l2_vs_direct"] = errs
    log(f"  engine(max_batch=2): 2 requests in {res['engine']['ticks']} "
        f"ticks, {res['engine']['wall_s']:.3f}s; vs the direct sampler at "
        f"batch 1: rel L2 " + ", ".join(f"{e:.3e}" for e in errs))
    if not max(errs) <= ENGINE_DELTA_MAX:
        fails.append(f"engine: a served request differs from the direct "
                     f"sampler by rel L2 {max(errs)}")


def qwen_image_phase(dev, depth, steps, enc_layers, vision_layers,
                     engine_steps):
    """Phase 15: Qwen-Image (``QWEN_IMAGE_20B_DIMS``, ``depth`` of 60
    blocks), seed-made Q4_K stacked, with the Qwen2.5-VL-7B-shaped llama
    graph (Q8_0, ``enc_layers`` of 28 layers, its config built as the
    reference's own test builds the published one: 28 heads, rope theta 1e6,
    M-RoPE (16, 24, 24), eps 1e-6) through ``QwenImagePipeline.generate`` at
    1024² with the reference's defaults (20 steps, CFG 4.0, shift 2.2,
    max_len 256, negative " "), on the bf16-fused tree and then on the w8a8
    tree (img_mod / txt_mod kept planar): finite latent tokens, K7 exactly
    ``depth`` times a forward, two forwards a step; the gates of phases
    13-14 on one forward of each tree; the w8a8 tree's distance over a
    forward and in the final latent recorded. Then the Qwen2.5-VL vision
    tower at published width (``vision_layers`` of 32 blocks) on a 448²
    image (1024 patches, 256 merged tokens) spliced through
    ``qwen_vl_encode_with_image``, and ``generate_edit`` with one
    128 × 128 × 16 reference latent for 4 steps on that conditioning; and
    ``qwen_image_engine`` serving two requests for ``engine_steps`` steps,
    each within 1e-2 of the direct sampler at batch 1. The trees are freed
    at the end."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.models.flux import make_img_ids
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (
        DiffusionModel, QwenImagePipeline, _text_states, qwen_image_engine,
        qwen_vl_encode_with_image)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)

    dims = dataclasses.replace(testing.QWEN_IMAGE_20B_DIMS, n_layers=depth)
    log(f"  Qwen-Image width (hidden 3072, 24 heads of 128), {depth} of 60 "
        f"blocks, 1024² = 4096 image + 256 text tokens")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DiffusionModel(
        arch="qwen_image", params=testing.qwen_image_random_stacked_params(
            dims, qtype=Q.Q4_K, seed=0, device=dev),
        config=dims.config(), qcfg=QuantConfig(), device=torch.device(dev))
    enc = _llama_encoder(dev, testing.QWEN25_VL_7B_LLAMA_DIMS, enc_layers,
                         40, n_heads=28, rope_theta=1e6,
                         mrope_section=(16, 24, 24), eps=1e-6)
    vdims = dataclasses.replace(testing.QWEN25_VL_7B_VISION_DIMS,
                                n_layers=vision_layers)
    enc.params.update(testing.qwen_vl_vision_random_params(vdims, seed=42,
                                                           device=dev))
    torch.cuda.synchronize()
    pipe = QwenImagePipeline(model, enc)
    res = {"depth": depth, "steps": steps, "cfg_scale": 4.0,
           "shift": pipe.shift, "encoder_layers": enc_layers,
           "vision_layers": vision_layers,
           "build_s": time.perf_counter() - t0}
    log(f"  random Q4_K stacked tree, Qwen2.5-VL-7B-shaped encoder "
        f"({enc_layers} layers, Q8_0, {enc.config.n_heads} heads / "
        f"{enc.config.n_kv_heads} kv of {enc.config.head_dim}) and vision "
        f"tower ({vision_layers} blocks, dense bf16) built on the card in "
        f"{res['build_s']:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    launches = {k: 0 for k in _build.LAUNCHES}
    fwds, recorded, fails = {}, [], []
    gen = torch.Generator(device=dev).manual_seed(31)
    img_ids = torch.as_tensor(np.array(make_img_ids(64, 64, 1)), device=dev)
    x0 = torch.randn((1, 4096, dims.in_ch), generator=gen,
                     device=dev).to(torch.bfloat16)
    cond = _text_states(enc, PROMPTS[0], 256)
    txt_ids = torch.zeros((1, 256, 3), dtype=torch.int32, device=dev)
    inputs = (x0, img_ids, cond, txt_ids, torch.full((1,), 0.7, device=dev))

    def check(tree):
        fwds[tree] = _tree_check(model, "qwen_image", inputs, tree,
                                 res.setdefault(tree, {}), recorded, fails)

    def generate():
        lat = pipe.generate(PROMPTS[0], width=1024, height=1024, steps=steps,
                            seed=0)
        if lat.shape != (4096, dims.in_ch):
            raise SystemExit(f"qwen_image: latent tokens of shape "
                             f"{lat.shape}")
        return lat, dict(pipe.last_timings)

    finals = _run_trees(
        "qwen_image", model, generate, check, "flash_attn_d128", depth, steps,
        2, res, launches,
        lambda tree: {"i8mm" if tree == "w8a8" else "qmm_nib4": 1,
                      "qmm_nib4_smallm": 2 * 2 * depth * steps,
                      "qmm_int8": 2 * 7 * enc_layers})
    res["forward_rel_delta_w8a8_vs_bf16"] = rel_l2(
        fwds["w8a8"].float(), fwds["bf16_fused"].float())
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    log(f"  requantize_i8 {res['requantize_s']:.3f}s (peak "
        f"{res['requantize_peak_gib']:.2f} GiB); w8a8 vs bf16-fused: one "
        f"forward rel L2 {res['forward_rel_delta_w8a8_vs_bf16']:.3e}, final "
        f"latent {res['latent_rel_delta_w8a8_vs_bf16']:.3e} (flux's and "
        f"sd3.5's phases 5 and 10 hold this under {LATENT_DELTA_MAX})")
    before = dict(_build.LAUNCHES)
    res["profile_w8a8_forward"] = profile_forward(
        model, inputs, res["w8a8"]["s_per_step"] / 2, "qwen_image w8a8")
    _build.LAUNCHES.update(before)

    # the vision tower at published width, spliced into the encoder, and
    # Qwen-Image-Edit on that conditioning with one reference latent
    rng = np.random.default_rng(43)
    image = rng.random((448, 448, 3)).astype(np.float32)
    head = enc.tokenizer.encode_batch([PROMPTS[1]], max_length=32)[0]
    ids = np.concatenate([head, np.full((1, 256), QWEN_PAD_ID)], axis=1)
    _build.reset_launch_counts()
    t1 = time.perf_counter()
    txt = qwen_vl_encode_with_image(enc, enc.params, ids, image,
                                    QWEN_PAD_ID)["last_hidden"]
    torch.cuda.synchronize()
    vis_s = time.perf_counter() - t1
    ntxt = _text_states(enc, " ", ids.shape[1])
    ref = torch.randn((128, 128, 16), generator=gen, device=dev)
    lat = pipe.generate_edit("", [ref], width=1024, height=1024, steps=4,
                             txt_override=txt, ntxt_override=ntxt, seed=1)
    counts = dict(_build.LAUNCHES)
    for k, n in counts.items():
        launches[k] += n
    tm = dict(pipe.last_timings)
    L_edit = ids.shape[1] + 2 * 4096
    res["edit"] = dict(vision_encode_s=vis_s, timings_s=tm,
                       s_per_step=tm["denoise_s"] / 4, tokens=L_edit,
                       launches=counts)
    log(f"  vision tower + splice ({ids.shape[1]} ids, 256 image tokens "
        f"from 1024 patches) {vis_s:.3f}s; generate_edit at {L_edit} "
        f"tokens (text + image + reference): "
        f"{res['edit']['s_per_step'] * 1e3:.1f} ms/step (CFG); launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if (lat.shape != (4096, dims.in_ch) or not bool(np.isfinite(lat).all())
            or counts["flash_attn_d128"] != 2 * depth * 4):
        raise SystemExit("qwen_image edit: a misshapen or non-finite latent, "
                         "or K7 not once a block")

    sig = shift_sigmas(linear_schedule(engine_steps), pipe.shift)
    reqs = [(torch.randn((4096, dims.in_ch), generator=gen,
                         device=dev).to(torch.bfloat16),
             {"txt": c[0]}, sig)
            for c in (cond, _text_states(enc, PROMPTS[1], 256))]

    def direct(x, c, s):
        def vel(xc, sg):
            return model.forward(xc, img_ids, c["txt"][None].to(
                torch.bfloat16), txt_ids, sg.to(torch.float32).expand(1))
        return sample_flow(vel, x[None], s)[0]

    _engine_check(lambda: qwen_image_engine(model, 64, 64, 256, max_batch=2),
                  reqs, direct, res, launches, fails)
    if fails:
        raise SystemExit("qwen_image: " + "; ".join(fails))
    res["launches"] = launches
    free_tree(model.params)
    free_tree(enc.params)
    del model, enc, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _routes(store):
    """Each HiDream router call's top-k mask (tokens × experts, on the host)
    appended to ``store``."""
    from comfyui_gguf_tpu_torch.models import hidream

    saved = hidream._routing_probs

    def spy(*a, **kw):
        probs, k = saved(*a, **kw)
        store.append((probs.reshape(-1, probs.shape[-1]) > 0).cpu())
        return probs, k

    hidream._routing_probs = spy
    try:
        yield
    finally:
        hidream._routing_probs = saved


@contextlib.contextmanager
def _capacity_factor(factor):
    from comfyui_gguf_tpu_torch.models import hidream

    saved = hidream.MOE_CAPACITY_FACTOR
    hidream.MOE_CAPACITY_FACTOR = factor
    try:
        yield
    finally:
        hidream.MOE_CAPACITY_FACTOR = saved


def _capacity_check(model, inputs, dims, factor, dense_out):
    """One HiDream forward in "capacity" dispatch at capacity ``factor``,
    each block also run in "dense" dispatch on the same inputs (the forward
    carries on with the capacity block's output). → the per-block and the
    whole-forward relative L2 against dense, and the overflows: the
    (block, expert) pairs routed more tokens than they take, and the
    tokens they drop."""
    import torch

    from comfyui_gguf_tpu_torch.models import hidream

    errs, routes = [], []

    def tap(block, a):
        with _moe_dispatch("capacity"):
            out = block(*a)
        errs.append(_rel_out(out, block(*a)))
        return out

    with (torch.no_grad(), _capacity_factor(factor),
          _block_taps("hidream", tap), _routes(routes)):
        out = model.forward(*inputs)
        caps = {m.shape[0]: hidream.capacity(m.shape[0], dims.top_k,
                                             dims.n_experts)
                for m in routes}
    torch.cuda.synchronize()
    routes = routes[::2]  # each block's capacity call (dense: the same)
    over = [max(0, int(m[:, e].sum()) - caps[m.shape[0]])
            for m in routes for e in range(dims.n_experts)]
    rec = dict(capacity_by_tokens=caps,
               overflowing_experts=sum(o > 0 for o in over),
               dropped_tokens=sum(over), block_rel_l2_vs_dense=errs,
               forward_rel_l2_vs_dense=rel_l2(out.float(),
                                              dense_out.float()))
    log(f"  capacity dispatch at factor {factor} (tokens an expert takes, "
        f"by tokens: {caps}): {rec['overflowing_experts']} of {len(over)} "
        f"(block, expert) pairs overflowed ({sum(over)} tokens dropped); a "
        f"w8a8 block vs the same block in dense dispatch, worst rel L2 "
        f"{_worst(errs):.3e} (whole forward "
        f"{rec['forward_rel_l2_vs_dense']:.3e})")
    return rec


def _budget_check(dev, dims, blocks, fails):
    """``requantize_i8(max_bytes=, host_stage=True)`` on a HiDream tree of
    ``blocks`` (double, single) blocks at published width, under a budget
    of its planar footprint plus 60% of the full conversion's byte delta
    (60% of the full int8 tree's bytes would sit below the planar tree's
    own: Q4_K takes 0.75 bytes a weight here, int8 one), beside the
    unbudgeted on-device conversion of the same tree: the planned share of
    the delta and the card's peak during each conversion. → the record."""
    import torch

    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree, tree_leaves
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel
    from comfyui_gguf_tpu_torch.quant.i8 import (_leaf_bytes,
                                                 is_modulation_key,
                                                 plan_i8_budget)
    from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

    dims = dataclasses.replace(dims, depth_double=blocks[0],
                               depth_single=blocks[1])
    pred = lambda k, v: not is_modulation_key(k)  # noqa: E731
    out = {"blocks": list(blocks)}
    for mode in ("on_device", "budget_host_staged"):
        model = DiffusionModel(
            arch="hidream", params=testing.hidream_random_stacked_params(
                dims, qtype=Q.Q4_K, seed=0, device=dev),
            config=dims.config(), qcfg=QuantConfig(),
            device=torch.device(dev))
        leaves = {}

        def scan(node, path):
            for k, v in node.items():
                kp = f"{path}.{k}" if path else k
                if isinstance(v, dict):
                    scan(v, kp)
                elif isinstance(v, PlanarQuant):
                    leaves[kp] = (*_leaf_bytes(v), pred(kp, v))

        scan(model.params, "")
        planar = sum(p for p, _, _ in leaves.values())
        delta = sum(i - p for p, i, ok in leaves.values() if ok)
        kw, plan = {}, None
        if mode != "on_device":
            kw = dict(max_bytes=int(planar + 0.6 * delta), host_stage=True)
            plan = plan_i8_budget(model.params, max_bytes=kw["max_bytes"],
                                  pred=pred)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model.requantize_i8(**kw)
        torch.cuda.synchronize()
        run = dict(seconds=time.perf_counter() - t0,
                   before_gib=before / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   after_gib=torch.cuda.memory_allocated() / 2**30,
                   planar_gb=planar / 1e9, full_int8_gb=(planar + delta)
                   / 1e9)
        if plan is not None:
            done = sum(i - p for k, (p, i, _) in leaves.items() if k in plan)
            run.update(budget_gb=kw["max_bytes"] / 1e9,
                       leaves_planned=len(plan), leaves=len(leaves),
                       planned_share_of_delta=done / delta,
                       budget_share_of_full_int8=kw["max_bytes"]
                       / (planar + delta))
            n_i8 = sum(1 for x in tree_leaves(model.params)
                       if x.dtype == torch.int8 and x.dim() >= 2)
            if n_i8 == 0 or not plan:
                fails.append("hidream: the budgeted conversion converted "
                             "nothing")
        out[mode] = run
        log(f"  {mode.replace('_', ' ')} conversion of a {blocks[0]} + "
            f"{blocks[1]}-block tree (planar {planar / 1e9:.2f} GB, full "
            f"int8 {(planar + delta) / 1e9:.2f} GB)"
            + (f" under {kw['max_bytes'] / 1e9:.2f} GB "
               f"({run['budget_share_of_full_int8']:.0%} of the full int8 "
               f"tree): {len(plan)} of {len(leaves)} leaves planned, "
               f"{run['planned_share_of_delta']:.0%} of the delta"
               if plan is not None else "")
            + f": {run['seconds']:.2f}s, card peak {run['peak_gib']:.2f} GiB "
            f"(from {run['before_gib']:.2f}, after {run['after_gib']:.2f})")
        free_tree(model.params)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hidream_phase(dev, depth_double, depth_single, steps, t5_layers,
                  llama_layers, engine_steps, budget_blocks):
    """Phase 16: HiDream-I1 (``HIDREAM_I1_DIMS``: 4 routed experts top-2
    plus the shared one; ``depth_double`` of 16 and ``depth_single`` of 32
    blocks), seed-made Q4_K stacked, with CLIP-L and CLIP-G, T5-xxl
    (``t5_layers``, Q8_0) and the Llama-3.1-8B-shaped llama graph
    (``llama_layers``, Q8_0, 128256 rows through the big-embed guard)
    through ``HiDreamPipeline.generate_from_ids`` at 1024², 20 steps (one
    forward a step), 128 T5 and 128 llama tokens (4352 joint tokens), on
    the bf16-fused tree and then on the w8a8 tree (adaLN kept planar): K7
    exactly ``depth_double + depth_single`` times a forward; the gates of
    phases 13-14, with the routing of each block recorded on both trees
    (the tokens whose top-2 sets differ); w8a8 forwards in "capacity"
    dispatch (``_capacity_check``) at the default factor (overflows
    recorded) and at E/k, where no expert can overflow and each block must
    be within 1e-2 of dense; ``hidream_engine`` serving two requests within
    1e-2 of the direct sampler. Then ``_budget_check`` on a tree of
    ``budget_blocks`` (double, single) blocks."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.models import hidream, t5, testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (DiffusionModel,
                                                 HiDreamPipeline, TextEncoder,
                                                 hidream_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)
    from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer

    dims = dataclasses.replace(testing.HIDREAM_I1_DIMS,
                               depth_double=depth_double,
                               depth_single=depth_single)
    n_attn = depth_double + depth_single
    log(f"  HiDream-I1 width (hidden 2560, 20 heads of 128, FFN 6912, 4 "
        f"experts top-2 + shared), {depth_double} double + {depth_single} "
        f"single blocks (of 16 + 32), 1024² = 4096 image + 128 T5 + 128 "
        f"llama tokens")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    model = DiffusionModel(
        arch="hidream", params=testing.hidream_random_stacked_params(
            dims, qtype=Q.Q4_K, seed=0, device=dev),
        config=dims.config(), qcfg=QuantConfig(), device=torch.device(dev))
    clip_l, clip_g = _published_clips(dev)
    t5_dims = dataclasses.replace(testing.T5_XXL_DIMS, n_layers=t5_layers)
    t5_params = testing.t5_random_params(t5_dims, qtype=Q.Q8_0, seed=50,
                                         device=dev)
    t5_enc = TextEncoder("t5", t5_params,
                         t5.T5Config.from_state_dict(t5_params),
                         UnigramTokenizer(testing.unigram_spec(
                             t5_dims.vocab)), QuantConfig(),
                         torch.device(dev))
    llama_enc = _llama_encoder(dev, testing.LLAMA31_8B_DIMS, llama_layers,
                               52)
    torch.cuda.synchronize()
    pipe = HiDreamPipeline(model, clip_l, clip_g, t5_enc, llama_enc)
    res = {"depth_double": depth_double, "depth_single": depth_single,
           "steps": steps, "shift": pipe.shift, "t5_layers": t5_layers,
           "llama_layers": llama_layers,
           "build_s": time.perf_counter() - t0}
    log(f"  random Q4_K stacked tree, CLIP-L, CLIP-G, T5-xxl ({t5_layers} "
        f"layers) and Llama-3.1-8B-shaped encoder ({llama_layers} layers, "
        f"{llama_enc.config.n_heads} heads / {llama_enc.config.n_kv_heads} kv)"
        f" built on the card in {res['build_s']:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    ids = (clip_l.tokenizer.encode_batch([PROMPTS[0]], max_length=77)[0],
           clip_g.tokenizer.encode_batch([PROMPTS[0]], max_length=77)[0],
           t5_enc.tokenizer.encode_batch([PROMPTS[0]], max_length=128)[0],
           llama_enc.tokenizer.encode_batch([PROMPTS[0]],
                                            max_length=128)[0])
    launches = {k: 0 for k in _build.LAUNCHES}
    fwds, recorded, fails, routes = {}, [], [], {}
    gen = torch.Generator(device=dev).manual_seed(32)
    dev_ids = [torch.as_tensor(i, device=dev) for i in ids]
    with torch.no_grad():
        pooled = torch.cat([clip_l.encode(dev_ids[0])["pooled"],
                            clip_g.encode(dev_ids[1])["pooled"]], dim=-1)
        t5s = t5_enc.encode(dev_ids[2])
        lls = llama_enc.encode(dev_ids[3])["last_hidden"]
    x0 = torch.randn((1, 128, 128, dims.in_ch), generator=gen,
                     device=dev).to(torch.bfloat16)
    inputs = (x0, t5s, lls, pooled, torch.full((1,), 0.7, device=dev))

    def check(tree):
        with _routes(routes.setdefault(tree, [])):
            fwds[tree] = _tree_check(model, "hidream", inputs, tree,
                                     res.setdefault(tree, {}), recorded,
                                     fails)

    def generate():
        lat = pipe.generate_from_ids(*ids, width=1024, height=1024,
                                     steps=steps, seed=0)
        if lat.shape != (128, 128, dims.in_ch):
            raise SystemExit(f"hidream: a latent of shape {lat.shape}")
        return lat, dict(pipe.last_timings)

    finals = _run_trees(
        "hidream", model, generate, check, "flash_attn_d128", n_attn, steps,
        1, res, launches,
        lambda tree: {"i8mm" if tree == "w8a8" else "qmm_nib4": 1,
                      "qmm_nib4_smallm": n_attn * steps,
                      "qmm_int8": 7 * (t5_layers + llama_layers)})
    res["forward_rel_delta_w8a8_vs_bf16"] = rel_l2(
        fwds["w8a8"].float(), fwds["bf16_fused"].float())
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    # each router call of the gates' forwards: the bf16-fused forward and
    # the w8a8 replay (each block on the bf16-fused inputs) come in the
    # same order, after the plain forward's calls
    n_moe = depth_double + depth_single
    pairs = list(zip(routes["bf16_fused"][-n_moe:], routes["w8a8"][-n_moe:]))
    flips = [int((a != b).any(dim=-1).sum()) for a, b in pairs]
    res["routing_flips_per_block"] = flips
    log(f"  requantize_i8 {res['requantize_s']:.3f}s (peak "
        f"{res['requantize_peak_gib']:.2f} GiB); w8a8 vs bf16-fused: one "
        f"forward rel L2 {res['forward_rel_delta_w8a8_vs_bf16']:.3e}, final "
        f"latent {res['latent_rel_delta_w8a8_vs_bf16']:.3e}; tokens whose "
        f"top-2 experts differ between the trees, by block (of "
        f"{pairs[0][0].shape[0] if pairs else 0}): {flips}")
    before = dict(_build.LAUNCHES)
    res["profile_w8a8_forward"] = profile_forward(
        model, inputs, res["w8a8"]["s_per_step"], "hidream w8a8")

    # capacity dispatch against dense on the w8a8 tree, block by block (the
    # dispatch's own effect; over a whole forward the stack carries its
    # bf16 rounding differences on through the int8 activation codes, as
    # any last-bit difference: PERF.md, Findings): at the default
    # capacity factor (overflows recorded), and at E/k, where an expert
    # takes every token (C = T) and none can overflow
    res["capacity"] = {}
    for factor in (hidream.MOE_CAPACITY_FACTOR,
                   dims.n_experts / dims.top_k):
        res["capacity"][factor] = _capacity_check(model, inputs, dims,
                                                  factor, fwds["w8a8"])
        _build.LAUNCHES.update(before)
    no_drop = [r for r in res["capacity"].values()
               if r["dropped_tokens"] == 0]
    if not no_drop or not all(_worst(r["block_rel_l2_vs_dense"]) <= 1e-2
                              for r in no_drop):
        fails.append("hidream: capacity dispatch moved a block by more than "
                     "1e-2 from dense with no expert overflowed")

    sig = shift_sigmas(linear_schedule(engine_steps), pipe.shift)
    reqs = [(torch.randn((128, 128, dims.in_ch), generator=gen,
                         device=dev).to(torch.bfloat16),
             {"t5": t5s[0], "llama": lls[0], "pooled": pooled[0] * scale},
             sig) for scale in (1.0, 0.5)]

    def direct(x, c, s):
        def vel(xc, sg):
            return model.forward(xc, *(c[k][None].to(torch.bfloat16)
                                       for k in ("t5", "llama", "pooled")),
                                 sg.to(torch.float32).expand(1))
        return sample_flow(vel, x[None], s)[0]

    _engine_check(lambda: hidream_engine(model, max_batch=2), reqs, direct,
                  res, launches, fails)
    free_tree(model.params)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    res["budget"] = _budget_check(dev, dims, budget_blocks, fails)
    if fails:
        raise SystemExit("hidream: " + "; ".join(fails))
    res["launches"] = launches
    for tree in (clip_l.params, clip_g.params, t5_enc.params,
                 llama_enc.params):
        free_tree(tree)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 17-18: Wan 2.1 14B and Cosmos at published width
# ---------------------------------------------------------------------------

# Wan 2.1's VAE latent statistics, per channel (the published VAE config's
# latents_mean / latents_std)
WAN21_LATENTS_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653,
                      -0.1517, 1.5508, 0.4134, -0.0715, 0.5517, -0.3632,
                      -0.1922, -0.9497, 0.2503, -0.2921)
WAN21_LATENTS_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052,
                     2.0743, 3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253,
                     2.8251, 1.9160)


# phase 17's latent: 480x832 with 9 pixel frames (published Wan 480p is 81
# frames, 21 latent frames, 32760 tokens: the frame count is the cut);
# phase 18's: one 1024² frame
WAN_LATENT = (3, 60, 104)
COSMOS_LATENT = (1, 128, 128)
DECODE_REPS = 5  # timed VAE decodes of phases 17 and 19


def vae_decode_ms(pipe, res):
    """The VAE decode of ``pipe``'s last latent (``pipe._decode`` on the
    f32 latent, as ``generate_video`` calls it) timed alone: a warm-up,
    then ``DECODE_REPS`` decodes, each between its own CUDA events, into
    ``res["vae_decode_ms"]`` (each decode's ms) and
    ``res["vae_decode_launches"]`` (one decode's); the launch counts are
    left as they were."""
    import torch

    from comfyui_gguf_tpu_torch import _build

    before = dict(_build.LAUNCHES)
    z = pipe.last_latent.to(torch.float32)
    pipe._decode(z)
    _build.reset_launch_counts()
    ms = []
    for i in range(DECODE_REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        pipe._decode(z)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        if i == 0:
            one = {k: n for k, n in _build.LAUNCHES.items() if n}
    _build.LAUNCHES.update(before)
    if one.get("flash_attn_f32") != 1:
        raise SystemExit(f"a VAE decode launched {one}: not K7 f32 once")
    res["vae_decode_ms"], res["vae_decode_launches"] = ms, one
    log(f"  VAE decode of the {' x '.join(map(str, z.shape[1:4]))} f32 "
        f"latent alone, {DECODE_REPS} decodes after a warm-up (CUDA "
        f"events): mean {statistics.mean(ms):.3f} ms, min {min(ms):.3f}, "
        f"max {max(ms):.3f}; launches a decode {one}")


def _t5_encoder(dev, dims, layers, seed):
    """A T5-family encoder at ``dims`` (``layers`` of its layers), seed-made
    on the card at Q8_0, its token embedding dense bf16 as the loader
    leaves it, with a unigram vocabulary of its size."""
    import torch

    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import t5, testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer

    dims = dataclasses.replace(dims, n_layers=layers)
    params = testing.t5_random_params(dims, qtype=Q.Q8_0, seed=seed,
                                      device=dev)
    return TextEncoder("t5", params, t5.T5Config.from_state_dict(params),
                       UnigramTokenizer(testing.unigram_spec(dims.vocab)),
                       QuantConfig(), torch.device(dev))


def video_full_phase(dev, arch, depth, steps, enc_layers, engine_steps):
    """Phase 17, Wan 2.1 14B (``WAN_14B_DIMS``, ``depth`` of 40 blocks) with
    the UMT5-xxl-shaped encoder (Q8_0, ``enc_layers`` of 24, its 256384-row
    embedding) and the Wan 2.1 VAE at its published widths
    (``WAN21_VAE_DIMS``), through ``WanPipeline.generate`` at 480×832 with
    9 pixel frames (a 3 × 60 × 104 latent, 4680 DiT tokens; 512 UMT5
    tokens), shift 5.0, CFG 5.0, ``steps`` steps, decoded to 9 frames; or
    phase 18, Cosmos (``COSMOS_7B_DIMS``, ``depth`` of 28 blocks) with a
    T5 encoder of output width 1024 (t5-v1_1-large widths, Q8_0,
    ``enc_layers`` of 24) through ``CosmosPipeline.generate`` at 1024² (one
    128 × 128 latent frame, 4096 tokens; 256 T5 tokens), shift 1.0, CFG
    4.0. Both seed-made Q4_K stacked, on the bf16-fused tree and then on
    the w8a8 tree, with phases 13-16's gates (``_run_trees``,
    ``_tree_check``: K7 D = 128 twice a block and forward, each kernel call
    against its plain version, each w8a8 block within
    ``W8A8_BLOCK_DELTA_MAX`` of the bf16-fused block); the Wan VAE decode
    must launch K7's f32 instance (D = 384). Then the arch's engine serves
    two requests for ``engine_steps`` steps, each within 1e-2 of the direct
    sampler at batch 1. The final latents' distance, s/step, the stage
    seconds, the Wan VAE decode timed alone (``vae_decode_ms``), one
    profiled w8a8 forward (the busy share) and the peak memory are
    recorded. The trees are freed at the end."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (
        CosmosPipeline, DiffusionModel, WanPipeline, _text_states,
        cosmos_engine, wan_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)

    is_wan = arch == "wan"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vae = None
    if is_wan:
        dims = dataclasses.replace(testing.WAN_14B_DIMS, n_layers=depth)
        params = testing.wan_random_stacked_params(dims, qtype=Q.Q4_K,
                                                   seed=0, device=dev)
        enc = _t5_encoder(dev, testing.UMT5_XXL_DIMS, enc_layers, 40)
        vae = testing.wan_vae_random_params(testing.WAN21_VAE_DIMS, seed=41,
                                            device=dev)
        lat_shape, txt_len, mk, cfg_scale = (WAN_LATENT, 512, wan_engine,
                                             5.0)
        log(f"  Wan 2.1 14B width (dim 5120, 40 heads of 128, ffn 13824), "
            f"{depth} of 40 blocks; 480x832, 9 frames = a 3 x 60 x 104 "
            f"latent, 4680 tokens; UMT5-xxl ({enc_layers} of 24 layers, "
            f"Q8_0, 256384-row embedding); the Wan 2.1 VAE (base 96, z 16, "
            f"mult 1/2/4/4, 127M parameters)")
    else:
        dims = dataclasses.replace(testing.COSMOS_7B_DIMS, n_layers=depth)
        params = testing.cosmos_random_stacked_params(dims, qtype=Q.Q4_K,
                                                      seed=0, device=dev)
        enc = _t5_encoder(dev, testing.T5_V11_LARGE_DIMS, enc_layers, 42)
        lat_shape, txt_len, mk, cfg_scale = (COSMOS_LATENT, 256,
                                             cosmos_engine, 4.0)
        log(f"  Cosmos 7B geometry (dim 4096, 32 heads of 128), {depth} of "
            f"28 blocks; 1024² = one 128 x 128 latent frame, 4096 tokens; "
            f"a t5-v1_1-large-shaped T5 ({enc_layers} of 24 layers, Q8_0, "
            f"1024 wide)")
    model = DiffusionModel(arch=arch, params=params, config=dims.config(),
                           qcfg=QuantConfig(), device=torch.device(dev))
    torch.cuda.synchronize()
    if is_wan:
        pipe = WanPipeline(model, enc, vae_params=vae,
                           latents_mean=np.asarray(WAN21_LATENTS_MEAN),
                           latents_std=np.asarray(WAN21_LATENTS_STD))
    else:
        pipe = CosmosPipeline(model, enc)
    res = {"depth": depth, "steps": steps, "cfg_scale": cfg_scale,
           "shift": pipe.shift, "encoder_layers": enc_layers,
           "latent": lat_shape, "build_s": time.perf_counter() - t0}
    log(f"  random Q4_K stacked tree, encoder and VAE built on the card in "
        f"{res['build_s']:.2f}s; {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB")

    launches = {k: 0 for k in _build.LAUNCHES}
    fwds, recorded, fails = {}, [], []
    gen = torch.Generator(device=dev).manual_seed(31)
    x0 = torch.randn((1, *lat_shape, dims.in_ch), generator=gen,
                     device=dev).to(torch.bfloat16)
    cond = _text_states(enc, PROMPTS[0], txt_len, zero_masked=is_wan)
    t = torch.full((1,), 0.7, device=dev)

    def check(tree):
        fwds[tree] = _tree_check(model, arch, (x0, cond, t), tree,
                                 res.setdefault(tree, {}), recorded, fails)

    videos = {}

    def generate():
        if is_wan:
            f, h, w = lat_shape
            vid = pipe.generate(PROMPTS[0], PROMPTS[1], latent_frames=f,
                                latent_height=h, latent_width=w,
                                steps=steps, cfg_scale=cfg_scale, seed=0,
                                max_t5_len=txt_len, dispatch_window=4)
            if (vid.shape != (1 + 4 * (f - 1), 8 * h, 8 * w, 3)
                    or not np.isfinite(vid).all()):
                raise SystemExit(f"wan: a video of shape {vid.shape} or "
                                 f"non-finite")
            videos[len(videos)] = vid
        else:
            pipe.generate(PROMPTS[0], latent_frames=lat_shape[0],
                          latent_height=lat_shape[1],
                          latent_width=lat_shape[2], steps=steps,
                          cfg_scale=cfg_scale, seed=0,
                          negative_prompt=PROMPTS[1], max_len=txt_len)
        return (pipe.last_latent[0].float().cpu().numpy(),
                dict(pipe.last_timings))

    def want(tree):
        need = {"i8mm" if tree == "w8a8" else "qmm_nib4": 1,
                "qmm_int8": 2 * 7 * enc_layers}
        if is_wan:
            # the VAE's mid-block attention, on the f32 latent
            need["flash_attn_f32"] = 1
        else:
            need["qmm_nib4_smallm"] = 3 * depth  # the adaLN, planar
        return need

    finals = _run_trees(arch, model, generate, check, "flash_attn_d128",
                        2 * depth, steps, 2, res, launches, want)
    res["forward_rel_delta_w8a8_vs_bf16"] = rel_l2(fwds["w8a8"].float(),
                                                   fwds["bf16_fused"].float())
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    if is_wan:
        res["video_rel_delta_w8a8_vs_bf16"] = rel_l2(
            torch.from_numpy(videos[1]), torch.from_numpy(videos[0]))
    log(f"  requantize_i8 {res['requantize_s']:.3f}s (peak "
        f"{res['requantize_peak_gib']:.2f} GiB); w8a8 vs bf16-fused: one "
        f"forward rel L2 {res['forward_rel_delta_w8a8_vs_bf16']:.3e}, final "
        f"latent {res['latent_rel_delta_w8a8_vs_bf16']:.3e}"
        + (f", decoded video {res['video_rel_delta_w8a8_vs_bf16']:.3e}"
           if is_wan else ""))
    if is_wan:
        vae_decode_ms(pipe, res)
    before = dict(_build.LAUNCHES)
    res["profile_w8a8_forward"] = profile_forward(
        model, (x0, cond, t), res["w8a8"]["s_per_step"] / 2, f"{arch} w8a8")
    _build.LAUNCHES.update(before)

    # the engine: two requests (CFG cfg_scale and 1) against the direct
    # sampler at batch 1 with the same f32 CFG mix
    sig = shift_sigmas(linear_schedule(engine_steps), pipe.shift)
    gen = torch.Generator(device=dev).manual_seed(30)
    nctx = _text_states(enc, PROMPTS[1], txt_len, zero_masked=is_wan)
    reqs = [(torch.randn((*lat_shape, dims.in_ch), generator=gen,
                         device=dev).to(torch.bfloat16),
             {"ctx": cond[0], "nctx": nctx[0],
              "cfg_scale": torch.tensor(scale, device=dev)}, sig)
            for scale in (cfg_scale, 1.0)]

    def direct(x, c, s):
        def vel(xc, sg):
            ts = sg.to(torch.float32).expand(1)
            v_c = model.forward(xc, c["ctx"][None].to(torch.bfloat16), ts)
            v_u = model.forward(xc, c["nctx"][None].to(torch.bfloat16), ts)
            return v_u.float() + float(c["cfg_scale"]) * (v_c.float()
                                                          - v_u.float())
        return sample_flow(vel, x[None], s)[0]

    _engine_check(lambda: mk(model, max_batch=2), reqs, direct, res,
                  launches, fails)
    if fails:
        raise SystemExit(f"{arch}: " + "; ".join(fails))
    res["launches"] = launches
    free_tree(model.params)
    free_tree(enc.params)
    del model, enc, pipe, vae
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 19-20: HunyuanVideo 13B and LTX-Video 2B at published width
# ---------------------------------------------------------------------------

# phase 19's latent: 480x832 with 9 pixel frames, Wan's geometry (the
# reference's HyVidPipeline default is 9 latent frames, 33 pixel frames:
# the frame count is the cut); phase 20's: the published 768x512 at 121
# frames, 16 x 16 x 24 latent voxels
HYVID_LATENT = (3, 60, 104)
LTXV_LATENT = (16, 16, 24)


def video2_full_phase(dev, arch, depth, steps, enc_layers, engine_steps):
    """Phase 19, HunyuanVideo 13B (``HYVID_13B_DIMS``: hidden 3072, 24 heads
    of 128, 2 refiner blocks, ``depth`` = (double, single) of 20 + 40
    blocks) with the Llama-3.1-8B-shaped llama encoder for the
    llava-llama-3 text tower (Q8_0, ``enc_layers`` of 32, 128256 rows
    through the big-embed guard) and the HunyuanVideo VAE at its published
    widths (``HYVID_VAE_DIMS``), through ``HyVidPipeline.generate`` at
    480×832 with 9 pixel frames (a 3 × 60 × 104 latent, 4680 image + 256
    text tokens), guidance 6.0, shift 7.0, ``steps`` steps (one forward a
    step), decoded to 9 frames with the VAE's mid-block attention on K7's
    f32 instance at D = 512; or phase 20, LTX-Video 2B (``LTXV_2B_DIMS``: dim 2048,
    32 heads of 64, ``depth`` of 28 blocks) with T5-xxl (Q8_0,
    ``enc_layers`` of 24) and the LTX-Video VAE at the published 0.9
    widths (``LTXV_VAE_DIMS``), through ``LTXVPipeline.generate`` at
    768×512 with 121 frames (16 × 16 × 24 = 6144 voxels; 256 T5 tokens),
    CFG 3.0, shift 3.0, decoded to 121 × 512 × 768. Both seed-made Q4_K
    stacked, on the bf16-fused tree and then on the w8a8 tree, with the
    gates of phases 13-18 (``_run_trees``, ``_tree_check``: K7 62 times a
    HunyuanVideo forward at D = 128, 56 times an LTX-Video forward at
    D = 64; each kernel call against its plain version; each w8a8 block
    within ``W8A8_BLOCK_DELTA_MAX`` of the bf16-fused block). Then the
    arch's engine serves two requests for ``engine_steps`` steps, each
    within 1e-2 of the direct sampler at batch 1. The final latents' and
    videos' distances, s/step, the stage seconds, the HunyuanVideo VAE
    decode timed alone (``vae_decode_ms``), one profiled w8a8 forward (the
    busy share) and the peak memory are recorded. The trees are freed at
    the end."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import (
        DiffusionModel, HyVidPipeline, LTXVPipeline, _text_states,
        hyvid_engine, ltxv_engine)
    from comfyui_gguf_tpu_torch.sampling import (linear_schedule,
                                                 sample_flow, shift_sigmas)

    is_hy = arch == "hyvid"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if is_hy:
        dims = dataclasses.replace(testing.HYVID_13B_DIMS,
                                   depth_double=depth[0],
                                   depth_single=depth[1])
        params = testing.hyvid_random_stacked_params(dims, qtype=Q.Q4_K,
                                                     seed=0, device=dev)
        enc = _llama_encoder(dev, testing.LLAMA31_8B_DIMS, enc_layers, 52)
        vae = testing.hyvid_vae_random_params(testing.HYVID_VAE_DIMS,
                                              seed=41, device=dev)
        lat_shape, txt_len, in_ch = HYVID_LATENT, 256, dims.in_ch
        n_k7, k7, fwd_per_step = (dims.refiner_depth + sum(depth),
                                  "flash_attn_d128", 1)
        log(f"  HunyuanVideo 13B width (hidden 3072, 24 heads of 128, mlp "
            f"12288, 2 refiner blocks), {depth[0]} + {depth[1]} of 20 + 40 "
            f"blocks; 480x832, 9 frames = a 3 x 60 x 104 latent, 4680 + 256 "
            f"tokens; the Llama-3.1-8B-shaped encoder ({enc_layers} of 32 "
            f"layers, Q8_0); the HunyuanVideo VAE (widths 128/256/512/512, "
            f"z 16, 246M parameters)")
    else:
        dims = dataclasses.replace(testing.LTXV_2B_DIMS, n_layers=depth)
        params = testing.ltxv_random_stacked_params(dims, qtype=Q.Q4_K,
                                                    seed=0, device=dev)
        enc = _t5_encoder(dev, testing.T5_XXL_DIMS, enc_layers, 43)
        vae = testing.ltxv_vae_random_params(testing.LTXV_VAE_DIMS, seed=44,
                                             device=dev)
        lat_shape, txt_len, in_ch = LTXV_LATENT, 256, dims.in_ch
        n_k7, k7, fwd_per_step = 2 * depth, "flash_attn_d64", 2
        log(f"  LTX-Video 2B width (dim 2048, 32 heads of 64, ffn 8192), "
            f"{depth} of 28 blocks; 768x512, 121 frames = 16 x 16 x 24 = "
            f"6144 voxels; T5-xxl ({enc_layers} of 24 layers, Q8_0, 256 "
            f"tokens); the LTX-Video 0.9 VAE (widths 128/256/512/512, 128 "
            f"latent channels, 297M parameters)")
    model = DiffusionModel(arch=arch, params=params, config=dims.config(),
                           qcfg=QuantConfig(), device=torch.device(dev))
    torch.cuda.synchronize()
    pipe = (HyVidPipeline(model, enc, vae_params=vae) if is_hy
            else LTXVPipeline(model, enc, vae_params=vae))
    guidance, cfg_scale = 6.0, 3.0
    res = {"depth": depth, "steps": steps, "shift": pipe.shift,
           "encoder_layers": enc_layers, "latent": lat_shape,
           "build_s": time.perf_counter() - t0}
    res.update({"guidance": guidance} if is_hy else {"cfg_scale": cfg_scale})
    log(f"  random Q4_K stacked tree, encoder and VAE built on the card in "
        f"{res['build_s']:.2f}s; {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB")

    f, h, w = lat_shape
    L = f * h * w
    launches = {k: 0 for k in _build.LAUNCHES}
    fwds, recorded, fails = {}, [], []
    gen = torch.Generator(device=dev).manual_seed(33)
    cond = _text_states(enc, PROMPTS[0], txt_len)
    t = torch.full((1,), 0.7, device=dev)
    if is_hy:
        x0 = torch.randn((1, *lat_shape, in_ch), generator=gen,
                         device=dev).to(torch.bfloat16)
        g = torch.full((1,), guidance * 1000.0, device=dev)
        inputs = (x0, cond, t, g)
    else:
        pos = torch.stack(torch.meshgrid(
            *(torch.arange(n, device=dev) for n in lat_shape),
            indexing="ij"), dim=-1).reshape(1, L, 3).to(torch.int32)
        x0 = torch.randn((1, L, in_ch), generator=gen,
                         device=dev).to(torch.bfloat16)
        inputs = (x0, pos, cond, t)

    def check(tree):
        fwds[tree] = _tree_check(model, arch, inputs, tree,
                                 res.setdefault(tree, {}), recorded, fails)

    videos = {}
    want_shape = ((1 + 4 * (f - 1), 8 * h, 8 * w, 3) if is_hy
                  else (1 + 8 * (f - 1), 32 * h, 32 * w, 3))

    def generate():
        if is_hy:
            vid = pipe.generate(PROMPTS[0], latent_frames=f,
                                latent_height=h, latent_width=w, steps=steps,
                                guidance=guidance, seed=0, max_len=txt_len,
                                dispatch_window=4)
        else:
            vid = pipe.generate(PROMPTS[0], latent_frames=f, latent_height=h,
                                latent_width=w, steps=steps,
                                cfg_scale=cfg_scale, seed=0,
                                negative_prompt=PROMPTS[1],
                                max_t5_len=txt_len)
        if vid.shape != want_shape or not np.isfinite(vid).all():
            raise SystemExit(f"{arch}: a video of shape {vid.shape} or "
                             f"non-finite")
        videos[len(videos)] = vid
        return (pipe.last_latent[0].float().cpu().numpy(),
                dict(pipe.last_timings))

    def want(tree):
        need = {"i8mm" if tree == "w8a8" else "qmm_nib4": 1}
        if is_hy:
            # the llama encoder's 7 linears a layer, once; the VAE's
            # mid-block attention; img_mod / txt_mod / modulation planar at
            # M = 1 (the split-K body)
            need.update(qmm_int8=7 * enc_layers, flash_attn_f32=1,
                        qmm_nib4_smallm=(2 * depth[0] + depth[1]) * steps)
        else:
            need["qmm_int8"] = 2 * 7 * enc_layers  # prompt and negative
        return need

    finals = _run_trees(arch, model, generate, check, k7, n_k7, steps,
                        fwd_per_step, res, launches, want)
    res["forward_rel_delta_w8a8_vs_bf16"] = rel_l2(fwds["w8a8"].float(),
                                                   fwds["bf16_fused"].float())
    res["latent_rel_delta_w8a8_vs_bf16"] = rel_l2(finals["w8a8"],
                                                  finals["bf16_fused"])
    res["video_rel_delta_w8a8_vs_bf16"] = rel_l2(
        torch.from_numpy(videos[1]), torch.from_numpy(videos[0]))
    del videos
    log(f"  requantize_i8 {res['requantize_s']:.3f}s (peak "
        f"{res['requantize_peak_gib']:.2f} GiB); w8a8 vs bf16-fused: one "
        f"forward rel L2 {res['forward_rel_delta_w8a8_vs_bf16']:.3e}, final "
        f"latent {res['latent_rel_delta_w8a8_vs_bf16']:.3e}, decoded video "
        f"{res['video_rel_delta_w8a8_vs_bf16']:.3e}")
    if is_hy:
        vae_decode_ms(pipe, res)
    before = dict(_build.LAUNCHES)
    res["profile_w8a8_forward"] = profile_forward(
        model, inputs, res["w8a8"]["s_per_step"] / fwd_per_step,
        f"{arch} w8a8")
    _build.LAUNCHES.update(before)

    # the engine: two requests (guidance 6 and 1, or CFG 3 and 1) against
    # the direct sampler at batch 1
    sig = shift_sigmas(linear_schedule(engine_steps), pipe.shift)
    if is_hy:
        reqs = [(torch.randn((*lat_shape, in_ch), generator=gen,
                             device=dev).to(torch.bfloat16),
                 {"txt": cond[0], "guidance": torch.tensor(gd, device=dev)},
                 sig) for gd in (guidance, 1.0)]

        def direct(x, c, s):
            def vel(xc, sg):
                return model.forward(
                    xc, c["txt"][None].to(torch.bfloat16),
                    sg.to(torch.float32).expand(1),
                    (c["guidance"] * 1000.0).reshape(1).float())
            return sample_flow(vel, x[None], s)[0]
        mk = hyvid_engine
    else:
        nctx = _text_states(enc, PROMPTS[1], txt_len)
        reqs = [(torch.randn((L, in_ch), generator=gen,
                             device=dev).to(torch.bfloat16),
                 {"ids": pos[0], "ctx": cond[0], "nctx": nctx[0],
                  "cfg_scale": torch.tensor(scale, device=dev)}, sig)
                for scale in (cfg_scale, 1.0)]

        def direct(x, c, s):
            def vel(xc, sg):
                ts = sg.to(torch.float32).expand(1)
                v_c, v_u = (model.forward(xc, c["ids"][None],
                                          c[k][None].to(torch.bfloat16), ts)
                            for k in ("ctx", "nctx"))
                return v_u.float() + float(c["cfg_scale"]) * (
                    v_c.float() - v_u.float())
            return sample_flow(vel, x[None], s)[0]
        mk = ltxv_engine

    _engine_check(lambda: mk(model, max_batch=2), reqs, direct, res,
                  launches, fails)
    if fails:
        raise SystemExit(f"{arch}: " + "; ".join(fails))
    res["launches"] = launches
    for tree in (model.params, enc.params, vae):
        free_tree(tree)
    del model, enc, pipe, vae
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 21: the offline tools as a user runs them
# ---------------------------------------------------------------------------

# the tools' checkpoint: flux-dev width, depth cut (``--tools-depth-*``)
TOOLS_GUIDANCE = 3.5
TOOLS_FTYPE = "Q4_K_M"
# most relative difference between read_trace's and profile_forward's
# device time of a kernel family over one traced forward
TRACE_FAMILY_DELTA_MAX = 1e-2
# the tuner's m values: the single stream's 4608 rows (bucket 8192), the
# image stream's 4096 and the text stream's 512
TUNE_MS = (4608, 4096, 512)
TUNE_FWD_REPS = 16  # forwards a turn, table against plan
# phase 21 on the port's numpy codecs alone, 2 + 4 flux-dev blocks (PERF.md
# §5, the same card's host): quantize M parameters a second, load seconds
NUMPY_QUANTIZE_MPS, NUMPY_LOAD_S = 37.1, 8.05
# the host codecs' tensor: flux-dev's img_mlp.2 weight (R, K)
HOST_CODEC_SHAPE = (3072, 12288)


def _cpu_model():
    """The host CPU as ``/proc/cpuinfo`` gives its first processor: the
    model name, its vendor, family and model numbers (the name alone where
    a sandbox hides it reads "unknown") and its clock."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break
                key, _, val = ln.partition(":")
                info[key.strip()] = val.strip()
    except OSError:
        return platform.machine()
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz)")


def host_codecs_step(dev, dims, shape=HOST_CODEC_SHAPE, seed=19):
    """Phase 21's first step, on the card machine's host: the library
    (``native/``) against the numpy codecs, each operation byte-equal and
    timed beside its numpy function (see the module docstring). ``dims``:
    the flux dims whose double and single block are encoded (depth is not
    read); ``dev`` makes the random weights. → result rows."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build, native
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.quant import codecs, planar

    fails, rows = [], []
    gen = torch.Generator(device=dev).manual_seed(seed)
    native.quantize(np.zeros(256, np.float32), Q.Q4_K)  # builds or loads
    host = _build.BUILD_REPORT["host"]
    log(f"  host codecs: {host['compiler']} ({host['version']}) "
        f"{host['flags']}: "
        + ("reused" if host["cached"] else f"built in {host['s']:.2f}s")
        + f" -> {host['path']}; {torch.get_num_threads()} threads "
        f"(torch.get_num_threads()) of {os.cpu_count()} CPUs, "
        f"{_cpu_model()}")

    def weight(sh):
        w = torch.randn(sh, generator=gen, device=dev) * 0.02
        return w.to(torch.bfloat16).float().cpu().numpy()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())

    # 1. Q4_K over one double and one single block at published width
    _, groups = testing.flux_shape_spec(dims)
    full = {"double_blocks": testing.FLUX_DEV_DIMS.depth_double,
            "single_blocks": testing.FLUX_DEV_DIMS.depth_single}
    for group, n_full in full.items():
        n, secs = 0, 0.0
        for suffix, sh in groups[group][1].items():
            if len(sh) != 2 or sh[1] % 256:
                continue
            w = weight(sh)
            blocks, s = timed(lambda: native.quantize(w, Q.Q4_K))
            n, secs = n + w.size, secs + s
            head = 16 * sh[1] // 256  # the blocks of the first 16 rows
            if not same(blocks[:head],
                        codecs.ENCODERS[Q.Q4_K](w[:16].reshape(-1))):
                fails.append(f"Q4_K encode of {group} {suffix} differs "
                             f"from numpy")
        rows.append(dict(op="encode", qtype="Q4_K", input=f"one {group[:-1]}",
                         params=n, lib_s=secs))
        log(f"  Q4_K encode of one {group[:-1]} (bf16-rounded weights): "
            f"{n / 1e6:.1f} M parameters in {secs:.3f} s = "
            f"{n / secs / 1e6:.1f} M/s; x{n_full} blocks of the full "
            f"model: {n * n_full / 1e9:.2f} B parameters in "
            f"{secs * n_full:.2f} s")

    # 2. one tensor per covered operation, library against numpy
    R, K = shape
    x32 = (torch.randn(shape, generator=gen, device=dev) * 0.02).cpu() \
        .numpy()
    xs = {"f32": x32, "bf16": torch.from_numpy(x32).to(torch.bfloat16)
          .float().numpy()}
    enc = {}

    def row(op, qtype, inp, lib, numpy_version, n):
        got, t_lib = timed(lib)
        want, t_np = timed(numpy_version)
        ok = (all(same(a, b) for a, b in zip(got, want))
              if isinstance(got, tuple) else same(got, want))
        rows.append(dict(op=op, qtype=qtype, input=inp, params=n,
                         lib_s=t_lib, numpy_s=t_np, equal=ok))
        log(f"  {op} {qtype} {inp} {R}x{K}: library {t_lib:.4f} s "
            f"({n / t_lib / 1e6:.1f} M/s), numpy {t_np:.4f} s "
            f"({n / t_np / 1e6:.1f} M/s), x{t_np / t_lib:.2f}; bytes "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fails.append(f"{op} {qtype} {inp}: the library's bytes differ "
                         f"from numpy's")
        return got

    for q in (Q.Q4_0, Q.Q8_0, Q.Q4_K, Q.Q5_K, Q.Q6_K):
        for inp, x in xs.items():
            got = row("encode", q.name, inp,
                      lambda: native.quantize(x, q),
                      lambda: codecs.ENCODERS[q](x.reshape(-1)), x.size)
            if inp == "bf16":
                enc[q] = got
    for q in (Q.Q4_0, Q.Q8_0, Q.Q4_K, Q.Q6_K):
        row("decode", q.name, "bf16", lambda: native.dequantize(
                enc[q], q, R * K),
            lambda: codecs.DECODERS[q](enc[q]).reshape(-1), R * K)
    for q in (Q.Q2_K, Q.Q3_K):  # encoded by numpy: the library has no encoder
        enc[q] = codecs.ENCODERS[q](xs["bf16"].reshape(-1))
    comps = {}
    for q, lib_fn, np_fn in (
            (Q.Q4_K, native.extract_q4k, codecs.components_Q4_K),
            (Q.Q5_K, native.extract_q5k, codecs.components_Q5_K),
            (Q.Q6_K, native.extract_q6k, codecs.components_Q6_K),
            (Q.Q3_K, native.extract_q3k, codecs.components_Q3_K),
            (Q.Q2_K, native.extract_q2k, codecs.components_Q2_K)):
        def numpy_version(np_fn=np_fn, q=q):
            c = np_fn(enc[q])
            return (c.q, c.scales) + (() if c.offsets is None
                                      else (c.offsets,))
        comps[q] = row("extract", q.name, "bf16",
                       lambda: lib_fn(enc[q]), numpy_version, R * K)
    rp = planar.padded_out_dim(R)
    codes4 = comps[Q.Q4_K][0].reshape(R, K)
    row("pack nib4", "Q4_K", "codes",
        lambda: native.pack_nib4_planar(codes4, rp),
        lambda: np.ascontiguousarray(planar.nib4_plane(codes4, rp)), R * K)
    codes6 = comps[Q.Q6_K][0].reshape(R, K)
    row("transpose int8", "Q6_K", "codes",
        lambda: native.transpose_i8(codes6, rp),
        lambda: np.ascontiguousarray(planar.int8_plane(codes6, rp)), R * K)
    if fails:
        raise SystemExit("phase 21 host codecs: " + "; ".join(fails))
    return rows


def _write_flux_checkpoint(path, dims, seed, dev):
    """A flux checkpoint with the published BFL key names (``flux_shape_
    spec``'s) in bf16, made on ``dev`` from a seed (standard deviation 0.02,
    norm scales centred at 1), written by the port's safetensors writer.
    → parameters."""
    import torch

    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.models import testing

    nonblock, groups = testing.flux_shape_spec(dims)
    shapes = dict(nonblock)
    for group, (depth, suffixes) in groups.items():
        for i in range(depth):
            shapes.update({f"{group}.{i}.{s}": sh
                           for s, sh in suffixes.items()})
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        sd[k] = (w + 1 if k.endswith(".scale") else w).to(
            torch.bfloat16).cpu()
    _safetensors.save_file(sd, path)
    return sum(v.numel() for v in sd.values())


def _flux_rows(key, img, txt):
    """Rows of x that flux's linear ``key`` takes for one 1024² request."""
    if ".lin." in key:  # img_mod / txt_mod / the single blocks' modulation
        return 1
    if key.startswith("double_blocks."):
        return txt if ".txt_" in key else img
    if key.startswith("single_blocks."):
        return img + txt
    return None


def _flux_expected_launches(params, depth, img, txt):
    """Kernel launches one forward of a flat flux tree implies: each packed
    leaf once, at its rows, on the body ``qmm_route`` picks (K1 nib4 / K2
    int8) or on K4; K7 once a block. → ({read_trace family: launches},
    {launch counter: launches})."""
    from comfyui_gguf_tpu_torch.ops.qmatmul import qmm_route
    from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
    from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

    fams = {"K7 flash_attn": depth}
    counts = {"flash_attn": depth, "flash_attn_d128": depth}

    def add(fam, counter):
        fams[fam] = fams.get(fam, 0) + 1
        counts[counter] = counts.get(counter, 0) + 1

    for k, leaf in params.items():
        m = _flux_rows(k, img, txt)
        if isinstance(leaf, I8Planar):
            add("K4 i8mm", "i8mm")
        elif isinstance(leaf, PlanarQuant):
            nib4 = leaf.layout == "nib4"
            small = qmm_route(m, leaf.padded_in, leaf.out_features,
                              nib4) == "smallm"
            add(f"{'K1' if nib4 else 'K2'} qmm "
                f"({'split-K' if small else 'wgmma'})",
                f"qmm_{leaf.layout}{'_smallm' if small else ''}")
    return fams, counts


def _trace_forward(model, inputs, tree, tmp, fails):
    """One forward under ``observability.trace``: read_trace's summary of
    its trace.json by family (K1/K2 by layout) and per annotated region,
    held against profile_forward's sums over the same profiler run. → (the
    families' rows, the launch counters of that forward)."""
    import torch

    from comfyui_gguf_tpu_torch import _build, observability
    from comfyui_gguf_tpu_torch.tools import read_trace

    d = os.path.join(tmp, f"trace_{tree}")
    before = dict(_build.LAUNCHES)
    with torch.no_grad(), observability.trace(d) as prof:
        with observability.span(f"chip_smoke.flux_forward.{tree}"):
            model.forward(*inputs)
        torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in _build.LAUNCHES.items()
              if n != before[k]}
    path = os.path.join(d, "trace.json")
    rows = read_trace.summarize(path, top_n=100, layouts=True)
    log(f"  read_trace of the {tree} forward ({path}):")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        read_trace.main([path, "12"])
    for ln in buf.getvalue().splitlines():
        log(f"    {ln}")
    mods = read_trace.module_ms(path)
    log(f"    annotated regions on the card: "
        + (", ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in mods.items())
           or "none in the trace"))
    by_fam, _ = family_ms(prof)
    merged = {}
    for r in read_trace.summarize(path, top_n=100):
        fam = r["op"]
        if fam in read_trace.NON_KERNEL_FAMILIES:
            fam = "other (elementwise, norms, rope, quantize, copies)"
        merged[fam] = merged.get(fam, 0.0) + r["ms"]
    for fam in sorted(set(by_fam) | set(merged)):
        a, b = merged.get(fam, 0.0), by_fam.get(fam, 0.0)
        rel = abs(a - b) / max(a, b, 1e-9)
        log(f"    {fam}: read_trace {a:.3f} ms, profile_forward {b:.3f} ms "
            f"(rel diff {rel:.2e})")
        if not rel <= TRACE_FAMILY_DELTA_MAX:
            fails.append(f"{tree}: read_trace's {fam} {a} ms differs from "
                         f"profile_forward's {b} ms by {rel:.2e}")
    return {r["op"]: r for r in rows}, counts


def tools_phase(dev, dims, steps, tmp):
    """Phase 21: safetensors → BF16 GGUF → Q4_K_M GGUF → validate → load →
    forwards and denoises on the hand-written kernels, then the tile
    autotuner, as a user runs the port's tools (see the module docstring).
    ``dims``: the flux dims of the checkpoint; ``tmp``: a directory for
    the files. On the CPU (the rehearsal at small dims) the forwards run
    the plain versions, the launch checks are skipped and the tuner must
    raise."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build, registry
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.gguf.reader import GGUFReader
    from comfyui_gguf_tpu_torch.models import testing
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
    from comfyui_gguf_tpu_torch.quant import codecs, planar
    from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
    from comfyui_gguf_tpu_torch.sampling import euler_sample, flux_schedule
    from comfyui_gguf_tpu_torch.tools import (convert, quantize,
                                              read_tensors,
                                              validate_checkpoint)

    cuda = torch.device(dev).type == "cuda"
    fails = []
    res = {}
    h_lat = 128 if cuda else 16
    txt_len = 512 if cuda else 16
    img_tok, depth = (h_lat // 2) ** 2, dims.depth_double + dims.depth_single

    # 1. the checkpoint under a ComfyUI-style root
    root = os.path.join(tmp, "models")
    os.makedirs(os.path.join(root, "diffusion_models"))
    src = os.path.join(root, "diffusion_models", "flux-tools.safetensors")
    t = time.perf_counter()
    n_params = _write_flux_checkpoint(src, dims, 21, dev)
    res["checkpoint"] = dict(params=n_params, bytes=os.path.getsize(src),
                             write_s=time.perf_counter() - t)
    log(f"  checkpoint: {n_params / 1e9:.3f} B parameters, "
        f"{res['checkpoint']['bytes'] / 1e9:.3f} GB bf16 safetensors, made "
        f"and written in {res['checkpoint']['write_s']:.2f}s")

    # 2. the registry resolves it
    reg = registry.ModelRegistry([root])
    if reg.get_full_path("unet", "flux-tools.safetensors") != src:
        fails.append("the registry did not resolve the checkpoint")

    # 3. convert to a BF16 GGUF
    t = time.perf_counter()
    bf16 = convert.convert_file(src, None, use_bf16_base=True)
    s = time.perf_counter() - t
    res["convert"] = dict(s=s, gb_per_s=res["checkpoint"]["bytes"] / s / 1e9,
                          bytes=os.path.getsize(bf16))
    log(f"  convert -> {os.path.basename(bf16)}: {s:.2f}s "
        f"({res['convert']['gb_per_s']:.3f} GB/s of source), "
        f"{res['convert']['bytes'] / 1e9:.3f} GB")

    # 4. quantize to Q4_K_M; its census must be the recipe's
    t = time.perf_counter()
    q4 = quantize.quantize_file(bf16, None, TOOLS_FTYPE)
    s = time.perf_counter() - t
    reader = GGUFReader(q4)
    n_quant = sum(t_.n_elements for t_ in reader.tensors
                  if t_.qtype not in (Q.F32, Q.F16, Q.BF16))
    res["quantize"] = dict(s=s, mparams_per_s=n_quant / s / 1e6,
                           quantized_params=n_quant,
                           bytes=os.path.getsize(q4))
    log(f"  quantize {TOOLS_FTYPE} -> {os.path.basename(q4)}: {s:.2f}s, "
        f"{n_quant / 1e6:.1f} M parameters quantized at "
        f"{res['quantize']['mparams_per_s']:.1f} M/s on the host "
        f"({dims.depth_double} + {dims.depth_single} blocks, the codec "
        f"library on {torch.get_num_threads()} threads; numpy alone: "
        f"{NUMPY_QUANTIZE_MPS} M/s at 2 + 4 blocks), "
        f"{res['quantize']['bytes'] / 1e9:.3f} GB")
    want = {}
    qs = quantize.QuantState()
    ftype = quantize._FTYPE_BY_NAME[TOOLS_FTYPE]
    for t_ in GGUFReader(bf16).tensors:
        qt = (quantize.tensor_qtype(t_.name, t_.shape, ftype, qs)
              if quantize.should_quantize(t_.name, t_.shape, "flux")
              else t_.qtype)
        want[Q(qt).name] = want.get(Q(qt).name, 0) + 1
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        read_tensors.main([q4])
    census_line = buf.getvalue().splitlines()[-1]
    census = {part.split(" (")[0]: int(part.split(" (")[1].rstrip(")"))
              for part in census_line[len("census: "):].split(", ")}
    res["census"] = census
    log(f"  read_tensors {census_line}; the recipe over the names: {want}")
    if census != want:
        fails.append(f"census {census} != the recipe's {want}")
    by_name = {t_.name: t_ for t_ in reader.tensors}
    if not {"Q4_K", "Q5_K"} <= set(census):
        fails.append(f"no Q4_K and Q5_K in the census {census}")
    for k, t_ in by_name.items():
        if k.startswith(("img_in", "txt_in", "time_in", "vector_in",
                         "guidance_in", "final_layer")) and Q(t_.qtype) \
                not in (Q.F32, Q.BF16):
            fails.append(f"{k} is {Q(t_.qtype).name}, not float")
        if k.endswith("_attn.qkv.weight") and Q(t_.qtype) != Q.Q5_K:
            fails.append(f"{k} is {Q(t_.qtype).name}, not Q5_K")
    names = reg.list_names("unet", gguf_only=True)
    log(f"  registry: unet GGUFs {names}")
    if sorted(names) != sorted(os.path.basename(p) for p in (bf16, q4)):
        fails.append(f"the registry lists {names}")

    # 5. validate
    rep = validate_checkpoint.validate(q4)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = validate_checkpoint.main([q4])
    res["validate"] = dict(rc=rc, **{k: len(v) for k, v in rep.to_json()
                                     .items() if isinstance(v, list)})
    log(f"  validate_checkpoint: exit {rc}, spec {rep.spec}, {res['validate']}")
    if rc != 0 or not rep.ok or rep.unexpected or rep.spec != "full":
        fails.append(f"validate_checkpoint: exit {rc}, {rep.to_json()}")

    # 6. load onto the device; one leaf of each qtype equals the codec
    _build.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = load_diffusion_model(q4, dev)
    if cuda:
        torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t
    checked = {}
    for k, leaf in model.params.items():
        t_ = by_name[k]
        qn = Q(t_.qtype).name
        if qn in checked:
            continue
        want_w = codecs.dequantize(t_.data, t_.qtype, t_.shape)
        got_w = (planar.dequantize(leaf) if isinstance(leaf, PlanarQuant)
                 else leaf.float())
        checked[qn] = (k, bool(np.array_equal(got_w.cpu().numpy(),
                                              want_w)))
    log(f"  load_diffusion_model(..., {dev!r}): {res['load_s']:.2f}s "
        f"({dims.depth_double} + {dims.depth_single} blocks; numpy alone: "
        f"{NUMPY_LOAD_S} s at 2 + 4 blocks); "
        f"dequantized on the device vs codecs.dequantize of the payload: "
        + ", ".join(f"{q} ({k}) {'equal' if ok else 'DIFFERENT'}"
                    for q, (k, ok) in checked.items()))
    for q, (k, ok) in checked.items():
        if not ok:
            fails.append(f"{q} leaf {k} differs from the file's payload")

    # 7-8. forwards, traces and denoises on each tree; 9. the tuner
    inputs = testing.flux_example_inputs(dims, batch=1, h_lat=h_lat,
                                         w_lat=h_lat, txt_len=txt_len,
                                         seed=2, device=dev)
    inputs = (*inputs[:6], torch.full_like(inputs[6], TOOLS_GUIDANCE))
    sigmas = flux_schedule(steps, img_tok)

    def denoise():
        img, ids, txt, tids, _, y, g = inputs

        def vel(x, s):
            return model.forward(x, ids, txt, tids, s.expand(x.shape[0]), y,
                                 g)
        with torch.no_grad():
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = euler_sample(vel, img, sigmas)
            if cuda:
                torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    recorded = []
    for tree in ("bf16_fused", "w8a8"):
        if tree == "w8a8":
            t = time.perf_counter()
            model.requantize_i8()
            if cuda:
                torch.cuda.synchronize()
            res["requantize_s"] = time.perf_counter() - t
        errs = _block_check(model, "flux", inputs, recorded,
                            replay=tree == "w8a8")
        _call_gate(errs["calls"], f"{tree} forward", fails)
        if tree == "w8a8":
            worst = _worst(errs["vs_bf16"])
            log(f"  w8a8 blocks vs the bf16-fused blocks on the same "
                f"inputs: worst rel L2 {worst:.3e} ({len(errs['vs_bf16'])} "
                f"blocks)")
            if not worst <= W8A8_BLOCK_DELTA_MAX:
                fails.append(f"a w8a8 block differs from its bf16-fused "
                             f"block by rel L2 {worst}")
        fams, counts = _flux_expected_launches(model.params, depth, img_tok,
                                               txt_len)
        if cuda:
            rows, got = _trace_forward(model, inputs, tree, tmp, fails)
            seen = {f: r["count"] for f, r in rows.items()
                    if f.startswith("K")}
            log(f"  {tree} forward: launches by family in the trace {seen}, "
                f"by the counters {got}; the census and depth imply {fams}")
            if seen != fams:
                fails.append(f"{tree}: trace families {seen} != {fams}")
            if {k: v for k, v in got.items() if v} != counts:
                fails.append(f"{tree}: launch counters {got} != {counts}")
        out, secs = denoise()
        if out.shape != inputs[0].shape or not bool(torch.isfinite(out)
                                                    .all()):
            fails.append(f"{tree}: non-finite or misshapen latent")
        res[tree] = dict(ms_per_step=secs / steps * 1e3,
                         peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else None))
        log(f"  {tree}: {steps}-step Euler denoise {secs:.3f}s -> "
            f"{res[tree]['ms_per_step']:.1f} ms/step; peak memory "
            + (f"{res[tree]['peak_gib']:.2f} GiB" if cuda else "n/a"))
        if tree == "bf16_fused":
            res["autotune"] = _autotune_step(model, inputs, tmp, cuda, fails)
    res["launches"] = dict(_build.LAUNCHES)
    res["files"] = dict(bf16=bf16, q4=q4)  # phase 23 serves from them
    del model
    if fails:
        raise SystemExit("phase 21: " + "; ".join(fails))
    return res


def _autotune_step(model, inputs, tmp, cuda, fails):
    """Step 9: the tuner over the bf16-fused tree's distinct planar shapes
    at each of ``TUNE_MS``; every candidate checked against the plain
    version; the table saved, cleared and loaded; the forward's gates and
    its time with the table beside the plan's. The tuner's launches are
    measurements, not the path's: the counters are restored after."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.ops import autotune, qmatmul
    from comfyui_gguf_tpu_torch.ops.qmatmul import (plain_quantized_matmul,
                                                    qmm_cuda,
                                                    wgmma_split_plan)
    from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

    qmatmul.SHAPE_TILES.clear()
    if not cuda:
        try:
            autotune.tune_for_params(model.params, TUNE_MS[0])
        except RuntimeError as e:
            log(f"  autotune without a card raises: {e}")
            return {}
        fails.append("autotune ran without a card")
        return {}
    before = dict(_build.LAUNCHES)
    leaves = {}
    for leaf in model.params.values():
        if isinstance(leaf, PlanarQuant):
            for m in TUNE_MS:
                leaves.setdefault(qmatmul.shape_key(
                    m, leaf.padded_in, leaf.padded_out, leaf.layout),
                    (m, leaf))
    out = {"shapes": {}}
    t = time.perf_counter()
    for m in TUNE_MS:
        times = {}
        winners = autotune.tune_for_params(model.params, m, times=times)
        for key, best in winners.items():
            m_, leaf = leaves[key]
            pick = wgmma_split_plan(m_, leaf.padded_in, leaf.out_features)
            gen = torch.Generator(device=leaf.qs.device).manual_seed(7)
            x = torch.randn((m_, leaf.in_features), generator=gen,
                            device=leaf.qs.device).to(torch.bfloat16)
            want = plain_quantized_matmul(x, leaf)
            legal = {t for t in autotune.CANDIDATES
                     if autotune._legal(leaf, m_, t)}
            if set(times[key]) != legal:
                fails.append(f"autotune {key}: timed {sorted(times[key])}, "
                             f"legal {sorted(legal)} (a candidate failed "
                             f"to launch)")
            checks = {}
            for tiles in times[key]:
                a = qmm_cuda(x, leaf, tiles=tiles)
                b = qmm_cuda(x, leaf, tiles=tiles)
                err = rel_l2(a, want)
                checks[tiles] = err
                if not (torch.equal(a, b) and err <= 2e-3):
                    fails.append(f"autotune {key} {tiles}: rel L2 {err}, "
                                 f"two launches equal {torch.equal(a, b)}")
            label = (f"m={m_} Kp={key[1]} Rp={key[2]} {key[3]} "
                     f"(R={leaf.out_features})")
            out["shapes"][json.dumps(list(key))] = dict(
                m=m_, r=leaf.out_features, times={
                    f"{nt},{s}": ms for (nt, s), ms in times[key].items()},
                pick=list(pick), winner=None if best is None else list(best),
                worst_rel_l2=max(checks.values()) if checks else None)
            log(f"  autotune {label}: "
                + (", ".join(f"({nt},{s}) {ms:.4f} ms"
                             for (nt, s), ms in times[key].items())
                   or "no wgmma candidate (the split-K body takes m)")
                + (f"; heuristic {pick}, winner {best}" if best else ""))
    out["tune_s"] = time.perf_counter() - t
    table = dict(qmatmul.SHAPE_TILES)
    path = os.path.join(tmp, "tiles.json")
    autotune.save(path)
    qmatmul.SHAPE_TILES.clear()
    n = autotune.load(path)
    if qmatmul.SHAPE_TILES != table or n != len(table):
        fails.append("the tile table did not load back equal")
    log(f"  autotune: {len(table)} entries tuned in {out['tune_s']:.1f}s, "
        f"saved, cleared and loaded back equal: "
        f"{qmatmul.SHAPE_TILES == table}")
    _build.LAUNCHES.update(before)
    # the forward with the table, under the kernel-call gates
    errs = _call_errs()
    with torch.no_grad(), _kernel_calls(errs):
        model.forward(*inputs)
    _call_gate(errs, "bf16-fused forward with the tuned table", fails)
    # the forward's device time with and without the table, in turns of
    # TUNE_FWD_REPS forwards each, every forward timed by its own events
    before = dict(_build.LAUNCHES)
    turns = []
    for tuned in (False, True, True, False):
        qmatmul.SHAPE_TILES.clear()
        if tuned:
            qmatmul.SHAPE_TILES.update(table)
        turns.append(_forward_times(model, inputs, TUNE_FWD_REPS))
    _build.LAUNCHES.update(before)
    qmatmul.SHAPE_TILES.clear()
    names = ("heuristic", "tuned", "tuned2", "heuristic2")
    out["forward_ms_turns"] = {
        n: dict(mean=statistics.fmean(t), stdev=statistics.stdev(t),
                n=len(t)) for n, t in zip(names, turns)}
    plan = turns[0] + turns[3]
    tuned = turns[1] + turns[2]
    diff = statistics.fmean(tuned) - statistics.fmean(plan)
    # two standard errors of the difference of the two means
    resolution = 2 * math.sqrt(statistics.variance(plan) / len(plan)
                               + statistics.variance(tuned) / len(tuned))
    out["forward_ms_tuned_minus_plan"] = dict(diff=diff,
                                              two_stderr=resolution)
    log("  bf16-fused forward, mean ± stdev of "
        f"{TUNE_FWD_REPS} forwards a turn (heuristic, tuned, tuned, "
        "heuristic): " + ", ".join(
            f"{statistics.fmean(t):.3f} ± {statistics.stdev(t):.3f}"
            for t in turns)
        + f" ms; tuned - plan {diff:+.4f} ms (two standard errors "
        f"{resolution:.4f} ms: "
        + ("resolved" if abs(diff) > resolution else "not resolved") + ")")
    return out


def _forward_times(model, inputs, n):
    """Device ms of each of ``n`` forwards after one warm-up, each between
    its own pair of CUDA events."""
    import torch

    with torch.no_grad():
        model.forward(*inputs)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for t0, t1 in events:
            t0.record()
            model.forward(*inputs)
            t1.record()
        torch.cuda.synchronize()
    return [t0.elapsed_time(t1) for t0, t1 in events]


# ---------------------------------------------------------------------------
# phase 23: the six entry scripts of examples/, as a user runs them
# ---------------------------------------------------------------------------

def _write_script_file(kind, path, dims):
    """One of phase 23's files (``kind``) at ``path`` from ``dims``, by the
    port's writers (run in a process of its own: the files are written in
    parallel)."""
    from comfyui_gguf_tpu_torch import _safetensors
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing

    if kind == "t5":
        testing.write_t5_gguf(testing.t5_state_dict(dims, seed=31), path,
                              qtype=Q.Q8_0,
                              tokenizer=testing.unigram_spec(dims.vocab))
    elif kind in ("clip_l", "clip_g"):
        _safetensors.save_file(testing.clip_state_dict(
            dims, seed=32 if kind == "clip_l" else 33), path)
        testing.write_clip_vocab(os.path.dirname(path),
                                 *testing.clip_vocab(dims.vocab))
    elif kind == "vae":
        _safetensors.save_file(testing.vae_state_dict(dims, seed=34), path)
    elif kind == "sd3":
        testing.write_gguf(
            testing.sd3_flat_state_dict(dims, seed=35), path,
            lambda k, v: testing.sd3_block_qtype(k, v, Q.Q4_K), "sd3")
    else:  # qwen_image, hidream
        spec = getattr(testing, f"{kind}_shape_spec")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=36), path,
            kind, Q.Q4_K)
    return kind


def _write_script_files(tmp):
    """The files phase 23's scripts read beside phase 21's flux-dev GGUFs,
    at published widths with the depth cut, written by the port's writers
    in parallel processes: a T5-xxl-width Q8_0 GGUF (2 layers, a 512-token
    unigram vocabulary), CLIP-L and CLIP-G safetensors (2 layers each) with
    a vocabulary beside them, the 16-channel flux VAE, an sd3.5-large-width
    GGUF (2 blocks), Qwen-Image (1 block) and HiDream-I1 (1 + 1 blocks)
    GGUFs, all block weights Q4_K, and a file of two prompts. → {name:
    path}"""
    import concurrent.futures
    import multiprocessing

    from comfyui_gguf_tpu_torch.models import testing

    clip_dir = os.path.join(tmp, "clip")
    os.makedirs(clip_dir, exist_ok=True)
    jobs = {
        "t5": ("t5xxl-2l-Q8_0.gguf", dataclasses.replace(
            testing.T5_XXL_DIMS, n_layers=2, vocab=512)),
        "clip_l": (os.path.join("clip", "clip_l.safetensors"),
                   dataclasses.replace(testing.CLIP_L_DIMS, n_layers=2,
                                       vocab=600)),
        "clip_g": (os.path.join("clip", "clip_g.safetensors"),
                   dataclasses.replace(testing.CLIP_G_DIMS, n_layers=2,
                                       vocab=600)),
        "vae": ("ae.safetensors", testing.FLUX_VAE_DIMS),
        "sd3": ("sd3.5-large-2b-Q4_K.gguf", dataclasses.replace(
            testing.SD35_LARGE_DIMS, depth=2)),
        "qwen_image": ("qwen_image-cut-Q4_K.gguf", dataclasses.replace(
            testing.QWEN_IMAGE_20B_DIMS, n_layers=1)),
        "hidream": ("hidream-cut-Q4_K.gguf", dataclasses.replace(
            testing.HIDREAM_I1_DIMS, depth_double=1, depth_single=1)),
    }
    f = {k: os.path.join(tmp, name) for k, (name, _) in jobs.items()}
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for fut in [pool.submit(_write_script_file, k, f[k], d)
                    for k, (_, d) in jobs.items()]:
            fut.result()
    f["prompts"] = os.path.join(tmp, "prompts.txt")
    with open(f["prompts"], "w") as fh:
        fh.write("\n".join(PROMPTS) + "\n")
    log(f"  files written in {time.perf_counter() - t0:.1f}s "
        f"({min(len(jobs), os.cpu_count() or 1)} processes): "
        + ", ".join(f"{os.path.basename(p)} "
                    f"{os.path.getsize(p) / 1e9:.3f} GB"
                    for k, p in f.items() if k != "prompts"))
    return f


def _run_script(name, argv, cwd, subprocess_=False, timeout=600):
    """examples/torch_{name}.py with ``argv`` in directory ``cwd``: in this
    process (``runpy``, ``sys.argv`` set; its launches count here; PIL
    hidden, as on the card's machine, so an image goes to ``.npy``) or as
    a subprocess, as a user starts it. → (exit code, wall seconds,
    stdout)."""
    import runpy

    path = os.path.join(HERE, "examples", f"torch_{name}.py")
    os.makedirs(cwd, exist_ok=True)
    t0 = time.perf_counter()
    if subprocess_:
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.run([sys.executable, path, *argv], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=timeout)
        if p.returncode:
            log(f"    {name} stderr: {p.stderr[-2000:]}")
        return p.returncode, time.perf_counter() - t0, p.stdout
    old_argv, old_cwd = sys.argv, os.getcwd()
    old_pil = sys.modules.get("PIL", False)
    buf = io.StringIO()
    sys.argv = [path, *argv]
    sys.modules["PIL"] = None
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
        code = 0
    except SystemExit as e:
        code = 0 if e.code is None else e.code
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)
        if old_pil is False:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = old_pil
    return code, time.perf_counter() - t0, buf.getvalue()


def scripts_phase(dev, tmp, files21, steps, size=1024):
    """Phase 23: ``examples/torch_*.py`` as a user runs them on the card,
    at published widths with the depth cut, 1024², ``steps`` steps:
    ``generate_flux`` (phase 21's Q4_K_M flux-dev, T5-xxl width, CLIP-L,
    the flux VAE; PIL is absent, so it writes ``out.png.npy``),
    ``serve_flux --i8 --preview-every 2 --max-batch 2`` over two prompts,
    ``serve_multi`` (the Q4_K_M file and its BF16 GGUF as the two models),
    ``serve_sd3`` (an sd3.5-large-width file, CLIP-L, CLIP-G, T5) in this
    process, their launches counted; ``serve_qwen_tp`` and
    ``serve_hidream_tp --i8`` at tp = 2 with ``--smoke`` as subprocesses
    (two ranks on the card over gloo). Gates: exit code 0, the files
    written and finite; generate's image bit-equal to an in-process
    ``FluxPipeline.generate`` of the same seed; K1/K2/K4/K7 launched.
    → {script: {wall_s, code}, "launches": ...}"""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline

    f = _write_script_files(tmp)
    out_root = os.path.join(tmp, "scripts")
    res, fails = {}, []
    size, seed = str(size), 7
    runs = [
        ("generate_flux", ["--unet", files21["q4"], "--t5", f["t5"],
                           "--clip-l", f["clip_l"], "--vae", f["vae"],
                           "--prompt", PROMPTS[0], "--width", size,
                           "--height", size, "--steps", str(steps),
                           "--seed", str(seed), "--out", "img.png"],
         ["img.png.npy"], False),
        ("serve_flux", ["--unet", files21["q4"], "--t5", f["t5"],
                        "--clip-l", f["clip_l"], "--prompts", f["prompts"],
                        "--width", size, "--height", size, "--steps",
                        str(steps), "--max-batch", "2", "--i8", "--vae",
                        f["vae"], "--preview-every", "2"],
         ["out_000.latent.npy", "out_001.latent.npy"], False),
        ("serve_multi", ["--model-a", files21["q4"], "--model-b",
                         files21["bf16"], "--t5", f["t5"], "--clip-l",
                         f["clip_l"], "--size", size, "--steps",
                         str(steps)], [], False),
        ("serve_sd3", ["--unet", f["sd3"], "--clip-l", f["clip_l"],
                       "--clip-g", f["clip_g"], "--t5", f["t5"],
                       "--prompts", f["prompts"], "--width", size,
                       "--height", size, "--steps", str(steps),
                       "--max-batch", "2"],
         ["out_000.latent.npy", "out_001.latent.npy"], False),
        ("serve_qwen_tp", ["--unet", f["qwen_image"], "--tp", "2",
                           "--smoke", "--size", size, "--steps",
                           str(steps)], ["qwen_latent.npy"], True),
        ("serve_hidream_tp", ["--unet", f["hidream"], "--tp", "2", "--i8",
                              "--smoke", "--size", size, "--steps",
                              str(steps)], ["hidream_latent.npy"], True),
    ]
    _build.reset_launch_counts()
    for name, argv, outs, sub in runs:
        cwd = os.path.join(out_root, name)
        gc.collect()
        torch.cuda.empty_cache()
        if dev == "cpu":  # a rehearsal: the scripts' plain versions
            argv = argv + ["--device", "cpu"]
        code, wall, stdout = _run_script(name, argv, cwd, sub)
        torch.cuda.synchronize()
        res[name] = dict(code=code, wall_s=wall)
        lines = [ln for ln in stdout.splitlines() if ln.strip()]
        log(f"  {name}: exit {code}, {wall:.1f}s"
            + (f"; last line: {lines[-1][:160]}" if lines else ""))
        if code != 0:
            fails.append(f"{name} exited {code}")
            continue
        for n in outs:
            p = os.path.join(cwd, n)
            if not os.path.exists(p):
                fails.append(f"{name} wrote no {n}")
                continue
            try:
                a = np.load(p)
            except ValueError:  # no array: a failed request's None
                fails.append(f"{name}: {n} holds no array")
                continue
            if not np.isfinite(a).all():
                fails.append(f"{name}: {n} is not finite")
        if name == "serve_multi" and sum(ln.startswith("model ")
                                         for ln in lines) != 2:
            fails.append("serve_multi did not report both models")
        if name == "serve_flux":
            n_prev = len([n for n in os.listdir(cwd)
                          if n.startswith("preview_")])
            res[name]["previews"] = n_prev
            if n_prev < 2:  # two requests, a preview every two steps
                fails.append(f"serve_flux wrote {n_prev} previews")
    launches = dict(_build.LAUNCHES)
    # generate's image against the same call in this process
    if res["generate_flux"]["code"] == 0:
        pipe = FluxPipeline.load(files21["q4"], f["t5"], f["clip_l"],
                                 vae_path=f["vae"], device=dev)
        img = pipe.generate(PROMPTS[0], width=int(size), height=int(size),
                            steps=steps, seed=seed)
        got = np.load(os.path.join(out_root, "generate_flux",
                                   "img.png.npy"))
        res["generate_flux"]["bit_equal"] = eq = bool(
            np.array_equal(got, img))
        log(f"  generate_flux: the image equals FluxPipeline.generate of "
            f"the same seed in this process bit for bit: {eq}")
        if not eq:
            fails.append("generate_flux's image differs from "
                          "FluxPipeline.generate's")
        del pipe
    need = ("qmm_nib4", "qmm_int8", "i8mm", "flash_attn")
    idle = [k for k in need if launches[k] == 0]
    if idle:
        fails.append(f"the in-process scripts launched no {idle}")
    res["launches"] = launches
    res["wall_s"] = sum(r["wall_s"] for r in res.values()
                        if isinstance(r, dict) and "wall_s" in r)
    log(f"  phase 23 scripts: {res['wall_s']:.1f}s of script wall; "
        f"launches of the in-process scripts "
        f"{ {k: n for k, n in launches.items() if n} }")
    if fails:
        raise SystemExit("phase 23: " + "; ".join(fails))
    return res


# ---------------------------------------------------------------------------
# phase 22: parallelism on two ranks that share the card
# ---------------------------------------------------------------------------

P22_TP_DELTA_MAX = 3e-2  # a bf16-fused TP forward vs the unsharded forward
P22_DELTA_MAX = 1e-2  # engines vs direct, PP vs sequential, EP, SP
P22_BLOCK_DELTA_MAX = 1e-1  # a w8a8 TP block vs the unsharded w8a8 block
P22_CPU_DELTA_MAX = 3e-2  # a tiny TP forward on the card vs on the CPU


def _p22_sync(reset=False, peak=False):
    """Wait for the card (a no-op in a CPU rehearsal); ``reset`` / ``peak``:
    its peak-memory counter (GiB)."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    elif peak:
        return torch.cuda.max_memory_allocated() / 2**30
    else:
        torch.cuda.synchronize()
    return 0.0


def _p22_log(rank, msg):
    log(f"  [rank {rank}] {msg}")


def _p22_digest(t):
    import hashlib

    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()
                        ).hexdigest()


def _p22_timed(fn, n=1):
    """``fn`` run ``n`` times on this rank: (its last output, {ms a call,
    ms in collectives a call, bytes staged through the host a call,
    collective calls a call, kernel launches a call})."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.parallel import collectives

    _p22_sync()
    s0, l0 = dict(collectives.STATS), dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n):
            out = fn()
    _p22_sync()
    dt = time.perf_counter() - t0
    st = {k: (collectives.STATS[k] - s0[k]) / n for k in s0}
    return out, dict(ms=dt * 1e3 / n, coll_ms=st["seconds"] * 1e3,
                     staged=st["staged_bytes"], calls=st["calls"],
                     launches={k: (v - l0[k]) / n
                               for k, v in _build.LAUNCHES.items()
                               if v != l0[k]})


def _p22_fmt(t):
    return (f"{t['ms']:.1f} ms a forward, {t['coll_ms']:.1f} ms in "
            f"{t['calls']:.0f} collectives, {t['staged'] / 1e6:.1f} MB "
            f"staged through the host; launches a forward {t['launches']}")


def p22_flux_job(dims, h_lat, txt_len, steps, dev):
    """Phase 22a-c on one rank: flux-dev at published width, tp = 2 (the
    hand layout and the spec table, bf16-fused and w8a8), flux_engine with
    a tp mesh and with a dp mesh, and the single-block trunk over two
    pipeline stages."""
    import numpy as np
    import torch

    from comfyui_gguf_tpu_torch import _build, pipeline
    from comfyui_gguf_tpu_torch.models import flux, testing
    from comfyui_gguf_tpu_torch.models.flux import block_view
    from comfyui_gguf_tpu_torch.nn.layers import DEFAULT_CONFIG as QC
    from comfyui_gguf_tpu_torch.parallel import collectives
    from comfyui_gguf_tpu_torch.parallel import mesh as pmesh
    from comfyui_gguf_tpu_torch.parallel import pp, tp_flux, tp_spec
    from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8,
                                                 is_modulation_key,
                                                 requantize_i8)
    from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
    from comfyui_gguf_tpu_torch.sampling import flux_schedule, sample_flow

    _build.reset_launch_counts()
    _p22_sync(reset=True)
    res, fails = {}, []
    mesh = pmesh.make_mesh(tp=2)
    r = collectives.axis_index("tp", mesh)
    res["backend"] = collectives.backend("tp", mesh)
    cfg = dims.config()
    n_img = (h_lat // 2) ** 2
    t0 = time.perf_counter()
    full = testing.flux_random_stacked_params(dims, seed=22, device=dev)
    keys = tp_flux.BLOCK_KEYS
    spec = tp_spec.shard_packed_params(
        full, block_keys=keys, rules=tp_spec.flux_rules(cfg.hidden), tp=2,
        index=r)
    hand = tp_flux.shard_packed_flux(full, cfg, 2, r)
    _p22_sync()
    _p22_log(r, f"seed-made Q4_K flux ({cfg.depth_double} + "
                f"{cfg.depth_single} blocks, hidden {cfg.hidden}) "
                f"and this rank's shards (spec table and hand "
                f"layout) in {time.perf_counter() - t0:.2f}s; backend "
                f"{res['backend']}")
    inputs = testing.flux_example_inputs(dims, batch=1, h_lat=h_lat,
                                         w_lat=h_lat, txt_len=txt_len,
                                         device=dev)

    def spec_fwd(p):
        return tp_spec.tp_flux_forward(p, cfg, *inputs, mesh=mesh, qcfg=QC)

    def hand_fwd(p):
        return tp_flux.tp_forward_stacked(p, cfg, *inputs, mesh=mesh,
                                          qcfg=QC)

    # 22a: bf16-fused, every kernel call of one forward against its plain
    # version, then timed forwards of both layouts
    errs = _call_errs()
    with torch.no_grad(), _kernel_calls(errs):
        spec_fwd(spec)
    _call_gate(errs, f"[rank {r}] 22a spec bf16-fused TP forward", fails)
    out_spec, t = _p22_timed(lambda: spec_fwd(spec))
    res["spec_bf16"] = t
    _p22_log(r, "22a tp_spec bf16-fused: " + _p22_fmt(t))
    with torch.no_grad():
        hand_fwd(hand)
    out_hand, t = _p22_timed(lambda: hand_fwd(hand))
    res["hand_bf16"] = t
    _p22_log(r, "22a tp_flux bf16-fused: " + _p22_fmt(t))
    with torch.no_grad():
        want = flux.forward_stacked(full, cfg, *inputs, qcfg=QC)
    res["spec_vs_unsharded"] = rel_l2(out_spec, want)
    res["hand_vs_unsharded"] = rel_l2(out_hand, want)
    res["digests"] = [_p22_digest(out_spec), _p22_digest(out_hand)]
    _p22_log(r, f"22a bf16-fused TP vs the unsharded forward of the same "
                f"codes: spec {res['spec_vs_unsharded']:.3e}, hand "
                f"{res['hand_vs_unsharded']:.3e} (<= {P22_TP_DELTA_MAX})")
    for k in ("spec_vs_unsharded", "hand_vs_unsharded"):
        if not res[k] <= P22_TP_DELTA_MAX:
            fails.append(f"rank {r} 22a {k} {res[k]}")

    # 22a: w8a8 (every token-facing shard converted on its own; the
    # modulation gather shards stay planar)
    def pred(k, v):
        return not is_modulation_key(k)

    t0 = time.perf_counter()
    spec8 = convert_tree_i8(spec, pred=pred)
    _p22_sync()
    res["convert_s"] = time.perf_counter() - t0
    errs = _call_errs()
    with torch.no_grad(), _kernel_calls(errs, control=True):
        spec_fwd(spec8)
    _call_gate(errs, f"[rank {r}] 22a spec w8a8 TP forward", fails)
    out8, t = _p22_timed(lambda: spec_fwd(spec8))
    res["spec_w8a8"] = t
    res["w8a8_vs_unsharded_bf16"] = rel_l2(out8, want)
    _p22_log(r, f"22a tp_spec w8a8 (conversion {res['convert_s']:.2f}s): "
                + _p22_fmt(t) + f"; vs the unsharded bf16-fused forward "
                f"{res['w8a8_vs_unsharded_bf16']:.3e} (recorded)")
    with torch.no_grad():
        img, txt, vec, pe = flux._prelude(full, cfg, *inputs, QC)
        x = torch.cat([txt, img], dim=1)
        local = dataclasses.replace(cfg, n_heads=cfg.n_heads // 2)
        with collectives.active(mesh):
            y_tp = flux._single_block(block_view(spec8["single_blocks"], 0),
                                      x, vec, pe, local, QC)
        blk = {k: (requantize_i8(v[0]) if isinstance(v, PlanarQuant)
                   and pred(f"single_blocks.{k}", v) else v[0])
               for k, v in full["single_blocks"].items()}
        y_one = flux._single_block(blk, x, vec, pe, cfg, QC)
    res["w8a8_block_vs_unsharded"] = rel_l2(y_tp, y_one)
    _p22_log(r, f"22a a w8a8 TP single block vs the same unsharded w8a8 "
                f"block: {res['w8a8_block_vs_unsharded']:.3e} "
                f"(<= {P22_BLOCK_DELTA_MAX})")
    if not res["w8a8_block_vs_unsharded"] <= P22_BLOCK_DELTA_MAX:
        fails.append(f"rank {r} 22a w8a8 block "
                     f"{res['w8a8_block_vs_unsharded']}")
    del spec8, blk, y_tp, y_one
    hand8 = convert_tree_i8(hand, pred=pred)
    with torch.no_grad():
        hand_fwd(hand8)
    out8h, t = _p22_timed(lambda: hand_fwd(hand8))
    res["hand_w8a8"] = t
    res["digests"] += [_p22_digest(out8), _p22_digest(out8h)]
    _p22_log(r, "22a tp_flux w8a8: " + _p22_fmt(t))
    del hand8, spec
    torch.cuda.empty_cache()

    # 22b: flux_engine with the tp mesh against the TP direct sampler, and
    # with a dp mesh against each request alone at batch 1
    sig = flux_schedule(steps, n_img)
    rng = np.random.default_rng(220)
    reqs = [(rng.standard_normal((n_img, cfg.in_channels)).astype(
                np.float32),
             {"txt": rng.standard_normal((txt_len, cfg.context_dim)).astype(
                 np.float32),
              "y": rng.standard_normal((cfg.vec_dim,)).astype(np.float32),
              "guidance": np.float32(3.5)}, sig) for _ in range(2)]
    img_ids = torch.as_tensor(np.array(flux.make_img_ids(
        h_lat // 2, h_lat // 2, 1)), device=dev)
    txt_ids = torch.zeros((1, txt_len, 3), dtype=torch.int32, device=dev)

    def direct(fwd, params, x, cond):
        txt_c = torch.as_tensor(cond["txt"], device=dev)[None].to(
            torch.bfloat16)
        y = torch.as_tensor(cond["y"], device=dev)[None].to(torch.bfloat16)
        g = torch.full((1,), float(cond["guidance"]), device=dev)

        def vel(xc, sg):
            return fwd(params, cfg, xc, img_ids, txt_c, txt_ids,
                       sg.to(torch.float32).expand(1), y, g, qcfg=QC)

        x0 = torch.as_tensor(x, device=dev)[None].to(torch.bfloat16)
        with torch.no_grad():
            return sample_flow(vel, x0, sig)[0].float().cpu()

    def serve(model, **kw):
        eng = pipeline.flux_engine(model, h_lat, h_lat, txt_len,
                                   max_batch=2, **kw)
        hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
        _p22_sync()
        t0 = time.perf_counter()
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        if any(h.error is not None or not h.finished for h in hs):
            raise RuntimeError(f"flux_engine {kw}: a request failed: "
                               f"{[h.error for h in hs]}")
        return [torch.from_numpy(np.asarray(h.result, np.float32))
                for h in hs], dt

    tp_model = pipeline.DiffusionModel(arch="flux", params=hand, config=cfg,
                                       qcfg=QC, device=torch.device(dev))
    s0 = dict(collectives.STATS)
    served, dt = serve(tp_model, mesh=mesh)
    coll = collectives.STATS["seconds"] - s0["seconds"]
    tp_fwd = functools.partial(tp_flux.tp_forward_stacked, mesh=mesh)
    res["tp_engine_vs_direct"] = [
        rel_l2(a, direct(tp_fwd, hand, x, c)) for a, (x, c, _) in
        zip(served, reqs)]
    res["tp_engine_s"] = dt
    _p22_log(r, f"22b flux_engine(mesh=tp2), 2 requests x {steps} steps at "
                f"{h_lat * 8}²: {dt:.2f}s ({coll:.2f}s in collectives); vs the TP "
                f"direct sampler "
                + ", ".join(f"{e:.3e}" for e in res["tp_engine_vs_direct"])
                + f" (<= {P22_DELTA_MAX})")
    del tp_model, hand
    torch.cuda.empty_cache()
    dp_mesh = pmesh.make_mesh(tp=1)
    dp_model = pipeline.DiffusionModel(arch="flux", params=full, config=cfg,
                                       qcfg=QC, device=torch.device(dev))
    served, dt = serve(dp_model, dp_mesh=dp_mesh)
    alone = [direct(flux.forward_stacked, full, x, c) for x, c, _ in reqs]
    res["dp_engine_vs_alone"] = [rel_l2(a, b) for a, b in zip(served, alone)]
    res["dp_bit_equal"] = all(torch.equal(a, b)
                              for a, b in zip(served, alone))
    res["dp_engine_s"] = dt
    _p22_log(r, f"22b flux_engine(dp_mesh=dp2, max_batch=2): {dt:.2f}s; vs "
                f"each request alone at batch 1 "
                + ", ".join(f"{e:.3e}" for e in res["dp_engine_vs_alone"])
                + f" (<= {P22_DELTA_MAX}), bit-equal: "
                f"{res['dp_bit_equal']}")
    for k in ("tp_engine_vs_direct", "dp_engine_vs_alone"):
        if not max(res[k]) <= P22_DELTA_MAX:
            fails.append(f"rank {r} 22b {k} {res[k]}")

    # 22c: the 38 single blocks over two pipeline stages, batch 2 in two
    # microbatches, against the sequential walk
    pp_mesh = pmesh.make_axis_mesh("pp")
    gen = torch.Generator(device=dev).manual_seed(221)
    xb = torch.randn((2, n_img + txt_len, cfg.hidden), generator=gen,
                     device=dev).to(torch.bfloat16)
    vecb = torch.randn((2, cfg.hidden), generator=gen, device=dev).to(
        torch.bfloat16)
    ids = torch.cat([txt_ids, img_ids], dim=1).expand(2, -1, -1)
    peb = flux.rope_freqs(ids, cfg.axes_dim, cfg.theta)
    out_pp, t = _p22_timed(lambda: pp.pp_flux_single_trunk(
        full["single_blocks"], xb, vecb, peb, cfg, QC, pp_mesh, n_micro=2))
    res["pp"] = t

    def sequential():
        x = xb
        for i in range(cfg.depth_single):
            x = flux._single_block(block_view(full["single_blocks"], i), x,
                                   vecb, peb, cfg, QC)
        return x

    seq, t_seq = _p22_timed(sequential)
    res["pp_vs_sequential"] = rel_l2(out_pp, seq)
    res["pp_bit_equal"] = bool(torch.equal(out_pp, seq))
    _p22_log(r, f"22c pp_flux_single_trunk, 2 stages x "
                f"{cfg.depth_single // 2} blocks, batch 2 in 2 "
                f"microbatches: " + _p22_fmt(t) + f"; sequential "
                f"{t_seq['ms']:.1f} ms; vs sequential "
                f"{res['pp_vs_sequential']:.3e} (<= {P22_DELTA_MAX}), "
                f"bit-equal: {res['pp_bit_equal']}")
    if not res["pp_vs_sequential"] <= P22_DELTA_MAX:
        fails.append(f"rank {r} 22c pp {res['pp_vs_sequential']}")
    res.update(fails=fails, launches=dict(_build.LAUNCHES),
               peak_gib=_p22_sync(peak=True))
    del full, dp_model
    torch.cuda.empty_cache()
    return res


def p22_ep_sp_job(d, wd, wan_latent, n_tokens, dev):
    """Phase 22d-e on one rank: a HiDream-I1 MoE FFN at published width over
    ep = 2 against dense dispatch, ring attention at the Wan 2.1 14B
    self-attention shape against K7 on the whole sequence, and one Wan
    block under ``sequence_parallel`` against the unsharded block."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import hidream, testing, wan
    from comfyui_gguf_tpu_torch.models.flux import block_view
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.nn.attention import (dot_product_attention,
                                                     sequence_parallel)
    from comfyui_gguf_tpu_torch.nn.layers import DEFAULT_CONFIG as QC
    from comfyui_gguf_tpu_torch.parallel import collectives
    from comfyui_gguf_tpu_torch.parallel import mesh as pmesh
    from comfyui_gguf_tpu_torch.parallel.ring import ring_attention

    _build.reset_launch_counts()
    _p22_sync(reset=True)
    res, fails = {}, []
    gen = torch.Generator(device=dev).manual_seed(223)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    # 22d
    ep_mesh = pmesh.make_axis_mesh("ep")
    r = collectives.axis_index("ep", ep_mesh)
    E, H, Fd = d.n_experts, d.hidden, d.ffn

    def pq(R, K, stack=None):
        return random_planar(Q.Q4_K, (R, K), gen, device=dev, stack=stack)

    p = "block.ff_i"
    params = {f"{p}.shared_experts.w1.weight": pq(Fd, H),
              f"{p}.shared_experts.w3.weight": pq(Fd, H),
              f"{p}.shared_experts.w2.weight": pq(H, Fd),
              f"{p}.gate.weight": torch.randn((E, H), generator=gen,
                                              device=dev) * 0.02,
              f"{p}.experts_stacked": {"w1": pq(Fd, H, E),
                                       "w3": pq(Fd, H, E),
                                       "w2": pq(H, Fd, E)}}
    x = randn(1, n_tokens, H)
    old = hidream.MOE_DISPATCH, hidream.EP_MESH
    try:
        hidream.MOE_DISPATCH = "dense"
        dense, t_dense = _p22_timed(lambda: hidream.moe_ffn(
            params, p, x, E, d.top_k, QC))
        hidream.MOE_DISPATCH, hidream.EP_MESH = "ep", ep_mesh
        got, t = _p22_timed(lambda: hidream.moe_ffn(params, p, x, E,
                                                    d.top_k, QC))
    finally:
        hidream.MOE_DISPATCH, hidream.EP_MESH = old
    res["ep"] = t
    res["ep_vs_dense"] = rel_l2(got, dense)
    _p22_log(r, f"22d HiDream-I1 MoE FFN ({E} experts, top-{d.top_k}, "
                f"{H} -> {Fd}) over ep=2, {n_tokens} tokens: "
                + _p22_fmt(t)
                + f"; dense dispatch {t_dense['ms']:.1f} ms; vs dense "
                f"{res['ep_vs_dense']:.3e} (<= {P22_DELTA_MAX})")
    if not res["ep_vs_dense"] <= P22_DELTA_MAX:
        fails.append(f"rank {r} 22d ep {res['ep_vs_dense']}")
    del params, dense, got

    # 22e: the ring at B1 H40 L4680 D128 (phase 17's geometry)
    sp_mesh = pmesh.make_axis_mesh("sp")
    f_, h_, w_ = wan_latent[0], wan_latent[1] // 2, wan_latent[2] // 2
    L = f_ * h_ * w_
    cfg = wd.config()
    nh, hd = cfg.n_heads, cfg.head_dim
    q, k, v = (randn(1, L, nh, hd) for _ in range(3))
    out, t = _p22_timed(lambda: ring_attention(q, k, v, sp_mesh))
    res["ring"] = t
    with torch.no_grad():
        want = dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2)).transpose(1, 2)
    res["ring_vs_k7"] = rel_l2(out, want)
    _p22_log(r, f"22e ring_attention B=1 H={nh} L={L} D={hd} over sp=2: "
                + _p22_fmt(t) + f"; vs K7 on the whole sequence "
                f"{res['ring_vs_k7']:.3e} (<= {P22_DELTA_MAX})")
    del q, k, v, out, want
    wp = testing.wan_random_stacked_params(wd, seed=224, device=dev)
    blk = block_view(wp["blocks"], 0)
    xw = randn(1, L, cfg.dim)
    e0 = randn(1, 6 * cfg.dim, scale=0.1)
    ctx = randn(1, 512, cfg.dim)
    pe = wan.rope_3d(f_, h_, w_, cfg.axes_dim, device=dev)
    c = L // 2

    def sp_block():
        with collectives.active(sp_mesh), sequence_parallel("sp"):
            y = wan._block(blk, xw[:, r * c:(r + 1) * c], e0, ctx,
                           pe[r * c:(r + 1) * c], cfg, QC)
        return collectives.all_gather(y, "sp", dim=1, mesh=sp_mesh)

    got, t = _p22_timed(sp_block)
    with torch.no_grad():
        one = wan._block(blk, xw, e0, ctx, pe, cfg, QC)
    res["sp"] = t
    res["sp_block_vs_unsharded"] = rel_l2(got, one)
    _p22_log(r, f"22e a Wan 2.1 block (dim {cfg.dim}) under "
                f"sequence_parallel (L={L} "
                f"over sp=2, cross-attention to 512 replicated text states "
                f"on K7): " + _p22_fmt(t) + f"; vs the unsharded block "
                f"{res['sp_block_vs_unsharded']:.3e} (<= {P22_DELTA_MAX})")
    for k_ in ("ring_vs_k7", "sp_block_vs_unsharded"):
        if not res[k_] <= P22_DELTA_MAX:
            fails.append(f"rank {r} 22e {k_} {res[k_]}")
    res.update(fails=fails, launches=dict(_build.LAUNCHES),
               peak_gib=_p22_sync(peak=True))
    del wp, blk
    torch.cuda.empty_cache()
    return res


P22_TINY = {
    "qwen_image": dict(hidden=512, n_heads=4, n_layers=2, in_ch=32,
                       context_dim=96),
    "wan": dict(dim=512, ffn_dim=1024, n_heads=4, n_layers=2, in_ch=16,
                text_dim=64),
    "aura": dict(hidden=512, depth_double=1, depth_single=1, mlp=1024,
                 in_ch=4, cond_dim=64, n_register_tokens=3, max_tokens=64),
    "cosmos": dict(dim=512, n_heads=4, n_layers=2, in_ch=16, text_dim=64),
    "hyvid": dict(hidden=512, n_heads=4, depth_double=1, depth_single=1,
                  refiner_depth=1, in_ch=16, text_dim=64),
    "lumina2": dict(dim=512, n_heads=4, n_layers=2, n_refiner=1,
                    n_context_refiner=1, ffn=1024, in_ch=4, cap_dim=64),
    "sd3": dict(hidden=512, heads=4, depth=3, ctx_dim=64, pooled=32,
                in_ch=16, pos_max=8, qk_norm=True),
    "flux": dict(hidden=512, heads=4, ctx=256, vec=64, in_ch=16,
                 depth_double=1, depth_single=1, axes_dim=(32, 48, 48)),
    "hidream": dict(hidden=512, heads=4, depth_double=1, depth_single=1,
                    ffn=1024, n_experts=2, top_k=2, t5_dim=64,
                    llama_dim=96, pooled=48),
}


def _p22_tiny_case(arch):
    """(state dict, config, numpy inputs, block keys) of a tiny ``arch``
    made from a seed."""
    import numpy as np

    from comfyui_gguf_tpu_torch.models import flux, testing

    rng = np.random.default_rng(22)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    t = np.full((1,), 0.5, np.float32)
    kw = P22_TINY[arch]
    if arch == "sd3":
        d = testing.TinySD3Dims(**kw)
        return (testing.sd3_flat_state_dict(d, seed=7), d.config(),
                (a(1, 8, 8, d.in_ch), a(1, 8, d.ctx_dim), a(1, d.pooled), t),
                ("joint_blocks", "joint_blocks_last"))
    if arch == "flux":
        d = testing.TinyFluxDims(**kw)
        return (testing.flux_state_dict(d, seed=19), d.config(),
                (a(1, 16, d.in_ch), np.array(flux.make_img_ids(4, 4, 1)),
                 a(1, 8, d.ctx), np.zeros((1, 8, 3), np.int32), t,
                 a(1, d.vec), np.full((1,), 4.0, np.float32)),
                ("double_blocks", "single_blocks"))
    dims_cls = {"qwen_image": testing.QwenImageDims,
                "wan": testing.WanDims, "aura": testing.AuraDims,
                "cosmos": testing.CosmosDims, "hyvid": testing.HyVidDims,
                "lumina2": testing.Lumina2Dims,
                "hidream": testing.TinyHiDreamDims}[arch]
    d = dims_cls(**kw)
    sd = testing.random_flat_sd_from_spec(
        *getattr(testing, f"{arch}_shape_spec")(d), seed=5)
    x = {"qwen_image": lambda: (a(1, 16, d.in_ch),
                                np.array(flux.make_img_ids(4, 4, 1)),
                                a(1, 8, d.context_dim),
                                np.zeros((1, 8, 3), np.int32), t),
         "wan": lambda: (a(1, 2, 8, 8, d.in_ch), a(1, 6, d.text_dim), t),
         "aura": lambda: (a(1, 8, 8, d.in_ch), a(1, 6, d.cond_dim), t),
         "cosmos": lambda: (a(1, 2, 8, 8, d.in_ch), a(1, 6, d.text_dim), t),
         "hyvid": lambda: (a(1, 2, 4, 4, d.in_ch), a(1, 6, d.text_dim), t,
                           np.full((1,), 6000.0, np.float32)),
         "lumina2": lambda: (a(1, 8, 8, d.in_ch), a(1, 6, d.cap_dim), t),
         "hidream": lambda: (a(1, 8, 8, d.in_ch), a(1, 6, d.t5_dim),
                             a(1, 5, d.llama_dim), a(1, d.pooled), t),
         }[arch]()
    keys = {"qwen_image": ("transformer_blocks",), "wan": ("blocks",),
            "aura": ("double_layers", "single_layers"),
            "cosmos": ("blocks",), "lumina2": None,
            "hyvid": ("double_blocks", "single_blocks"),
            "hidream": ("double_stream_blocks",
                        "single_stream_blocks")}[arch]
    return sd, d.config(), x, keys


def p22_tiny_job(dev):
    """Phase 22f on one rank: every ``tp_spec`` wrapper (nine archs) at a
    tiny size, tp = 2, bf16-fused on the card and on the CPU, with bf16
    activations and again with f32 ones (K7's f32 instance: every arch's
    attention must launch it)."""
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.nn.layers import DEFAULT_CONFIG as QC
    from comfyui_gguf_tpu_torch.parallel import collectives, tp_spec
    from comfyui_gguf_tpu_torch.parallel import mesh as pmesh

    _build.reset_launch_counts()
    mesh = pmesh.make_mesh(tp=2)
    r = collectives.axis_index("tp", mesh)
    res, fails = {}, []
    for arch in P22_TINY:
        sd, cfg, x, keys = _p22_tiny_case(arch)
        sharded = getattr(tp_spec, f"shard_{arch}_params")(sd, cfg, 2,
                                                           Q.Q4_K)
        if keys is None:
            keys = tp_spec.lumina2_tp_block_keys(sharded)
        fwd = getattr(tp_spec, f"tp_{arch}_forward")
        locals_ = {where: tp_spec.place_tp_params(sharded, mesh, keys,
                                                  device=where)
                   for where in (dev, "cpu")}
        # activations in bf16 (what a pipeline hands the forward), then in
        # f32; timesteps and guidance in f32, ids as they are
        for adt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
            outs = {}
            f32_before = _build.LAUNCHES["flash_attn_f32"]
            for where in (dev, "cpu"):
                xs = tuple(torch.as_tensor(a, device=where).to(
                    adt if a.dtype.kind == "f" and a.ndim > 1
                    else torch.as_tensor(a).dtype) for a in x)
                with torch.no_grad():
                    outs[where] = fwd(locals_[where], cfg, *xs, mesh=mesh,
                                      qcfg=QC).float().cpu()
            res[arch + tag] = e = rel_l2(outs[dev], outs["cpu"])
            if not (torch.isfinite(outs[dev]).all()
                    and e <= P22_CPU_DELTA_MAX):
                fails.append(f"rank {r} 22f {arch}{tag} card vs CPU {e}")
            if tag and _build.LAUNCHES["flash_attn_f32"] == f32_before:
                fails.append(f"rank {r} 22f {arch}{tag} launched no "
                             f"flash_attn_f32")
    _p22_log(r, "22f every tp_spec wrapper, tiny, tp=2, bf16 and f32 "
                "activations, card vs CPU: "
                + ", ".join(f"{a} {e:.3e}" for a, e in res.items())
                + f" (<= {P22_CPU_DELTA_MAX})")
    res_out = dict(tiny=res, fails=fails, launches=dict(_build.LAUNCHES))
    return res_out


def _p22_dims(args):
    """Phase 22's published dims: flux-dev (depth from the flags),
    HiDream-I1, one Wan 2.1 14B block."""
    from comfyui_gguf_tpu_torch.models import testing

    return (dataclasses.replace(testing.FLUX_DEV_DIMS,
                                depth_double=args.parallel_depth_double,
                                depth_single=args.parallel_depth_single),
            testing.HIDREAM_I1_DIMS,
            dataclasses.replace(testing.WAN_14B_DIMS, n_layers=1))


def parallel_phase(dev, flux_dims, hd_dims, wan_dims, steps, h_lat=128,
                   txt_len=512, wan_latent=WAN_LATENT, n_tokens=4096):
    """Phase 22: two ranks on the one card over gloo (``parallel.launch``):
    22a-c (``p22_flux_job``), 22d-e (``p22_ep_sp_job``) and 22f
    (``p22_tiny_job``). The parent built the kernel library already; the
    ranks load it. → the launches summed over ranks and the ranks'
    results; a failed gate fails the run."""
    import torch

    from comfyui_gguf_tpu_torch.parallel import launch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with launch.Ranks(2, device=dev, backend="gloo") as ranks:
        log(f"  2 ranks on {dev} over "
            f"{ranks.backend} (ranks share the card; CUDA tensors go through "
            f"pinned host buffers, counted)")
        a = ranks.run(p22_flux_job, flux_dims, h_lat, txt_len, steps, dev)
        b = ranks.run(p22_ep_sp_job, hd_dims, wan_dims, wan_latent, n_tokens,
                      dev)
        c = ranks.run(p22_tiny_job, dev)
    wall = time.perf_counter() - t0
    fails = [f for res in (*a, *b, *c) for f in res["fails"]]
    digests = [res["digests"] for res in a]
    if digests[0] != digests[1]:
        fails.append(f"22a the ranks' replicated outputs differ: {digests}")
    launches = {}
    for res in (*a, *b, *c):
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    log(f"  phase 22: {wall:.1f}s; peak memory a rank (22a-c / 22d-e): "
        + ", ".join(f"{x['peak_gib']:.2f} / {y['peak_gib']:.2f} GiB"
                    for x, y in zip(a, b))
        + f"; bytes staged through the host a forward (22a tp_spec "
          f"bf16-fused) {a[0]['spec_bf16']['staged'] / 1e6:.1f} MB; "
          f"launches over the phase, both ranks "
        + str({k: n for k, n in launches.items() if n}))
    if fails:
        raise SystemExit("phase 22 failed: " + "; ".join(fails))
    return dict(launches=launches, ranks=a, ep_sp=b, tiny=c, wall=wall)


# phases that run alone under --only (phases 21 and 22, or phases 5, 17
# and 19 on a parent commit's port, this script copied into its checkout,
# beside this one's)
ALONE_PHASES = (5, 17, 19, 21, 22)


def _tools_alone(dev, args):
    """Phase 21 by itself (``--only 21``): the host codecs' step and the
    tools at ``--tools-depth-*`` in a temporary directory."""
    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch.models import testing

    host_codecs_step(dev, testing.FLUX_DEV_DIMS)
    dims = dataclasses.replace(
        testing.FLUX_DEV_DIMS, depth_double=args.tools_depth_double,
        depth_single=args.tools_depth_single)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tools_phase(dev, dims, args.tools_steps, tmp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-double", type=int, default=19)
    ap.add_argument("--depth-single", type=int, default=38)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--t5-layers", type=int, default=24)
    ap.add_argument("--sd3-depth", type=int, default=38)
    ap.add_argument("--sd3-steps", type=int, default=28)
    ap.add_argument("--unet-steps", type=int, default=20)
    # phases 13, 14, 15, 16, 17, 18, 19, 20 and 21 run at half depth, so
    # that the whole, phases 4i, 22 and 23 included, keeps a margin under a
    # 1200 s limit (1083.7 s with 13, 14 and 18-20 at full depth on an H100
    # 80GB HBM3 at 700 W); the flags restore it
    ap.add_argument("--aura-depth-single", type=int, default=16)
    ap.add_argument("--aura-steps", type=int, default=20)
    ap.add_argument("--lumina-depth", type=int, default=13)
    ap.add_argument("--lumina-steps", type=int, default=20)
    ap.add_argument("--llama-layers", type=int, default=26)
    ap.add_argument("--qwen-depth", type=int, default=30)
    ap.add_argument("--qwen-steps", type=int, default=20)
    ap.add_argument("--qwen-encoder-layers", type=int, default=28)
    ap.add_argument("--qwen-vision-layers", type=int, default=32)
    ap.add_argument("--hidream-depth-double", type=int, default=8)
    ap.add_argument("--hidream-depth-single", type=int, default=16)
    ap.add_argument("--hidream-steps", type=int, default=20)
    ap.add_argument("--hidream-t5-layers", type=int, default=24)
    ap.add_argument("--hidream-llama-layers", type=int, default=32)
    ap.add_argument("--hidream-budget-blocks", type=int, nargs=2,
                    default=(2, 4), metavar=("DOUBLE", "SINGLE"))
    ap.add_argument("--wan-depth", type=int, default=20)
    ap.add_argument("--wan-steps", type=int, default=20)
    ap.add_argument("--umt5-layers", type=int, default=24)
    ap.add_argument("--cosmos-depth", type=int, default=14)
    ap.add_argument("--cosmos-steps", type=int, default=20)
    ap.add_argument("--cosmos-t5-layers", type=int, default=24)
    ap.add_argument("--hyvid-depth-double", type=int, default=10)
    ap.add_argument("--hyvid-depth-single", type=int, default=20)
    ap.add_argument("--hyvid-steps", type=int, default=20)
    ap.add_argument("--hyvid-llama-layers", type=int, default=32)
    ap.add_argument("--ltxv-depth", type=int, default=14)
    ap.add_argument("--ltxv-steps", type=int, default=20)
    ap.add_argument("--ltxv-t5-layers", type=int, default=24)
    ap.add_argument("--tools-depth-double", type=int, default=1)
    ap.add_argument("--tools-depth-single", type=int, default=2)
    ap.add_argument("--tools-steps", type=int, default=4)
    ap.add_argument("--scripts-steps", type=int, default=4)
    ap.add_argument("--parallel-depth-double", type=int, default=19)
    ap.add_argument("--parallel-depth-single", type=int, default=38)
    ap.add_argument("--parallel-steps", type=int, default=4)
    ap.add_argument("--only", type=int, nargs="+", choices=ALONE_PHASES,
                    metavar="PHASE",
                    help="build, then only these of phases "
                         f"{', '.join(map(str, ALONE_PHASES))}, each with "
                         "its own gates (no build gates, no result lines)")
    args = ap.parse_args()

    import torch

    from comfyui_gguf_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    _T0[0] = t_start
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

    if args.only:
        import comfyui_gguf_tpu_torch as pkg
        log(f"[2 build] the port in "
            f"{os.path.dirname(os.path.dirname(pkg.__file__))}")
        _build.lib()
        alone = {
            5: lambda: main_path_phase(dev, args.depth_double,
                                       args.depth_single, args.steps),
            17: lambda: video_full_phase(dev, "wan", args.wan_depth,
                                         args.wan_steps, args.umt5_layers,
                                         min(args.wan_steps, 2)),
            19: lambda: video2_full_phase(
                dev, "hyvid",
                (args.hyvid_depth_double, args.hyvid_depth_single),
                args.hyvid_steps, args.hyvid_llama_layers,
                min(args.hyvid_steps, 2)),
            21: lambda: _tools_alone(dev, args),
            22: lambda: parallel_phase(dev, *_p22_dims(args),
                                       args.parallel_steps),
        }
        for n in args.only:
            log(f"[{n} alone]")
            alone[n]()
            gc.collect()
            torch.cuda.empty_cache()
        log(f"wall {time.perf_counter() - t_start:.1f}s")
        return 0

    log("[2 build]")
    _build.host_lib()
    host = _build.BUILD_REPORT["host"]
    log(f"  host codecs: {host['compiler']} {host['flags']}: built in "
        f"{host['s']:.2f}s (phase 21 holds them to numpy)")
    _build.lib()
    rep = _build.BUILD_REPORT
    if rep.get("cached"):
        log(f"  reused {rep['path']}")
    else:
        log(f"  nvcc {rep['compile_s']:.2f}s (parallel), total "
            f"{rep['total_s']:.2f}s")
        for src, lines in rep["ptxas"].items():
            spills = [ln.strip() for ln in lines if "spill" in ln]
            if src in NAMED_SOURCES:
                # registers and spills of each instance, by its template
                # arguments (LoRA instances: the last argument is 1; flash
                # attention: the head dim)
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
    # K1/K2 and K7: no wgmma serialization advisory (ptxas C751x) and no
    # spill in any instance (K7's D = 512 among them)
    qmm_flags = [f"{src}: {ln.strip()[:160]}"
                 for src in QMM_SOURCES + FLASH_SOURCES
                 for ln in rep.get("ptxas", {}).get(src, [])
                 if "C751" in ln or ("spill" in ln
                                     and " 0 bytes spill stores, 0 bytes "
                                         "spill loads" not in ln)]
    if qmm_flags:
        raise SystemExit("K1/K2 or K7 ptxas advisories or spills: "
                         + "; ".join(qmm_flags))
    lib = _build.lib()
    from comfyui_gguf_tpu_torch.ops.qmatmul import _RESIDENT
    resident = {s: lib.qmm_wgmma_resident_blocks(2, s) for s in _RESIDENT}
    log("  K1/K2 and K7: no C751x advisory, no spill; the wgmma body's "
        "blocks resident "
        "at once by K-split cluster size (cudaOccupancyMaxActiveClusters x "
        "size): " + ", ".join(f"{s}: {n} (plan {_RESIDENT[s]})"
                              for s, n in resident.items()))
    log("  dynamic shared memory a block: i8mm.cu and gemm_probe.cu (one "
        "body, gemm_wgmma.cuh) "
        + ", ".join(f"bn={bn} {lib.i8mm_smem_bytes(bn)} B" for bn in (256, 128))
        + "; flash_attn.cu and flash_attn_f16.cu "
        + ", ".join(f"D={d} {lib.flash_attn_smem_bytes(d)} B"
                    for d in (40, 64, 80, 96, 128, 160, 256, 384, 512))
        + "; flash_attn_f32.cu "
        + ", ".join(f"D={d} {lib.flash_attn_f32_smem_bytes(d)} B"
                    for d in (40, 64, 80, 96, 128, 160, 256, 384, 512))
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
        if "sdpa_rel_l2" in r:
            extra = f" | SDPA f32 vs plain (control) {r['sdpa_rel_l2']:.2e}"
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
    log("[4a the same GGUF at dequant_dtype float16 and float32, with an "
        "f16 LoRA, card vs CPU]")
    tiny_dt = tiny_dtype_phase(dev)
    log("[4b tiny FluxPipeline from files, card vs CPU, with and without "
        "attention_i8]")
    tiny_pipe = tiny_pipeline_phase(dev)
    log("[4c every flow sampler through the tiny flux, card vs CPU]")
    menu = sampler_menu_phase(dev)
    log("[4d tiny SD3 / SD1 / SDXL from files, card vs CPU]")
    sd_tiny = sd_tiny_phase(dev)
    log("[4e tiny AuraFlow / Lumina 2 from files, card vs CPU]")
    dit_tiny = dit_tiny_phase(dev)
    log("[4f tiny Qwen-Image / HiDream from files, card vs CPU]")
    qh_tiny = qh_tiny_phase(dev)
    log("[4g tiny Wan 2.1 (with its VAE) / Cosmos from files, card vs CPU]")
    video_tiny = video_tiny_phase(dev)
    log("[4h tiny HunyuanVideo / LTX-Video (with their VAEs) from files, "
        "card vs CPU]")
    video2_tiny = video2_tiny_phase(dev)

    log("[4i f16 and f32 attention through the models, card vs CPU]")
    dtype_attn = dtype_attention_phase(dev)

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
    del clip_l, clip_g
    torch.cuda.empty_cache()
    log(f"[13 AuraFlow v0.3 at published width, 4 + "
        f"{args.aura_depth_single} of 4 + 32 layers, aura_engine]")
    aura_res = dit_full_phase(dev, "aura", args.aura_depth_single,
                              args.aura_steps, 24, min(args.aura_steps, 4))
    log(f"[14 Lumina Image 2.0 at published width, {args.lumina_depth} of 26 "
        f"layers, lumina2_engine]")
    lumina_res = dit_full_phase(dev, "lumina2", args.lumina_depth,
                                args.lumina_steps, args.llama_layers,
                                min(args.lumina_steps, 4))
    log(f"[15 Qwen-Image at published width, {args.qwen_depth} of 60 "
        f"blocks, the Qwen2.5-VL vision tower, Qwen-Image-Edit, "
        f"qwen_image_engine]")
    qwen_res = qwen_image_phase(dev, args.qwen_depth, args.qwen_steps,
                                args.qwen_encoder_layers,
                                args.qwen_vision_layers,
                                min(args.qwen_steps, 4))
    log(f"[16 HiDream-I1 at published width, {args.hidream_depth_double} + "
        f"{args.hidream_depth_single} of 16 + 32 blocks, hidream_engine, the "
        f"budgeted conversion]")
    hidream_res = hidream_phase(dev, args.hidream_depth_double,
                                args.hidream_depth_single,
                                args.hidream_steps, args.hidream_t5_layers,
                                args.hidream_llama_layers,
                                min(args.hidream_steps, 4),
                                args.hidream_budget_blocks)
    log("[17 Wan 2.1 14B at published width, the UMT5-xxl-shaped encoder, "
        "the Wan 2.1 VAE, wan_engine]")
    wan_res = video_full_phase(dev, "wan", args.wan_depth, args.wan_steps,
                               args.umt5_layers, min(args.wan_steps, 2))
    log("[18 Cosmos at published width (the 7B geometry), cosmos_engine]")
    cosmos_res = video_full_phase(dev, "cosmos", args.cosmos_depth,
                                  args.cosmos_steps, args.cosmos_t5_layers,
                                  min(args.cosmos_steps, 2))
    log("[19 HunyuanVideo 13B at published width, the Llama-3.1-8B-shaped "
        "encoder, the HunyuanVideo VAE, hyvid_engine]")
    hyvid_res = video2_full_phase(
        dev, "hyvid", (args.hyvid_depth_double, args.hyvid_depth_single),
        args.hyvid_steps, args.hyvid_llama_layers, min(args.hyvid_steps, 2))
    log("[20 LTX-Video 2B at published width, T5-xxl, the LTX-Video VAE, "
        "ltxv_engine]")
    ltxv_res = video2_full_phase(dev, "ltxv", args.ltxv_depth,
                                 args.ltxv_steps, args.ltxv_t5_layers,
                                 min(args.ltxv_steps, 2))
    log("[21 the host block codecs against numpy at published widths; "
        "the offline tools as a user runs them: safetensors -> BF16 "
        "GGUF -> Q4_K_M -> validate -> load -> denoise, the tile "
        "autotuner]")
    from comfyui_gguf_tpu_torch.models import testing
    host_codecs_step(dev, testing.FLUX_DEV_DIMS)
    tools_dims = dataclasses.replace(
        testing.FLUX_DEV_DIMS, depth_double=args.tools_depth_double,
        depth_single=args.tools_depth_single)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tools_res = tools_phase(dev, tools_dims, args.tools_steps, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        log("[23 the six entry scripts of examples/ as a user runs them, "
            "at published widths with the depth cut, 1024²]")
        scripts_res = scripts_phase(dev, tmp, tools_res["files"],
                                    args.scripts_steps)
    torch.cuda.empty_cache()
    log("[22 parallelism: flux-dev over tp=2 (hand layout and spec table, "
        "bf16-fused and w8a8), flux_engine over tp and dp, pipeline stages, "
        "HiDream experts over ep, Wan 2.1 ring attention over sp, every "
        "tp_spec wrapper; two ranks sharing the card, gloo]")
    par_res = parallel_phase(dev, *_p22_dims(args), args.parallel_steps)

    # launches of each kernel over the driven paths (every path had its
    # counts set to 0 just before it and read just after)
    launches = {k: 0 for k in _build.LAUNCHES}
    for counts in (*(v["launches"] for v in tiny.values()),
                   *(v["launches"] for v in tiny_dt.values()),
                   *(v["launches"] for v in video_tiny.values()),
                   *(v["launches"] for v in video2_tiny.values()),
                   *(v["launches"] for v in tiny_pipe.values()),
                   *(v["launches"] for v in sd_tiny.values()),
                   *(v["launches"] for v in dit_tiny.values()),
                   *(v["launches"] for v in qh_tiny.values()),
                   *(v["launches"] for v in dtype_attn.values()),
                   menu["launches"], main_res["launches"],
                   main_res["f32_forward"]["launches"], t2i["launches"],
                   serve_res["launches"], lora_res["launches"], tool_counts,
                   sd3_res["launches"], sd3_t2i["launches"],
                   unet_res["launches"], aura_res["launches"],
                   lumina_res["launches"], qwen_res["launches"],
                   hidream_res["launches"], wan_res["launches"],
                   cosmos_res["launches"], hyvid_res["launches"],
                   ltxv_res["launches"], tools_res["launches"],
                   scripts_res["launches"], par_res["launches"]):
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
