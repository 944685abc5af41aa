// K1/K2: fused dequantize + matmul over planar quantized weights.
//
// Replaces the Pallas kernels of comfyui_gguf_tpu/ops/qmatmul.py
// (_make_nib4_kernel and _make_int8_kernel, launched by pallas_qmm and, on a
// depth-stacked weight, by pallas_qmm_indexed). On the card the stacked case
// needs no kernel of its own: the wrapper passes the pointer of block i's
// view of the stacked tensors.
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] ),
//   W[k, r]   = bf16( s[k/gs, r] * (q[k, r] - zp) + o[k/gs, r] )
//
// Layout (the reference package's planar layout, kept as is): codes are
// K-major. nib4: byte row j holds k=j in its low nibble and k=j+Kp/2 in its
// high nibble. int8: one zero-point-folded code per element. The weight is
// dequantized in f32 with separately rounded multiply and add, then rounded
// to bf16, so it equals the plain version's dense bf16 weight bit for bit.
//
// Two bodies, chosen by the wrapper from M alone. Both unpack the same way
// (qmm_common.cuh): a byte permute drops a code into the low byte of
// 0x4B000000, which is the float 2^23 + code; f32 arithmetic takes it from
// there; cvt.rn.bf16x2.f32 packs two weights into one operand register.
//
// The wgmma body (qmm_wgmma.cuh; this file holds its nib4 instances,
// qmm_int8.cu its int8 instances, so that they compile side by side), for M
// above the small-M limit; bound by bf16 tensor-core operations.
//   The problem is transposed, out^T = W^T x^T, so that the dequantized
// weight is the A operand of wgmma and is fed from registers: it never takes
// a trip through shared memory and no warp waits for another warp's
// unpacking. x is the B operand, K-major, and arrives by TMA as 64-byte-
// swizzled 32-column tiles exactly as the wgmma descriptor reads them. (The
// alternative, dequant warps writing a swizzled MN-major B tile, costs a
// shared-memory store and load per weight element and a hand-over barrier
// per tile; the first measurement of this form gave no reason to try it.)
// A k16 slice needs no permuted k order: a thread pairs the low nibbles of
// two adjacent code rows (k, k+1) for the low slice and the high nibbles of
// the same two bytes for the slice Kp/2 further on, which multiplies a
// second x tile fetched from column Kp/2 + k. The out-features, though, are
// permuted inside a tile: wgmma rows g and g+8 of a warp are two adjacent
// columns of the weight, so a thread reads its codes two bytes at a time
// and stores its results two bf16 at a time.
//   One persistent block per SM walks a list of output tiles of 128
// out-features x (128 or 256) tokens, token tiles fastest so that the x
// tiles of a wave stay in L2. A 256-token tile unpacks every weight element
// once for two wgmma (measured: the unpack's ALU work does not hide behind
// the tensor cores, it adds to them), a 128-token tile leaves a shorter
// last wave; the wrapper picks per shape. The block has three warpgroups
// and moves registers with setmaxnreg: the producer's keeps 40 a thread,
// the two consumers' take 232. One producer lane issues the TMA boxes of a
// K step of 64 (two x tiles, the raw code tile with the 128-byte swizzle,
// the scale and offset rows) into a 5-stage ring; mbarriers carry "full"
// and "empty", and there is no block-wide barrier in the K loop. Each
// consumer warpgroup owns 64 out-features: per step it unpacks four A
// fragments and issues one group of 4 (or 8) m64n128k16 wgmma; fragments
// are double-buffered over steps, so a step is unpacked while the group
// before it runs, and a stage is released when the group that read it has
// retired. Ragged edges: TMA zero-fills x past M and past K (the tensor
// map's extents are M and K, not the padded ones); columns past R are
// masked in the epilogue.
//
// The split-K body (qmm_smallm.cu), for M <= 8; bound by bytes: the packed
// weight is read once. A 256-thread block owns a 128-column strip and a
// slice of K; the M <= 8 rows of x sit in shared memory as bf16. A warp
// streams 8-byte code loads of 16 rows at a time, unpacks them into the same
// register A fragments and multiplies with mma.sync m16n8k16, x as the
// 8-column B operand, so 1 <= M <= 8 all cost the same. The K split is a
// thread-block cluster along K: every block reduces its 4 row lanes in a
// fixed order into shared memory, and rank 0 adds the ranks' partial sums
// in rank order through distributed shared memory and runs the epilogue.
// No atomics: two launches give the same bits.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// Plain C entry (bound with ctypes). Shapes are checked by the Python
// wrapper: Kp % 512 == 0, Rp % 128 == 0, R <= Rp, K <= Kp, K % 8 == 0,
// gs in {16, 32}, offsets only with zero point 0, all pointers 16-byte
// aligned. `nt` (1 or 2) is the number of 128-token sub-tiles of an output
// tile. Returns the launch's CUDA error code.
extern "C" int qmm_wgmma_nib4_launch(const void* x, const void* qs,
                                     const void* scales, const void* offsets,
                                     const void* bias, void* out, int M,
                                     int K, int Kp, int R, int Rp, int gs,
                                     int zp, int act_from, int nt,
                                     void* stream) {
  return launch_wgmma<true, false>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, act_from, nt, static_cast<cudaStream_t>(stream));
}
