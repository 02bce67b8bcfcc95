// The softmax-floor ladder for Hopper (sm_90a): the inference flash-attention kernel
// K1 with parts of its softmax stripped, to attribute K1's time (flash_attention.cu)
// between its products and its softmax.
//
// Replaces the Pallas TPU kernel tools/bench_softmax_floor.py::_variant_kernel
// (behind variant()). Same function and the same rounding, mode by mode:
//   q' = bf16(q * scale * log2(e)) in every mode (f32 product, rounded to bf16);
//   kDots:        out = sum_j bf16(q'.k_j) v_j (no softmax; wrong numerics);
//   kUnsafe:      p_j = exp2(q'.k_j) in f32, out = sum_j bf16(p_j) v_j / sum_j p_j
//                 (no running max, no corrections);
//   kBf16Softmax: the online softmax with its per-element chain in bf16, rescaled
//                 once per key block of the TPU kernel (block_k keys): l = bf16(q'.k),
//                 m' = max(m, max_block l) in bf16 (m starts at bf16(-30000)),
//                 p = jnp.exp2 of bf16(l - m') in bf16, which JAX computes as
//                 bf16(exp(bf16(bf16(ln 2) * d))), the block's sum of p rounded to
//                 bf16, the correction exp2(bf16(m - m')) in f32.
// Keys past nk up to nk_pad (the next multiple of block_k) are zero keys with zero
// values, as the TPU wrapper pads them, and are not masked: each adds exp2(0) = 1
// to the unsafe row sum, and they can raise the bf16 running max to 0.
//
// Design: K1's own kernel (flash_forward.cuh), MODE the rung, at d = dv = 32: the
// same 64-row blocks, 64-key tiles staged by cp.async, q k^T and P v on the tensor
// cores (mma.sync; bf16 as stored, f32 storage as 3xTF32 where an operand is f32),
// so the gaps between the rungs and K1 ("full") are K1's. q' and every P are bf16
// values: one bf16 P v product a k-step where K1 takes two (hi + lo), and in f32 two
// TF32 products where K1 takes three. kBf16Softmax must take each TPU key block's
// max before its first exponential (a per-tile rescale would round p against other
// maxima), so it walks each block's tiles twice, k alone for the max and then k and v
// for p: 1.5x the products of the others.
//
// What bounds it (the tool's shape, B*H = 192, N = 1400 against 1408 keys, d = dv =
// 32, bf16): the products, 2 * 192 * 1400 * 1408 * 64 = 4.84e10 operations, 0.049 ms
// at 989 TFLOP/s, for kDots; the exponentials, 3.78e8 at 16 ex2 a clock an SM
// (0.090 ms at 1.98 GHz), for kUnsafe and kBf16Softmax (each of its p takes one
// exp2f; chip_smoke.py phase 1c computes both bounds from the card's clock).
#include "flash_forward.cuh"

namespace {

constexpr int kD = 32;  // head dim of q/k and of v

template <typename T, int MODE>
int launch_mode(const void* q, const void* k, const void* v, void* out, int bh, int nq, int nk,
                int nk_pad, int block_k, float scale_log2, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(out), nq, nk, nk_pad, block_k, scale_log2};
  return launch<T, kD, kD, MODE>(a, bh, stream);
}

template <typename T>
int dispatch(int mode, const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nk, int nk_pad, int block_k, float scale_log2, cudaStream_t s) {
  if (mode == kDots)
    return launch_mode<T, kDots>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  if (mode == kUnsafe)
    return launch_mode<T, kUnsafe>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  if (mode == kBf16Softmax)
    return launch_mode<T, kBf16Softmax>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_info(int mode, int* out) {
  if (mode == kDots) return info<T, kD, kD, kDots>(out);
  if (mode == kUnsafe) return info<T, kD, kD, kUnsafe>(out);
  if (mode == kBf16Softmax) return info<T, kD, kD, kBf16Softmax>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (bh, nq, 32); k, v: (bh, nk, 32); out: (bh, nq, 32); all contiguous, one
// storage type, 16-byte aligned. nk_pad = nk rounded up to a multiple of block_k.
// scale_log2 = scale * log2(e) in f32. mode: 0 dots, 1 unsafe, 2 bf16 softmax.
// Returns the launch's CUDA status.
extern "C" int fod_attention_floor(const void* q, const void* k, const void* v, void* out,
                                   int bh, int nq, int nk, int nk_pad, int block_k,
                                   float scale_log2, int mode, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || block_k <= 0 || nk_pad < nk ||
      nk_pad % block_k != 0 || nk_pad - nk >= block_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return dispatch<float>(mode, q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  if (dtype == fod::kBFloat16)
    return dispatch<__nv_bfloat16>(mode, q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: a mode's registers a thread, static shared bytes, dynamic shared bytes a
// block, local bytes a thread (spills), resident blocks an SM. Launches nothing.
extern "C" int fod_attention_floor_info(int mode, int dtype, int* out) {
  if (dtype == fod::kFloat32) return dispatch_info<float>(mode, out);
  if (dtype == fod::kBFloat16) return dispatch_info<__nv_bfloat16>(mode, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
