// Flash attention forward for Hopper (sm_90a) on the tensor cores:
// softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel future_od_tpu/ops/flash_attention.py::_flash_kernel
// (behind flash_attention). Same function: an online softmax over key tiles in
// base 2 (log2(e) folded into the scale), an f32 running max, f32 row sums and f32
// accumulators, output in q's storage type. The (Nq, Nk) logits never reach device
// memory.
//
// The kernel is flash_forward.cuh's, MODE kFull (the softmax-floor ladder T1 runs the
// same kernel with parts of its softmax stripped).
//
// Layout. A block of 4 warps owns 64 query rows of one batch*head, 16 rows a warp,
// in the fragment layout of mma.sync (m16n8k16 for bf16, m16n8k8 for tf32). Each
// warp keeps its q fragments in registers for the whole call (up to d 128). The block walks the
// keys in tiles of 64, double-buffered in shared memory by cp.async (16 bytes a
// copy; rows padded by 16 bytes so that ldmatrix and the f32 v reads hit 32
// distinct banks). Keys past nk are zero-filled and scored -inf before the max;
// their p is set to 0. Per tile and warp: S = q k^T as 16 x 64 f32 accumulators
// (k fragments by ldmatrix: row-major k is already the .col B operand; v fragments
// by ldmatrix.trans in bf16); the row max across the 4 threads of a quad by
// __shfl_xor_sync; p = 2^((s - max) * scale * log2(e)), one ex2 a logit, with the
// difference taken before the scale so that logits of 1e3 lose nothing to it; then
// O = O * correction + P v with P taken from the S accumulators in registers (the C
// fragment of q k^T is the A fragment of P v), no trip through shared memory. Row
// sums stay per thread until the end.
//
// Rounding.
// - bf16 storage: q and k go to the tensor cores as stored; their products are exact
//   and summed in f32, the value of the TPU kernel's upcast-f32 dot up to summation
//   order. P is passed as a hi + lo pair of bf16 (two P v products): P rounded once
//   to bf16 put the flagship encoder's output at up to 0.93 of chip_smoke.py phase
//   1's bf16 tolerance in an emulation (tests/test_torch_flash_tc_rounding.py); the
//   pair leaves the output's own rounding, about half of it.
// - f32 storage (3xTF32): every f32 operand x is split into big = tf32(x) and
//   small = tf32(x - big) (cvt.rna), and each product is big*small + small*big +
//   big*big on m16n8k8, for q k^T and for P v. That is f32 accuracy (about 2^-21
//   relative a product), not TF32's 2^-11. For P v the k index of a key pair is
//   permuted (keys 2t and 2t+1 of an 8-key step go to k slots t and t + 4, with v's
//   rows read to match) so that the S accumulators are already the tf32 A fragment.
// - The tensor cores' f32 sums truncate. In f32 each key tile's P v starts from zero
//   and is added to O on the CUDA cores (round to nearest): with every mma's sum
//   rounded toward zero, P v chained through all 22 key tiles of the flagship
//   encoder lies at 1.17 of the f32 tolerance, the per-tile sum at 0.08 (the
//   emulation in tests/test_torch_flash_tc_rounding.py). bf16 keeps one chain (its
//   drift is far below its tolerance) and with it the registers for 6 blocks an SM.
//
// What bounds it (the flagship encoder, 32 x 1400 x 1400, d = dv = 32, a call):
// 8.03e9 operations, 8.1 us at 989 TFLOP/s bf16 or 48.7 us as 3xTF32 (3 x the
// operations at 495 TFLOP/s); 62.7 M exponentials, 15.0 us at 16 ex2 a clock an SM
// (CUDA C Programming Guide, arithmetic instruction throughput, compute capability
// 9.0) x 132 SMs x 1.98 GHz (nvidia-smi's clocks.max.sm on an H100 80GB HBM3); 11.5
// MB moved in bf16, 3.4 us. So in bf16 the exponentials, not the products, set the
// floor at d 32; in f32 the three TF32 products do. The design keeps one ex2 a
// logit; today the instructions around the products (the softmax, the hi + lo
// split, the fragment moves) and their latencies bind it, not the ex2 unit.
//
// Grid: (ceil(nq / 64), batch*heads, dv / 128 above dv 128, else 1) blocks of 128
// threads, 22 x 32 = 704 at the flagship shape. The registers set the resident
// blocks an SM, not the shared memory (20-52 KB a block of the 227 KB at d 32):
// bf16 d 32 at 80 registers (held there by
// __launch_bounds__, a few bytes spilled) 6, f32 d 32 at 147 registers 3 (ptxas -v
// and fod_flash_attention_info on an H100, which chip_smoke.py phase 0 prints).
//
// Head dims: the pairs (d, dv) below are built; ops/flash_attention.py zero-pads any
// other pair up to 256 onto the smallest built one that holds it (zero columns add
// exact zeros to the logits and give zero output columns, which it slices off).
// Past d + dv = 128 the accumulators take most of the registers, so those
// instantiations set no resident-block floor (flash_forward.cuh's Geometry). At d 256
// q is staged in shared memory rather than held in registers, and above dv 128 each
// block owns 128 output columns (a grid z of dv / 128 slices, each recomputing the
// logits): f32's 3xTF32 q fragments at d 256 would take 256 registers a thread, and
// the output accumulators at dv 256 128 more.
#include "flash_forward.cuh"

namespace {

template <typename T, int D, int DV>
int launch_full(const void* q, const void* k, const void* v, void* out, int bh, int nq, int nk,
                float scale_log2, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(out), nq, nk, nk, 1, scale_log2};
  return launch<T, D, DV, kFull>(a, bh, stream);
}

// The instantiated (d, dv), as ops/flash_attention.py's SUPPORTED_HEAD_DIMS lists
// them: the flagship encoder's 32/32 and conditional cross-attention's concat heads
// 64/32, the same at heads of 16 (the single-frame debug config), 16/16 and 32/16,
// an encoder's heads of 64, 64/64, the concat heads of heads of 64 (hidden 512 over 8
// heads), 128/64, heads of 128, 128/128, and the widest: the concat heads of heads of
// 128 (hidden 1024 over 8 heads), 256/128, and heads of 256, 256/256.
template <typename T, typename F>
int dispatch_dims(int d, int dv, const F& f) {
  if (d == 32 && dv == 32) return f(std::integral_constant<int, 32>{}, std::integral_constant<int, 32>{});
  if (d == 64 && dv == 32) return f(std::integral_constant<int, 64>{}, std::integral_constant<int, 32>{});
  if (d == 16 && dv == 16) return f(std::integral_constant<int, 16>{}, std::integral_constant<int, 16>{});
  if (d == 32 && dv == 16) return f(std::integral_constant<int, 32>{}, std::integral_constant<int, 16>{});
  if (d == 64 && dv == 64) return f(std::integral_constant<int, 64>{}, std::integral_constant<int, 64>{});
  if (d == 128 && dv == 64) return f(std::integral_constant<int, 128>{}, std::integral_constant<int, 64>{});
  if (d == 128 && dv == 128) return f(std::integral_constant<int, 128>{}, std::integral_constant<int, 128>{});
  if (d == 256 && dv == 128) return f(std::integral_constant<int, 256>{}, std::integral_constant<int, 128>{});
  if (d == 256 && dv == 256) return f(std::integral_constant<int, 256>{}, std::integral_constant<int, 256>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nk, int d, int dv, float scale_log2, cudaStream_t stream) {
  return dispatch_dims<T>(d, dv, [&](auto dd, auto ddv) {
    return launch_full<T, decltype(dd)::value, decltype(ddv)::value>(q, k, v, out, bh, nq, nk,
                                                                      scale_log2, stream);
  });
}

template <typename T>
int dispatch_info(int d, int dv, int* out) {
  return dispatch_dims<T>(d, dv, [&](auto dd, auto ddv) {
    return info<T, decltype(dd)::value, decltype(ddv)::value, kFull>(out);
  });
}

}  // namespace

// q, k: (bh, nq|nk, d); v: (bh, nk, dv); out: (bh, nq, dv); all contiguous, one
// storage type, 16-byte aligned. scale_log2 = scale * log2(e). Returns the launch's
// CUDA status.
extern "C" int fod_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int bh, int nq, int nk, int d, int dv, float scale_log2,
                                   int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return dispatch<float>(q, k, v, out, bh, nq, nk, d, dv, scale_log2, s);
  if (dtype == fod::kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, out, bh, nq, nk, d, dv, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: the instantiation's registers a thread, static shared bytes, dynamic shared
// bytes a block, local bytes a thread (spills), resident blocks an SM. Launches nothing.
extern "C" int fod_flash_attention_info(int d, int dv, int dtype, int* out) {
  if (dtype == fod::kFloat32) return dispatch_info<float>(d, dv, out);
  if (dtype == fod::kBFloat16) return dispatch_info<__nv_bfloat16>(d, dv, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
