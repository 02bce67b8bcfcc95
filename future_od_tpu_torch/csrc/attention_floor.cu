// The softmax-floor ladder for Hopper (sm_90a): flash attention with parts of the
// softmax stripped, to attribute the inference kernel's time (flash_attention.cu)
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
// What bounds it: at the tool's shape (B*H = 192, N = 1400, d = dv = 32) the
// products' 2*Nq*Nk*(d+dv) operations, as for the inference kernel. The design is
// that kernel's, so the gaps between the rungs measure it: one thread per query
// row, 64-key K and V tiles in shared memory as f32 broadcasts, 16 keys scored
// before their exponentials and P.V updates, the products on the CUDA cores in
// f32. kDots and kUnsafe need no running max. kBf16Softmax must take each TPU key
// block's max before its first exponential (a per-16-key rescale would round p
// against other maxima), so it runs two passes over each block: the q.k products
// once for the max and again for p, 1.5x the products of the others.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys staged in shared memory per step
constexpr int kChunk = 16;   // keys scored before their exponentials and P.V updates
constexpr int kD = 32;       // head dim of q/k and of v
constexpr float kLn2Bf16 = 0.69140625f;  // bf16(ln 2), the factor jnp.exp2 uses in bf16
constexpr float kLog2e = 1.4426950408889634f;

enum Mode : int { kDots = 0, kUnsafe = 1, kBf16Softmax = 2 };

__device__ __forceinline__ float bf16r(float x) { return fod::round_to<__nv_bfloat16>(x); }

// Stage keys [k0, k0 + kBlockK) of k (and of v, if vs) as f32; rows past nk (the
// zero-padded keys, and any past nk_pad, which the callers skip) are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ kb, const T* __restrict__ vb,
                                      float* ks, float* vs, int k0, int nk) {
  for (int i = threadIdx.x; i < kBlockK * kD; i += kBlockQ) {
    const bool real = k0 + i / kD < nk;
    ks[i] = real ? fod::to_float(kb[(size_t)k0 * kD + i]) : 0.f;
    if (vs) vs[i] = real ? fod::to_float(vb[(size_t)k0 * kD + i]) : 0.f;
  }
  __syncthreads();
}

__device__ __forceinline__ float dot(const float (&qr)[kD], const float* kr) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) s = fmaf(qr[c], kr[c], s);
  return s;
}

__device__ __forceinline__ void add_pv(float (&acc)[kD], float p, const float* vr) {
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kBlockQ)
attention_floor_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int nq, int nk,
                       int nk_pad, int block_k, float scale_log2) {
  extern __shared__ float4 fod_smem[];
  float* ks = reinterpret_cast<float*>(fod_smem);  // [kBlockK][kD]
  float* vs = ks + kBlockK * kD;                    // [kBlockK][kD]

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool valid = row < nq;
  const T* qrow = q + ((size_t)bh * nq + (valid ? row : 0)) * kD;
  const T* kb = k + (size_t)bh * nk * kD;
  const T* vb = v + (size_t)bh * nk * kD;

  float qr[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) qr[c] = valid ? bf16r(fod::to_float(qrow[c]) * scale_log2) : 0.f;
  float acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;
  float row_sum = 0.f;

  if (MODE != kBf16Softmax) {
    for (int k0 = 0; k0 < nk_pad; k0 += kBlockK) {
      stage(kb, vb, ks, vs, k0, nk);
      const int n = min(kBlockK, nk_pad - k0);
      for (int j0 = 0; j0 < n; j0 += kChunk) {
        float s[kChunk];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) s[jj] = dot(qr, ks + (j0 + jj) * kD);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const bool real = j0 + jj < n;
          float p;
          if (MODE == kDots) {
            p = real ? bf16r(s[jj]) : 0.f;
          } else {
            const float e = real ? exp2f(s[jj]) : 0.f;
            row_sum += e;
            p = bf16r(e);
          }
          add_pv(acc, p, vs + (j0 + jj) * kD);
        }
      }
      __syncthreads();
    }
  } else {
    float row_max = bf16r(-30000.f);
    for (int b0 = 0; b0 < nk_pad; b0 += block_k) {
      // pass 1: the block's max logit; bf16 rounding is monotone, so the max
      // of the rounded logits is the rounded max
      float block_max = -INFINITY;
      for (int k0 = b0; k0 < b0 + block_k; k0 += kBlockK) {
        stage(kb, vb, ks, static_cast<float*>(nullptr), k0, nk);
        const int n = min(kBlockK, b0 + block_k - k0);
        for (int j0 = 0; j0 < n; j0 += kChunk) {
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const float s = dot(qr, ks + (j0 + jj) * kD);
            block_max = fmaxf(block_max, j0 + jj < n ? s : -INFINITY);
          }
        }
        __syncthreads();
      }
      const float new_max = fmaxf(row_max, bf16r(block_max));
      const float correction = exp2f(bf16r(row_max - new_max));
      row_sum *= correction;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] *= correction;
      // pass 2: p in bf16 against the block's max
      float block_sum = 0.f;
      for (int k0 = b0; k0 < b0 + block_k; k0 += kBlockK) {
        stage(kb, vb, ks, vs, k0, nk);
        const int n = min(kBlockK, b0 + block_k - k0);
        for (int j0 = 0; j0 < n; j0 += kChunk) {
          float s[kChunk];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) s[jj] = dot(qr, ks + (j0 + jj) * kD);
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const float d = bf16r(bf16r(s[jj]) - new_max);
            const float p =
                j0 + jj < n ? bf16r(exp2f(bf16r(kLn2Bf16 * d) * kLog2e)) : 0.f;
            block_sum += p;
            add_pv(acc, p, vs + (j0 + jj) * kD);
          }
        }
        __syncthreads();
      }
      row_sum += bf16r(block_sum);
      row_max = new_max;
    }
  }

  if (valid) {
    T* orow = out + ((size_t)bh * nq + row) * kD;
#pragma unroll
    for (int c = 0; c < kD; ++c)
      orow[c] = fod::from_float<T>(MODE == kDots ? acc[c] : acc[c] / row_sum);
  }
}

template <typename T, int MODE>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int nq, int nk,
           int nk_pad, int block_k, float scale_log2, cudaStream_t stream) {
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  const size_t smem = (size_t)2 * kBlockK * kD * sizeof(float);
  attention_floor_kernel<T, MODE><<<grid, kBlockQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, nk, nk_pad, block_k, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int mode, const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nk, int nk_pad, int block_k, float scale_log2, cudaStream_t s) {
  if (mode == kDots)
    return launch<T, kDots>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  if (mode == kUnsafe)
    return launch<T, kUnsafe>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  if (mode == kBf16Softmax)
    return launch<T, kBf16Softmax>(q, k, v, out, bh, nq, nk, nk_pad, block_k, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (bh, nq, 32); k, v: (bh, nk, 32); out: (bh, nq, 32); all contiguous, one
// storage type. nk_pad = nk rounded up to a multiple of block_k. scale_log2 =
// scale * log2(e) in f32. mode: 0 dots, 1 unsafe, 2 bf16 softmax. Returns the
// launch's CUDA status.
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
