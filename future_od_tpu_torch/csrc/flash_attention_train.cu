// Differentiable flash attention with in-kernel dropout, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels behind
// future_od_tpu/ops/flash_attention.py::flash_attention_train:
//   K4 fod_flash_train_fwd  <- _flash_fwd_kernel: out = (dropout(p) v) / rowsum(p)
//                              and lse = max + log(rowsum(p)), p = exp(q k^T scale - max);
//                              the row sum is taken before the mask multiplies p.
//   K5 fod_flash_train_dq   <- _flash_dq_kernel: dq = sum_k p (dS mask - delta) k scale,
//                              p recomputed from lse, dS = do v^T.
//   K6 fod_flash_train_dkv  <- _flash_dkv_kernel: dv = (p mask)^T do and
//                              dk = (p (dS mask - delta))^T q scale, keys >= nk and
//                              queries >= nq masked.
// and writes K7's mask for the checks (fod_dropout_keep_mask). The mask is
// dropout_mask.cuh's hash of the element's global (bh, row, col), so the three
// kernels agree with each other and with the TPU kernels whatever their tiles.
//
// What bounds them: at the stage-1 training shapes (350 tokens; encoder d = dv =
// 32, decoder d = 64, dv = 32) each call does 2-4 products of Nq * Nk * d
// multiply-adds per batch*head against O((Nq + Nk) * d) elements moved, so
// arithmetic bounds them, not memory. This first version computes in f32 on the
// CUDA cores (no tensor cores). K4 and K5 give each thread one query row (q, do
// and the f32 accumulators in registers) and stage 64-key tiles of K and V in
// shared memory as f32, read by every thread as broadcasts; K4 scores 16 keys per
// rescale of its running sums. K6 gives each thread one key (its k and v rows and
// its dk/dv accumulators in registers), one block per (bh, 64-key tile), and
// loops over 64-query tiles of q, do, lse and delta staged in shared memory: the
// block owns its dk/dv rows, so no atomics are needed. The (Nq, Nk)
// probabilities never reach device memory in either direction.
//
// The three kernels compute every logit the same way, bit for bit: fmaf over
// c = 0..d-1 of (q[c] * scale) * k[c], in natural-log units, and lse is
// max + log(rowsum) of those logits. The backward's p = exp(logit - lse) is then
// at most 1 whatever the logits' size, because lse >= the row's max logit. A
// recompute that rounds otherwise (other units, the scale applied after the
// product) puts the exponent off by a few ulps of the logit: at logits of 1e6-1e7,
// which a randomly initialised backbone reaches within a few training steps, p
// came out as large as 2^16 and the step's gradient was no longer finite.
#include "common.cuh"
#include "dropout_mask.cuh"

namespace {

constexpr int kRows = 64;   // query rows (K4, K5) or keys (K6) per block, one per thread
constexpr int kTile = 64;   // keys (K4, K5) or queries (K6) staged in shared memory per step
constexpr int kChunk = 16;  // keys K4 scores between rescales

// Stage rows [r0, r0 + n) of a (rows, W) matrix as f32 times `mul` into
// s[kTile][W], zero beyond n.
template <typename T, int W>
__device__ __forceinline__ void stage(float* s, const T* src, int r0, int n, float mul = 1.f) {
  for (int i = threadIdx.x; i < kTile * W; i += kRows) {
    s[i] = (i / W) < n ? fod::to_float(src[(size_t)r0 * W + i]) * mul : 0.f;
  }
}

// The logit of query row qs (already times scale) and key row ks: the one
// rounding order all three kernels use.
template <int D>
__device__ __forceinline__ float logit(const float* qs, const float* ks) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) dot = fmaf(qs[c], ks[c], dot);
  return dot;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kRows)
train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int nq, int nk,
                 float scale, fod::Dropout dp) {
  extern __shared__ float4 fod_smem[];
  float* ks = reinterpret_cast<float*>(fod_smem);  // [kTile][D]
  float* vs = ks + kTile * D;                       // [kTile][DV]

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool valid = row < nq;
  const T* qrow = q + ((size_t)bh * nq + (valid ? row : 0)) * D;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * DV;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = fod::to_float(qrow[c]) * scale;
  float acc[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) acc[c] = 0.f;
  float row_max = -INFINITY;
  float row_sum = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    const int n = min(kTile, nk - k0);
    stage<T, D>(ks, kb, k0, n);
    stage<T, DV>(vs, vb, k0, n);
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float new_max = row_max;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float dot = logit<D>(qr, ks + (j0 + jj) * D);
        s[jj] = (j0 + jj) < n ? dot : -INFINITY;
        new_max = fmaxf(new_max, s[jj]);
      }
      // new_max is finite (key j0 < n is real); exp(-inf) = 0 covers the
      // first chunk and the padded keys
      const float correction = expf(row_max - new_max);
      row_sum *= correction;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[c] *= correction;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float p = expf(s[jj] - new_max);
        row_sum += p;  // the softmax denominator is taken before dropout
        if (dp.active()) p *= fod::dropout_value(bh, row, k0 + j0 + jj, dp);
        const float* vr = vs + (j0 + jj) * DV;
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
      row_max = new_max;
    }
    __syncthreads();
  }

  if (valid) {
    T* orow = out + ((size_t)bh * nq + row) * DV;
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DV; ++c) orow[c] = fod::from_float<T>(acc[c] * inv);
    lse[(size_t)bh * nq + row] = row_max + logf(row_sum);  // row_sum >= 1
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kRows)
train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int nq, int nk,
                float scale, fod::Dropout dp) {
  extern __shared__ float4 fod_smem[];
  float* ks = reinterpret_cast<float*>(fod_smem);  // [kTile][D]
  float* vs = ks + kTile * D;                       // [kTile][DV]

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool valid = row < nq;
  const size_t r = (size_t)bh * nq + (valid ? row : 0);
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * DV;

  float qr[D], dqr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = fod::to_float(q[r * D + c]) * scale;
    dqr[c] = 0.f;
  }
  float dor[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) dor[c] = fod::to_float(dout[r * DV + c]);
  const float lr = lse[r];
  const float dl = delta[r];

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    const int n = min(kTile, nk - k0);
    stage<T, D>(ks, kb, k0, n);
    stage<T, DV>(vs, vb, k0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * D;
      const float* vr = vs + j * DV;
      const float s = logit<D>(qr, kr);
      float ds = 0.f;
#pragma unroll
      for (int c = 0; c < DV; ++c) ds = fmaf(dor[c], vr[c], ds);
      if (dp.active()) ds *= fod::dropout_value(bh, row, k0 + j, dp);
      const float p = expf(s - lr);
      const float dlogit = p * (ds - dl);
#pragma unroll
      for (int c = 0; c < D; ++c) dqr[c] = fmaf(dlogit, kr[c], dqr[c]);
    }
    __syncthreads();
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < D; ++c) dq[r * D + c] = fod::from_float<T>(dqr[c] * scale);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kRows)
train_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int nq, int nk, float scale, fod::Dropout dp) {
  extern __shared__ float4 fod_smem[];
  float* qs = reinterpret_cast<float*>(fod_smem);  // [kTile][D]
  float* dos = qs + kTile * D;                      // [kTile][DV]
  float* lses = dos + kTile * DV;                   // [kTile]
  float* deltas = lses + kTile;                     // [kTile]

  const int bh = blockIdx.y;
  const int key = blockIdx.x * kRows + threadIdx.x;
  const bool valid = key < nk;
  const size_t kr_idx = (size_t)bh * nk + (valid ? key : 0);
  const T* qb = q + (size_t)bh * nq * D;
  const T* dob = dout + (size_t)bh * nq * DV;

  float kr[D], dkr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = fod::to_float(k[kr_idx * D + c]);
    dkr[c] = 0.f;
  }
  float vr[DV], dvr[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    vr[c] = fod::to_float(v[kr_idx * DV + c]);
    dvr[c] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    const int n = min(kTile, nq - q0);  // queries >= nq are never read
    stage<T, D>(qs, qb, q0, n, scale);  // q * scale, as K4 and K5 round it
    stage<T, DV>(dos, dob, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kRows) {
      const size_t rr = (size_t)bh * nq + q0 + i;
      lses[i] = i < n ? lse[rr] : 0.f;
      deltas[i] = i < n ? delta[rr] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* qr = qs + i * D;
      const float* dor = dos + i * DV;
      const float s = logit<D>(qr, kr);
      float ds = 0.f;
#pragma unroll
      for (int c = 0; c < DV; ++c) ds = fmaf(vr[c], dor[c], ds);
      const float p = expf(s - lses[i]);
      float p_dropped = p;
      if (dp.active()) {
        const float m = fod::dropout_value(bh, q0 + i, key, dp);
        p_dropped = p * m;
        ds *= m;
      }
      const float dlogit = p * (ds - deltas[i]);
#pragma unroll
      for (int c = 0; c < DV; ++c) dvr[c] = fmaf(p_dropped, dor[c], dvr[c]);
#pragma unroll
      for (int c = 0; c < D; ++c) dkr[c] = fmaf(dlogit, qr[c], dkr[c]);
    }
    __syncthreads();
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < D; ++c) dk[kr_idx * D + c] = fod::from_float<T>(dkr[c]);
#pragma unroll
    for (int c = 0; c < DV; ++c) dv[kr_idx * DV + c] = fod::from_float<T>(dvr[c]);
  }
}

__global__ void keep_mask_kernel(float* __restrict__ out, int nq, int nk, fod::Dropout dp) {
  const int bh = blockIdx.y;
  const size_t n = (size_t)nq * nk;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(i / nk), col = static_cast<int>(i % nk);
    out[(size_t)bh * n + i] = dp.active() ? fod::dropout_value(bh, row, col, dp) : 1.f;
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o0, *o1;  // out/lse, dq, or dk/dv
  int bh, nq, nk;
  float scale;
  fod::Dropout dp;
  cudaStream_t stream;
};

enum Which { kFwd, kDq, kDkv };

template <typename T, int D, int DV>
int launch(Which which, const Args& a) {
  const dim3 block(kRows);
  if (which == kFwd) {
    const size_t smem = (size_t)kTile * (D + DV) * sizeof(float);
    train_fwd_kernel<T, D, DV><<<dim3((a.nq + kRows - 1) / kRows, a.bh), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.nq, a.nk, a.scale, a.dp);
  } else if (which == kDq) {
    const size_t smem = (size_t)kTile * (D + DV) * sizeof(float);
    train_dq_kernel<T, D, DV><<<dim3((a.nq + kRows - 1) / kRows, a.bh), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.o0), a.nq, a.nk, a.scale, a.dp);
  } else {
    const size_t smem = (size_t)kTile * (D + DV + 2) * sizeof(float);
    train_dkv_kernel<T, D, DV><<<dim3((a.nk + kRows - 1) / kRows, a.bh), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.nq,
        a.nk, a.scale, a.dp);
  }
  return static_cast<int>(cudaGetLastError());
}

// The head dims of ops/flash_attention.py's SUPPORTED_HEAD_DIMS, as K1 takes them.
template <typename T>
int dispatch_dims(Which which, int d, int dv, const Args& a) {
  if (d == 32 && dv == 32) return launch<T, 32, 32>(which, a);
  if (d == 64 && dv == 32) return launch<T, 64, 32>(which, a);
  if (d == 16 && dv == 16) return launch<T, 16, 16>(which, a);
  if (d == 32 && dv == 16) return launch<T, 32, 16>(which, a);
  if (d == 64 && dv == 64) return launch<T, 64, 64>(which, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(Which which, int d, int dv, int dtype, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.nq <= 0 || a.nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fod::kFloat32) return dispatch_dims<float>(which, d, dv, a);
  if (dtype == fod::kBFloat16) return dispatch_dims<__nv_bfloat16>(which, d, dv, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All tensors contiguous: q (bh, nq, d), k (bh, nk, d), v (bh, nk, dv), out and do
// (bh, nq, dv) in one storage type (dtype); lse and delta (bh, nq) f32. Dropout:
// seed, threshold (0: none), keep value and the JAX geometry nq_pad / nk_pad.
// Each returns the launch's CUDA status.
extern "C" int fod_flash_train_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int nq, int nk, int d, int dv,
                                   float scale, uint32_t seed, uint32_t threshold, float keep,
                                   int nq_pad, int nk_pad, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, bh, nq, nk, scale,
               fod::make_dropout(seed, threshold, keep, nq_pad, nk_pad),
               static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, d, dv, dtype, a);
}

extern "C" int fod_flash_train_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, int bh, int nq, int nk, int d, int dv, float scale,
                                  uint32_t seed, uint32_t threshold, float keep, int nq_pad,
                                  int nk_pad, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, nq, nk, scale,
               fod::make_dropout(seed, threshold, keep, nq_pad, nk_pad),
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, d, dv, dtype, a);
}

extern "C" int fod_flash_train_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv_out, int bh, int nq, int nk, int d,
                                   int dv, float scale, uint32_t seed, uint32_t threshold,
                                   float keep, int nq_pad, int nk_pad, int dtype,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv_out, bh, nq, nk, scale,
               fod::make_dropout(seed, threshold, keep, nq_pad, nk_pad),
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, d, dv, dtype, a);
}

// out (bh, nq, nk) f32: K7's mask value of every element (1 where threshold is 0).
extern "C" int fod_dropout_keep_mask(void* out, int bh, int nq, int nk, uint32_t seed,
                                     uint32_t threshold, float keep, int nq_pad, int nk_pad,
                                     void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t want = ((size_t)nq * nk + 255) / 256;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  keep_mask_kernel<<<dim3(blocks, bh), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), nq, nk, fod::make_dropout(seed, threshold, keep, nq_pad, nk_pad));
  return static_cast<int>(cudaGetLastError());
}
