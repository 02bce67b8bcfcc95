// Flash attention forward for Hopper (sm_90a): softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel future_od_tpu/ops/flash_attention.py::_flash_kernel
// (behind flash_attention). Same function: an online softmax over key tiles, base-2
// exponentials with log2(e) folded into the q scale, f32 dots and sums, output in
// q's storage type. The (Nq, Nk) logits never reach device memory.
//
// What bounds it: at the encoder's shape (B*H = 8 * images, Nq = Nk = 1400, d = dv
// = 32) the work is 2*Nq*Nk*(d+dv) operations against (3*N*d + N*dv) elements
// moved per head, so the card's arithmetic rate bounds it, not its memory. This
// first version computes on the CUDA cores in f32 (no tensor cores): one thread
// per query row holds its scaled q row, running max, running sum and f32
// accumulator in registers; the block stages 64-key tiles of K and V in shared
// memory (converted to f32 once) and every thread reads them as broadcasts. Keys
// are scored 16 at a time before one rescale of the running sums. The ragged last
// tile is zero-filled and its missing keys get a score of -inf.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys staged in shared memory per step
constexpr int kChunk = 16;   // keys scored between rescales

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kBlockQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int nq, int nk,
                       float scale_log2) {
  extern __shared__ float4 fod_smem[];
  float* ks = reinterpret_cast<float*>(fod_smem);  // [kBlockK][D]
  float* vs = ks + kBlockK * D;                     // [kBlockK][DV]

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool valid = row < nq;
  const T* qrow = q + ((size_t)bh * nq + (valid ? row : 0)) * D;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * DV;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = valid ? fod::to_float(qrow[c]) * scale_log2 : 0.f;
  float acc[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) acc[c] = 0.f;
  float row_max = -INFINITY;
  float row_sum = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    const int n = min(kBlockK, nk - k0);
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      ks[i] = (i / D) < n ? fod::to_float(kb[(size_t)k0 * D + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBlockK * DV; i += kBlockQ) {
      vs[i] = (i / DV) < n ? fod::to_float(vb[(size_t)k0 * DV + i]) : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float new_max = row_max;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (j0 + jj) * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
        s[jj] = (j0 + jj) < n ? dot : -INFINITY;
        new_max = fmaxf(new_max, s[jj]);
      }
      // new_max is finite: key j0 < n is real. exp2(-inf) = 0 covers the
      // first chunk (row_max = -inf) and the padded keys.
      const float correction = exp2f(row_max - new_max);
      row_sum *= correction;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[c] *= correction;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - new_max);
        row_sum += p;
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
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
           int nk, float scale_log2, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D, DV>;
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  const size_t smem = (size_t)kBlockK * (D + DV) * sizeof(float);
  kern<<<grid, kBlockQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nk, int d, int dv, float scale_log2, cudaStream_t stream) {
  if (d == 32 && dv == 32) return launch<T, 32, 32>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  if (d == 64 && dv == 32) return launch<T, 64, 32>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k: (bh, nq|nk, d); v: (bh, nk, dv); out: (bh, nq, dv); all contiguous, one
// storage type. scale_log2 = scale * log2(e). Returns the launch's CUDA status.
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
