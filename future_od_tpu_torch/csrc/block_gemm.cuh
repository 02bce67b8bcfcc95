// The register-tiled block GEMM of the stem study's CUDA-core kernels
// (stem_variants.cu): f32 on the CUDA cores, one block of 256 threads laid out
// 16 x 16.
#pragma once

#include "common.cuh"

namespace fod {

constexpr int kGemmThreads = 256;  // 16 x 16 threads per block
constexpr int kGemmKC = 16;        // reduction slice staged per step

// Floats of shared memory block_gemm<TM, TN> stages A and B in.
template <int TM>
__host__ __device__ constexpr int gemm_stage_a() {
  return kGemmKC * (16 * TM + 1);
}
template <int TN>
__host__ __device__ constexpr int gemm_stage_b() {
  return kGemmKC * 16 * TN;
}

// acc[i][j] += sum_k A(tm + 16 i, k) * B[k][n0 + tn + 16 j] over k in [0, K),
// for tm = threadIdx.x / 16 and tn = threadIdx.x % 16. A is read through
// load_a(m, k) (rows m >= M count as zero); B is row-major with row pitch ldb.
// K must be a multiple of kGemmKC. Ends with a __syncthreads().
template <int TM, int TN, typename T, typename LoadA>
__device__ __forceinline__ void block_gemm(float (&acc)[TM][TN], const LoadA& load_a, int M,
                                           int K, const T* __restrict__ b, int ldb, int n0,
                                           float* as, float* bs) {
  constexpr int MP = 16 * TM;
  constexpr int AP = MP + 1;  // odd pitch: the transposed staging writes spread over banks
  constexpr int NT = 16 * TN;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  for (int k0 = 0; k0 < K; k0 += kGemmKC) {
    for (int i = threadIdx.x; i < MP * kGemmKC; i += kGemmThreads) {
      const int m = i / kGemmKC, kk = i % kGemmKC;
      as[kk * AP + m] = m < M ? load_a(m, k0 + kk) : 0.f;
    }
    for (int i = threadIdx.x; i < kGemmKC * NT; i += kGemmThreads) {
      const int kk = i / NT, n = i % NT;
      bs[kk * NT + n] = to_float(b[(size_t)(k0 + kk) * ldb + n0 + n]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmKC; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk * AP + tm + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = bs[kk * NT + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace fod
