// The tensor-core tile product shared by the port's Hopper kernels: cp.async
// staging, ldmatrix fragment loads and mma.sync (sm_80+ PTX, run on sm_90a), in the
// two arithmetic modes the port uses:
// - bf16 storage: m16n8k16 with the operands as stored and f32 accumulators (the
//   TPU's MXU with preferred_element_type=f32);
// - f32 storage, 3xTF32: each f32 operand x is split into big = tf32(x) and small =
//   tf32(x - big) (cvt.rna), and each product is big*small + small*big + big*big on
//   m16n8k8. That is f32 accuracy (about 2^-21 relative a product), not TF32's 2^-11.
//
// The tensor cores' f32 sums truncate (see flash_attention.cu): mma_chunk sums every
// 32 reduction rows (two bf16 k-steps, four tf32 ones) into a fresh accumulator and
// adds that to the running one on the CUDA cores, rounding to nearest. One chain
// through a long product biases every sum toward zero, so intermediates rounded to
// bf16 afterwards flip to the lower neighbour together: the fused bottleneck's
// layer1.0 output missed its bf16 tolerance on an H100 that way.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8; g = lane / 4, t = lane % 4):
// A rows g and g + 8, B column g, C rows g and g + 8 at columns 2t and 2t + 1. An
// ldmatrix.x4 over rows (lane & 15) at byte offset (lane >> 4) * 16 of a row-major
// A tile gives the bf16 A fragment of a 16 x 16 tile and, read as f32 bits, the
// tf32 A fragment of a 16 x 8 tile: both are 32 bytes of a row a k-step.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace fod {

// Bytes of an operand row that one staged chunk holds: 64 bf16 or 32 f32, four
// k-steps of 32 bytes.
constexpr int kChunkBytes = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n"); }

// Wait until no committed group is in flight.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Two f32 values as a pair of bf16 (round to nearest even), the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);  // .x in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a pair of bf16 (the lower column in the low half): an f32
// value as the A operand of two bf16 products.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 8 consecutive elements of a staged row as f32 (16-byte aligned).
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const unsigned char* p) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 16);
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower column sits in the low half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// x0, x1 into two consecutive elements (8- or 4-byte aligned), rounded to T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  }
}

// x = big + small to about 2^-22 relative, each a tf32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b as 3xTF32: the two cross terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// acc[i][j] += A_i B_j over one staged chunk (kChunkBytes of each A row, the
// matching kChunkBytes / sizeof(T) rows of B), for a warp that owns MI m16 slabs and
// NJ n8 tiles (NJ even for bf16).
// - a[i]: this lane's ldmatrix address (shared space) in slab i: its row (lane & 15)
//   at the chunk's first column, plus 16 bytes for lanes 16-31.
// - b: the chunk's first B row in shared memory at the warp's first column, row
//   pitch b_pitch bytes. Conflict-free when b_pitch / 16 is odd (bf16, ldmatrix
//   .trans) or b_pitch / 4 is 8 or 24 modulo 32 (f32, one word a lane).
// Every 32 reduction rows sum into a fresh accumulator, added to acc on the CUDA
// cores.
template <typename T, int MI, int NJ>
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][NJ][4], const uint32_t (&a)[MI],
                                          const unsigned char* b, int b_pitch) {
  constexpr int kSteps = kChunkBytes / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    float c[MI][NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t ab[MI][4], as[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t r[4];
        ldmatrix_x4(r, a[i] + ks * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ab[i][e], as[i][e]);
      }
      const float* b0 = reinterpret_cast<const float*>(b + (ks * 8 + t) * b_pitch) + g;
      const float* b1 = reinterpret_cast<const float*>(b + (ks * 8 + t + 4) * b_pitch) + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(b0[8 * j], bb0, bs0);
        split_tf32(b1[8 * j], bb1, bs1);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_3xtf32(c[i][j], ab[i], as[i], bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
  } else {
    static_assert(NJ % 2 == 0, "bf16 B fragments come two n-tiles an ldmatrix");
    // ldmatrix.x4.trans: lanes 8m..8m+7 address k rows 8(m & 1) + 0..7 at n columns
    // 8(m >> 1): b0, b1 of n-tile 2jj and b0, b1 of n-tile 2jj + 1
    const uint32_t bl = smem_addr(b) + ((lane & 7) + ((lane >> 3) & 1) * 8) * b_pitch +
                        (lane >> 4) * 16;
#pragma unroll
    for (int ks = 0; ks < kSteps; ks += 2) {  // 32 reduction rows a fresh accumulator
      uint32_t af[MI][2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldmatrix_x4(af[i][0], a[i] + ks * 32);
        ldmatrix_x4(af[i][1], a[i] + (ks + 1) * 32);
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t r0[4], r1[4];
        ldmatrix_x4_trans(r0, bl + ks * 16 * b_pitch + jj * 32);
        ldmatrix_x4_trans(r1, bl + (ks + 1) * 16 * b_pitch + jj * 32);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c0, af[i][0], r0[0], r0[1]);
          mma_bf16(c0, af[i][1], r1[0], r1[1]);
          mma_bf16(c1, af[i][0], r0[2], r0[3]);
          mma_bf16(c1, af[i][1], r1[2], r1[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * jj][e] += c0[e];
            acc[i][2 * jj + 1][e] += c1[e];
          }
        }
      }
    }
  }
}

// Double-buffered product over n_chunks staged chunks: stage(c, buf) issues the
// cp.async copies of chunk c into buffer buf (0 or 1), a_addr(c, buf, i) gives this
// lane's A address of slab i for chunk c (see mma_chunk), and chunk c's B rows sit
// at b_buf + buf * b_stage_bytes + b_col_bytes, pitch b_pitch. Every thread of the
// block calls it. On return no copy is in flight and the buffers are free.
template <typename T, int MI, int NJ, typename Stage, typename AAddr>
__device__ __forceinline__ void staged_product(float (&acc)[MI][NJ][4], int n_chunks,
                                               const Stage& stage, const AAddr& a_addr,
                                               const unsigned char* b_buf, int b_stage_bytes,
                                               int b_col_bytes, int b_pitch) {
  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) stage(c + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: the wait below then covers chunk c
    cp_async_wait_one();
    __syncthreads();
    uint32_t a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = a_addr(c, buf, i);
    mma_chunk<T, MI, NJ>(acc, a, b_buf + buf * b_stage_bytes + b_col_bytes, b_pitch);
    __syncthreads();  // the next chunk but one refills this buffer
  }
}

}  // namespace fod
