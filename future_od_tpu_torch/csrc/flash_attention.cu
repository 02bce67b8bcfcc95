// Flash attention forward for Hopper (sm_90a) on the tensor cores:
// softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel future_od_tpu/ops/flash_attention.py::_flash_kernel
// (behind flash_attention). Same function: an online softmax over key tiles in
// base 2 (log2(e) folded into the scale), an f32 running max, f32 row sums and f32
// accumulators, output in q's storage type. The (Nq, Nk) logits never reach device
// memory.
//
// Layout. A block of 4 warps owns 64 query rows of one batch*head, 16 rows a warp,
// in the fragment layout of mma.sync (m16n8k16 for bf16, m16n8k8 for tf32). Each
// warp keeps its q fragments in registers for the whole call. The block walks the
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
// Grid: (ceil(nq / 64), batch*heads) blocks of 128 threads, 22 x 32 = 704 at the
// flagship shape. The registers set the resident blocks an SM, not the shared
// memory (20-52 KB a block of the 227 KB): bf16 d 32 at 80 registers (held there by
// __launch_bounds__, a few bytes spilled) 6, f32 d 32 at 147 registers 3 (ptxas -v
// and fod_flash_attention_info on an H100, which chip_smoke.py phase 0 prints).
#include <cstdint>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 a warp
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of 8 keys in S
constexpr int kPad = 16;              // bytes of padding after each staged row

template <typename T, int D, int DV>
struct Geometry {
  static constexpr int kRowK = D * (int)sizeof(T) + kPad;   // bytes a staged k row
  static constexpr int kRowV = DV * (int)sizeof(T) + kPad;  // bytes a staged v row
  static constexpr int kStage = kBlockK * (kRowK + kRowV);  // bytes a k + v tile
  static constexpr int kSmem = 2 * kStage;                  // double-buffered
  // Resident blocks an SM the registers must allow. The flagship grid, 704 blocks of
  // d 32, is one wave of 132 SMs at 6 an SM (792 slots) and two at 5 (660), so bf16
  // d 32 is held to 80 registers; f32 takes two waves at 3 or 4.
  static constexpr int kMinBlocks =
      std::is_same<T, float>::value ? (D <= 32 ? 3 : 2) : (D <= 32 ? 6 : 4);
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims");
};

using fod::cp_async16;
using fod::ldmatrix_x2;
using fod::ldmatrix_x4;
using fod::ldmatrix_x4_trans;
using fod::mma_3xtf32;
using fod::mma_bf16;
using fod::smem_addr;
using fod::split_tf32;

// 2^x by one MUFU.EX2. exp2f adds a range test and two multiplies to keep results
// below 2^-126 from flushing to zero; the softmax weights here lie in [0, 1] beside a
// weight of 1 a row, where such a result adds nothing to an f32 sum.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);  // .x in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a pair of bf16 (the lower column in the low half).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Copy rows k0 .. k0 + kBlockK of one (rows, width)-element array into a staged tile
// (row stride kRow bytes) in 16-byte pieces; rows past n are zero-filled. 128 is a
// multiple of the pieces a row, so each thread copies one fixed piece of every
// (kThreads / pieces)-th row, a count known at compile time.
template <typename T, int kWidth, int kRow>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, int n, int k0) {
  constexpr int kPieces = kWidth * (int)sizeof(T) / 16;  // a row
  constexpr int kRowsApart = kThreads / kPieces;
  static_assert(kThreads % kPieces == 0 && kBlockK % kRowsApart == 0, "tile copy");
  const int piece = threadIdx.x % kPieces, r0 = threadIdx.x / kPieces;
  const char* base = reinterpret_cast<const char*>(src) + piece * 16;
#pragma unroll
  for (int i = 0; i < kBlockK / kRowsApart; ++i) {
    const int r = r0 + i * kRowsApart;
    const bool real = k0 + r < n;
    cp_async16(smem_addr(dst + r * kRow + piece * 16),
               base + (size_t)(real ? k0 + r : 0) * kWidth * sizeof(T), real ? 16 : 0);
  }
}

// Stage key tile `tile` (k and v rows k0 .. k0 + kBlockK) into `stage`.
template <typename T, int D, int DV>
__device__ __forceinline__ void load_tile(unsigned char* smem, const T* kb, const T* vb,
                                          int nk, int tile, int stage) {
  using G = Geometry<T, D, DV>;
  unsigned char* ks = smem + stage * G::kStage;
  stage_rows<T, D, G::kRowK>(ks, kb, nk, tile * kBlockK);
  stage_rows<T, DV, G::kRowV>(ks + kBlockK * G::kRowK, vb, nk, tile * kBlockK);
}

// sign * q[row][col] of one batch*head as f32; 0 past nq.
template <typename T, int D>
__device__ __forceinline__ float q_at(const T* qb, int nq, int row, int col, float sign) {
  return row < nq ? sign * fod::to_float(qb[(size_t)row * D + col]) : 0.f;
}

// columns col and col + 1 of a q row as a bf16 pair
template <int D>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, int nq, int row, int col,
                                           float sign) {
  return pack_bf16(q_at<__nv_bfloat16, D>(qb, nq, row, col, sign),
                   q_at<__nv_bfloat16, D>(qb, nq, row, col + 1, sign));
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, (Geometry<T, D, DV>::kMinBlocks))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int nq, int nk,
                       float scale_log2) {
  using G = Geometry<T, D, DV>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in quad
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * DV;
  // A negative scale is folded into q (exact), so the max is taken of s * |scale|.
  const float sign = scale_log2 < 0.f ? -1.f : 1.f;
  const float c = fabsf(scale_log2);

  // q fragments, rows past nq zero. bf16: m16n8k16 A, a k-step of 16 columns.
  // f32: m16n8k8 A split into big and small, a k-step of 8 columns.
  const T* qb = q + (size_t)bh * nq * D;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  constexpr int kSteps = kF32 ? D / 8 : D / 16;
  uint32_t qa[kSteps][4], qs[kF32 ? kSteps : 1][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if constexpr (kF32) {
      const int col = 8 * ks + t;
      split_tf32(q_at<T, D>(qb, nq, r0, col, sign), qa[ks][0], qs[ks][0]);
      split_tf32(q_at<T, D>(qb, nq, r1, col, sign), qa[ks][1], qs[ks][1]);
      split_tf32(q_at<T, D>(qb, nq, r0, col + 4, sign), qa[ks][2], qs[ks][2]);
      split_tf32(q_at<T, D>(qb, nq, r1, col + 4, sign), qa[ks][3], qs[ks][3]);
    } else {
      const int col = 16 * ks + 2 * t;
      qa[ks][0] = q_pair<D>(qb, nq, r0, col, sign);
      qa[ks][1] = q_pair<D>(qb, nq, r1, col, sign);
      qa[ks][2] = q_pair<D>(qb, nq, r0, col + 8, sign);
      qa[ks][3] = q_pair<D>(qb, nq, r1, col + 8, sign);
    }
  }

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, unscaled
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only

  const int n_tiles = (nk + kBlockK - 1) / kBlockK;
  load_tile<T, D, DV>(smem, kb, vb, nk, 0, 0);
  fod::cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile<T, D, DV>(smem, kb, vb, nk, tile + 1, (tile + 1) & 1);
    fod::cp_async_commit();
    fod::cp_async_wait_one();
    __syncthreads();
    const unsigned char* ks = smem + (tile & 1) * G::kStage;
    const unsigned char* vs = ks + kBlockK * G::kRowK;

    // S = q k^T: kKeyTiles n-tiles of 8 keys. ldmatrix.x4 brings 4 16-byte
    // chunks of 8 key rows: lanes 8m..8m+7 address chunk m of rows 0..7.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const unsigned char* krow = ks + (8 * j + (lane & 7)) * G::kRowK + (lane >> 3) * 16;
#pragma unroll
      for (int ch = 0; ch < D * (int)sizeof(T) / 64; ++ch) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(krow + ch * 64));
        if constexpr (kF32) {  // 16 columns: k-steps 2ch (b0, b1) and 2ch + 1 (b2, b3)
          uint32_t bb[4], bs[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), bb[e], bs[e]);
          mma_3xtf32(s[j], qa[2 * ch], qs[2 * ch], bb[0], bb[1], bs[0], bs[1]);
          mma_3xtf32(s[j], qa[2 * ch + 1], qs[2 * ch + 1], bb[2], bb[3], bs[2], bs[3]);
        } else {  // 32 columns: k-steps 2ch and 2ch + 1
          mma_bf16(s[j], qa[2 * ch], b[0], b[1]);
          mma_bf16(s[j], qa[2 * ch + 1], b[2], b[3]);
        }
      }
      if constexpr (D * sizeof(T) % 64 != 0) {  // bf16 d 16 (or 48): one last k-step
        constexpr int ch = D * (int)sizeof(T) / 64;  // lanes 0..15 address its 2 chunks
        uint32_t b[2];
        ldmatrix_x2(b, smem_addr(krow + ch * 64));
        mma_bf16(s[j], qa[2 * ch], b[0], b[1]);
      }
    }

    // keys past nk (the last tile only) take no part in the max
    const int k0 = tile * kBlockK;
    const bool ragged = k0 + kBlockK > nk;
    if (ragged) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= nk) s[j][e] = -INFINITY;
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = row_max[h];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mx is finite: every tile holds a real key. The first tile has nothing to
      // correct (and at scale 0, -inf * 0 would be NaN).
      corr[h] = row_max[h] == -INFINITY ? 0.f : exp2_ftz((row_max[h] - mx) * c);
      row_max[h] = mx;
      row_sum[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz((s[j][e] - row_max[e >> 1]) * c);
        if (ragged && s[j][e] == -INFINITY) p = 0.f;  // a missing key, at any scale
        s[j][e] = p;
        row_sum[e >> 1] += p;
      }

    // O = O * corr + P v. The S fragment of key n-tiles 2kk, 2kk + 1 is the A
    // fragment (bf16) of key k-step kk; for tf32 each key n-tile is one k-step.
    if constexpr (kF32) {
      // The tile's P v goes to a fresh accumulator, added to O on the CUDA cores
      // (round to nearest): the tensor cores' f32 sums truncate, and one chain of
      // 24 mma a tile through every key tile lets that bias grow (see the header).
      float pv[DV / 8][4] = {};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        // A slots (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) hold keys
        // 2t, 2t, 2t + 1, 2t + 1 of the n-tile
        uint32_t pb[4], ps[4];
        split_tf32(s[j][0], pb[0], ps[0]);
        split_tf32(s[j][2], pb[1], ps[1]);
        split_tf32(s[j][1], pb[2], ps[2]);
        split_tf32(s[j][3], pb[3], ps[3]);
        const float* v0 = reinterpret_cast<const float*>(vs + (8 * j + 2 * t) * G::kRowV);
        const float* v1 = reinterpret_cast<const float*>(vs + (8 * j + 2 * t + 1) * G::kRowV);
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          uint32_t b0b, b0s, b1b, b1s;
          split_tf32(v0[8 * n + g], b0b, b0s);
          split_tf32(v1[8 * n + g], b1b, b1s);
          mma_3xtf32(pv[n], pb, ps, b0b, b1b, b0s, b1s);
        }
      }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        // ldmatrix.x4.trans: lanes 8m..8m+7 address key rows 16kk + 8(m & 1) + 0..7,
        // v chunk 2n2 + (m >> 1); b0, b1 feed v n-tile 2n2, b2, b3 n-tile 2n2 + 1
        const unsigned char* vrow =
            vs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * G::kRowV + (lane >> 4) * 16;
#pragma unroll
        for (int n2 = 0; n2 < DV / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vrow + n2 * 32));
          mma_bf16(o[2 * n2], pl, b[0], b[1]);
          mma_bf16(o[2 * n2], ph, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], pl, b[2], b[3]);
          mma_bf16(o[2 * n2 + 1], ph, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = row_sum[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[h] = 1.f / sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= nq) continue;
    T* orow = out + ((size_t)bh * nq + row) * DV + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const float x0 = o[n][2 * h] * inv[h], x1 = o[n][2 * h + 1] * inv[h];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int D, int DV>
cudaError_t prepare() {
  // above 48 KB a block's dynamic shared memory needs the opt-in (f32, d 64),
  // which is set per device: set it before every launch
  if (Geometry<T, D, DV>::kSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(flash_attention_kernel<T, D, DV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Geometry<T, D, DV>::kSmem);
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int nq, int nk,
           float scale_log2, cudaStream_t stream) {
  const cudaError_t err = prepare<T, D, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  constexpr int smem = Geometry<T, D, DV>::kSmem;
  flash_attention_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// registers, static and dynamic shared bytes, local (spill) bytes, resident blocks an SM
template <typename T, int D, int DV>
int info(int* out) {
  cudaError_t err = prepare<T, D, DV>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_attention_kernel<T, D, DV>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_attention_kernel<T, D, DV>, kThreads, Geometry<T, D, DV>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = Geometry<T, D, DV>::kSmem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}

// The instantiated (d, dv), as ops/flash_attention.py's SUPPORTED_HEAD_DIMS lists
// them: the flagship encoder's 32/32 and conditional cross-attention's concat heads
// 64/32, the same at heads of 16 (the single-frame debug config), 16/16 and 32/16,
// and an encoder's heads of 64, 64/64.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nk, int d, int dv, float scale_log2, cudaStream_t stream) {
  if (d == 32 && dv == 32) return launch<T, 32, 32>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  if (d == 64 && dv == 32) return launch<T, 64, 32>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  if (d == 16 && dv == 16) return launch<T, 16, 16>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  if (d == 32 && dv == 16) return launch<T, 32, 16>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  if (d == 64 && dv == 64) return launch<T, 64, 64>(q, k, v, out, bh, nq, nk, scale_log2, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_info(int d, int dv, int* out) {
  if (d == 32 && dv == 32) return info<T, 32, 32>(out);
  if (d == 64 && dv == 32) return info<T, 64, 32>(out);
  if (d == 16 && dv == 16) return info<T, 16, 16>(out);
  if (d == 32 && dv == 16) return info<T, 32, 16>(out);
  if (d == 64 && dv == 64) return info<T, 64, 64>(out);
  return static_cast<int>(cudaErrorInvalidValue);
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
