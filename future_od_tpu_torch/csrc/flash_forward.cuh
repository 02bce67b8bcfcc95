// The forward flash-attention kernel on the tensor cores, shared by K1
// (flash_attention.cu, MODE kFull) and the softmax-floor ladder T1
// (attention_floor.cu, the other modes): the same tiles, staging and products, so
// the ladder's gaps are K1's own. See flash_attention.cu for K1's design, rounding
// and bounds, and attention_floor.cu for the ladder's functions.
//
// A block of 4 warps owns 64 query rows of one batch*head, 16 rows a warp, in the
// fragment layout of mma.sync (m16n8k16 for bf16, m16n8k8 for tf32), its q fragments
// in registers for the whole call up to d 128; at d 256 (64 registers a thread of bf16
// fragments, 256 of f32's big and small parts) q is staged once in shared memory and
// each key tile ldmatrix'es its fragments, a 32-column chunk at a time. Above dv 128 a
// block owns 128 of the output's columns (grid z: the slice), so its accumulators stay
// at dv 128's; each slice recomputes the logits and the softmax, bit for bit alike.
// The block walks the keys in steps of 64-key tiles (32 for f32 at d 256, to fit the
// staged q beside two stages),
// double-buffered in shared memory by cp.async (16 bytes a copy; rows padded by 16
// bytes so that ldmatrix and the f32 v reads hit 32 distinct banks). Per tile and
// warp: S = q k^T as 16 x 64 f32 accumulators (k fragments by ldmatrix), then the
// mode's softmax on the CUDA cores, then O += P v with P taken from the S
// accumulators in registers (the C fragment of q k^T is the A fragment of P v).
//
// Modes (the floor modes' functions are ops/attention_floor.py's plain version):
//   kFull         K1: online softmax, f32 running max, one ex2 a logit, P as a hi + lo
//                 pair of bf16 (bf16 storage), keys past nk scored -inf.
//   kDots         q' = bf16(q * scale * log2 e); out = sum_j bf16(q'.k_j) v_j.
//   kUnsafe       p_j = exp2(q'.k_j) in f32, out = sum_j bf16(p_j) v_j / sum_j p_j.
//   kBf16Softmax  the online softmax with its per-element chain in bf16, rescaled once
//                 a TPU key block of block_k keys, whose max is taken before its first
//                 exponential: two passes over the block's tiles (the max, then p).
// The floor modes take nk_pad keys (nk rounded up to block_k): the keys past nk are
// the staging's zero rows, unmasked, as the TPU wrapper pads them. Their P is a bf16
// value, so bf16 storage takes one P v product a k-step, and f32 (3xTF32) two: P's
// small part is zero, and so is q's in q k^T.
#pragma once

#include <cstdint>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;    // query rows per block, 16 a warp
constexpr int kPad = 16;                // bytes of padding after each staged row
constexpr int kMaxSlice = 128;          // output columns a block at most (grid z above)

enum Mode : int { kDots = 0, kUnsafe = 1, kBf16Softmax = 2, kFull = 3 };

constexpr float kLn2Bf16 = 0.69140625f;  // bf16(ln 2), the factor jnp.exp2 uses in bf16
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D, int DV>
struct Geometry {
  // q staged in shared memory (d 256) rather than held in registers
  static constexpr bool kQSmem = D > 128;
  // keys a staged tile: f32 at d 256 takes 32 so that two stages and q fit
  static constexpr int kBlockK = std::is_same<T, float>::value && D > 128 ? 32 : 64;
  static constexpr int kKeyTiles = kBlockK / 8;             // n-tiles of 8 keys in S
  static constexpr int kSliceV = DV > kMaxSlice ? kMaxSlice : DV;  // output columns a block
  static constexpr int kSlices = DV / kSliceV;              // grid z
  static constexpr int kRowK = D * (int)sizeof(T) + kPad;   // bytes a staged k (or q) row
  static constexpr int kRowV = kSliceV * (int)sizeof(T) + kPad;  // bytes a staged v row
  static constexpr int kStage = kBlockK * (kRowK + kRowV);  // bytes a k + v tile
  static constexpr int kQBytes = kQSmem ? kBlockQ * kRowK : 0;
  static constexpr int kSmem = 2 * kStage + kQBytes;        // double-buffered, then q
  // Resident blocks an SM the registers must allow. The flagship grid, 704 blocks of
  // d 32, is one wave of 132 SMs at 6 an SM (792 slots) and two at 5 (660), so bf16
  // d 32 is held to 80 registers; f32 takes two waves at 3 or 4. Past d + dv = 128
  // (d 128) the accumulators alone take 64-128 registers: no floor is set, and ptxas
  // may take up to 255 (f32 spills there; PERF.md lists the bytes).
  static constexpr bool kWide = D + DV > 128;
  static constexpr int kMinBlocks =
      kWide ? 1 : std::is_same<T, float>::value ? (D <= 32 ? 3 : 2) : (D <= 32 ? 6 : 4);
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV % kSliceV == 0, "head dims");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

using fod::cp_async16;
using fod::ldmatrix_x2;
using fod::ldmatrix_x4;
using fod::ldmatrix_x4_trans;
using fod::mma_3xtf32;
using fod::mma_bf16;
using fod::mma_tf32;
using fod::pack_bf16;
using fod::smem_addr;
using fod::split_bf16;
using fod::split_tf32;

// One call's arguments. nk_pad and block_k are the floor modes' (K1 takes nk keys).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int nq, nk, nk_pad, block_k;
  float scale_log2;  // scale * log2(e)
};

// 2^x by one MUFU.EX2. exp2f adds a range test and two multiplies to keep results
// below 2^-126 from flushing to zero; the softmax weights here lie in [0, 1] beside a
// weight of 1 a row, where such a result adds nothing to an f32 sum.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16r(float x) { return fod::round_to<__nv_bfloat16>(x); }

// Copy rows k0 .. k0 + kRows of one array (kLd elements a row) into a staged tile (kWidth
// elements of each row from src, row stride kRow bytes) in 16-byte pieces; rows past n
// are zero-filled. 128 is a multiple of the pieces a row, so each thread copies one
// fixed piece of every (kThreads / pieces)-th row, a count known at compile time.
template <typename T, int kWidth, int kRow, int kRows, int kLd = kWidth>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, int n, int k0) {
  constexpr int kPieces = kWidth * (int)sizeof(T) / 16;  // a row
  constexpr int kRowsApart = kThreads / kPieces;
  static_assert(kThreads % kPieces == 0 && kRows % kRowsApart == 0, "tile copy");
  const int piece = threadIdx.x % kPieces, r0 = threadIdx.x / kPieces;
  const char* base = reinterpret_cast<const char*>(src) + piece * 16;
#pragma unroll
  for (int i = 0; i < kRows / kRowsApart; ++i) {
    const int r = r0 + i * kRowsApart;
    const bool real = k0 + r < n;
    cp_async16(smem_addr(dst + r * kRow + piece * 16),
               base + (size_t)(real ? k0 + r : 0) * kLd * sizeof(T), real ? 16 : 0);
  }
}

// Stage the key tile from key k0 (k rows, and v rows unless with_v is false) into
// `stage`; vb points at the block's slice of v's columns.
template <typename T, int D, int DV>
__device__ __forceinline__ void load_tile(unsigned char* smem, const T* kb, const T* vb,
                                          int nk, int k0, int stage, bool with_v) {
  using G = Geometry<T, D, DV>;
  unsigned char* ks = smem + stage * G::kStage;
  stage_rows<T, D, G::kRowK, G::kBlockK>(ks, kb, nk, k0);
  if (with_v)
    stage_rows<T, G::kSliceV, G::kRowV, G::kBlockK, DV>(ks + G::kBlockK * G::kRowK, vb, nk, k0);
}

// q[row][col] of one batch*head times mul as f32, rounded to bf16 when kRound (the
// floor modes' q'); 0 past nq.
template <typename T, int D, bool kRound>
__device__ __forceinline__ float q_at(const T* qb, int nq, int row, int col, float mul) {
  if (row >= nq) return 0.f;
  const float x = mul * fod::to_float(qb[(size_t)row * D + col]);
  return kRound ? bf16r(x) : x;
}

// columns col and col + 1 of a q row as a bf16 pair
template <int D, bool kRound>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, int nq, int row, int col,
                                           float mul) {
  return pack_bf16(q_at<__nv_bfloat16, D, kRound>(qb, nq, row, col, mul),
                   q_at<__nv_bfloat16, D, kRound>(qb, nq, row, col + 1, mul));
}

// The walk over the keys as steps of one tile of kTile keys each: K1, kDots and kUnsafe
// take one pass over [0, end); kBf16Softmax two passes over each TPU block of block_k keys.
template <int kTile>
struct Walk {
  int end, per_pass, steps;
  bool two_pass;

  __device__ __forceinline__ Walk(int mode, int nk, int nk_pad, int block_k) {
    two_pass = mode == kBf16Softmax;
    end = mode == kFull ? nk : nk_pad;
    per_pass = ((two_pass ? block_k : end) + kTile - 1) / kTile;
    steps = two_pass ? (nk_pad / block_k) * 2 * per_pass : per_pass;
  }
  // the step's first key, its keys' end (exclusive), and its pass (0 or 1)
  __device__ __forceinline__ void at(int step, int block_k, int& k0, int& k1, int& pass) const {
    if (!two_pass) {
      k0 = step * kTile, k1 = end, pass = 1;
      return;
    }
    const int blk = step / (2 * per_pass), r = step % (2 * per_pass);
    pass = r / per_pass;
    k0 = blk * block_k + (r % per_pass) * kTile;
    k1 = (blk + 1) * block_k;
  }
};

template <typename T, int D, int DV, int MODE>
__global__ void __launch_bounds__(kThreads, (Geometry<T, D, DV>::kMinBlocks))
flash_attention_kernel(const Args<T> a) {
  using G = Geometry<T, D, DV>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kFloor = MODE != kFull;
  constexpr int kBlockK = G::kBlockK, kKeyTiles = G::kKeyTiles, kSliceV = G::kSliceV;
  static_assert(!(kFloor && G::kQSmem), "the floor modes keep q in registers");
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.y, slice = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in quad
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const int nq = a.nq, nk = a.nk;
  const T* kb = a.k + (size_t)bh * nk * D;
  const T* vb = a.v + (size_t)bh * nk * DV + slice * kSliceV;
  // K1: a negative scale is folded into q (exact), so the max is taken of s * |scale|.
  // The floor modes: q' = bf16(q * scale * log2 e), the logits already in log2 units.
  const float c = fabsf(a.scale_log2);
  const float mul = kFloor ? a.scale_log2 : (a.scale_log2 < 0.f ? -1.f : 1.f);

  // q fragments, rows past nq zero. bf16: m16n8k16 A, a k-step of 16 columns.
  // f32: m16n8k8 A split into big and small (small is zero in the floor modes), a
  // k-step of 8 columns.
  const T* qb = a.q + (size_t)bh * nq * D;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  constexpr int kSteps = kF32 ? D / 8 : D / 16;
  uint32_t qa[kSteps][4], qs[kF32 && !kFloor ? kSteps : 1][4];  // unused at d 256
  // d 256: the block's q rows times mul (+-1: exact) in the storage type, once
  unsigned char* qsm = smem + 2 * G::kStage;
  if constexpr (G::kQSmem) {
    const int qrow0 = blockIdx.x * kBlockQ;
    for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
      const int r = i / D, col = i % D;
      reinterpret_cast<T*>(qsm + r * G::kRowK)[col] =
          fod::from_float<T>(q_at<T, D, false>(qb, nq, qrow0 + r, col, mul));
    }
  }
#pragma unroll
  for (int ks = 0; ks < (G::kQSmem ? 0 : kSteps); ++ks) {
    if constexpr (kF32) {
      const int col = 8 * ks + t;
      const float x[4] = {q_at<T, D, kFloor>(qb, nq, r0, col, mul),
                          q_at<T, D, kFloor>(qb, nq, r1, col, mul),
                          q_at<T, D, kFloor>(qb, nq, r0, col + 4, mul),
                          q_at<T, D, kFloor>(qb, nq, r1, col + 4, mul)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kFloor) {
          qa[ks][e] = fod::to_tf32(x[e]);  // a bf16 value: exact in tf32
        } else {
          split_tf32(x[e], qa[ks][e], qs[ks][e]);
        }
      }
    } else {
      const int col = 16 * ks + 2 * t;
      qa[ks][0] = q_pair<D, kFloor>(qb, nq, r0, col, mul);
      qa[ks][1] = q_pair<D, kFloor>(qb, nq, r1, col, mul);
      qa[ks][2] = q_pair<D, kFloor>(qb, nq, r0, col + 8, mul);
      qa[ks][3] = q_pair<D, kFloor>(qb, nq, r1, col + 8, mul);
    }
  }

  float o[kSliceV / 8][4];
#pragma unroll
  for (int n = 0; n < kSliceV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8: K1's running max (unscaled), kBf16Softmax's (bf16, log2 units)
  float row_max[2];
  row_max[0] = row_max[1] = MODE == kBf16Softmax ? bf16r(-30000.f) : -INFINITY;
  float row_sum[2] = {0.f, 0.f};  // this thread's columns only (kBf16Softmax: the row's)
  float blk[2] = {-INFINITY, -INFINITY};  // kBf16Softmax: the block's max, then its sum

  const Walk<kBlockK> walk(MODE, nk, a.nk_pad, a.block_k);
  int k0, k1, pass;
  walk.at(0, a.block_k, k0, k1, pass);
  load_tile<T, D, DV>(smem, kb, vb, nk, k0, 0, pass == 1);
  fod::cp_async_commit();
  for (int step = 0; step < walk.steps; ++step) {
    if (step + 1 < walk.steps) {
      int n0, n1, np;
      walk.at(step + 1, a.block_k, n0, n1, np);
      load_tile<T, D, DV>(smem, kb, vb, nk, n0, (step + 1) & 1, np == 1);
    }
    fod::cp_async_commit();
    fod::cp_async_wait_one();
    __syncthreads();
    walk.at(step, a.block_k, k0, k1, pass);
    const unsigned char* ks = smem + (step & 1) * G::kStage;
    const unsigned char* vs = ks + kBlockK * G::kRowK;

    // S = q k^T: kKeyTiles n-tiles of 8 keys. ldmatrix.x4 brings 4 16-byte
    // chunks of 8 key rows: lanes 8m..8m+7 address chunk m of rows 0..7.
    float s[kKeyTiles][4];
    if constexpr (G::kQSmem) {
      // q's fragments of two k-steps a 64-byte chunk by ldmatrix (row lane & 15, 16 bytes
      // on for lanes 16-31: the bf16 A fragment of 16 columns, or read as f32 bits the
      // tf32 one of 8), then every key n-tile's: the same chain a logit as held fragments
      const uint32_t qrow = smem_addr(qsm + (warp * 16 + (lane & 15)) * G::kRowK + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
      for (int ch = 0; ch < D * (int)sizeof(T) / 64; ++ch) {
        uint32_t qf[2][4], qsf[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ldmatrix_x4(qf[h], qrow + ch * 64 + h * 32);
          if constexpr (kF32) {
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(qf[h][e]), qf[h][e], qsf[h][e]);
          }
        }
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(ks + (8 * j + (lane & 7)) * G::kRowK + (lane >> 3) * 16 + ch * 64));
          if constexpr (kF32) {
            uint32_t bb[4], bs[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), bb[e], bs[e]);
            mma_3xtf32(s[j], qf[0], qsf[0], bb[0], bb[1], bs[0], bs[1]);
            mma_3xtf32(s[j], qf[1], qsf[1], bb[2], bb[3], bs[2], bs[3]);
          } else {
            mma_bf16(s[j], qf[0], b[0], b[1]);
            mma_bf16(s[j], qf[1], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < (G::kQSmem ? 0 : kKeyTiles); ++j) {
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
          if constexpr (kFloor) {  // q' is a bf16 value: its small part is zero
            mma_tf32(s[j], qa[2 * ch], bs[0], bs[1]);
            mma_tf32(s[j], qa[2 * ch], bb[0], bb[1]);
            mma_tf32(s[j], qa[2 * ch + 1], bs[2], bs[3]);
            mma_tf32(s[j], qa[2 * ch + 1], bb[2], bb[3]);
          } else {
            mma_3xtf32(s[j], qa[2 * ch], qs[2 * ch], bb[0], bb[1], bs[0], bs[1]);
            mma_3xtf32(s[j], qa[2 * ch + 1], qs[2 * ch + 1], bb[2], bb[3], bs[2], bs[3]);
          }
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

    // keys at or past k1 (the last tile of a pass only) take no part
    const bool ragged = k0 + kBlockK > k1;
    float corr[2] = {1.f, 1.f};
    if constexpr (MODE == kFull) {
      if (ragged) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= k1) s[j][e] = -INFINITY;
      }
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
    } else if constexpr (MODE == kBf16Softmax) {
      if (pass == 0) {  // the block's max logit (bf16 rounding is monotone)
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!ragged || k0 + 8 * j + 2 * t + (e & 1) < k1)
              blk[e >> 1] = fmaxf(blk[e >> 1], s[j][e]);
        if (k0 + kBlockK >= k1) {  // the block's last tile: rescale once
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = blk[h];
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float new_max = fmaxf(row_max[h], bf16r(mx));
            corr[h] = exp2f(bf16r(row_max[h] - new_max));
            row_max[h] = new_max;
            row_sum[h] *= corr[h];
            blk[h] = 0.f;  // now the block's sum of p
          }
#pragma unroll
          for (int n = 0; n < kSliceV / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
        }
        __syncthreads();  // the next iteration refills this stage
        continue;
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = bf16r(bf16r(s[j][e]) - row_max[e >> 1]);
          float p = bf16r(exp2f(bf16r(kLn2Bf16 * d) * kLog2e));
          if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= k1) p = 0.f;
          blk[e >> 1] += p;
          s[j][e] = p;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = !ragged || k0 + 8 * j + 2 * t + (e & 1) < k1;
          if constexpr (MODE == kDots) {
            s[j][e] = real ? bf16r(s[j][e]) : 0.f;
          } else {  // kUnsafe
            const float p = real ? exp2f(s[j][e]) : 0.f;
            row_sum[e >> 1] += p;
            s[j][e] = bf16r(p);
          }
        }
    }

    // O = O * corr + P v. The S fragment of key n-tiles 2kk, 2kk + 1 is the A
    // fragment (bf16) of key k-step kk; for tf32 each key n-tile is one k-step.
    if constexpr (kF32) {
      // The tile's P v goes to a fresh accumulator, added to O on the CUDA cores
      // (round to nearest): the tensor cores' f32 sums truncate, and one chain of
      // 24 mma a tile through every key tile lets that bias grow (flash_attention.cu).
      float pv[kSliceV / 8][4] = {};
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
        for (int n = 0; n < kSliceV / 8; ++n) {
          uint32_t b0b, b0s, b1b, b1s;
          split_tf32(v0[8 * n + g], b0b, b0s);
          split_tf32(v1[8 * n + g], b1b, b1s);
          if constexpr (kFloor) {  // P is a bf16 value: its small part is zero
            mma_tf32(pv[n], pb, b0s, b1s);
            mma_tf32(pv[n], pb, b0b, b1b);
          } else {
            mma_3xtf32(pv[n], pb, ps, b0b, b1b, b0s, b1s);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kSliceV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    } else {
      if constexpr (MODE == kFull) {
#pragma unroll
        for (int n = 0; n < kSliceV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      }
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        uint32_t ph[4], pl[4];
        if constexpr (kFloor) {  // P is a bf16 value: hi alone
          ph[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          ph[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          ph[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          ph[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        } else {
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        }
        // ldmatrix.x4.trans: lanes 8m..8m+7 address key rows 16kk + 8(m & 1) + 0..7,
        // v chunk 2n2 + (m >> 1); b0, b1 feed v n-tile 2n2, b2, b3 n-tile 2n2 + 1
        const unsigned char* vrow =
            vs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * G::kRowV + (lane >> 4) * 16;
#pragma unroll
        for (int n2 = 0; n2 < kSliceV / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vrow + n2 * 32));
          if constexpr (!kFloor) mma_bf16(o[2 * n2], pl, b[0], b[1]);
          mma_bf16(o[2 * n2], ph, b[0], b[1]);
          if constexpr (!kFloor) mma_bf16(o[2 * n2 + 1], pl, b[2], b[3]);
          mma_bf16(o[2 * n2 + 1], ph, b[2], b[3]);
        }
      }
    }
    if constexpr (MODE == kBf16Softmax) {
      if (k0 + kBlockK >= k1) {  // the block's last tile: its sum of p, rounded to bf16
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sum = blk[h];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          row_sum[h] += bf16r(sum);
          blk[h] = -INFINITY;  // the next block's max
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = row_sum[h];
    if constexpr (MODE != kBf16Softmax) {  // per thread until now
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    }
    inv[h] = MODE == kDots ? 1.f : 1.f / sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= nq) continue;
    T* orow = a.out + ((size_t)bh * nq + row) * DV + slice * kSliceV + 2 * t;
#pragma unroll
    for (int n = 0; n < kSliceV / 8; ++n) {
      const float x0 = o[n][2 * h] * inv[h], x1 = o[n][2 * h + 1] * inv[h];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int D, int DV, int MODE>
cudaError_t prepare() {
  // above 48 KB a block's dynamic shared memory needs the opt-in (f32, d 64 and up),
  // which is set per device: set it before every launch
  if (Geometry<T, D, DV>::kSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(flash_attention_kernel<T, D, DV, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Geometry<T, D, DV>::kSmem);
}

template <typename T, int D, int DV, int MODE>
int launch(const Args<T>& a, int bh, cudaStream_t stream) {
  const cudaError_t err = prepare<T, D, DV, MODE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nq + kBlockQ - 1) / kBlockQ, bh, Geometry<T, D, DV>::kSlices);
  flash_attention_kernel<T, D, DV, MODE>
      <<<grid, kThreads, Geometry<T, D, DV>::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// registers, static and dynamic shared bytes, local (spill) bytes, resident blocks an SM
template <typename T, int D, int DV, int MODE>
int info(int* out) {
  cudaError_t err = prepare<T, D, DV, MODE>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_attention_kernel<T, D, DV, MODE>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_attention_kernel<T, D, DV, MODE>, kThreads, Geometry<T, D, DV>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = Geometry<T, D, DV>::kSmem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}

}  // namespace
