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
// Operands. Every kernel reads q, k, v and do, and writes its outputs, by (batch, head,
// row) strides with a contiguous last dim (TrainArgs), so the (B, N, H, d) layout that
// models/layers.py::attend_heads holds goes in and out without a copy; lse and delta
// are (B, H, Nq) f32 by strides too. ops/flash_attention.py packs the arguments into
// one TrainArgs a call (a ctypes call costs about as much per argument as the rest of
// the wrapper).
//
// The logits. All three kernels compute every logit the same way, bit for bit: fmaf
// over c = 0..d-1 of (q[c] * scale) * k[c], in f32 and natural-log units, and lse is
// max + log(rowsum) of those logits. The backward's p = exp(logit - lse) is then at
// most 1 whatever the logits' size, because lse >= the row's max logit. A recompute
// that rounds otherwise (other units, the scale applied after the product, another
// summation order) puts the exponent off by a few ulps of the logit: at logits of
// 1e6-1e7, which a randomly initialised backbone reaches within a few training steps,
// p came out as large as 2^16 and the step's gradient was no longer finite. All three
// keep that chain on the CUDA cores: each lane computes the logits at its own positions
// of an mma C fragment, each as that sequential chain (`logits`; K6 with keys as the
// fragment's rows). fmaf's product is exact, so the order of its two factors does not
// matter; the order over c does.
//
// K4 and K5 (redesigned for the tensor cores). A block of 4 warps; each warp owns a
// 16-row query slab in the mma fragment layout (rows g and g + 8 of lane (g, t), keys
// 2t and 2t + 1 of each 8-key n-tile). The block stages 64-key tiles of k and v in
// shared memory, double-buffered by cp.async (16 bytes a copy, rows padded by 16 bytes:
// the lane reads of the logits, ldmatrix and the f32 row reads all hit distinct banks),
// and its q rows once, as f32 * scale. Keys past nk are zero-filled and masked. When a
// grid of 64-row blocks would give fewer than two blocks an SM (the decoder's 128
// queries x 32 batch*heads: 64 blocks on 132 SMs) the warps of a block share one slab,
// 2 or 4 of them, and split each tile's keys (`split_for`); at the end the block merges
// their (max, sum, out) for K4 and sums their dq for K5 in shared memory. A warp walks
// its keys of a tile in passes of 32 (16 at split 4):
// - K4: the logits; the online softmax (quad shuffles for the row max; exp as __expf,
//   one ex2.approx, whose exp(0) is exactly 1, so lse >= max still holds; the sum
//   before dropout); then P v on the tensor cores, P taken from the logits' registers
//   (the C fragment of the logits is the A fragment of P v; for tf32 the two keys of a
//   lane go to k slots t and t + 4, with v's rows read to match).
// - K5: the logits; dS = do v^T on the tensor cores (do's A fragments held in registers
//   for the whole call, v's B fragments by ldmatrix); dlogits = p (dS mask - delta) on
//   the CUDA cores (p by expf, as K6 takes it: at most 1 for logit <= lse); then
//   dq += dlogits k on the tensor cores, dlogits from registers.
// Rounding: f32 products as 3xTF32 (mma_tile.cuh: f32 accuracy, about 2^-21 relative a
// product); bf16 operands as stored, with P and dlogits, which are f32 values, as a
// hi + lo pair of bf16 (K1's design). The tensor cores' f32 sums truncate, so every
// product starts a fresh accumulator each pass (32 keys of P v and dq; 32 columns of
// dS) that is added to the running one on the CUDA cores, rounding to nearest
// (tests/test_torch_flash_train_tc_rounding.py emulates this on the CPU).
//
// What bounds K4 and K5 (the stage-1 train step, 18 calls each): the logits' chains,
// 5.21 GFLOP a step for each kernel on the CUDA cores, 0.078 ms at 67 TFLOP/s; the
// tensor-core products (K4 P v, K5 dS and dq) as 3xTF32 0.025 and 0.056 ms. So the
// CUDA cores' logits set this design's floor (K6's too: its products as 3xTF32 take
// 0.081 ms a step); moving the logits onto the tensor cores would change all three
// kernels together (ROADMAP Queue 2, deferred). On an H100 80GB HBM3 at 700 W,
// f32, dropout 0.1 (chip_smoke.py phase 1b, device time): K4 57 us a call at the
// encoder's shape (122 registers, 4 blocks an SM, split 1) and 25 at the decoder's
// (split 4), K5 68-74 and 29. The time goes to latency at 8-12 warps an SM rather than
// to one unit: in builds of this file without one piece of work each, dropping the
// logits' shared-memory loads changed nothing, while dropping the logits or P v each
// took a large share.
//
// K6 (redesigned for the tensor cores, see train_dkv_kernel): K5 mirrored, each warp
// owning a 16-key slab and walking 64-query tiles staged by cp.async; dS^T, dv and dk on
// the tensor cores, the logits on the CUDA cores as above. The block owns its dk/dv
// rows, so no atomics are needed. The (Nq, Nk) probabilities never reach device memory
// in any kernel.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dropout_mask.cuh"
#include "mma_tile.cuh"

namespace {

using fod::cp_async16;
using fod::ldmatrix_x2;
using fod::ldmatrix_x4;
using fod::ldmatrix_x4_trans;
using fod::load8;
using fod::mma_3xtf32;
using fod::mma_bf16;
using fod::pack_bf16;
using fod::smem_addr;
using fod::split_bf16;
using fod::split_tf32;
using fod::store2;

// A (batch, head, row, column) operand: element strides of the first three, the last
// contiguous.
struct Operand {
  void* ptr;
  long long sb, sh, sn;
};

// One call's arguments, as ops/flash_attention.py::_TRAIN_ARGS packs them.
struct TrainArgs {
  Operand q, k, v, dout;
  Operand o0, o1;  // out, dq, or dk and dv
  Operand lse, delta;  // (batch, head, row) f32; a row has one column
  void* stream;
  int b, h, nq, nk, d, dv, dtype;
  float scale;
  uint32_t seed, threshold;  // dropout: threshold 0 is none
  float keep;
  int nq_pad, nk_pad;  // the JAX kernels' padded geometry, which the mask hashes
  int h_local, h_full, h0;  // the call's heads among the layer's (dropout_mask.cuh)
};
static_assert(offsetof(TrainArgs, nk_pad) == 312, "ops/flash_attention.py::_TRAIN_ARGS");
static_assert(offsetof(TrainArgs, h0) == 324, "ops/flash_attention.py::_TRAIN_ARGS");
static_assert(sizeof(TrainArgs) == 328, "ops/flash_attention.py::_TRAIN_ARGS");

template <typename T>
__device__ __forceinline__ T* at(const Operand& o, int b, int h, int n) {
  return static_cast<T*>(o.ptr) + (b * o.sb + h * o.sh + n * o.sn);
}

// ---------------------------------------------------------------------------
// K4 and K5
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileK = 64;              // keys a staged tile (32 at d 256: Geometry::kTile)
constexpr int kPassN = 4;               // n-tiles a warp takes a pass: 32 keys
constexpr int kPad = 16;                // bytes of padding after each staged row
constexpr int kMaxRows = 16 * kWarps;   // query rows a block at split 1
constexpr int kMaxSlice = 128;          // output columns a block at d 256 (grid z)

// The tiles of K4-K6 at head dims (D, DV). Up to d 128 a block stages 64-key (K6:
// 64-query) tiles and owns all of its rows' output columns. At d 256 (ROADMAP Queue 3's
// remedy) the tiles take 32 rows so that two stages fit beside the staged q; a block owns
// 128 output columns (a grid z of slices: K4 out's, K5 dq's, K6 dk's then dv's), so its
// accumulators stay at d 128's, and every slice recomputes the logits bit for bit alike;
// K5 stages its do rows in shared memory (v_dot) rather than holding 64-256 registers of
// fragments; and at f32 256/256 K5 and K6 take 32 rows a block (split >= 2).
template <typename T, int D, int DV>
struct Geometry {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kSliced = D > 128;
  static constexpr int kTile = kSliced ? 32 : kTileK;       // keys (K6: queries) a tile
  static constexpr int kTileN = kTile / 8;                  // n-tiles of 8 in a tile
  // a warp takes kTileN / split n-tiles of a tile: at least 1, and an even count in bf16
  // (its products take keys two n-tiles a k-step)
  static constexpr int kSplitCap = kF32 ? kTileN : kTileN / 2;
  static constexpr int kMaxSplit = kSplitCap < kWarps ? kSplitCap : kWarps;
  static constexpr int kMinSplitGrad = kF32 && D + DV > 384 ? 2 : 1;  // K5, K6
  static constexpr int kSliceD = kSliced ? kMaxSlice : D;   // dq, dk columns a block
  static constexpr int kSliceV = DV > kMaxSlice ? kMaxSlice : DV;  // out, dv columns a block
  static constexpr int kRowK = D * (int)sizeof(T) + kPad;   // bytes a staged k row
  static constexpr int kRowV = DV * (int)sizeof(T) + kPad;  // bytes a staged v (do) row
  static constexpr int kRowVS = kSliceV * (int)sizeof(T) + kPad;  // K4's v slice row
  static constexpr int kStageFwd = kTile * (kRowK + kRowVS);  // bytes a k + v tile, K4
  static constexpr int kStage = kTile * (kRowK + kRowV);      // bytes a k + v tile, K5
  static constexpr int kRowQ = D + kPad / 4;                // floats a staged q row
  static constexpr int kRowsGrad = kMaxRows / kMinSplitGrad;  // K5's rows a block at most
  static constexpr int kSmemFwd = 2 * kStageFwd + kMaxRows * kRowQ * 4;
  static constexpr int kSmem =
      2 * kStage + kRowsGrad * kRowQ * 4 + (kSliced ? kRowsGrad * kRowV : 0);
  static_assert(D % 16 == 0 && DV % 16 == 0 && D % kSliceD == 0 && DV % kSliceV == 0,
                "head dims");
  static_assert(kSmem <= 232448 && kSmemFwd <= 232448, "a block's shared memory");
  // Past d + dv = 128 (d 128) the accumulators alone take 64-128 registers a thread: no
  // resident-block floor is set there, and ptxas may take up to 255 (PERF.md lists the
  // spills of those instantiations).
  static constexpr bool kWide = D + DV > 128;
  static constexpr int kMinBlocksFwd = kWide ? 1 : 3;
  static constexpr int kMinBlocksGrad = kWide ? 1 : 2;
  // the split's merge reuses the two stages: a value a lane, kWarps x 32 lanes
  static constexpr int kMergeVals = (kSliceD > kSliceV ? kSliceD : kSliceV) / 2 + 4;
  static_assert(kWarps * 32 * kMergeVals * 4 <= 2 * (kStageFwd < kStage ? kStageFwd : kStage),
                "merge scratch");
};

// Copy rows r0 .. r0 + kRows of one (rows, kWidth)-element operand (row stride sn
// elements) into a staged tile (row pitch kRow bytes) in 16-byte pieces; rows past n
// are zero-filled.
template <typename T, int kWidth, int kRow, int kRows = kTileK>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, long long sn, int n,
                                           int r0) {
  constexpr int kPieces = kWidth * (int)sizeof(T) / 16;  // a row
  constexpr int kRowsApart = kThreads / kPieces;
  static_assert(kThreads % kPieces == 0 && kRows % kRowsApart == 0, "tile copy");
  const int piece = threadIdx.x % kPieces, r = threadIdx.x / kPieces;
#pragma unroll
  for (int i = 0; i < kRows / kRowsApart; ++i) {
    const int row = r + i * kRowsApart;
    const bool real = r0 + row < n;
    cp_async16(smem_addr(dst + row * kRow + piece * 16),
               src + (real ? r0 + row : 0) * sn + piece * (16 / (int)sizeof(T)), real ? 16 : 0);
  }
}

// Key tile `tile` (k rows, and kVW columns of v's rows from vb) into stage buf of
// kStage bytes.
template <typename T, int D, int DV, int kVW, int kRowV, int kStage>
__device__ __forceinline__ void load_tile(unsigned char* smem, const TrainArgs& a, const T* kb,
                                          const T* vb, int tile, int buf) {
  using G = Geometry<T, D, DV>;
  unsigned char* ks = smem + buf * kStage;
  stage_rows<T, D, G::kRowK, G::kTile>(ks, kb, a.k.sn, a.nk, tile * G::kTile);
  stage_rows<T, kVW, kRowV, G::kTile>(ks + G::kTile * G::kRowK, vb, a.v.sn, a.nk, tile * G::kTile);
}

// Rows row_base .. row_base + rows of a (rows, W)-element operand (row stride sn) as f32
// times mul into dst (row pitch W + kPad / 4 floats), 0 past n: K4's and K5's q rows times
// scale (the rounding every kernel here takes), K6's k rows as they are.
template <typename T, int W>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long sn, int n,
                                          int row_base, int rows, float mul) {
  constexpr int kRow = W + kPad / 4;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W, c = i % W, row = row_base + r;
    dst[r * kRow + c] = row < n ? fod::to_float(src[row * sn + c]) * mul : 0.f;
  }
}

// s[jn][e], jn < np: the logit of q row (g + 8 (e >> 1)) of the warp's slab (q0, q1:
// its rows g and g + 8, f32 * scale) and key 8 (jb + jn) + 2t + (e & 1) of the staged
// tile ks, each the sequential fmaf chain over c = 0 .. D - 1 that all three kernels
// take (see the header): bit-equal across the three kernels.
template <typename T, int D, int kRowK>
__device__ __forceinline__ void logits(float (&s)[kPassN][4], const float* q0, const float* q1,
                                       const unsigned char* ks, int jb, int np, int t) {
#pragma unroll
  for (int jn = 0; jn < kPassN; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 8) {
    float qa[8], qb[8];
    load8<float>(qa, reinterpret_cast<const unsigned char*>(q0 + c));
    load8<float>(qb, reinterpret_cast<const unsigned char*>(q1 + c));
#pragma unroll
    for (int jn = 0; jn < kPassN; ++jn) {
      if (jn < np) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float kv[8];
          load8<T>(kv, ks + (8 * (jb + jn) + 2 * t + e) * kRowK + c * (int)sizeof(T));
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) {
            s[jn][e] = fmaf(qa[cc], kv[cc], s[jn][e]);
            s[jn][2 + e] = fmaf(qb[cc], kv[cc], s[jn][2 + e]);
          }
        }
      }
    }
  }
}

// acc += A B over one pass, into a fresh accumulator added to acc on the CUDA cores. A
// is the pass's s (C layout: rows g, g + 8 x keys 8 (jb + jn) + 2t, + 1; f32 values),
// B the staged rows (a key each, W columns, pitch kRow bytes) of those keys: P v in K4,
// dlogits k in K5. f32: 3xTF32 on m16n8k8, the lane's two keys in k slots t and t + 4
// with B's rows read to match. bf16: A as a hi + lo pair of bf16 (two products a
// k-step of 16 keys), B by ldmatrix.trans as stored.
template <typename T, int W, int kRow>
__device__ __forceinline__ void product(float (&acc)[W / 8][4], const float (&s)[kPassN][4],
                                        int np, const unsigned char* rows, int jb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float c[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int jn = 0; jn < kPassN; ++jn) {
      if (jn < np) {
        // A slots (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) hold keys 2t,
        // 2t, 2t + 1, 2t + 1 of the n-tile
        uint32_t ab[4], as[4];
        split_tf32(s[jn][0], ab[0], as[0]);
        split_tf32(s[jn][2], ab[1], as[1]);
        split_tf32(s[jn][1], ab[2], as[2]);
        split_tf32(s[jn][3], ab[3], as[3]);
        const float* r0 = reinterpret_cast<const float*>(rows + (8 * (jb + jn) + 2 * t) * kRow);
        const float* r1 = reinterpret_cast<const float*>(rows + (8 * (jb + jn) + 2 * t + 1) * kRow);
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          uint32_t b0b, b0s, b1b, b1s;
          split_tf32(r0[8 * n + g], b0b, b0s);
          split_tf32(r1[8 * n + g], b1b, b1s);
          mma_3xtf32(c[n], ab, as, b0b, b1b, b0s, b1s);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kPassN / 2; ++kk) {
      if (2 * kk < np) {  // np is even
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        // ldmatrix.x4.trans: lanes 8m..8m+7 address key rows 8 (jb + 2kk) + 8 (m & 1) +
        // 0..7 at column chunk 2 n2 + (m >> 1): b0, b1 of n-tile 2 n2, b2, b3 of 2 n2 + 1
        const unsigned char* r =
            rows + (8 * (jb + 2 * kk) + 8 * ((lane >> 3) & 1) + (lane & 7)) * kRow +
            (lane >> 4) * 16;
#pragma unroll
        for (int n2 = 0; n2 < W / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(r + n2 * 32));
          mma_bf16(c[2 * n2], pl, b[0], b[1]);
          mma_bf16(c[2 * n2], ph, b[0], b[1]);
          mma_bf16(c[2 * n2 + 1], pl, b[2], b[3]);
          mma_bf16(c[2 * n2 + 1], ph, b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[n][e];
}

// K5's do fragments, the A operand of dS = do v^T, held for the whole call: rows g and
// g + 8 of the warp's slab (0 past nq). f32: m16n8k8 tf32, split into big and small;
// bf16: m16n8k16 as stored.
template <typename T, int DV>
struct DoFragments {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kSteps = kF32 ? DV / 8 : DV / 16;
  uint32_t big[kSteps][4];
  uint32_t small[kF32 ? kSteps : 1][4];

  __device__ __forceinline__ void load(const TrainArgs& a, int b, int h, int row0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* rows[2] = {at<T>(a.dout, b, h, row0 + g), at<T>(a.dout, b, h, row0 + g + 8)};
    const bool real[2] = {row0 + g < a.nq, row0 + g + 8 < a.nq};
    auto x = [&](int r, int col) { return real[r] ? fod::to_float(rows[r][col]) : 0.f; };
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (kF32) {
        const int col = 8 * ks + t;
        split_tf32(x(0, col), big[ks][0], small[ks][0]);
        split_tf32(x(1, col), big[ks][1], small[ks][1]);
        split_tf32(x(0, col + 4), big[ks][2], small[ks][2]);
        split_tf32(x(1, col + 4), big[ks][3], small[ks][3]);
      } else {
        const int col = 16 * ks + 2 * t;
        big[ks][0] = pack_bf16(x(0, col), x(0, col + 1));
        big[ks][1] = pack_bf16(x(1, col), x(1, col + 1));
        big[ks][2] = pack_bf16(x(0, col + 8), x(0, col + 9));
        big[ks][3] = pack_bf16(x(1, col + 8), x(1, col + 9));
      }
    }
  }
};

// ds[jn] = do v^T for the pass's n-tiles (C layout, as the logits), v's rows the keys
// of the staged tile vs; a fresh accumulator every 32 columns of do. ldmatrix.x4 (no
// .trans) over 8 key rows gives lane (g, t) word t of each of 4 16-byte chunks of key
// row g: the B fragments of two k-steps (v row-major is B in .col layout).
template <typename T, int DV, int kRowV>
__device__ __forceinline__ void do_vt(float (&ds)[kPassN][4], const DoFragments<T, DV>& f,
                                      int np, const unsigned char* vs, int jb, int lane) {
#pragma unroll
  for (int jn = 0; jn < kPassN; ++jn) {
    ds[jn][0] = ds[jn][1] = ds[jn][2] = ds[jn][3] = 0.f;
    if (jn >= np) continue;
    const unsigned char* vrow = vs + (8 * (jb + jn) + (lane & 7)) * kRowV + (lane >> 3) * 16;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int ch = 0; ch < DV / 16; ++ch) {  // 16 columns: k-steps 2ch and 2ch + 1
        uint32_t b[4], bb[4], bs[4];
        ldmatrix_x4(b, smem_addr(vrow + ch * 64));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), bb[e], bs[e]);
        mma_3xtf32(c, f.big[2 * ch], f.small[2 * ch], bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(c, f.big[2 * ch + 1], f.small[2 * ch + 1], bb[2], bb[3], bs[2], bs[3]);
        if (ch % 2 == 1 || ch == DV / 16 - 1) {  // 32 columns: into ds, a fresh c
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[jn][e] += c[e], c[e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < DV / 32; ++ch) {  // 32 columns: k-steps 2ch and 2ch + 1
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(vrow + ch * 64));
        mma_bf16(c, f.big[2 * ch], b[0], b[1]);
        mma_bf16(c, f.big[2 * ch + 1], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[jn][e] += c[e], c[e] = 0.f;
      }
      if constexpr (DV % 32 != 0) {  // dv 16 (or 48): one last k-step
        constexpr int ch = DV / 32;  // lanes 0..15 address its two chunks
        uint32_t b[2];
        ldmatrix_x2(b, smem_addr(vrow + ch * 64));
        mma_bf16(c, f.big[2 * ch], b[0], b[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[jn][e] += c[e];
      }
    }
  }
}

// ds[jn] = v do^T for the pass's n-tiles of queries (C layout: keys g, g + 8 of the warp's
// slab x queries 8 (jb + jn) + 2t, + 1): K5's do_vt with the roles swapped. v's A fragments
// come by ldmatrix from the block's staged v rows (v_addr: this lane's address in the slab,
// row lane & 15, plus 16 bytes for lanes 16-31; a 16 x 8 tf32 tile or a 16 x 16 bf16 one
// each 32 bytes), do's B fragments by ldmatrix from the staged do tile dos as do_vt reads
// v's; a fresh accumulator every 32 columns of v.
template <typename T, int DV, int kRowDo>
__device__ __forceinline__ void v_dot(float (&ds)[kPassN][4], uint32_t v_addr, int np,
                                      const unsigned char* dos, int jb, int lane) {
  float c[kPassN][4];
#pragma unroll
  for (int jn = 0; jn < kPassN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[jn][e] = c[jn][e] = 0.f;
  const unsigned char* dorow = dos + (8 * jb + (lane & 7)) * kRowDo + (lane >> 3) * 16;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int ch = 0; ch < DV / 16; ++ch) {  // 16 columns: k-steps 2ch and 2ch + 1
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t r[4];
        ldmatrix_x4(r, v_addr + ch * 64 + s * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ab[s][e], as[s][e]);
      }
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= np) continue;
        uint32_t b[4], bb[4], bs[4];
        ldmatrix_x4(b, smem_addr(dorow + 8 * jn * kRowDo + ch * 64));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), bb[e], bs[e]);
        mma_3xtf32(c[jn], ab[0], as[0], bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(c[jn], ab[1], as[1], bb[2], bb[3], bs[2], bs[3]);
        if (ch % 2 == 1 || ch == DV / 16 - 1) {  // 32 columns: into ds, a fresh c
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[jn][e] += c[jn][e], c[jn][e] = 0.f;
        }
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < DV / 32; ++ch) {  // 32 columns: k-steps 2ch and 2ch + 1
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, v_addr + ch * 64);
      ldmatrix_x4(a1, v_addr + ch * 64 + 32);
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= np) continue;
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(dorow + 8 * jn * kRowDo + ch * 64));
        mma_bf16(c[jn], a0, b[0], b[1]);
        mma_bf16(c[jn], a1, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[jn][e] += c[jn][e], c[jn][e] = 0.f;
      }
    }
    if constexpr (DV % 32 != 0) {  // dv 16 (or 48): one last k-step
      constexpr int ch = DV / 32;  // lanes 0..15 address its two B chunks
      uint32_t a0[4];
      ldmatrix_x4(a0, v_addr + ch * 64);
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= np) continue;
        uint32_t b[2];
        ldmatrix_x2(b, smem_addr(dorow + 8 * jn * kRowDo + ch * 64));
        mma_bf16(c[jn], a0, b[0], b[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[jn][e] += c[jn][e];
      }
    }
  }
}

// The warp layout of a block: `split` warps share each 16-row query slab and take
// their part of every key tile.
struct Layout {
  int warp, lane, g, t;
  int slabs, slab, part;  // slabs a block; this warp's slab and key part
  int nt, np;             // n-tiles the warp takes of a tile; n-tiles a pass
  int row_base, row0;     // the block's and the warp's first query row

  __device__ __forceinline__ Layout(int split, int tile_n) {
    warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    slabs = kWarps / split, slab = warp % slabs, part = warp / slabs;
    nt = tile_n / split, np = nt < kPassN ? nt : kPassN;
    row_base = blockIdx.x * 16 * slabs, row0 = row_base + 16 * slab;
  }
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, (Geometry<T, D, DV>::kMinBlocksFwd))
train_fwd_kernel(const TrainArgs a, const fod::Dropout dp, int split) {
  using G = Geometry<T, D, DV>;
  constexpr int kTile = G::kTile, DVS = G::kSliceV;  // this block's columns of out
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + 2 * G::kStageFwd);
  const Layout L(split, G::kTileN);
  const int bh = blockIdx.y, b = bh / a.h, h = bh - b * a.h, slice = blockIdx.z;
  const uint32_t gbh = dp.global_bh(bh);  // the mask's batch·head
  const T* kb = at<T>(a.k, b, h, 0);
  const T* vb = at<T>(a.v, b, h, 0) + slice * DVS;
  const auto load = [&](int tile, int buf) {
    load_tile<T, D, DV, DVS, G::kRowVS, G::kStageFwd>(smem, a, kb, vb, tile, buf);
  };

  load(0, 0);
  fod::cp_async_commit();
  stage_f32<T, D>(qs, at<T>(a.q, b, h, 0), a.q.sn, a.nq, L.row_base, 16 * L.slabs, a.scale);
  const float* q0 = qs + (16 * L.slab + L.g) * G::kRowQ;
  const float* q1 = q0 + 8 * G::kRowQ;

  float o[DVS / 8][4];
#pragma unroll
  for (int n = 0; n < DVS / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float row_sum[2] = {0.f, 0.f};              // this lane's keys only, until the end

  const int n_tiles = (a.nk + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load(tile + 1, (tile + 1) & 1);
    fod::cp_async_commit();  // possibly empty: the wait below then covers this tile
    fod::cp_async_wait_one();
    __syncthreads();
    const unsigned char* ks = smem + (tile & 1) * G::kStageFwd;
    const unsigned char* vs = ks + kTile * G::kRowK;
    for (int jb = L.part * L.nt; jb < (L.part + 1) * L.nt; jb += L.np) {
      float s[kPassN][4];
      logits<T, D, G::kRowK>(s, q0, q1, ks, jb, L.np, L.t);
      const int key0 = tile * kTile + 8 * jb + 2 * L.t;  // the lane's key of n-tile 0
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = row_max[hh];
#pragma unroll
        for (int jn = 0; jn < kPassN; ++jn) {
          if (jn >= L.np) continue;
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            if (key0 + 8 * jn + e1 >= a.nk) s[jn][2 * hh + e1] = -INFINITY;  // no key
            mx = fmaxf(mx, s[jn][2 * hh + e1]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // -inf: no real key of this warp yet, so nothing to correct
        corr[hh] = mx == -INFINITY ? 1.f : __expf(row_max[hh] - mx);
        row_max[hh] = mx;
        row_sum[hh] *= corr[hh];
      }
#pragma unroll
      for (int n = 0; n < DVS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= L.np) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[jn][e];
          float p = x == -INFINITY ? 0.f : __expf(x - row_max[e >> 1]);
          row_sum[e >> 1] += p;  // the softmax denominator is taken before dropout
          if (dp.active())
            p *= fod::dropout_value(gbh, L.row0 + L.g + 8 * (e >> 1), key0 + 8 * jn + (e & 1), dp);
          s[jn][e] = p;
        }
      }
      product<T, DVS, G::kRowVS>(o, s, L.np, vs, jb, L.lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
  }
  if (split > 1) {  // merge the slab's parts into part 0: [warp][value][lane] in the stages
    float* buf = reinterpret_cast<float*>(smem);
    constexpr int kVals = DVS / 2 + 4;
    if (L.part > 0) {
      float* w = buf + L.warp * kVals * 32 + L.lane;
#pragma unroll
      for (int n = 0; n < DVS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 * n + e) * 32] = o[n][e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        w[(DVS / 2 + hh) * 32] = row_max[hh];
        w[(DVS / 2 + 2 + hh) * 32] = row_sum[hh];
      }
    }
    __syncthreads();
    if (L.part == 0) {
      for (int p = 1; p < split; ++p) {
        const float* w = buf + (L.warp + p * L.slabs) * kVals * 32 + L.lane;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // part 0 holds key 0, so its max is finite; a part may have no real key
          const float m = w[(DVS / 2 + hh) * 32];
          const float mx = fmaxf(row_max[hh], m);
          const float fa = expf(row_max[hh] - mx);
          const float fb = m == -INFINITY ? 0.f : expf(m - mx);
          row_sum[hh] = row_sum[hh] * fa + w[(DVS / 2 + 2 + hh) * 32] * fb;
#pragma unroll
          for (int n = 0; n < DVS / 8; ++n)
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 2 * hh + e1;
              o[n][e] = o[n][e] * fa + w[(4 * n + e) * 32] * fb;
            }
          row_max[hh] = mx;
        }
      }
    }
  }
  if (L.part != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = L.row0 + L.g + 8 * hh;
    if (row >= a.nq) continue;
    const float inv = 1.f / row_sum[hh];
    T* orow = at<T>(a.o0, b, h, row) + slice * DVS + 2 * L.t;
#pragma unroll
    for (int n = 0; n < DVS / 8; ++n) store2<T>(orow + 8 * n, o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    // row_sum >= 1 (the max's own p is exactly 1), so lse >= the row's max logit; every
    // slice computes it alike, the first writes it
    if (L.t == 0 && slice == 0) *at<float>(a.lse, b, h, row) = row_max[hh] + logf(row_sum[hh]);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, (Geometry<T, D, DV>::kMinBlocksGrad))
train_dq_kernel(const TrainArgs a, const fod::Dropout dp, int split) {
  using G = Geometry<T, D, DV>;
  constexpr int kTile = G::kTile, DS = G::kSliceD;  // this block's columns of dq
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + 2 * G::kStage);
  // d 256: the block's do rows, staged (v_dot's A operand) in place of DoFragments
  unsigned char* dos = reinterpret_cast<unsigned char*>(qs + G::kRowsGrad * G::kRowQ);
  const Layout L(split, G::kTileN);
  const int bh = blockIdx.y, b = bh / a.h, h = bh - b * a.h, slice = blockIdx.z;
  const uint32_t gbh = dp.global_bh(bh);  // the mask's batch·head
  const T* kb = at<T>(a.k, b, h, 0);
  const T* vb = at<T>(a.v, b, h, 0);
  const auto load = [&](int tile, int buf) {
    load_tile<T, D, DV, DV, G::kRowV, G::kStage>(smem, a, kb, vb, tile, buf);
  };

  load(0, 0);
  if constexpr (G::kSliced)
    stage_rows<T, DV, G::kRowV, G::kRowsGrad>(dos, at<T>(a.dout, b, h, 0), a.dout.sn, a.nq,
                                              L.row_base);
  fod::cp_async_commit();
  stage_f32<T, D>(qs, at<T>(a.q, b, h, 0), a.q.sn, a.nq, L.row_base, 16 * L.slabs, a.scale);
  const float* q0 = qs + (16 * L.slab + L.g) * G::kRowQ;
  const float* q1 = q0 + 8 * G::kRowQ;
  const uint32_t do_addr =
      smem_addr(dos + (16 * L.slab + (L.lane & 15)) * G::kRowV + (L.lane >> 4) * 16);
  DoFragments<T, G::kSliced ? 16 : DV> dof;  // unused at d 256
  if constexpr (!G::kSliced) dof.load(a, b, h, L.row0, L.lane);
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = L.row0 + L.g + 8 * hh;
    lse[hh] = row < a.nq ? *at<float>(a.lse, b, h, row) : 0.f;
    delta[hh] = row < a.nq ? *at<float>(a.delta, b, h, row) : 0.f;
  }

  float dq[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_tiles = (a.nk + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load(tile + 1, (tile + 1) & 1);
    fod::cp_async_commit();
    fod::cp_async_wait_one();
    __syncthreads();
    const unsigned char* ks = smem + (tile & 1) * G::kStage;
    const unsigned char* vs = ks + kTile * G::kRowK;
    for (int jb = L.part * L.nt; jb < (L.part + 1) * L.nt; jb += L.np) {
      float s[kPassN][4], ds[kPassN][4];
      logits<T, D, G::kRowK>(s, q0, q1, ks, jb, L.np, L.t);
      if constexpr (G::kSliced) {
        v_dot<T, DV, G::kRowV>(ds, do_addr, L.np, vs, jb, L.lane);  // the same sums as do_vt
      } else {
        do_vt<T, DV, G::kRowV>(ds, dof, L.np, vs, jb, L.lane);
      }
      const int key0 = tile * kTile + 8 * jb + 2 * L.t;
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= L.np) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * jn + (e & 1);
          float d = ds[jn][e];
          if (dp.active()) d *= fod::dropout_value(gbh, L.row0 + L.g + 8 * (e >> 1), key, dp);
          const float p = expf(s[jn][e] - lse[e >> 1]);
          s[jn][e] = key < a.nk ? p * (d - delta[e >> 1]) : 0.f;  // dlogits
        }
      }
      product<T, DS, G::kRowK>(dq, s, L.np, ks + slice * DS * (int)sizeof(T), jb, L.lane);
    }
    __syncthreads();
  }

  if (split > 1) {  // sum the slab's parts into part 0: [warp][value][lane] in the stages
    float* buf = reinterpret_cast<float*>(smem);
    constexpr int kVals = DS / 2;
    if (L.part > 0) {
      float* w = buf + L.warp * kVals * 32 + L.lane;
#pragma unroll
      for (int n = 0; n < DS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 * n + e) * 32] = dq[n][e];
    }
    __syncthreads();
    if (L.part == 0) {
      for (int p = 1; p < split; ++p) {
        const float* w = buf + (L.warp + p * L.slabs) * kVals * 32 + L.lane;
#pragma unroll
        for (int n = 0; n < DS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] += w[(4 * n + e) * 32];
      }
    }
  }
  if (L.part != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = L.row0 + L.g + 8 * hh;
    if (row >= a.nq) continue;
    T* drow = at<T>(a.o0, b, h, row) + slice * DS + 2 * L.t;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      store2<T>(drow + 8 * n, dq[n][2 * hh] * a.scale, dq[n][2 * hh + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// K6's shared memory: two stages of a 64-query tile (q and do rows in the storage type,
// then lse and delta of its queries), q * scale as f32 rows for the logits (for f32 the
// stage's q tile itself, scaled in place; apart for bf16, whose product takes q as
// stored), then the block's keys: k rows as f32 and a 64-row tile of v as stored.
template <typename T, int D, int DV>
struct DkvGeometry {
  using G = Geometry<T, D, DV>;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kTile = G::kTile;                    // queries a staged tile
  static constexpr int kRowQ = D * (int)sizeof(T) + kPad;   // bytes a staged q row
  static constexpr int kRowDo = DV * (int)sizeof(T) + kPad; // bytes a staged do row
  static constexpr int kRowV = DV * (int)sizeof(T) + kPad;  // bytes a staged v row
  static constexpr int kRowS = D + kPad / 4;                // floats a q * scale or k row
  static constexpr int kStage = kTile * (kRowQ + kRowDo) + 2 * kTile * 4;
  static constexpr int kScaled = kF32 ? 0 : kTile * kRowS * 4;
  static constexpr int kVRows = kMaxRows / G::kMinSplitGrad;  // v rows staged, a block's most
  // bytes at `rows` keys a block (k rows as f32 for those, v staged as a kVRows-row tile)
  static constexpr int smem(int rows) {
    return 2 * kStage + kScaled + rows * kRowS * 4 + kVRows * kRowV;
  }
  // d 256: dk's slices of 128 columns, then dv's (grid z)
  static constexpr int kSlicesD = D / G::kSliceD;
  static constexpr int kSlices = G::kSliced ? kSlicesD + DV / G::kSliceV : 1;
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims");
  static_assert(kThreads >= 2 * kTile, "a thread stages one lse or delta of a tile");
  // the split's sum reuses the two stages: dk and dv a lane (d 256: one slice), kWarps x
  // 32 lanes
  static constexpr int kMergeVals = G::kSliced ? kMaxSlice / 2 : D / 2 + DV / 2;
  static_assert(kWarps * 32 * kMergeVals * 4 <= 2 * kStage, "merge scratch");
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes));
}

// Query tile `tile` into stage buf: its q and do rows (zero past nq) by 16-byte cp.async,
// the lse and delta of its queries by 4-byte ones (zero past nq: a padded query's are
// never read).
template <typename T, int D, int DV>
__device__ __forceinline__ void load_queries(unsigned char* smem, const TrainArgs& a, int b,
                                             int h, int tile, int buf) {
  using G = DkvGeometry<T, D, DV>;
  constexpr int kTile = G::kTile;
  unsigned char* st = smem + buf * G::kStage;
  const int r0 = tile * kTile;
  stage_rows<T, D, G::kRowQ, kTile>(st, at<T>(a.q, b, h, 0), a.q.sn, a.nq, r0);
  stage_rows<T, DV, G::kRowDo, kTile>(st + kTile * G::kRowQ, at<T>(a.dout, b, h, 0), a.dout.sn,
                                      a.nq, r0);
  if (threadIdx.x >= 2 * kTile) return;
  const int i = threadIdx.x % kTile, which = threadIdx.x / kTile;  // 0 lse, 1 delta
  const bool real = r0 + i < a.nq;
  float* dst = reinterpret_cast<float*>(st + kTile * (G::kRowQ + G::kRowDo)) + which * kTile + i;
  cp_async4(smem_addr(dst), at<float>(which ? a.delta : a.lse, b, h, real ? r0 + i : 0),
            real ? 4 : 0);
}

// The stage's q tile (pitch kRowQ bytes) as f32 times scale into qs (pitch kRowS floats):
// the rounding every kernel's logits take. For f32, qs is the tile itself.
template <typename T, int D, int kRowQ, int kRowS, int kTile>
__device__ __forceinline__ void scale_queries(float* qs, const unsigned char* qt, float scale) {
  constexpr int kChunks = D / 8;  // 8 elements a chunk
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float x[8];
    load8<T>(x, qt + r * kRowQ + c * (int)sizeof(T));
    float4* d = reinterpret_cast<float4*>(qs + r * kRowS + c);
    d[0] = make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
    d[1] = make_float4(x[4] * scale, x[5] * scale, x[6] * scale, x[7] * scale);
  }
}

// K6's end at d 256: sum the slab's parts of its one slice (acc: 128 columns of dk or dv)
// into part 0, then write them (dk times scale in bf16, as below).
template <typename T, int D, int DV>
__device__ __forceinline__ void sliced_dkv_epilogue(const TrainArgs& a, int b, int h,
                                                    const Layout& L, int split,
                                                    float (&acc)[kMaxSlice / 8][4],
                                                    bool dk_slice, int col_d, int col_v,
                                                    unsigned char* smem) {
  if (split > 1) {  // [warp][value][lane] in the stages
    float* buf = reinterpret_cast<float*>(smem);
    constexpr int kVals = kMaxSlice / 2;
    if (L.part > 0) {
      float* w = buf + L.warp * kVals * 32 + L.lane;
#pragma unroll
      for (int n = 0; n < kMaxSlice / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 * n + e) * 32] = acc[n][e];
    }
    __syncthreads();
    if (L.part == 0) {
      for (int p = 1; p < split; ++p) {
        const float* w = buf + (L.warp + p * L.slabs) * kVals * 32 + L.lane;
#pragma unroll
        for (int n = 0; n < kMaxSlice / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += w[(4 * n + e) * 32];
      }
    }
  }
  if (L.part != 0) return;
  const float mul = dk_slice && !std::is_same<T, float>::value ? a.scale : 1.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = L.row0 + L.g + 8 * hh;
    if (key >= a.nk) continue;
    T* row = dk_slice ? at<T>(a.o0, b, h, key) + col_d : at<T>(a.o1, b, h, key) + col_v;
#pragma unroll
    for (int n = 0; n < kMaxSlice / 8; ++n)
      store2<T>(row + 8 * n + 2 * L.t, acc[n][2 * hh] * mul, acc[n][2 * hh + 1] * mul);
  }
}

// K6 (redesigned for the tensor cores): K5 mirrored, keys in the place of queries. A block
// of 4 warps; each warp owns a 16-key slab as the M rows of mma.sync and walks the queries
// in 8-query n-tiles. The block stages its keys once (k as f32 for the logits, v as stored
// for dS^T's A fragments) and 64-query tiles of q, do, lse and delta, double-buffered by
// cp.async; each tile's q rows are scaled to f32 once (scale_queries). When 64-key blocks
// would give fewer than two blocks an SM (the decoder: 6 x 32 = 192 blocks on 132 SMs) the
// warps of a block share one slab, 2 or 4 of them, and split each tile's queries
// (`split_for`), summing their dk and dv in shared memory at the end. A warp's pass over
// its queries of a tile (32; 16 at split 4):
// - the logits s^T on the CUDA cores, each the sequential chain of the header, at this
//   lane's C-fragment positions (`logits`, with keys as its rows): bit-equal to K4's and
//   K5's;
// - dS^T = v do^T on the tensor cores (`v_dot`);
// - p = exp(s - lse), the mask, dlogits = p (dS mask - delta) on the CUDA cores, with lse
//   and delta of the lane's query columns; zero for queries >= nq and keys >= nk;
// - dv += (p mask)^T do and dk += dlogits^T q on the tensor cores (`product`), p and
//   dlogits from the registers: the C fragment of s^T is the A operand.
// Rounding as K5's: f32 as 3xTF32, dk's B the tile's q * scale (so dk takes no scale at the
// end); bf16 with p and dlogits as hi + lo pairs and q as stored, dk times scale in f32 at
// the end. Every product starts a fresh accumulator each pass (32 columns of v for dS^T).
// On an H100 80GB HBM3 at 700 W, f32, dropout 0.1 (chip_smoke.py phase 1b, device time):
// 100 us a call at the encoder's shape (split 1, 128 registers, 4 blocks an SM) and 29.6
// at the decoder's (split 2, 156 registers), 0.96 ms a train step against 1.89 for the
// one-thread-a-key kernel it replaced; its bound is 0.113 ms, its design's floor (the
// logits' chains on the CUDA cores) 0.081.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, (Geometry<T, D, DV>::kMinBlocksGrad))
train_dkv_kernel(const TrainArgs a, const fod::Dropout dp, int split) {
  using G = DkvGeometry<T, D, DV>;
  using GG = Geometry<T, D, DV>;
  constexpr int kTile = G::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(split, GG::kTileN);  // rows are keys here, parts split the queries
  const int rows = 16 * L.slabs;
  float* kf = reinterpret_cast<float*>(smem + 2 * G::kStage + G::kScaled);
  unsigned char* vs = reinterpret_cast<unsigned char*>(kf + rows * G::kRowS);
  const int bh = blockIdx.y, b = bh / a.h, h = bh - b * a.h;
  const uint32_t gbh = dp.global_bh(bh);  // the mask's batch·head
  // d 256: this block's output, dk's slice z (its 128 columns) or dv's slice z - kSlicesD
  const int slice = blockIdx.z;
  const bool dk_slice = slice < G::kSlicesD;
  const int col_d = dk_slice ? slice * GG::kSliceD : 0;
  const int col_v = dk_slice ? 0 : (slice - G::kSlicesD) * GG::kSliceV;

  // v's kVRows rows from the block's first key (past its `rows` keys they go unread)
  stage_rows<T, DV, G::kRowV, G::kVRows>(vs, at<T>(a.v, b, h, 0), a.v.sn, a.nk, L.row_base);
  load_queries<T, D, DV>(smem, a, b, h, 0, 0);
  fod::cp_async_commit();
  stage_f32<T, D>(kf, at<T>(a.k, b, h, 0), a.k.sn, a.nk, L.row_base, rows, 1.f);
  const float* k0 = kf + (16 * L.slab + L.g) * G::kRowS;
  const float* k1 = k0 + 8 * G::kRowS;
  const uint32_t v_addr =
      smem_addr(vs + (16 * L.slab + (L.lane & 15)) * G::kRowV + (L.lane >> 4) * 16);

  // up to d 128 one block writes dk and dv; at d 256 one slice of 128 columns (acc)
  float dk[D / 8][4], dv[DV / 8][4], acc[kMaxSlice / 8][4];  // dk, dv unused at d 256
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxSlice / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (a.nq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_queries<T, D, DV>(smem, a, b, h, tile + 1, (tile + 1) & 1);
    fod::cp_async_commit();  // possibly empty: the wait below then covers this tile
    fod::cp_async_wait_one();
    __syncthreads();
    unsigned char* qt = smem + (tile & 1) * G::kStage;
    const unsigned char* dos = qt + kTile * G::kRowQ;
    const float* lses = reinterpret_cast<const float*>(dos + kTile * G::kRowDo);
    const float* deltas = lses + kTile;
    float* qs = reinterpret_cast<float*>(G::kF32 ? qt : smem + 2 * G::kStage);
    scale_queries<T, D, G::kRowQ, G::kRowS, kTile>(qs, qt, a.scale);
    __syncthreads();
    for (int jb = L.part * L.nt; jb < (L.part + 1) * L.nt; jb += L.np) {
      float s[kPassN][4], ds[kPassN][4];
      logits<float, D, G::kRowS * 4>(s, k0, k1, reinterpret_cast<const unsigned char*>(qs), jb,
                                     L.np, L.t);
      if (!GG::kSliced || dk_slice) {  // dv's slices need no dS
        v_dot<T, DV, G::kRowDo>(ds, v_addr, L.np, dos, jb, L.lane);
      } else {
#pragma unroll
        for (int jn = 0; jn < kPassN; ++jn) ds[jn][0] = ds[jn][1] = ds[jn][2] = ds[jn][3] = 0.f;
      }
      const int col0 = 8 * jb + 2 * L.t;  // the lane's query of n-tile 0, in the tile
#pragma unroll
      for (int jn = 0; jn < kPassN; ++jn) {
        if (jn >= L.np) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + 8 * jn + (e & 1), query = tile * kTile + col;
          const int key = L.row0 + L.g + 8 * (e >> 1);
          float p = 0.f, dl = 0.f;
          if (query < a.nq && key < a.nk) {
            p = expf(s[jn][e] - lses[col]);
            float d = ds[jn][e];
            float pd = p;
            if (dp.active()) {
              const float m = fod::dropout_value(gbh, query, key, dp);
              pd = p * m;
              d *= m;
            }
            dl = p * (d - deltas[col]);
            p = pd;
          }
          s[jn][e] = p;  // (p mask)^T
          ds[jn][e] = dl;  // dlogits^T
        }
      }
      if constexpr (GG::kSliced) {
        if (dk_slice) {
          product<T, kMaxSlice, G::kRowQ>(acc, ds, L.np, qt + col_d * (int)sizeof(T), jb, L.lane);
        } else {
          product<T, kMaxSlice, G::kRowDo>(acc, s, L.np, dos + col_v * (int)sizeof(T), jb, L.lane);
        }
      } else {
        product<T, DV, G::kRowDo>(dv, s, L.np, dos, jb, L.lane);
        product<T, D, G::kRowQ>(dk, ds, L.np, qt, jb, L.lane);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  if constexpr (GG::kSliced) {
    sliced_dkv_epilogue<T, D, DV>(a, b, h, L, split, acc, dk_slice, col_d, col_v, smem);
    return;
  }

  if (split > 1) {  // sum the slab's parts into part 0: [warp][value][lane] in the stages
    float* buf = reinterpret_cast<float*>(smem);
    constexpr int kVals = G::kMergeVals;
    if (L.part > 0) {
      float* w = buf + L.warp * kVals * 32 + L.lane;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 * n + e) * 32] = dk[n][e];
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(D / 2 + 4 * n + e) * 32] = dv[n][e];
    }
    __syncthreads();
    if (L.part == 0) {
      for (int p = 1; p < split; ++p) {
        const float* w = buf + (L.warp + p * L.slabs) * kVals * 32 + L.lane;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[n][e] += w[(4 * n + e) * 32];
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[n][e] += w[(D / 2 + 4 * n + e) * 32];
      }
    }
  }
  if (L.part != 0) return;
  const float dk_scale = G::kF32 ? 1.f : a.scale;  // f32's dk took q * scale
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = L.row0 + L.g + 8 * hh;
    if (key >= a.nk) continue;
    T* dkrow = at<T>(a.o0, b, h, key) + 2 * L.t;
    T* dvrow = at<T>(a.o1, b, h, key) + 2 * L.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(dkrow + 8 * n, dk[n][2 * hh] * dk_scale, dk[n][2 * hh + 1] * dk_scale);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) store2<T>(dvrow + 8 * n, dv[n][2 * hh], dv[n][2 * hh + 1]);
  }
}

__global__ void keep_mask_kernel(float* __restrict__ out, int nq, int nk, fod::Dropout dp) {
  const int bh = blockIdx.y;
  const uint32_t gbh = dp.global_bh(bh);
  const size_t n = (size_t)nq * nk;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(i / nk), col = static_cast<int>(i % nk);
    out[(size_t)bh * n + i] = dp.active() ? fod::dropout_value(gbh, row, col, dp) : 1.f;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };
constexpr int kMaxDevices = 64;

int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && sms[dev] > 0) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 132;
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

// Warps that share a 16-row slab and split the other operand's rows: the least of 1, 2 and
// 4 whose grid of n rows (queries for K4 and K5, keys for K6) gives every SM two blocks,
// else 4. The encoder (64 x 350) takes 1; the decoder (32 x 128 queries, 350 keys) takes 4
// in K4 and K5, 2 in K6.
int split_for(int n, int bh) {
  const long long want = 2LL * sm_count();
  for (int split = 1; split < kWarps; split *= 2) {
    const int rows = 16 * (kWarps / split);
    if ((long long)((n + rows - 1) / rows) * bh >= want) return split;
  }
  return kWarps;
}

struct Launch {
  dim3 grid;
  int threads, smem, split;
};

// The split (within the geometry's bounds: d 256's 32-row tiles cap it, and f32 256/256
// takes 32 rows a block in K5 and K6), the grid (z: the output's column slices) and the
// shared memory of a launch.
template <typename T, int D, int DV>
Launch plan(Which which, int bh, int nq, int nk) {
  using G = Geometry<T, D, DV>;
  int split = split_for(which == kDkv ? nk : nq, bh);
  split = split > G::kMaxSplit ? G::kMaxSplit : split;
  if (which != kFwd && split < G::kMinSplitGrad) split = G::kMinSplitGrad;
  const int rows = 16 * (kWarps / split);
  if (which == kDkv)
    return {dim3((nk + rows - 1) / rows, bh, DkvGeometry<T, D, DV>::kSlices), kThreads,
            DkvGeometry<T, D, DV>::smem(rows), split};
  if (which == kFwd)
    return {dim3((nq + rows - 1) / rows, bh, DV / G::kSliceV), kThreads, G::kSmemFwd, split};
  return {dim3((nq + rows - 1) / rows, bh, D / G::kSliceD), kThreads, G::kSmem, split};
}

// The most dynamic shared memory a launch of the kernel takes (K6's shrinks with its split).
template <typename T, int D, int DV>
int max_smem(Which which) {
  using K6 = DkvGeometry<T, D, DV>;
  static_assert(K6::smem(K6::kVRows) <= 232448, "a block's shared memory");
  if (which == kDkv) return K6::smem(K6::kVRows);
  return which == kFwd ? Geometry<T, D, DV>::kSmemFwd : Geometry<T, D, DV>::kSmem;
}

template <typename T, int D, int DV>
const void* kernel_of(Which which) {
  if (which == kFwd) return reinterpret_cast<const void*>(train_fwd_kernel<T, D, DV>);
  if (which == kDq) return reinterpret_cast<const void*>(train_dq_kernel<T, D, DV>);
  return reinterpret_cast<const void*>(train_dkv_kernel<T, D, DV>);
}

// Above 48 KB a block's dynamic shared memory needs the opt-in, set once a device and
// kernel.
template <typename T, int D, int DV>
cudaError_t prepare(Which which) {
  static bool done[3][kMaxDevices] = {};
  const int smem = max_smem<T, D, DV>(which);
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[which][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of<T, D, DV>(which),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[which][dev] = true;
  return err;
}

template <typename T, int D, int DV>
int launch(Which which, const TrainArgs& a, const fod::Dropout& dp) {
  const Launch l = plan<T, D, DV>(which, a.b * a.h, a.nq, a.nk);
  const cudaError_t err = prepare<T, D, DV>(which);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(a.stream);
  if (which == kFwd)
    train_fwd_kernel<T, D, DV><<<l.grid, l.threads, l.smem, stream>>>(a, dp, l.split);
  else if (which == kDq)
    train_dq_kernel<T, D, DV><<<l.grid, l.threads, l.smem, stream>>>(a, dp, l.split);
  else
    train_dkv_kernel<T, D, DV><<<l.grid, l.threads, l.smem, stream>>>(a, dp, l.split);
  return static_cast<int>(cudaGetLastError());
}

// out[9]: registers a thread, static and dynamic shared bytes a block, local (spill)
// bytes a thread, resident blocks an SM, and the launch's grid x, grid y, threads a
// block and split at (bh, nq, nk). Launches nothing.
template <typename T, int D, int DV>
int info(Which which, int bh, int nq, int nk, int* out) {
  const Launch l = plan<T, D, DV>(which, bh, nq, nk);
  cudaError_t err = prepare<T, D, DV>(which);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_of<T, D, DV>(which));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of<T, D, DV>(which),
                                                        l.threads, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {attr.numRegs, (int)attr.sharedSizeBytes, l.smem, (int)attr.localSizeBytes,
                       blocks, (int)l.grid.x, (int)l.grid.y, l.threads, l.split};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// The head dims of ops/flash_attention.py's SUPPORTED_HEAD_DIMS, as K1 takes them
// (flash_attention.cu); the wrappers zero-pad any other pair up to 256 onto the
// smallest of them that holds it. At (128, 128) in f32 K6 takes 203,776 bytes of shared
// memory a block and K4/K5 168,960, of the 232,448 a block may have; at d 256 the
// geometry's 32-row tiles and slices keep every kernel near 200,000 (Geometry).
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
int run(Which which, const TrainArgs& a) {
  const fod::Dropout dp = fod::make_dropout(a.seed, a.threshold, a.keep, a.nq_pad, a.nk_pad,
                                           a.h_local, a.h_full, a.h0);
  return dispatch_dims<T>(a.d, a.dv, [&](auto d, auto dv) {
    return launch<T, decltype(d)::value, decltype(dv)::value>(which, a, dp);
  });
}

int train(Which which, const TrainArgs* a) {
  if (a->b <= 0 || a->h <= 0 || (long long)a->b * a->h > 65535 || a->nq <= 0 || a->nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->h_local <= 0 || a->h0 < 0 || a->h0 + a->h_local > a->h_full)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == fod::kFloat32) return run<float>(which, *a);
  if (a->dtype == fod::kBFloat16) return run<__nv_bfloat16>(which, *a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One TrainArgs each (see the struct): q, k, v and do read, out/dq/dk/dv written, by
// strides; lse (K4 writes it) and delta by strides, f32; the dropout seed, threshold
// (0: none), keep value, the JAX geometry nq_pad / nk_pad and the heads the call
// holds of the layer's (h_local from h0 of h_full). Each returns the launch's CUDA
// status.
// (A TrainArgs pointer: a type of this file's unnamed namespace in the signature would
// keep the symbols out of the library.)
extern "C" int fod_flash_train_fwd(const void* a) {
  return train(kFwd, static_cast<const TrainArgs*>(a));
}
extern "C" int fod_flash_train_dq(const void* a) {
  return train(kDq, static_cast<const TrainArgs*>(a));
}
extern "C" int fod_flash_train_dkv(const void* a) {
  return train(kDkv, static_cast<const TrainArgs*>(a));
}

// which: 0 K4, 1 K5, 2 K6. out[9]: see info. Launches nothing.
extern "C" int fod_flash_train_info(int which, int d, int dv, int dtype, int bh, int nq, int nk,
                                    int* out) {
  if (which < 0 || which > 2 || bh <= 0 || nq <= 0 || nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Which w = static_cast<Which>(which);
  auto query = [&](auto tag) {
    using T = decltype(tag);
    return dispatch_dims<T>(d, dv, [&](auto dd, auto ddv) {
      return info<T, decltype(dd)::value, decltype(ddv)::value>(w, bh, nq, nk, out);
    });
  };
  if (dtype == fod::kFloat32) return query(float{});
  if (dtype == fod::kBFloat16) return query(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (bh, nq, nk) f32: K7's mask value of every element (1 where threshold is 0), the
// call's batch·heads being h_local from h0 of h_full a batch.
extern "C" int fod_dropout_keep_mask(void* out, int bh, int nq, int nk, uint32_t seed,
                                     uint32_t threshold, float keep, int nq_pad, int nk_pad,
                                     int h_local, int h_full, int h0, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h_local <= 0 || h0 < 0 || h0 + h_local > h_full)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t want = ((size_t)nq * nk + 255) / 256;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  keep_mask_kernel<<<dim3(blocks, bh), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), nq, nk,
      fod::make_dropout(seed, threshold, keep, nq_pad, nk_pad, h_local, h_full, h0));
  return static_cast<int>(cudaGetLastError());
}
