// The stem-study kernels for Hopper (sm_90a), NHWC. They replace the Pallas TPU
// kernels of tools/bench_stem.py (behind ops/stem_variants.py):
//   A   _kernelA   matmul of materialized patches (K = 192) + bias + relu + 3x3/2 pool
//   B   _kernelB   the same, the patches gathered from 12-channel padded s2d rows
//   B16 _kernelB16 as B over channels padded 12 -> 16 (K = 256)
//   D   _kernelD   s2d(4) 3x3 conv as 9 tap products over 128 channels, relu, the
//                  packed 256-channel (a, b, c) output; the pool runs outside
// Same functions on the TPU tool's operand layouts; the blocking is this card's own.
//
// Conv coordinates (A, B, B16): i in [0, 2Hp] is conv row i - 1 and j in [0, 2Wp]
// conv column j - 1, so i = 0 / j = 0 is the pool's padding row / column. Its 4x4
// window covers real pixels, so relu can make it positive: it is set to -inf and
// never wins a max (the TPU kernel masks it to -1e30, row 0 in its first row tile
// only, which is global row 0). Pool output (p, q) is the max over i in 2p .. 2p+2,
// j in 2q .. 2q+2.
//
// What bounds them: the stem's 2*147*64 operations per conv position against 12-16
// input and 16 output elements per position (A reads a 16x larger patch matrix);
// D's output is 2 bytes per operation-heavy position as well. A, B and B16 compute
// on the CUDA cores in f32 through the register-tiled block GEMM (block_gemm.cuh),
// so the f32 rate bounds them. They share the GEMM and the pool epilogue and differ
// only in where the patch matrix comes from: A stages K-slices of it straight from
// device memory, B and B16 stage the 20x20 window of padded s2d rows their 17x17
// conv positions read in shared memory and gather the patches from there. One block
// of 256 threads owns an 8x8 tile of pool outputs (all 64 channels); the conv values
// are kept in shared memory, aliased over the GEMM's staging, and never written to
// device memory.
//
// D is an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums; mma_tile.cuh): M = the output pixels, N = 256, K = 9 taps x 128 channels in
// (tap, channel) order. A block owns an 8 x 16 tile of output pixels and 128 of the
// 256 channels. It stages the tile's 10 x 18 halo of xp (all 128 channels, rounded to
// bf16: the TPU kernel rounds x to bf16 whatever the storage type) in shared memory
// once and reads every tap's A fragments from it by ldmatrix at the tap's shift; the
// weights stream through in 18 chunks of 64 rows (half a tap), double-buffered by
// cp.async (bf16 xp's halo by cp.async too, with the first chunk). Each of the 8 warps
// owns 2 rows x 16 pixels x 64 channels, its sums one f32 chain, relu in the
// epilogue. Its own products, 2 * pixels * 1152 * 256, put a floor of 1.28 ms under
// it at the tool's shape (989 TFLOP/s bf16), above cuDNN's 3x3 conv over the 48 real
// channels: the padded channels are the TPU layout's, and the kernel may not assume
// their zeros.
#include "block_gemm.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = fod::kGemmThreads;
constexpr int kCout = 64;                 // stem output channels
constexpr int kPool = 8;                  // pool outputs per tile side
constexpr int kConv = 2 * kPool + 1;      // conv positions per side the tile's pools read
constexpr int kConvPix = kConv * kConv;
constexpr int kWin = kConv + 3;           // padded s2d rows/cols those positions read
constexpr int kTM = (kConvPix + 15) / 16;
constexpr int kTN = kCout / 16;
constexpr int kStageA = fod::gemm_stage_a<kTM>();
constexpr int kStage = kStageA + fod::gemm_stage_b<kTN>();
constexpr int kPatchK = 16 * 12;          // A's patch columns: 16 taps x 12 channels

constexpr int kDCin = 128, kDCout = 256;  // D's channels
constexpr int kDTH = 8, kDTW = 16;        // D's block: 8 x 16 output pixels ...
constexpr int kDCols = 128;               // ... x 128 output channels
constexpr int kDHaloH = kDTH + 2, kDHaloW = kDTW + 2;
constexpr int kDRow = kDCin * 2 + 16;     // bytes a staged halo pixel (bf16, padded)
constexpr int kDHalo = kDHaloH * kDHaloW * kDRow;
constexpr int kDChunkK = fod::kChunkBytes / 2;  // reduction rows a chunk: 64 channels of a tap
constexpr int kDChunks = 9 * kDCin / kDChunkK;
constexpr int kDBRow = kDCols * 2 + 16;   // bytes a staged weight row (bf16, padded)
constexpr int kDBStage = kDChunkK * kDBRow;
constexpr int kDSmem = kDHalo + 2 * kDBStage;
static_assert(kDRow / 16 % 2 == 1 && kDBRow / 16 % 2 == 1, "ldmatrix rows on distinct banks");
static_assert(kThreads == 256 && kDTH == 2 * 4 && kDCols == 2 * 64, "8 warps of 2 x 16 x 64");

constexpr int max_i(int a, int b) { return a > b ? a : b; }

// relu(acc + bias) of the tile's conv positions into conv[kConvPix][kCout], -inf at
// i = 0 or j = 0, then each of the tile's pool outputs as the max of its 3x3 window.
template <typename T>
__device__ void pool_epilogue(const float (&acc)[kTM][kTN], const float* __restrict__ bias,
                              float* conv, T* __restrict__ out, int img, int Hp, int Wp,
                              int p0, int q0) {
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = tm + 16 * i;
    if (m >= kConvPix) continue;
    const bool pad = (2 * p0 + m / kConv == 0) || (2 * q0 + m % kConv == 0);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = tn + 16 * j;
      conv[m * kCout + n] = pad ? -INFINITY : fmaxf(acc[i][j] + bias[n], 0.f);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPool * kPool * kCout; idx += kThreads) {
    const int n = idx % kCout, pq = idx / kCout;
    const int pr = pq / kPool, pc = pq % kPool;
    const int p = p0 + pr, q = q0 + pc;
    if (p >= Hp || q >= Wp) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        mx = fmaxf(mx, conv[((2 * pr + dy) * kConv + 2 * pc + dx) * kCout + n]);
    out[(((size_t)img * Hp + p) * Wp + q) * kCout + n] = fod::from_float<T>(mx);
  }
}

// A: patches (B, 2Hp+1, Js, 192), the row of conv coordinate i holding, per column
// j, the 16 taps x 12 channels that position reads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_a_kernel(const T* __restrict__ patches, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out, int Hp, int Wp, int Js) {
  extern __shared__ float4 fod_smem[];
  float* smem = reinterpret_cast<float*>(fod_smem);
  const int img = blockIdx.z, p0 = blockIdx.y * kPool, q0 = blockIdx.x * kPool;
  const int rows = 2 * Hp + 1;
  const T* pb = patches + (size_t)img * rows * Js * kPatchK;
  auto load_a = [&](int m, int k) -> float {
    const int i = 2 * p0 + m / kConv, j = 2 * q0 + m % kConv;
    if (i >= rows || j > 2 * Wp) return 0.f;  // feeds no pool output of this launch
    return fod::to_float(pb[((size_t)i * Js + j) * kPatchK + k]);
  };
  float acc[kTM][kTN] = {};
  fod::block_gemm<kTM, kTN>(acc, load_a, kConvPix, kPatchK, w, kCout, 0, smem,
                            smem + kStageA);
  pool_epilogue<T>(acc, bias, smem, out, img, Hp, Wp, p0, q0);
}

// B (C = 12) and B16 (C = 16): sp (B, 2Hp+4, Js, C), the s2d input padded by (3, 1)
// rows and (3, >= 1) columns; conv position (i, j) reads sp rows i .. i+3, columns
// j .. j+3, its patch in (di, dj, c) order.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
stem_b_kernel(const T* __restrict__ sp, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out, int Hp, int Wp, int Js) {
  extern __shared__ float4 fod_smem[];
  float* smem = reinterpret_cast<float*>(fod_smem);
  float* win = smem + kStage;  // [kWin][kWin][C]
  const int img = blockIdx.z, p0 = blockIdx.y * kPool, q0 = blockIdx.x * kPool;
  const int nrow = 2 * Hp + 4;
  const T* sb = sp + (size_t)img * nrow * Js * C;
  for (int idx = threadIdx.x; idx < kWin * kWin * C; idx += kThreads) {
    const int r = 2 * p0 + idx / (kWin * C), col = 2 * q0 + (idx / C) % kWin;
    win[idx] = r < nrow && col < Js
                   ? fod::to_float(sb[((size_t)r * Js + col) * C + idx % C]) : 0.f;
  }
  __syncthreads();
  auto load_a = [&](int m, int k) -> float {
    const int tap = k / C;
    return win[((m / kConv + tap / 4) * kWin + m % kConv + tap % 4) * C + k % C];
  };
  float acc[kTM][kTN] = {};
  fod::block_gemm<kTM, kTN>(acc, load_a, kConvPix, 16 * C, w, kCout, 0, smem,
                            smem + kStageA);
  pool_epilogue<T>(acc, bias, smem, out, img, Hp, Wp, p0, q0);
}

// D: xp (B, Hp+2, Wp+2, 128), the s2d(4) input padded by 1 all round; w9
// (9, 128, 256) bf16, tap-major; out (B, Hp, Wp, 256) = relu(sum over the 9 taps),
// out[y][x] += xp[y + tap / 3][x + tap % 3] . w9[tap]. Block (tile * 2 + half, image):
// output rows y0 .. y0 + 7, columns x0 .. x0 + 15, channels 128 half .. + 127. Warp w
// owns tile rows 2 (w % 4) and 2 (w % 4) + 1 (its two m16 slabs, 16 pixels each) and
// channels 64 (w / 4) .. + 63 of the block's.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_d_kernel(const T* __restrict__ xp, const __nv_bfloat16* __restrict__ w9,
              T* __restrict__ out, int Hp, int Wp) {
  extern __shared__ __align__(16) unsigned char smem_d[];
  unsigned char* halo = smem_d;  // [kDHaloH][kDHaloW][kDRow]
  unsigned char* wbuf = smem_d + kDHalo;
  const int tiles_w = (Wp + kDTW - 1) / kDTW;
  const int tile = blockIdx.x >> 1, half = blockIdx.x & 1, img = blockIdx.y;
  const int y0 = (tile / tiles_w) * kDTH, x0 = (tile % tiles_w) * kDTW, n0 = half * kDCols;
  const int H2 = Hp + 2, W2 = Wp + 2;
  const T* xb = xp + (size_t)img * H2 * W2 * kDCin;
  constexpr int kPieces = kDCin * 2 / 16;  // 16-byte pieces of a staged halo pixel

  // the halo, 8 channels a piece; pixels past the image zero (they feed no output)
  if constexpr (std::is_same<T, float>::value) {  // rounded to bf16 on the way
    for (int i = threadIdx.x; i < kDHaloH * kDHaloW * kPieces; i += kThreads) {
      const int pos = i / kPieces, piece = i % kPieces;
      const int gy = y0 + pos / kDHaloW, gx = x0 + pos % kDHaloW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy < H2 && gx < W2) {
        const float4* src =
            reinterpret_cast<const float4*>(xb + ((size_t)gy * W2 + gx) * kDCin + 8 * piece);
        const float4 lo = src[0], hi = src[1];
        v = make_uint4(fod::pack_bf16(lo.x, lo.y), fod::pack_bf16(lo.z, lo.w),
                       fod::pack_bf16(hi.x, hi.y), fod::pack_bf16(hi.z, hi.w));
      }
      *reinterpret_cast<uint4*>(halo + pos * kDRow + 16 * piece) = v;
    }
  }
  auto stage = [&](int c, int buf) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (c == 0) {  // the halo, with the first chunk
        for (int i = threadIdx.x; i < kDHaloH * kDHaloW * kPieces; i += kThreads) {
          const int pos = i / kPieces, piece = i % kPieces;
          const int gy = y0 + pos / kDHaloW, gx = x0 + pos % kDHaloW;
          const bool real = gy < H2 && gx < W2;
          const T* src = real ? xb + ((size_t)gy * W2 + gx) * kDCin + 8 * piece : xb;
          fod::cp_async16(fod::smem_addr(halo + pos * kDRow + 16 * piece), src, real ? 16 : 0);
        }
      }
    }
    // chunk c: w9 rows 64 c .. 64 c + 63 (tap c / 2, channels 64 (c % 2) ..), the
    // block's 128 columns: 16 pieces a row
    const __nv_bfloat16* wc = w9 + (size_t)c * kDChunkK * kDCout + n0;
    for (int i = threadIdx.x; i < kDChunkK * 16; i += kThreads) {
      const int r = i / 16, piece = i % 16;
      fod::cp_async16(fod::smem_addr(wbuf + buf * kDBStage + r * kDBRow + 16 * piece),
                      wc + (size_t)r * kDCout + 8 * piece, 16);
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % 4, wn = warp / 4;
  // slab i's ldmatrix rows: tile row 2 wm + i, pixel lane & 15 (plus 16 bytes for
  // lanes 16-31), at tap c / 2's shift and channel half c % 2 for chunk c
  const uint32_t halo_lane = fod::smem_addr(halo) + (lane & 15) * kDRow + (lane >> 4) * 16;
  // B by ldmatrix.x4.trans: lanes 8m..8m+7 address k rows 8 (m & 1) + 0..7 at n
  // columns 8 (m >> 1): b0, b1 of n-tile 2 jj and of 2 jj + 1
  const uint32_t b_lane = fod::smem_addr(wbuf) + wn * 128 +
                          ((lane & 7) + ((lane >> 3) & 1) * 8) * kDBRow + (lane >> 4) * 16;
  // One f32 chain through all 72 k-steps: both operands are bf16 values, the
  // products exact, and the truncating sums' bias stays far inside the f32
  // tolerance (tests/test_torch_stem_d_tc_rounding.py), so no fresh accumulators.
  float acc[2][8][4] = {};
  stage(0, 0);
  fod::cp_async_commit();
  for (int c = 0; c < kDChunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < kDChunks) stage(c + 1, buf ^ 1);
    fod::cp_async_commit();  // possibly empty: the wait below then covers chunk c
    fod::cp_async_wait_one();
    __syncthreads();
    const int tap = c >> 1;
    uint32_t a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[i] = halo_lane + ((2 * wm + i + tap / 3) * kDHaloW + tap % 3) * kDRow + (c & 1) * 128;
    const uint32_t b = b_lane + buf * kDBStage;
#pragma unroll
    for (int ks = 0; ks < kDChunkK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) fod::ldmatrix_x4(af[i], a[i] + ks * 32);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t r[4];
        fod::ldmatrix_x4_trans(r, b + ks * 16 * kDBRow + jj * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          fod::mma_bf16(acc[i][2 * jj], af[i], r[0], r[1]);
          fod::mma_bf16(acc[i][2 * jj + 1], af[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next chunk but one refills this buffer
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + 2 * wm + i;
    if (y >= Hp) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + g + 8 * h;
      if (x >= Wp) continue;
      T* orow = out + (((size_t)img * Hp + y) * Wp + x) * kDCout + n0 + wn * 64 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fod::store2<T>(orow + 8 * j, fmaxf(acc[i][j][2 * h], 0.f),
                       fmaxf(acc[i][j][2 * h + 1], 0.f));
    }
  }
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

dim3 pool_grid(int B, int Hp, int Wp) {
  return dim3((Wp + kPool - 1) / kPool, (Hp + kPool - 1) / kPool, B);
}

template <typename T>
int launch_a(const void* patches, const void* w, const void* bias, void* out, int B, int Hp,
             int Wp, int Js, cudaStream_t stream) {
  auto kern = stem_a_kernel<T>;
  const size_t smem = (size_t)max_i(kStage, kConvPix * kCout) * sizeof(float);
  if (int err = prepare(kern, smem)) return err;
  kern<<<pool_grid(B, Hp, Wp), kThreads, smem, stream>>>(
      static_cast<const T*>(patches), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), Hp, Wp, Js);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_b(const void* sp, const void* w, const void* bias, void* out, int B, int Hp, int Wp,
             int Js, cudaStream_t stream) {
  auto kern = stem_b_kernel<T, C>;
  const size_t smem = (size_t)max_i(kStage + kWin * kWin * C, kConvPix * kCout) * sizeof(float);
  if (int err = prepare(kern, smem)) return err;
  kern<<<pool_grid(B, Hp, Wp), kThreads, smem, stream>>>(
      static_cast<const T*>(sp), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), Hp, Wp, Js);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* xp, const void* w9, void* out, int B, int Hp, int Wp,
             cudaStream_t stream) {
  auto kern = stem_d_kernel<T>;
  if (int err = prepare(kern, kDSmem)) return err;
  const int tiles = ((Hp + kDTH - 1) / kDTH) * ((Wp + kDTW - 1) / kDTW);
  const dim3 grid(2 * tiles, B);
  kern<<<grid, kThreads, kDSmem, stream>>>(static_cast<const T*>(xp),
                                           static_cast<const __nv_bfloat16*>(w9),
                                           static_cast<T*>(out), Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}

// D's registers a thread, static and dynamic shared bytes a block, local (spill) bytes
// a thread, resident blocks an SM. Launches nothing.
template <typename T>
int info_d(int* out) {
  auto kern = stem_d_kernel<T>;
  cudaError_t err = static_cast<cudaError_t>(prepare(kern, kDSmem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, kDSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {attr.numRegs, (int)attr.sharedSizeBytes, kDSmem,
                       (int)attr.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

bool bad_pool_shape(int B, int Hp, int Wp) { return B <= 0 || B > 65535 || Hp <= 0 || Wp <= 0; }

template <int C>
int stem_b_entry(const void* sp, const void* w, const void* bias, void* out, int B, int Hp,
                 int Wp, int Js, int dtype, void* stream) {
  if (bad_pool_shape(B, Hp, Wp) || Js < 2 * Wp + 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch_b<float, C>(sp, w, bias, out, B, Hp, Wp, Js, s);
  if (dtype == fod::kBFloat16)
    return launch_b<__nv_bfloat16, C>(sp, w, bias, out, B, Hp, Wp, Js, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// patches: (B, 2Hp+1, Js, 192), Js >= 2Wp+1; w: (192, 64); bias: (64,) f32;
// out: (B, Hp, Wp, 64). All contiguous. Returns the launch's CUDA status.
extern "C" int fod_stem_a(const void* patches, const void* w, const void* bias, void* out, int B,
                          int Hp, int Wp, int Js, int dtype, void* stream) {
  if (bad_pool_shape(B, Hp, Wp) || Js < 2 * Wp + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch_a<float>(patches, w, bias, out, B, Hp, Wp, Js, s);
  if (dtype == fod::kBFloat16)
    return launch_a<__nv_bfloat16>(patches, w, bias, out, B, Hp, Wp, Js, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// sp: (B, 2Hp+4, Js, 12), Js >= 2Wp+4; w: (192, 64); bias: (64,) f32; out: (B, Hp, Wp, 64).
extern "C" int fod_stem_b(const void* sp, const void* w, const void* bias, void* out, int B,
                          int Hp, int Wp, int Js, int dtype, void* stream) {
  return stem_b_entry<12>(sp, w, bias, out, B, Hp, Wp, Js, dtype, stream);
}

// sp: (B, 2Hp+4, Js, 16), Js >= 2Wp+4; w: (256, 64); bias: (64,) f32; out: (B, Hp, Wp, 64).
extern "C" int fod_stem_b16(const void* sp, const void* w, const void* bias, void* out, int B,
                            int Hp, int Wp, int Js, int dtype, void* stream) {
  return stem_b_entry<16>(sp, w, bias, out, B, Hp, Wp, Js, dtype, stream);
}

// xp: (B, Hp+2, Wp+2, 128); w9: (9, 128, 256) bf16; out: (B, Hp, Wp, 256). All
// contiguous and 16-byte aligned.
extern "C" int fod_stem_d(const void* xp, const void* w9, void* out, int B, int Hp, int Wp,
                          int dtype, void* stream) {
  if (bad_pool_shape(B, Hp, Wp)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch_d<float>(xp, w9, out, B, Hp, Wp, s);
  if (dtype == fod::kBFloat16) return launch_d<__nv_bfloat16>(xp, w9, out, B, Hp, Wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: D's resources in xp's storage type (see info_d). Launches nothing.
extern "C" int fod_stem_d_info(int dtype, int* out) {
  if (dtype == fod::kFloat32) return info_d<float>(out);
  if (dtype == fod::kBFloat16) return info_d<__nv_bfloat16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
