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
// D's output is 2 bytes per operation-heavy position as well. These first versions
// compute on the CUDA cores in f32 through the register-tiled block GEMM
// (block_gemm.cuh), so the f32 rate bounds them. A, B and B16 share the GEMM and the
// pool epilogue and differ only in where the patch matrix comes from: A stages
// K-slices of it straight from device memory, B and B16 stage the 20x20 window of
// padded s2d rows their 17x17 conv positions read in shared memory and gather the
// patches from there. One block of 256 threads owns an 8x8 tile of pool outputs
// (all 64 channels); the conv values are kept in shared memory, aliased over the
// GEMM's staging, and never written to device memory. D: one block owns 128 output
// pixels x 128 of the 256 output channels; its A operand rounds to bf16 as it is
// staged (the TPU kernel rounds x to bf16 whatever the storage type), w9 is bf16.
#include "block_gemm.cuh"

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
constexpr int kDK = 9 * kDCin;
constexpr int kDTM = 8, kDTN = 8;         // D's block: 128 pixels x 128 channels
constexpr int kDRows = 16 * kDTM, kDCols = 16 * kDTN;

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
// (9, 128, 256) bf16, tap-major; out (B, Hp, Wp, 256) = relu(sum over the 9 taps).
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_d_kernel(const T* __restrict__ xp, const __nv_bfloat16* __restrict__ w9,
              T* __restrict__ out, int Hp, int Wp) {
  extern __shared__ float4 fod_smem[];
  float* smem = reinterpret_cast<float*>(fod_smem);
  __shared__ int pix[kDRows];  // offset in the image of each row's (0, 0) tap
  const int img = blockIdx.z, n0 = blockIdx.y * kDCols, m0 = blockIdx.x * kDRows;
  const int npix = Hp * Wp, M = min(kDRows, npix - m0);
  const T* xb = xp + (size_t)img * (Hp + 2) * (Wp + 2) * kDCin;
  for (int m = threadIdx.x; m < kDRows; m += kThreads) {
    const int g = min(m0 + m, npix - 1);
    pix[m] = ((g / Wp) * (Wp + 2) + g % Wp) * kDCin;
  }
  __syncthreads();
  auto load_a = [&](int m, int k) -> float {
    const int tap = k / kDCin;
    const float x = fod::to_float(
        xb[pix[m] + ((tap / 3) * (Wp + 2) + tap % 3) * kDCin + k % kDCin]);
    return fod::round_to<__nv_bfloat16>(x);
  };
  float acc[kDTM][kDTN] = {};
  fod::block_gemm<kDTM, kDTN>(acc, load_a, M, kDK, w9, kDCout, n0, smem,
                              smem + fod::gemm_stage_a<kDTM>());
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  T* ob = out + ((size_t)img * npix + m0) * kDCout + n0;
#pragma unroll
  for (int i = 0; i < kDTM; ++i) {
    const int m = tm + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kDTN; ++j)
      ob[(size_t)m * kDCout + tn + 16 * j] = fod::from_float<T>(fmaxf(acc[i][j], 0.f));
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
  const size_t smem =
      (size_t)(fod::gemm_stage_a<kDTM>() + fod::gemm_stage_b<kDTN>()) * sizeof(float);
  if (int err = prepare(kern, smem)) return err;
  const dim3 grid((Hp * Wp + kDRows - 1) / kDRows, kDCout / kDCols, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(xp),
                                         static_cast<const __nv_bfloat16*>(w9),
                                         static_cast<T*>(out), Hp, Wp);
  return static_cast<int>(cudaGetLastError());
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

// xp: (B, Hp+2, Wp+2, 128); w9: (9, 128, 256) bf16; out: (B, Hp, Wp, 256).
extern "C" int fod_stem_d(const void* xp, const void* w9, void* out, int B, int Hp, int Wp,
                          int dtype, void* stream) {
  if (bad_pool_shape(B, Hp, Wp)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch_d<float>(xp, w9, out, B, Hp, Wp, s);
  if (dtype == fod::kBFloat16) return launch_d<__nv_bfloat16>(xp, w9, out, B, Hp, Wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
