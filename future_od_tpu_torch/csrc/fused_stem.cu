// Fused ResNet stem for Hopper (sm_90a), NHWC:
//   out = maxpool3x3/2 pad 1 (relu(conv4x4/1 pad (2,1) (x_s2d) w4 + bias))
// over 2x2 space-to-depth input (12 channels), which equals the 7x7/2 stem conv on
// the unpacked image with frozen BN folded into w4 and bias. The pool's padding is
// -inf: a padded position never wins the max.
//
// Replaces the Pallas TPU kernel future_od_tpu/ops/fused_resnet.py::_stem_kernel
// (behind fused_stem). Same function; the blocking is this card's own.
//
// What bounds it: 2*147*64 operations per conv position (the 7x7x3 taps the stem
// needs; this version also multiplies the s2d kernel's 45 zero taps, 192 in all)
// against 12 input and 16 (pooled) output elements per position, so the
// arithmetic rate bounds it; the unfused version also writes and reads back the
// 4x larger conv output. This version computes on the CUDA cores in f32 and never
// writes the conv output to device memory. One block of 256 threads owns an 8x8 tile of pool outputs of one
// image: it stages the 20x20x12 input window and the (192, 64) weights in shared
// memory, computes the 17x17 conv positions the tile's pools read (a strided
// 19x4 micro-tile per thread, im2col addressing into the staged window), stores
// relu(conv + bias) in shared memory with positions outside the conv output set
// to -inf, and takes each pool's 3x3 max from there.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // 16 x 16 threads per block
constexpr int kPool = 8;                // pool outputs per tile side
constexpr int kConv = 2 * kPool + 1;    // conv rows/cols the tile's pools read
constexpr int kIn = kConv + 3;          // input rows/cols those conv positions read
constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kTaps = 16;               // 4x4
constexpr int kK = kTaps * kCin;        // 192
constexpr int kConvPix = kConv * kConv;
constexpr int kTM = (kConvPix + 15) / 16;
constexpr int kTN = kCout / 16;
constexpr int kSmemFloats = kIn * kIn * kCin + kK * kCout + kConvPix * kCout;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int Hc, int Wc) {
  extern __shared__ float4 fod_smem[];
  float* xin = reinterpret_cast<float*>(fod_smem);  // [kIn][kIn][kCin]
  float* ws = xin + kIn * kIn * kCin;                // [kK][kCout]
  float* conv = ws + kK * kCout;                     // [kConvPix][kCout]

  const int img = blockIdx.z;
  const int Hp = Hc / 2, Wp = Wc / 2;
  const int p0 = blockIdx.y * kPool, q0 = blockIdx.x * kPool;
  const int cr0 = 2 * p0 - 1, cc0 = 2 * q0 - 1;  // first conv row/col the tile reads
  const int ir0 = cr0 - 2, ic0 = cc0 - 2;        // conv row r reads input rows r-2 .. r+1
  const T* xb = x + (size_t)img * Hc * Wc * kCin;

  for (int i = threadIdx.x; i < kIn * kIn * kCin; i += kThreads) {
    const int r = i / (kIn * kCin), rem = i % (kIn * kCin);
    const int gy = ir0 + r, gx = ic0 + rem / kCin;
    const bool inside = gy >= 0 && gy < Hc && gx >= 0 && gx < Wc;
    xin[i] = inside ? fod::to_float(xb[((size_t)gy * Wc + gx) * kCin + rem % kCin]) : 0.f;
  }
  for (int i = threadIdx.x; i < kK * kCout; i += kThreads) ws[i] = fod::to_float(w[i]);
  __syncthreads();

  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  int base[kTM];  // offset in xin of each row's top-left input pixel
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = min(tm + 16 * i, kConvPix - 1);
    base[i] = ((m / kConv) * kIn + m % kConv) * kCin;
  }
  float acc[kTM][kTN] = {};
  for (int tap = 0; tap < kTaps; ++tap) {
    const int off = ((tap / 4) * kIn + tap % 4) * kCin;
#pragma unroll 4
    for (int c = 0; c < kCin; ++c) {
      const float* wr = ws + (tap * kCin + c) * kCout;
      float wv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = wr[tn + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = xin[base[i] + off + c];
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = tm + 16 * i;
    if (m >= kConvPix) continue;
    const int gy = cr0 + m / kConv, gx = cc0 + m % kConv;
    const bool inside = gy >= 0 && gy < Hc && gx >= 0 && gx < Wc;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = tn + 16 * j;
      conv[m * kCout + n] = inside ? fmaxf(acc[i][j] + bias[n], 0.f) : -INFINITY;
    }
  }
  __syncthreads();

  // Pool (p, q) reads conv rows 2p-1 .. 2p+1, i.e. local rows 2(p-p0) .. +2.
  for (int i = threadIdx.x; i < kPool * kPool * kCout; i += kThreads) {
    const int n = i % kCout, pq = i / kCout;
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

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int Hc, int Wc,
           cudaStream_t stream) {
  auto kern = fused_stem_kernel<T>;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = Hc / 2, Wp = Wc / 2;
  const dim3 grid((Wp + kPool - 1) / kPool, (Hp + kPool - 1) / kPool, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                         static_cast<const float*>(bias), static_cast<T*>(out),
                                         Hc, Wc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_s2d: (B, Hc, Wc, 12), Hc and Wc even; w: (4, 4, 12, 64) HWIO, i.e. (192, 64)
// with rows in (dy, dx, c) order; bias: (64,) f32; out: (B, Hc/2, Wc/2, 64). All
// contiguous. Returns the launch's CUDA status.
extern "C" int fod_fused_stem(const void* x, const void* w, const void* bias, void* out, int B,
                              int Hc, int Wc, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Hc < 2 || Wc < 2 || Hc % 2 != 0 || Wc % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch<float>(x, w, bias, out, B, Hc, Wc, s);
  if (dtype == fod::kBFloat16) return launch<__nv_bfloat16>(x, w, bias, out, B, Hc, Wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
