// K9: the int8 activation quantizer of the int8 PTQ backbone for Hopper (sm_90a), on
// an NHWC activation read as R = N*H*W rows of C channels, f32 or bf16. Two entry
// points:
//   range:    out[c] = max(0, max over rows of f(x[r, c])), f = |x| or x itself, (C,) f32;
//   quantize: q = cast_int8(clamp(rint((x / m[c]) / scale), lo, hi) - zp), with lo, hi,
//             zp = 0, 255, 128 on the zero-point path and -127, 127, 0 on the signed
//             one; each division IEEE-rounded (__fdiv_rn: never a product by a
//             reciprocal, never one divide by m * scale), rint half to even.
// That is ops/quant.py's chain (`_amax(x.float().abs(), dims)`; `x.float() / m`, then
// `/ scale`, `round`, `clamp`, `- 128`, the cast), as the JAX package's
// future_od_tpu/ops/quant.py:44-80, 91-93, 120, 157-158, 300-301 orders it, bit for
// bit. Built without fast-math flags (ops/_kernels.py::NVCC_FLAGS).
//
// Replaces no Pallas kernel: it is the counterpart of the quantization that XLA
// fuses into its int8 convolutions on the TPU; the port ran it as about ten
// unfused torch passes over each convolution's input.
//
// What bounds it: the bytes. range reads x once; quantize reads x once and writes
// one int8 code an element; both do a few operations a byte (two IEEE divisions an
// element in quantize).
//
// The design: every thread reads 16 bytes at a time, neighbouring threads
// neighbouring addresses, over the flat array. range: the grid's stride in elements
// is a multiple of C, so each of a thread's lanes of a 16-byte load always meets the
// same channel; a thread keeps one running max a lane, as the bits of a float (for
// non-negative floats the order of the int bits is the order of the values; a
// negative value's bits are a negative int and lose to the initial 0), so the max
// is exact and does not depend on the order. A block folds its threads' maxima by
// shared-memory atomicMax into C slots, then into the output by global atomicMax
// (the output zeroed first, on the same stream). quantize: 16 elements a thread
// (one 16-byte store of codes); when C % 16 == 0 the grid's stride is a multiple of
// C and a thread keeps its 16 channels' m in registers, else the channel of each
// element comes from a running index. A zero (half of a post-ReLU input) skips both
// divisions: the divisions' slow path made zeros cost as much as the rest. On an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 11a, a forward's inputs of 4 frames at
// 896x1600, f32): the 49 range passes 1.3-1.5 ms of device time against 1.24 of
// bytes, the 53 quantizations 2.6 ms against 1.82.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 12288;  // range's shared slots: 48 KB

template <typename T>
struct Vec;  // one 16-byte load

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static uint32_t bits(const uint4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static uint32_t bits(const uint4& v, int j) {
    const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return (j & 1) ? (w & 0xffff0000u) : (w << 16);  // the f32 bits of the bf16
  }
};

template <typename T>
__device__ __forceinline__ uint32_t scalar_bits(const T* p);

template <>
__device__ __forceinline__ uint32_t scalar_bits<float>(const float* p) {
  return __float_as_uint(*p);
}

template <>
__device__ __forceinline__ uint32_t scalar_bits<__nv_bfloat16>(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

template <bool kAbs>
__device__ __forceinline__ int key(uint32_t bits) {
  return static_cast<int>(kAbs ? (bits & 0x7fffffffu) : bits);
}

template <typename T, bool kAbs>
__global__ void __launch_bounds__(kThreads)
    channel_range_kernel(const T* __restrict__ x, long long n, int C, int* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ int slots[];  // C running maxima of the block
  for (int c = threadIdx.x; c < C; c += kThreads) slots[c] = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kN;  // % C == 0
  const long long f0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kN;
  int acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0;
  long long f = f0;
  for (; f + 3 * stride + kN <= n; f += 4 * stride) {  // four loads in flight
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(x + f + u * stride));
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] = max(acc[j], key<kAbs>(Vec<T>::bits(v[u], j)));
  }
  for (; f + kN <= n; f += stride) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + f));
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = max(acc[j], key<kAbs>(Vec<T>::bits(v, j)));
  }
  if (f < n) {  // the last, partial 16 bytes
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (f + j < n) acc[j] = max(acc[j], key<kAbs>(scalar_bits(x + f + j)));
  }
  __syncthreads();
  const int c0 = static_cast<int>(f0 % C);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    int c = c0 + j;
    while (c >= C) c -= C;
    if (acc[j] > 0) atomicMax(&slots[c], acc[j]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads)
    if (slots[c] > 0) atomicMax(&out[c], slots[c]);
}

// One element's code from its f32 value t and its channel's m (mc, unread without m).
// A zero skips both divisions (half a post-ReLU input is 0): 0 / m and 0 / scale are
// +-0, which every later step maps to the same code.
template <bool kZeroPoint>
__device__ __forceinline__ int8_t code_of(float t, bool has_m, float mc, float scale) {
  if (t != 0.f) {
    if (has_m) t = __fdiv_rn(t, mc);
    t = rintf(__fdiv_rn(t, scale));
  }
  t = kZeroPoint ? fminf(fmaxf(t, 0.f), 255.f) - 128.f : fminf(fmaxf(t, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(t));
}

template <typename T, bool kZeroPoint>
__device__ __forceinline__ int8_t code(T v, const float* m, int c, float scale) {
  return code_of<kZeroPoint>(fod::to_float<T>(v), m != nullptr,
                             m != nullptr ? __ldg(m + c) : 1.f, scale);
}

// 16 elements a thread and a step of the grid's loop.
template <typename T, bool kZeroPoint>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ m,
                    const float* __restrict__ scale_ptr, int8_t* __restrict__ q, long long n,
                    int C) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kLoads = 16 / kN;
  const float scale = __ldg(scale_ptr);
  const long long chunks = n / 16;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < chunks;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(x + i * 16) + u);
    const T* e = reinterpret_cast<const T*>(v);
    alignas(16) int8_t out[16];
    int c = static_cast<int>((i * 16) % C);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      out[j] = code<T, kZeroPoint>(e[j], m, c, scale);
      if (++c == C) c = 0;
    }
    *reinterpret_cast<uint4*>(q + i * 16) = *reinterpret_cast<const uint4*>(out);
  }
  // the last n % 16 elements: one thread of the first block
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long f = chunks * 16; f < n; ++f)
      q[f] = code<T, kZeroPoint>(x[f], m, static_cast<int>(f % C), scale);
  }
}

// The same for C % 16 == 0 (every block convolution's input): the grid's stride is a
// multiple of C, so a thread's 16 elements are always the same 16 channels, whose m
// it keeps in registers.
template <typename T, bool kZeroPoint>
__global__ void __launch_bounds__(kThreads)
    quantize_channels_kernel(const T* __restrict__ x, const float* __restrict__ m,
                             const float* __restrict__ scale_ptr, int8_t* __restrict__ q,
                             long long n, int C) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kLoads = 16 / kN;
  const float scale = __ldg(scale_ptr);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;  // chunks; * 16 % C == 0
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int c0 = static_cast<int>((first * 16) % C);
  float mc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) mc[j] = m != nullptr ? __ldg(m + c0 + j) : 1.f;
  for (long long i = first; i < n / 16; i += step) {
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(x + i * 16) + u);
    const T* e = reinterpret_cast<const T*>(v);
    alignas(16) int8_t out[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[j] = code_of<kZeroPoint>(fod::to_float<T>(e[j]), m != nullptr, mc[j], scale);
    *reinterpret_cast<uint4*>(q + i * 16) = *reinterpret_cast<const uint4*>(out);
  }
}

int multiprocessors() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return sms;
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b, b = t;
  }
  return a;
}

template <typename T, bool kAbs>
int launch_range(const void* x, void* out, long long n, int C, cudaStream_t s) {
  constexpr int kN = Vec<T>::kN;
  const long long per_block = static_cast<long long>(kThreads) * kN;
  const long long step = C / gcd(C, per_block);  // blocks: a multiple of it, so stride % C == 0
  long long blocks = (n + 4 * per_block - 1) / (4 * per_block);
  blocks = blocks < 4LL * multiprocessors() ? blocks : 4LL * multiprocessors();
  blocks = (blocks + step - 1) / step * step;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(out, 0, C * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_range_kernel<T, kAbs><<<static_cast<unsigned>(blocks), kThreads, C * sizeof(int), s>>>(
      static_cast<const T*>(x), n, C, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kZeroPoint>
int launch_quantize(const void* x, const void* m, const void* scale, void* q, long long n, int C,
                    cudaStream_t s) {
  const long long chunks = n / 16;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  blocks = blocks < 8LL * multiprocessors() ? blocks : 8LL * multiprocessors();
  if (blocks < 1) blocks = 1;
  const T* xt = static_cast<const T*>(x);
  const float* mf = static_cast<const float*>(m);
  const float* sf = static_cast<const float*>(scale);
  int8_t* qt = static_cast<int8_t*>(q);
  if (C % 16 == 0) {
    const long long unit = C / gcd(C, 16LL * kThreads);  // blocks: a multiple of it
    blocks = (blocks + unit - 1) / unit * unit;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    quantize_channels_kernel<T, kZeroPoint>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(xt, mf, sf, qt, n, C);
  } else {
    quantize_kernel<T, kZeroPoint><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xt, mf, sf, qt, n, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements (rows of C channels), f32 or bf16, 16-byte aligned, contiguous; out:
// (C,) f32, zeroed here first; absolute: f = |x| (else x). Returns the launch's CUDA
// status.
extern "C" int fod_int8_channel_range(const void* x, void* out, long long n, int C,
                                      int absolute, int dtype, void* stream) {
  if (n <= 0 || C <= 0 || C > kMaxChannels || n % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return absolute ? launch_range<float, true>(x, out, n, C, s)
                    : launch_range<float, false>(x, out, n, C, s);
  if (dtype == fod::kBFloat16)
    return absolute ? launch_range<__nv_bfloat16, true>(x, out, n, C, s)
                    : launch_range<__nv_bfloat16, false>(x, out, n, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: n elements (rows of C channels), f32 or bf16, 16-byte aligned, contiguous; m:
// (C,) f32 or null (no division by m); scale: one f32 on the device; q: n int8 codes,
// 16-byte aligned. zero_point: clamp to [0, 255] and subtract 128, else clamp to
// [-127, 127]. Returns the launch's CUDA status.
extern "C" int fod_int8_quantize(const void* x, const void* m, const void* scale, void* q,
                                 long long n, int C, int zero_point, int dtype, void* stream) {
  if (n <= 0 || C <= 0 || n % C != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return zero_point ? launch_quantize<float, true>(x, m, scale, q, n, C, s)
                      : launch_quantize<float, false>(x, m, scale, q, n, C, s);
  if (dtype == fod::kBFloat16)
    return zero_point ? launch_quantize<__nv_bfloat16, true>(x, m, scale, q, n, C, s)
                      : launch_quantize<__nv_bfloat16, false>(x, m, scale, q, n, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
