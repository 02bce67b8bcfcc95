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
// needs) against 12 input and 16 (pooled) output elements per position, so the
// arithmetic rate bounds it; the unfused version also writes and reads back the 4x
// larger conv output, which this one keeps in shared memory.
//
// The design: an implicit GEMM on the tensor cores (mma.sync, mma_tile.cuh), M = a
// tile's conv positions, N = 64, K = 192 in (dy, dx, c) order, the s2d kernel's 45 zero
// taps included (they fill no whole k-step). For a fixed dy a position's (dx, c) row is
// 48 contiguous elements of the staged NHWC window, so the A fragments are read from
// the window itself, with no im2col buffer. In bf16 a pixel is 24 bytes, so a row
// starts 16-byte aligned only at even columns and ldmatrix cannot take it: A comes by
// 32-bit loads of element pairs, which are always 4-byte aligned (padding the pixels to
// 16 channels would cost a third more products). bf16 goes as stored (12 k-steps of
// 16); f32 as 3xTF32 (24 k-steps of 8), each operand split where it is loaded (an A
// fragment serves 4 n-tiles, a B fragment 2 m-tiles): split copies staged beside the
// window and the weights would double their shared memory, to one block an SM. A
// fresh accumulator every 32 reduction rows is added on the CUDA cores (the tensor
// cores' f32 sums truncate).
//
// A block of 8 warps owns 7 x 8 pool outputs of one image (224 rows are 32 tiles): it
// stages the 18 x 20 x 12 input window (zero outside the image) and the weights,
// packed once a model in fragment order (ops/fused_resnet.py::pack_stem: a 16-byte load
// a lane gives the B fragments of two n-tiles), then computes the 15 x 17 = 255 conv
// positions its pools read, 16 m-tiles, two a warp, in two passes of 32 channels. Each
// pass writes relu(conv + bias) into a conv tile in the storage type (positions outside
// the conv output -inf: conv row and column -1 are real conv values the pool must not
// take) and then takes each pool's 3x3 max from it. Rounding is monotone, so the max of
// the rounded values equals the rounded max, which is what the plain version computes.
// Shared memory: 52.4 KB a block in bf16, 104.7 KB in f32, two blocks (16 warps) an
// SM. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 1, the flagship's 4 x 448x800
// s2d input): 0.86 ms in f32 (121 registers) and 0.24 in bf16 (100), against bounds of
// 0.164 and 0.027 ms (147 taps) and 1.96 and 2.11 for the CUDA-core kernel it replaced.
#include <cstdint>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using fod::cp_async16;
using fod::load8;
using fod::mma_3xtf32;
using fod::mma_bf16;
using fod::pack_bf16;
using fod::smem_addr;
using fod::split_tf32;
using fod::store2;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPoolH = 7, kPoolW = 8;                            // pool outputs a tile
constexpr int kConvH = 2 * kPoolH + 1, kConvW = 2 * kPoolW + 1;  // conv positions they read
constexpr int kInH = kConvH + 3, kInW = kConvW + 3;              // input pixels those read
constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kK = 16 * kCin;                         // 192, in (dy, dx, c) order
constexpr int kDyElems = 4 * kCin;                    // a dy's (dx, c) row: 48 elements
constexpr int kPositions = kConvH * kConvW;           // 255
constexpr int kMTiles = (kPositions + 15) / 16;       // 16, the last with one padding row
constexpr int kMI = kMTiles / kWarps;                 // m-tiles a warp
constexpr int kPassC = 32;                            // output channels a pass
constexpr int kNJ = kPassC / 8;                       // n-tiles a pass
constexpr int kConvRow = kPassC + 8;                  // elements a staged conv position
static_assert(kMTiles == kMI * kWarps, "every warp takes as many m-tiles");

template <typename T>
struct StemGeometry {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStep = kF32 ? 8 : 16;          // reduction rows an mma
  static constexpr int kSteps = kK / kStep;            // 24 or 12
  static constexpr int kStepsDy = kDyElems / kStep;    // 6 or 3 a dy
  static constexpr int kFresh = 32 / kStep;            // k-steps a fresh accumulator
  static constexpr int kWindow = kInH * kInW * kCin * (int)sizeof(T);  // bytes
  static constexpr int kWeights = kK * kCout * (int)sizeof(T);
  static constexpr int kConv = kPositions * kConvRow * (int)sizeof(T);
  static constexpr int kSmem = kWindow + kWeights + kConv;
  static_assert(kWindow % 16 == 0 && kWeights % 16 == 0, "16-byte regions");
};

// 8 values rounded to T into 8 consecutive elements (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&x)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    float4* d = reinterpret_cast<float4*>(p);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                              pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const T* __restrict__ x, const uint4* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int Hc, int Wc) {
  using G = StemGeometry<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);                                   // [kInH][kInW][kCin]
  const uint4* ws = reinterpret_cast<const uint4*>(smem + G::kWindow);   // fragment order
  T* conv = reinterpret_cast<T*>(smem + G::kWindow + G::kWeights);       // [pos][kConvRow]

  const int img = blockIdx.z;
  const int Hp = Hc / 2, Wp = Wc / 2;
  const int p0 = blockIdx.y * kPoolH, q0 = blockIdx.x * kPoolW;
  const int cr0 = 2 * p0 - 1, cc0 = 2 * q0 - 1;  // first conv row/col the tile reads
  const int ir0 = cr0 - 2, ic0 = cc0 - 2;        // conv row r reads input rows r-2 .. r+1
  const T* xb = x + (size_t)img * Hc * Wc * kCin;

  for (int i = threadIdx.x; i < G::kWeights / 16; i += kThreads)
    cp_async16(smem_addr(smem + G::kWindow + 16 * i), w + i, 16);
  fod::cp_async_commit();
  using Vec = typename std::conditional<G::kF32, float4, uint2>::type;  // 4 channels
  for (int i = threadIdx.x; i < kInH * kInW * 3; i += kThreads) {
    const int pix = i / 3, part = i % 3;
    const int gy = ir0 + pix / kInW, gx = ic0 + pix % kInW;
    Vec v{};
    if (gy >= 0 && gy < Hc && gx >= 0 && gx < Wc)
      v = *reinterpret_cast<const Vec*>(xb + ((size_t)gy * Wc + gx) * kCin + 4 * part);
    *reinterpret_cast<Vec*>(win + pix * kCin + 4 * part) = v;
  }
  fod::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's A rows, positions 16 mt + g and + 8 of the warp's m-tiles mt, as the
  // window offset of their top-left input pixel (the padding row repeats position 254)
  int base[kMI][2];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = min(16 * (kMI * warp + i) + g + 8 * hh, kPositions - 1);
      base[i][hh] = ((m / kConvW) * kInW + m % kConvW) * kCin;
    }

  for (int pass = 0; pass < kCout / kPassC; ++pass) {
    float acc[kMI][kNJ][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < G::kSteps; k0 += G::kFresh) {
      float c[kMI][kNJ][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
#pragma unroll
      for (int ks = k0; ks < k0 + G::kFresh; ++ks) {
        const int off = (ks / G::kStepsDy) * kInW * kCin + (ks % G::kStepsDy) * G::kStep;
        // B: n-tiles 2jp, 2jp + 1 of this k-step from uint4 jp, jp = 2 pass + 0, 1
        const uint4 w0 = ws[(ks * 4 + 2 * pass) * 32 + lane];
        const uint4 w1 = ws[(ks * 4 + 2 * pass + 1) * 32 + lane];
        const uint32_t b[kNJ][2] = {{w0.x, w0.y}, {w0.z, w0.w}, {w1.x, w1.y}, {w1.z, w1.w}};
        if constexpr (G::kF32) {
          uint32_t bb[kNJ][2], bs[kNJ][2];
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) split_tf32(__uint_as_float(b[j][e]), bb[j][e], bs[j][e]);
#pragma unroll
          for (int i = 0; i < kMI; ++i) {
            // A slots (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
            const float av[4] = {win[base[i][0] + off + t], win[base[i][1] + off + t],
                                 win[base[i][0] + off + t + 4], win[base[i][1] + off + t + 4]};
            uint32_t ab[4], as[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(av[e], ab[e], as[e]);
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
              mma_3xtf32(c[i][j], ab, as, bb[j][0], bb[j][1], bs[j][0], bs[j][1]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kMI; ++i) {
            // A pairs (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
            const T* r0 = win + base[i][0] + off + 2 * t;
            const T* r1 = win + base[i][1] + off + 2 * t;
            const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(r0),
                                   *reinterpret_cast<const uint32_t*>(r1),
                                   *reinterpret_cast<const uint32_t*>(r0 + 8),
                                   *reinterpret_cast<const uint32_t*>(r1 + 8)};
#pragma unroll
            for (int j = 0; j < kNJ; ++j) mma_bf16(c[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
    }

    // relu(conv + bias) into the conv tile, -inf where the conv output has no position
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 16 * (kMI * warp + i) + g + 8 * hh;
        if (m >= kPositions) continue;
        const int gy = cr0 + m / kConvW, gx = cc0 + m % kConvW;
        const bool inside = gy >= 0 && gy < Hc && gx >= 0 && gx < Wc;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = 8 * j + 2 * t;
          const float* bn = bias + kPassC * pass + n;
          store2<T>(conv + m * kConvRow + n,
                    inside ? fmaxf(acc[i][j][2 * hh] + bn[0], 0.f) : -INFINITY,
                    inside ? fmaxf(acc[i][j][2 * hh + 1] + bn[1], 0.f) : -INFINITY);
        }
      }
    __syncthreads();

    // Pool (p, q) reads conv rows 2p-1 .. 2p+1, i.e. local rows 2(p-p0) .. +2; a thread
    // takes 8 channels of one pool.
    for (int i = threadIdx.x; i < kPoolH * kPoolW * (kPassC / 8); i += kThreads) {
      const int cg = i % (kPassC / 8), pq = i / (kPassC / 8);
      const int pr = pq / kPoolW, pc = pq % kPoolW;
      const int p = p0 + pr, q = q0 + pc;
      if (p >= Hp || q >= Wp) continue;
      float mx[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float v[8];
          load8<T>(v, reinterpret_cast<const unsigned char*>(
                          conv + ((2 * pr + dy) * kConvW + 2 * pc + dx) * kConvRow + 8 * cg));
#pragma unroll
          for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], v[e]);
        }
      store8<T>(out + (((size_t)img * Hp + p) * Wp + q) * kCout + kPassC * pass + 8 * cg, mx);
    }
    __syncthreads();  // the next pass rewrites the conv tile
  }
}

constexpr int kMaxDevices = 64;

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int Hc, int Wc,
           cudaStream_t stream) {
  using G = StemGeometry<T>;
  auto kern = fused_stem_kernel<T>;
  static bool done[kMaxDevices] = {};  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < kMaxDevices && done[dev])) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = Hc / 2, Wp = Wc / 2;
  const dim3 grid((Wp + kPoolW - 1) / kPoolW, (Hp + kPoolH - 1) / kPoolH, B);
  kern<<<grid, kThreads, G::kSmem, stream>>>(static_cast<const T*>(x),
                                             static_cast<const uint4*>(w),
                                             static_cast<const float*>(bias),
                                             static_cast<T*>(out), Hc, Wc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int* out) {
  using G = StemGeometry<T>;
  auto kern = fused_stem_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {attr.numRegs, (int)attr.sharedSizeBytes, G::kSmem,
                       (int)attr.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// x_s2d: (B, Hc, Wc, 12), Hc and Wc even, 16-byte aligned; w: the (192, 64) weights with
// rows in (dy, dx, c) order, packed in fragment order (ops/fused_resnet.py::pack_stem);
// bias: (64,) f32; out: (B, Hc/2, Wc/2, 64). All contiguous. Returns the launch's CUDA
// status.
extern "C" int fod_fused_stem(const void* x, const void* w, const void* bias, void* out, int B,
                              int Hc, int Wc, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Hc < 2 || Wc < 2 || Hc % 2 != 0 || Wc % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch<float>(x, w, bias, out, B, Hc, Wc, s);
  if (dtype == fod::kBFloat16) return launch<__nv_bfloat16>(x, w, bias, out, B, Hc, Wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: registers a thread, static and dynamic shared bytes a block, local (spill)
// bytes a thread, resident blocks an SM. Launches nothing.
extern "C" int fod_fused_stem_info(int dtype, int* out) {
  if (dtype == fod::kFloat32) return info<float>(out);
  if (dtype == fod::kBFloat16) return info<__nv_bfloat16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
