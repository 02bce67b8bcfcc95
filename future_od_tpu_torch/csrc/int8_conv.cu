// K8: the int8 convolution of the int8 PTQ backbone for Hopper (sm_90a), NHWC:
//   out[b, oh, ow, c] = cast(f32(acc + zp[c]) * sw[c] + bias[c]), relu if asked,
//   acc = sum over (kh, kw, ci) of q[b, oh*sh - pt + kh*dh, ow*sw - pl + kw*dw, ci]
//         * w[c, (kh, kw, ci)], q outside the image = pad_value,
// int8 codes and int8 weights, exact int32 sums, then ops/quant.py's epilogue: the
// f32 product and sum each rounded once (__fmul_rn / __fadd_rn: nvcc would contract
// them into one FMA, and XLA rounds twice), the cast round-to-nearest-even.
//
// Replaces no Pallas kernel: the JAX package's int8 convolutions are XLA's
// (future_od_tpu/ops/quant.py:99,121, lax.conv_general_dilated with int32
// preferred_element_type), and no PyTorch call computes an int8 convolution on CUDA.
//
// What bounds it: 2*K operations per output element (K = 64 to 4608) against an int8
// code read once and the output written once in f32 or bf16. At 1979 TOPS (int8 dense)
// against 3.35 TB/s, the bytes bound 21 of the trunk's 24 distinct shapes (the f32
// output's 4 bytes an element against 1x1 convolutions' short K), the operations only
// the 3x3s of layer3 and layer4.
//
// The design, simple and right first: an implicit GEMM on mma.sync m16n8k32 (s8 x s8
// -> s32), M = the B*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin padded with zero
// weights to Kp, a multiple of 32. A block of 4 warps owns 128 pixels x 64 channels
// (a warp 64 x 32: 4 x 4 mma tiles) and walks K in stages of 64 values, three stages
// in flight. The weights come packed (Cout, Kp), a row an output channel
// (ops/int8_conv.py::pack_int8_weights), by 16-byte cp.async. The codes are gathered
// into the A tile: when Cin % 16 == 0 each 16 values of K lie in one tap and are 16
// contiguous bytes, copied by cp.async, or written as pad_value bytes where the tap
// falls outside the image; else (the stems: Cin 3 and 12) each byte is gathered by
// hand. Tiles in shared memory have 80-byte rows (64 + 16), so the ldmatrix reads of
// 8 rows hit 8 distinct 4-bank groups. ldmatrix of the b16 8x8 matrices gives the s8
// fragments of m16n8k32 directly: a lane's 4 bytes of a row are one b16 pair. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 11a, the 53 convolutions of a forward
// of 4 frames at 896x1600, f32 out): 7.02 ms against a bound of 1.93 ms (bytes), 124
// registers (157 for the byte gather), 4 blocks an SM; 28-236 TOPS a shape.
#include <cstdint>

#include "mma_tile.cuh"

namespace {

using fod::cp_async16;
using fod::cp_async_commit;
using fod::ldmatrix_x4;
using fod::smem_addr;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 128;           // output pixels a block
constexpr int kBN = 64;            // output channels a block
constexpr int kBK = 64;            // K values a stage (two mma k-steps)
constexpr int kRow = kBK + 16;     // bytes a staged row
constexpr int kStages = 3;
constexpr int kAStage = kBM * kRow;
constexpr int kBStage = kBN * kRow;
constexpr int kSmem = kStages * (kAStage + kBStage);  // 46,080 bytes: static

struct Conv {
  const int8_t* q;
  const int8_t* w;
  const int* zp;
  const float* sw;
  const float* bias;
  void* out;
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw_, pt, pl, dh, dw, K, Kp, relu;
  uint32_t pad4;  // pad_value in each byte
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The input window origin of one output pixel: (image offset, ih0, iw0), or valid false
// for a pixel past M.
struct Pixel {
  long long base;  // element offset of image b
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ Pixel pixel_of(const Conv& p, int m) {
  Pixel px;
  const int M = p.B * p.Ho * p.Wo;
  px.valid = m < M;
  if (!px.valid) m = 0;
  const int b = m / (p.Ho * p.Wo), r = m - b * (p.Ho * p.Wo);
  const int oh = r / p.Wo, ow = r - oh * p.Wo;
  px.base = static_cast<long long>(b) * p.H * p.W * p.Cin;
  px.ih0 = oh * p.sh - p.pt;
  px.iw0 = ow * p.sw_ - p.pl;
  return px;
}

// Stage K values [k0, k0 + kBK) of the block's A rows and B rows into stage buffers.
// Thread t owns chunk (t % 4) of 16 bytes in A rows t / 4 + 32 i, and B rows t / 4 +
// 32 i (i < 2).
template <bool kVec>
__device__ __forceinline__ void load_stage(const Conv& p, const Pixel (&px)[4], int n0, int k0,
                                           unsigned char* As, unsigned char* Bs) {
  const int t = threadIdx.x, col = (t & 3) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (t >> 2) + 32 * i;
    unsigned char* dst = As + row * kRow + col;
    const int k = k0 + col;
    if constexpr (kVec) {
      bool copied = false;
      uint32_t fill = 0u;
      if (k < p.K && px[i].valid) {
        const int tap = k / p.Cin, ci = k - tap * p.Cin;
        const int kh = tap / p.KW, kw = tap - kh * p.KW;
        const int ih = px[i].ih0 + kh * p.dh, iw = px[i].iw0 + kw * p.dw;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
          cp_async16(smem_addr(dst),
                     p.q + px[i].base + (static_cast<long long>(ih) * p.W + iw) * p.Cin + ci, 16);
          copied = true;
        } else {
          fill = p.pad4;
        }
      }
      if (!copied) *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
    } else {  // the byte gather: the tap and channel of k, then one step a byte
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (px[i].valid && k < p.K) {
        const int tap = k / p.Cin;
        int ci = k - tap * p.Cin, kh = tap / p.KW, kw = tap - kh * p.KW;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          uint32_t v = 0u;
          if (k + j < p.K) {
            const int ih = px[i].ih0 + kh * p.dh, iw = px[i].iw0 + kw * p.dw;
            v = (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W)
                    ? (p.pad4 & 0xffu)
                    : static_cast<uint8_t>(
                          p.q[px[i].base + (static_cast<long long>(ih) * p.W + iw) * p.Cin + ci]);
          }
          words[j >> 2] |= v << (8 * (j & 3));
          if (++ci == p.Cin) {
            ci = 0;
            if (++kw == p.KW) kw = 0, ++kh;
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (t >> 2) + 32 * i;
    const int k = k0 + col;
    const bool inside = k < p.Kp;
    cp_async16(smem_addr(Bs + row * kRow + col),
               p.w + static_cast<long long>(n0 + row) * p.Kp + (inside ? k : 0), inside ? 16 : 0);
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, float v0, float v1);

template <>
__device__ __forceinline__ void store_pair<float>(float* out, float v0, float v1) {
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out, float v0,
                                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float epilogue(const Conv& p, int acc, int n) {
  const int a = p.zp != nullptr ? acc + p.zp[n] : acc;
  float v = __fmul_rn(__int2float_rn(a), p.sw[n]);
  if (p.bias != nullptr) v = __fadd_rn(v, p.bias[n]);
  if (p.relu && v < 0.f) v = 0.f;  // keeps NaN, as relu does
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Conv p) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  unsigned char* As = smem;
  unsigned char* Bs = smem + kStages * kAStage;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  Pixel px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = pixel_of(p, m0 + (threadIdx.x >> 2) + 32 * i);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int stages = (p.Kp + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load_stage<kVec>(p, px, n0, s * kBK, As + s * kAStage, Bs + s * kBStage);
    cp_async_commit();
  }
  // ldmatrix addresses: A rows (lane & 15) at byte (lane >> 4) * 16 of an m-tile; B
  // rows 8 * (lane >> 4) + (lane & 7) of an n-tile pair at byte ((lane >> 3) & 1) * 16.
  const int a_off = (wm * 64 + (lane & 15)) * kRow + (lane >> 4) * 16;
  const int b_off = (wn * 32 + 8 * (lane >> 4) + (lane & 7)) * kRow + ((lane >> 3) & 1) * 16;

  for (int s = 0; s < stages; ++s) {
    fod::cp_async_wait_one();  // stage s has landed (kStages - 2 groups may fly)
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < stages) {
      const int buf = next % kStages;
      load_stage<kVec>(p, px, n0, next * kBK, As + buf * kAStage, Bs + buf * kBStage);
    }
    cp_async_commit();
    const int buf = s % kStages;
    const uint32_t a_base = smem_addr(As + buf * kAStage + a_off);
    const uint32_t b_base = smem_addr(Bs + buf * kBStage + b_off);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a[mt], a_base + mt * 16 * kRow + ks * 32);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_base + np * 16 * kRow + ks * 32);
        b[2 * np][0] = r[0], b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  fod::cp_async_wait_all();

  // C fragment: rows g and g + 8 of an m-tile, columns 2t and 2t + 1 of an n-tile.
  const int g = lane >> 2, tq = lane & 3;
  const int M = p.B * p.Ho * p.Wo;
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
        store_pair<T>(out + static_cast<long long>(m) * p.Cout + n,
                      epilogue(p, acc[mt][nt][2 * half], n),
                      epilogue(p, acc[mt][nt][2 * half + 1], n + 1));
      }
    }
  }
}

template <typename T>
int launch(const Conv& p, cudaStream_t stream) {
  const long long M = static_cast<long long>(p.B) * p.Ho * p.Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), p.Cout / kBN);
  if (p.Cin % 16 == 0)
    int8_conv_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  else
    int8_conv_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int info(int* out) {
  auto kern = int8_conv_kernel<T, kVec>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {attr.numRegs, (int)attr.sharedSizeBytes, 0, (int)attr.localSizeBytes,
                       blocks};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// q: (B, H, W, Cin) int8 codes, 16-byte aligned; w: (Cout, Kp) int8, 16-byte aligned,
// rows (kh, kw, ci) zero padded to Kp (a multiple of 32); zp: (Cout,) int32 or null; sw:
// (Cout,) f32; bias: (Cout,) f32 or null; out: (B, Ho, Wo, Cout) f32 or bf16. Cout a
// multiple of 64; padding (pt, pl) at the top and left (the bottom and right follow
// from Ho and Wo); pad_value in [-128, 127]. All contiguous. Returns the launch's CUDA
// status.
extern "C" int fod_int8_conv(const void* q, const void* w, const void* zp, const void* sw,
                             const void* bias, void* out, int B, int H, int W, int Cin, int Ho,
                             int Wo, int Cout, int KH, int KW, int sh, int sw_, int pt, int pl,
                             int dh, int dw, int Kp, int pad_value, int relu, int dtype,
                             void* stream) {
  const long long K = static_cast<long long>(KH) * KW * Cin;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 ||
      Cout % kBN != 0 || Cout / kBN > 65535 || KH <= 0 || KW <= 0 || sh <= 0 || sw_ <= 0 ||
      dh <= 0 || dw <= 0 || Kp % 32 != 0 || Kp < K || Kp - K >= 32 || pad_value < -128 ||
      pad_value > 127 || M * Cout >= (1LL << 62) || M > (1LL << 31) - kBM ||
      static_cast<long long>(B) * H * W * Cin >= (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(pad_value));
  Conv p{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
         static_cast<const int*>(zp), static_cast<const float*>(sw),
         static_cast<const float*>(bias), out, B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw_, pt,
         pl, dh, dw, static_cast<int>(K), Kp, relu, byte * 0x01010101u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch<float>(p, s);
  if (dtype == fod::kBFloat16) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: registers a thread, static and dynamic shared bytes a block, local (spill)
// bytes a thread, resident blocks an SM. vec: the 16-byte gather (Cin % 16 == 0) or the
// byte gather. Launches nothing.
extern "C" int fod_int8_conv_info(int dtype, int vec, int* out) {
  if (dtype == fod::kFloat32) return vec ? info<float, true>(out) : info<float, false>(out);
  if (dtype == fod::kBFloat16)
    return vec ? info<__nv_bfloat16, true>(out) : info<__nv_bfloat16, false>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
