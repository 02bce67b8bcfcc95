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
// The design: an implicit GEMM on wgmma (m64nNk32, s8 x s8 -> s32), M = the B*Ho*Wo
// output pixels, N = Cout, K = KH*KW*Cin padded with zero weights to Kp, a multiple of
// 32. A tile is 128 pixels x 128 channels (64 when Cout is not a multiple of 128), two
// consumer warpgroups of 64 pixels each, K walked in stages of 128 values: one
// 128-byte row of a pixel's codes and of a channel's weights, stored with the 128-byte
// swizzle that the wgmma descriptors name (16-byte chunk c of row r at chunk c ^ (r %
// 8)). Both operands are K-major, as 8-bit wgmma requires: the codes are channels
// last, the weights packed (Cout, Kp) (ops/int8_conv.py::pack_int8_weights).
// - Stride-1 1x1 convolutions (33 of a forward's 53) are plain GEMMs [B*H*W, Cin] x
//   [Cin, Cout]: a persistent kernel, one block an SM walking the output tiles
//   (channels fastest, so blocks at work together share the codes in L2), a producer
//   warpgroup whose one thread keeps 2-D TMA tiles of codes and weights in flight into
//   a ring of four stages under mbarriers, and the two consumer warpgroups.
// - Every other convolution (the padded 3x3s, the strided downsamples, the stems) is
//   gathered: every thread copies 16-byte pieces of the codes with cp.async into a
//   three-stage ring, each piece one tap's channels when Cin % 16 == 0, or written
//   as pad_value where the tap falls outside the image (TMA would fill those with
//   zero, and the zero-point path pads with -128); the stems (Cin 3 and 12) read a
//   kernel row's KW * Cin contiguous codes as aligned words (stem_chunk), byte by
//   byte only at the image's border.
// The epilogue of both: each consumer warpgroup stages the tile's channel constants
// (zp, sw, bias) in shared memory, writes its 64 x N values into a staging tile
// (128-byte swizzled, so the warp's stores spread over the banks), and one thread
// stores it with 2-D TMA stores; the persistent kernel's next tile runs while the
// stores drain. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 11a, the 53
// convolutions of a forward of 4 frames at 896x1600, f32 out): 3.5-4.1 ms of device
// time against a bound of 1.90 ms (bytes); the 33 stride-1 1x1s 1.6-1.9 ms, as
// cuBLAS's int8 GEMM (torch._int_mm) takes; the 3x3s at about 350 TOPS, most of it
// in the main loop (tools/k8_ablation.py); the 7x7 stem 0.5 ms.
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is the driver's, fetched at run time

#include "mma_tile.cuh"

namespace {

using fod::cp_async16;
using fod::cp_async_commit;
using fod::smem_addr;

constexpr int kBM = 128;                // output pixels a tile: two warpgroups of 64
constexpr int kBK = 128;                // K values a stage: one 128-byte swizzled row
constexpr int kATile = kBM * kBK;       // bytes
constexpr int kBoxBytes = 64 * 128;     // one TMA store box: 64 rows of 128 bytes
constexpr int kTmaStages = 4;
constexpr int kGatherStages = 3;
constexpr int kTmaThreads = 384;        // a producer warpgroup, two consumers
constexpr int kGatherThreads = 256;     // two consumer warpgroups

struct Conv {
  const int8_t* q;
  const int8_t* w;
  const int* zp;
  const float* sw;
  const float* bias;
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw_, pt, pl, dh, dw, K, Kp, relu;
  uint32_t pad4;  // pad_value in each byte
};

template <typename T, int kBN>
struct Shape {
  static constexpr int kStage = kATile + kBN * kBK;
  static constexpr int kStaging = 64 * kBN * static_cast<int>(sizeof(T));  // a warpgroup's
  static constexpr int kParams = 2 * kBN * 12;  // both warpgroups' Params
  static constexpr int kTmaSmem =
      1024 + kTmaStages * kStage + 2 * kStaging + 16 * kTmaStages + kParams;
  static constexpr int kGatherSmem =
      1024 + (kGatherStages * kStage > 2 * kStaging ? kGatherStages * kStage : 2 * kStaging) +
      kParams;
};

// ---- PTX: wgmma, mbarriers, TMA, proxies ------------------------------------------

// The shared-memory matrix descriptor of a K-major tile with the 128-byte swizzle: 8
// rows of 128 bytes an atom, atoms 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma(int (&d)[kBN / 2], uint64_t a, uint64_t b) {
  if constexpr (kBN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n64(d, a, b);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keep the compiler from moving reads of the accumulators above a wgmma wait.
template <int kRegs>
__device__ __forceinline__ void settle(int (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of this parity has completed. A wait of more than
// about 2^31 polls (seconds) traps, so that a fault shows as a failed launch and not
// as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == 0x80000000u) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The bulk stores committed so far have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled tile.
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// ---- the epilogue ----------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void put_pair(unsigned char* dst, float v0, float v1);

template <>
__device__ __forceinline__ void put_pair<float>(unsigned char* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void put_pair<__nv_bfloat16>(unsigned char* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// A channel's epilogue constants, staged in shared memory for a tile.
struct Params {
  int zp;
  float sw, bias;
};

__device__ __forceinline__ float dequantize(const Conv& p, int acc, int zp, float sw, float b) {
  float v = __fmul_rn(__int2float_rn(acc + zp), sw);
  if (p.bias != nullptr) v = __fadd_rn(v, b);
  if (p.relu && v < 0.f) v = 0.f;  // keeps NaN, as relu does
  return v;
}

// A consumer warpgroup's 64 rows (from m0) x kBN channels (from n0): the epilogue's
// values into its staging tile, laid out as the output map's TMA boxes (64 rows of
// 128 bytes each, 128-byte swizzled), then one thread's TMA stores. `t`: the thread in
// its warpgroup; `bar`: the warpgroup's named barrier; `params`: the warpgroup's
// kBN slots for the channels' constants. Accumulator layout (wgmma
// m64nN): warp w of the group holds rows 16w + g and 16w + g + 8 (g = lane / 4) at
// columns 8j + 2(lane % 4) and the next, in d[4j], d[4j + 1] and d[4j + 2], d[4j + 3].
template <typename T, int kBN>
__device__ __forceinline__ void store_tile(const Conv& p, const int (&acc)[kBN / 2], int m0,
                                           int n0, unsigned char* staging, Params* params,
                                           const CUtensorMap* out_map, int t, int bar) {
  constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  constexpr int kBoxes = kBN / kBoxCols;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  if (t == 0) bulk_wait_read();  // the group's last stores have read the staging tile
  for (int c = t; c < kBN; c += 128) {     // the tile's channels' constants, once
    const int n = n0 + c < p.Cout ? n0 + c : 0;
    params[c] = {p.zp != nullptr ? __ldg(p.zp + n) : 0, __ldg(p.sw + n),
                 p.bias != nullptr ? __ldg(p.bias + n) : 0.f};
  }
  named_sync(bar, 128);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * tq, n = n0 + col;
    if (n < p.Cout) {  // Cout % 64 == 0: the whole 8-column group is in or out
      const Params c0 = params[col], c1 = params[col + 1];
      const int zp0 = c0.zp, zp1 = c1.zp;
      const float sw0 = c0.sw, sw1 = c1.sw, b0 = c0.bias, b1 = c1.bias;
      const int box = col / kBoxCols, byte = (col % kBoxCols) * static_cast<int>(sizeof(T));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half;
        put_pair<T>(staging + box * kBoxBytes + swizzled(row, byte >> 4) + (byte & 15),
                    dequantize(p, acc[4 * j + 2 * half], zp0, sw0, b0),
                    dequantize(p, acc[4 * j + 2 * half + 1], zp1, sw1, b1));
      }
    }
  }
  fence_proxy_async();  // the values reach the TMA unit's view of shared memory
  named_sync(bar, 128);
  if (t == 0) {
#pragma unroll
    for (int box = 0; box < kBoxes; ++box)
      if (n0 + box * kBoxCols < p.Cout)
        tma_store(out_map, n0 + box * kBoxCols, m0, smem_addr(staging + box * kBoxBytes));
    bulk_commit();
  }
}

// ---- stride-1 1x1 convolutions: TMA producer, persistent -----------------------

template <typename T, int kBN>
__global__ void __launch_bounds__(kTmaThreads, 1)
    int8_gemm_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap out_map, const Conv p) {
  using S = Shape<T, kBN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  unsigned char* staging = stages + kTmaStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * S::kStaging);
  uint64_t* empty = full + kTmaStages;
  Params* params = reinterpret_cast<Params*>(empty + kTmaStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(smem_addr(full + s), 1);   // the producer's arrival and the bytes
      mbar_init(smem_addr(empty + s), 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int M = p.B * p.Ho * p.Wo;
  const int n_tiles = p.Cout / kBN, tiles = (M + kBM - 1) / kBM * n_tiles;
  const int k_blocks = (p.Kp + kBK - 1) / kBK;
  const int group = threadIdx.x >> 7, t = threadIdx.x & 127;
  if (group == 0) {  // the producer: one thread issues every load
    if (t == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(smem_addr(empty + stage), phase ^ 1);  // the consumers freed it
          mbar_expect(smem_addr(full + stage), S::kStage);
          unsigned char* a = stages + stage * S::kStage;
          tma_load(smem_addr(a), &a_map, kb * kBK, m0, smem_addr(full + stage));
          tma_load(smem_addr(a + kATile), &b_map, kb * kBK, n0, smem_addr(full + stage));
          if (++stage == kTmaStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }
  const int half = group - 1;  // this consumer's 64 rows of a tile
  unsigned char* my_staging = staging + half * S::kStaging;
  int stage = 0, phase = 0;
  int acc[kBN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    int held = -1;  // the stage whose products may still run
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(smem_addr(full + stage), phase);
      const uint32_t a = smem_addr(stages + stage * S::kStage) + half * 64 * kBK;
      const uint32_t b = smem_addr(stages + stage * S::kStage + kATile);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)
        wgmma<kBN>(acc, sw128_desc(a) + 2 * k, sw128_desc(b) + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      if (held >= 0 && t == 0) mbar_arrive(smem_addr(empty + held));
      held = stage;
      if (++stage == kTmaStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    settle(acc);
    if (held >= 0 && t == 0) mbar_arrive(smem_addr(empty + held));
    store_tile<T, kBN>(p, acc, m0 + 64 * half, n0, my_staging, params + half * kBN, &out_map,
                       t, 1 + half);
  }
  if (t == 0) bulk_wait_read();  // the block may end once its stores have read the tile
}

// ---- every other convolution: the cp.async gather ---------------------------------

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

// The 16 codes of K values [k, k + 16) of pixel px one byte at a time: the tap and
// channel of k, then one step a byte (the padding and K's end wherever they fall).
__device__ __forceinline__ uint4 byte_chunk(const Conv& p, const Pixel& px, int k) {
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  const int tap = k / p.Cin;
  int ci = k - tap * p.Cin, kh = tap / p.KW, kw = tap - kh * p.KW;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t v = 0u;
    if (k + j < p.K) {
      const int ih = px.ih0 + kh * p.dh, iw = px.iw0 + kw * p.dw;
      v = (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W)
              ? (p.pad4 & 0xffu)
              : static_cast<uint8_t>(
                    p.q[px.base + (static_cast<long long>(ih) * p.W + iw) * p.Cin + ci]);
    }
    words[j >> 2] |= v << (8 * (j & 3));
    if (++ci == p.Cin) {
      ci = 0;
      if (++kw == p.KW) kw = 0, ++kh;
    }
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// 16 bytes of q from byte offset `at` (any alignment): five aligned words, shifted.
__device__ __forceinline__ uint4 bytes16(const int8_t* q, long long at) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q + (at & ~3LL));
  const int shift = 8 * static_cast<int>(at & 3);
  uint32_t r[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) r[t] = __ldg(w + t);
  return make_uint4(__funnelshift_r(r[0], r[1], shift), __funnelshift_r(r[1], r[2], shift),
                    __funnelshift_r(r[2], r[3], shift), __funnelshift_r(r[3], r[4], shift));
}

// Word t of a mask whose bytes below `len` are 0xff.
__device__ __forceinline__ uint32_t low_bytes(int t, int len) {
  const int n = len - 4 * t;
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (0xffffffffu >> (32 - 8 * n));
}

// The stems' fast gather: with dilation 1 along W the KW taps of one kernel row are
// KW * Cin contiguous codes, so 16 values of K are at most two runs of contiguous
// bytes (this kernel row's rest and the next's start), each read as five aligned
// words. False (nothing written) where a run would leave the image or the tensor,
// or a kernel row holds fewer than 16 codes: byte_chunk takes those.
__device__ __forceinline__ bool stem_chunk(const Conv& p, const Pixel& px, int k, uint4& out) {
  const int row = p.KW * p.Cin;  // the codes of one kernel row
  if (p.dw != 1 || row < 16 || px.iw0 < 0 || px.iw0 + p.KW > p.W) return false;
  const int kh = k / row, r0 = k - kh * row;
  const int len_a = min(row - r0, 16);  // from this kernel row
  const long long end = static_cast<long long>(p.B) * p.H * p.W * p.Cin;
  const int ih_a = px.ih0 + kh * p.dh, ih_b = ih_a + p.dh;
  if (ih_a < 0 || ih_a >= p.H) return false;
  const long long at_a = px.base + (static_cast<long long>(ih_a) * p.W + px.iw0) * p.Cin + r0;
  if (at_a + 20 > end) return false;
  uint4 v = bytes16(p.q, at_a);
  if (len_a < 16 && k + len_a < p.K) {  // the next kernel row's first codes
    if (ih_b < 0 || ih_b >= p.H) return false;
    const long long at_b =
        px.base + (static_cast<long long>(ih_b) * p.W + px.iw0) * p.Cin - len_a;
    if (at_b < 0 || at_b + 20 > end) return false;
    const uint4 b = bytes16(p.q, at_b);
    v.x = (v.x & low_bytes(0, len_a)) | (b.x & ~low_bytes(0, len_a));
    v.y = (v.y & low_bytes(1, len_a)) | (b.y & ~low_bytes(1, len_a));
    v.z = (v.z & low_bytes(2, len_a)) | (b.z & ~low_bytes(2, len_a));
    v.w = (v.w & low_bytes(3, len_a)) | (b.w & ~low_bytes(3, len_a));
  }
  const int valid = min(p.K - k, 16);  // zeros past K
  v.x &= low_bytes(0, valid), v.y &= low_bytes(1, valid);
  v.z &= low_bytes(2, valid), v.w &= low_bytes(3, valid);
  out = v;
  return true;
}

// Stage K values [k0, k0 + kBK) of the tile's A rows and B rows, swizzled. Thread t
// owns 16-byte chunk (t % 8) of rows t / 8 + 32 i.
template <bool kVec, int kBN>
__device__ __forceinline__ void load_stage(const Conv& p, const Pixel (&px)[4], int n0, int k0,
                                           unsigned char* As, unsigned char* Bs) {
  const int chunk = threadIdx.x & 7, k = k0 + chunk * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (threadIdx.x >> 3) + 32 * i;
    unsigned char* dst = As + swizzled(row, chunk);
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
    } else {  // the stems: 16 values of K span taps of Cin channels
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (px[i].valid && k < p.K && !stem_chunk(p, px[i], k, v)) v = byte_chunk(p, px[i], k);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
#pragma unroll
  for (int i = 0; i < kBN / 32; ++i) {
    const int row = (threadIdx.x >> 3) + 32 * i, n = n0 + row;
    const bool inside = k < p.Kp && n < p.Cout;
    cp_async16(smem_addr(Bs + swizzled(row, chunk)),
               p.w + (inside ? static_cast<long long>(n) * p.Kp + k : 0), inside ? 16 : 0);
  }
}

template <typename T, int kBN, bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
    int8_conv_gather_kernel(const __grid_constant__ CUtensorMap out_map, const Conv p) {
  using S = Shape<T, kBN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int half = threadIdx.x >> 7, t = threadIdx.x & 127;

  Pixel px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = pixel_of(p, m0 + (threadIdx.x >> 3) + 32 * i);
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;

  const int k_blocks = (p.Kp + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kGatherStages - 1; ++s) {
    if (s < k_blocks)
      load_stage<kVec, kBN>(p, px, n0, s * kBK, stages + s * S::kStage,
                            stages + s * S::kStage + kATile);
    cp_async_commit();
  }
  for (int kb = 0; kb < k_blocks; ++kb) {
    fod::cp_async_wait_one();  // stage kb has landed (one younger group may fly)
    fence_proxy_async();       // this thread's copies and fills, to wgmma's view
    __syncthreads();           // everyone's; and stage kb - 1's products are done
    unsigned char* s = stages + (kb % kGatherStages) * S::kStage;
    const uint32_t a = smem_addr(s) + half * 64 * kBK, b = smem_addr(s + kATile);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 32; ++k)
      wgmma<kBN>(acc, sw128_desc(a) + 2 * k, sw128_desc(b) + 2 * k);
    wgmma_commit();
    // the gather of stage kb + 2 (into kb - 1's buffer, whose products are done)
    // runs while the products of stage kb do
    const int next = kb + kGatherStages - 1;
    if (next < k_blocks) {
      unsigned char* t = stages + (next % kGatherStages) * S::kStage;
      load_stage<kVec, kBN>(p, px, n0, next * kBK, t, t + kATile);
    }
    cp_async_commit();
    wgmma_wait<0>();
    settle(acc);
  }
  fod::cp_async_wait_all();
  __syncthreads();  // every stage is free: the staging tiles reuse them
  Params* params = reinterpret_cast<Params*>(
      stages + (kGatherStages * S::kStage > 2 * S::kStaging ? kGatherStages * S::kStage
                                                           : 2 * S::kStaging));
  store_tile<T, kBN>(p, acc, m0 + 64 * half, n0, stages + half * S::kStaging,
                        params + half * kBN, &out_map, t,
                     1 + half);
  if (t == 0) bulk_wait_read();  // the block may end once its stores have read the tile
}

// ---- host --------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major rows x cols matrix of `elem`-byte values as 2-D TMA boxes of box_rows x
// box_cols (box_cols * elem == 128: one swizzled row), 128-byte swizzle, zero fill.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                long long rows, long long cols, int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn != nullptr &&
         fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

constexpr int kMaxDevices = 64;

int current_device() {
  int device = -1;
  return cudaGetDevice(&device) == cudaSuccess && device < kMaxDevices ? device : -1;
}

int multiprocessors() {
  static int sms[kMaxDevices] = {};
  const int device = current_device();
  if (device < 0) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

// The kernel's dynamic shared-memory limit raised to `bytes`, once a device.
template <auto kern>
cudaError_t allow_smem(int bytes) {
  static bool done[kMaxDevices] = {};
  const int device = current_device();
  if (device < 0) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[device] = err == cudaSuccess;
  return err;
}

// Stride-1 1x1 convolutions with Cin % 16 == 0 go to the TMA kernel.
bool is_gemm(const Conv& p) {
  return p.KH == 1 && p.KW == 1 && p.sh == 1 && p.sw_ == 1 && p.pt == 0 && p.pl == 0 &&
         p.Ho == p.H && p.Wo == p.W && p.Cin % 16 == 0;
}

template <typename T, int kBN>
int launch_tma(const Conv& p, void* out, cudaStream_t stream) {
  using S = Shape<T, kBN>;
  const long long M = static_cast<long long>(p.B) * p.Ho * p.Wo;
  CUtensorMap a_map, b_map, out_map;
  if (!tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, M, p.Cin, kBM, kBK) ||
      !tensor_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.w, p.Cout, p.Kp, kBN, kBK) ||
      !tensor_map(&out_map, map_type<T>(), sizeof(T), out, M, p.Cout, 64, 128 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = int8_gemm_tma_kernel<T, kBN>;
  const cudaError_t err = allow_smem<int8_gemm_tma_kernel<T, kBN>>(S::kTmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (M + kBM - 1) / kBM * (p.Cout / kBN);
  const int sms = multiprocessors();
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kern<<<grid, kTmaThreads, S::kTmaSmem, stream>>>(a_map, b_map, out_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kBN, bool kVec>
int launch_gather(const Conv& p, void* out, cudaStream_t stream) {
  using S = Shape<T, kBN>;
  const long long M = static_cast<long long>(p.B) * p.Ho * p.Wo;
  CUtensorMap out_map;
  if (!tensor_map(&out_map, map_type<T>(), sizeof(T), out, M, p.Cout, 64, 128 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = int8_conv_gather_kernel<T, kBN, kVec>;
  const cudaError_t err = allow_smem<int8_conv_gather_kernel<T, kBN, kVec>>(S::kGatherSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), p.Cout / kBN);
  kern<<<grid, kGatherThreads, S::kGatherSmem, stream>>>(out_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kBN>
int launch(const Conv& p, void* out, cudaStream_t stream) {
  if (is_gemm(p)) return launch_tma<T, kBN>(p, out, stream);
  if (p.Cin % 16 == 0) return launch_gather<T, kBN, true>(p, out, stream);
  return launch_gather<T, kBN, false>(p, out, stream);
}

template <typename T>
int launch(const Conv& p, void* out, cudaStream_t stream) {
  return p.Cout % 128 == 0 ? launch<T, 128>(p, out, stream) : launch<T, 64>(p, out, stream);
}

template <typename K>
int info_of(K kern, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {attr.numRegs, static_cast<int>(attr.sharedSizeBytes), smem,
                       static_cast<int>(attr.localSizeBytes), blocks};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

template <typename T, int kBN>
int info(int variant, int* out) {
  using S = Shape<T, kBN>;
  if (variant == 2) return info_of(int8_gemm_tma_kernel<T, kBN>, kTmaThreads, S::kTmaSmem, out);
  if (variant == 1)
    return info_of(int8_conv_gather_kernel<T, kBN, true>, kGatherThreads, S::kGatherSmem, out);
  return info_of(int8_conv_gather_kernel<T, kBN, false>, kGatherThreads, S::kGatherSmem, out);
}

}  // namespace

// q: (B, H, W, Cin) int8 codes, 16-byte aligned; w: (Cout, Kp) int8, 16-byte aligned,
// rows (kh, kw, ci) zero padded to Kp (a multiple of 32); zp: (Cout,) int32 or null; sw:
// (Cout,) f32; bias: (Cout,) f32 or null; out: (B, Ho, Wo, Cout) f32 or bf16, 16-byte
// aligned. Cout a multiple of 64; padding (pt, pl) at the top and left (the bottom and
// right follow from Ho and Wo); pad_value in [-128, 127]. All contiguous. Returns the
// launch's CUDA status.
extern "C" int fod_int8_conv(const void* q, const void* w, const void* zp, const void* sw,
                             const void* bias, void* out, int B, int H, int W, int Cin, int Ho,
                             int Wo, int Cout, int KH, int KW, int sh, int sw_, int pt, int pl,
                             int dh, int dw, int Kp, int pad_value, int relu, int dtype,
                             void* stream) {
  const long long K = static_cast<long long>(KH) * KW * Cin;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 ||
      Cout % 64 != 0 || Cout / 64 > 65535 || KH <= 0 || KW <= 0 || sh <= 0 || sw_ <= 0 ||
      dh <= 0 || dw <= 0 || Kp % 32 != 0 || Kp < K || Kp - K >= 32 || pad_value < -128 ||
      pad_value > 127 || M * Cout >= (1LL << 62) || M > (1LL << 31) - kBM ||
      static_cast<long long>(B) * H * W * Cin >= (1LL << 62) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(pad_value));
  Conv p{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
         static_cast<const int*>(zp), static_cast<const float*>(sw),
         static_cast<const float*>(bias), B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw_, pt,
         pl, dh, dw, static_cast<int>(K), Kp, relu, byte * 0x01010101u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch<float>(p, out, s);
  if (dtype == fod::kBFloat16) return launch<__nv_bfloat16>(p, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: registers a thread, static and dynamic shared bytes a block, local (spill)
// bytes a thread, resident blocks an SM, of one instantiation: variant 0 the byte
// gather, 1 the 16-byte gather, 2 the TMA kernel; bn 64 or 128 channels a tile.
// Launches nothing.
extern "C" int fod_int8_conv_info(int dtype, int variant, int bn, int* out) {
  if (variant < 0 || variant > 2 || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fod::kFloat32)
    return bn == 128 ? info<float, 128>(variant, out) : info<float, 64>(variant, out);
  if (dtype == fod::kBFloat16)
    return bn == 128 ? info<__nv_bfloat16, 128>(variant, out)
                     : info<__nv_bfloat16, 64>(variant, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
