// The fused-bottleneck study kernels for Hopper (sm_90a), NHWC, stride 1, frozen BN
// folded into the weights and f32 biases:
//   bottleneck(x) = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x))))) + residual)
// with the residual x itself or a 1x1 downsample of x.
//
// fod_bottleneck_v2 replaces the Pallas TPU kernel
// tools/bench_fused_bottleneck.py::_v2_kernel (behind fused_v2): one bottleneck,
// the function of fused_bottleneck.cu, with the tool's two choices kept:
//   - tile_h, the output rows a block owns. The TPU kernel's strip is the full
//     image width; a 400-wide strip's intermediates do not fit in 227 KB of shared
//     memory here, so a block owns tile_h x tile_w pixels, tile_w the widest of 8,
//     4, 2, 1 that fits (fod_bottleneck_plan says which).
//   - im2col: the 3x3 either as one product over a (pixels, 9*cmid) patch matrix
//     staged in shared memory (in K-chunks where the whole matrix does not fit
//     beside the intermediates: at layer1's tile 8 it is one chunk) or as 9 tap
//     products over shifted windows of h1.
// fod_fused_layer1 replaces tools/bench_fused_bottleneck.py::_v3_kernel (behind
// fused_layer1): layer1's 3 chained bottlenecks (block 0 with a 64->256 downsample,
// cmid 64) in one kernel. Block k's output is computed on the output tile grown by
// 2 - k pixels a side, the TPU kernel's 3-row halos in both directions. Block 0's
// and block 1's 256-channel outputs do not fit in shared memory beside the rest
// (147 KB in f32 for block 0 at 8x8), so each block of the grid keeps them in its
// own scratch in device memory, allocated by the wrapper; the grid is one block per
// resident slot, each walking over tiles, so the scratch (33 MB in bf16 at tile 8,
// one block an SM) stays near the L2 cache's 50 MB. The halos recompute: at 8x8
// tiles layer1 does 1.73x the operations of its three bottlenecks
// (ops/fused_resnet.py::layer1_recompute).
//
// Zero padding holds after every block as in the TPU kernels: h1, and every
// bottleneck output that feeds another, are 0 outside the image; input pixels
// outside the image read as 0 and never reach the result.
//
// What bounds them: the products, 2*(cin*cmid + 9*cmid^2 + cmid*cout [+ cin*cout])
// operations a pixel against (cin + cout) elements moved a pixel. All products run
// through fod::block_gemm (block_gemm.cuh), f32 on the CUDA cores, as in
// fused_bottleneck.cu; intermediates are kept in shared memory in the storage type
// (their values are rounded to it, as in the TPU kernels and the plain versions).
#include "block_gemm.cuh"

namespace {

using fod::block_gemm;

constexpr int kThreads = fod::kGemmThreads;
constexpr int kKC = fod::kGemmKC;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kOutTM = 4, kOutTN = 8;  // expansion product micro-tile: 64 pixels x 128 channels
constexpr int kLayer1Mid = 64, kLayer1Out = 256;

// Per-thread micro-tile of the products into h1 and h2: TM x TN accumulators, TN =
// cmid / 16, TM 4 or, where it keeps the accumulators at 32 and more than 64
// pixels are left, 8 (a wider choice cost registers, so resident blocks, on the
// H100: 128 registers a thread with TM up to 16 at cmid 64).
template <int TM>
struct RowsTM {
  static constexpr int value = TM;
};

template <int CMID>
struct Mid {
  static constexpr int TN = CMID / 16;
  static constexpr int TM_MAX = 32 / TN < 4 ? 4 : 32 / TN;
  static constexpr int MC = 16 * TM_MAX;  // most pixels a chunk of those products covers
  static constexpr int kStageFloats =
      fod::gemm_stage_a<(TM_MAX > kOutTM ? TM_MAX : kOutTM)>() +
      fod::gemm_stage_b<(TN > kOutTN ? TN : kOutTN)>();
};

// f(RowsTM<TM>{}) for the TM of a chunk with `rows` pixels left
template <int CMID, typename F>
__device__ __forceinline__ void with_tm(int rows, const F& f) {
  if constexpr (Mid<CMID>::TM_MAX >= 8) {
    if (rows > 64) return f(RowsTM<8>{});
  }
  f(RowsTM<4>{});
}

template <typename T>
struct Weights {
  const T *w1, *w2, *w3, *wd;  // (cin, cmid), (9 cmid, cmid), (cmid, cout), (cin, cout) or null
  const float *b1, *b2, *b3, *bd;
};

template <typename T>
struct Smem {
  float *as, *bs;   // block_gemm staging
  T *h1, *h2, *patch;
  int k_chunk;      // columns of the patch matrix staged at once; 0: 9 tap products
};

// The input region of one bottleneck: its top-left pixel in image coordinates and
// its size. The output region is the input region less one pixel a side.
struct Region {
  int gy0, gx0, hin, win;
};

template <int CMID>
size_t smem_bytes(int in_px, int out_px, int k_chunk, size_t item) {
  const int patch_rows = out_px < Mid<CMID>::MC ? out_px : Mid<CMID>::MC;
  return sizeof(float) * Mid<CMID>::kStageFloats +
         item * ((size_t)(in_px + out_px) * CMID + (size_t)patch_rows * k_chunk);
}

template <typename T, int CMID>
__device__ Smem<T> carve(int in_px, int out_px, int k_chunk) {
  extern __shared__ float4 fod_smem[];
  Smem<T> s;
  s.as = reinterpret_cast<float*>(fod_smem);
  s.bs = s.as + fod::gemm_stage_a<(Mid<CMID>::TM_MAX > kOutTM ? Mid<CMID>::TM_MAX : kOutTM)>();
  s.h1 = reinterpret_cast<T*>(s.as + Mid<CMID>::kStageFloats);
  s.h2 = s.h1 + (size_t)in_px * CMID;
  s.patch = s.h2 + (size_t)out_px * CMID;
  s.k_chunk = k_chunk;
  return s;
}

// One bottleneck over region r: load_in(m, c) is input pixel m (row-major in r) at
// channel c, 0 outside the image; store(m, n, value) receives output pixel m
// (row-major in the output region) at channel n, already 0 outside the image.
template <typename T, int CMID, typename LoadIn, typename Store>
__device__ void bottleneck_region(const LoadIn& load_in, const Region r, int H, int W,
                                  int cin, int cout, const Weights<T>& w, const Smem<T>& s,
                                  const Store& store) {
  using M = Mid<CMID>;
  const int in_px = r.hin * r.win;
  const int wout = r.win - 2, out_px = (r.hin - 2) * wout;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };

  // 1. h1 = relu(x w1 + b1) over the input region, 0 outside the image
  for (int m0 = 0; m0 < in_px;) {
    with_tm<CMID>(in_px - m0, [&](auto rows_tm) {
      constexpr int TM = decltype(rows_tm)::value;
      float acc[TM][M::TN] = {};
      auto load = [&](int m, int c) { return load_in(m0 + m, c); };
      block_gemm<TM, M::TN>(acc, load, in_px - m0, cin, w.w1, CMID, 0, s.as, s.bs);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + tm + 16 * i;
        if (m >= in_px) continue;
        const bool ok = inside(r.gy0 + m / r.win, r.gx0 + m % r.win);
#pragma unroll
        for (int j = 0; j < M::TN; ++j) {
          const int n = tn + 16 * j;
          s.h1[m * CMID + n] = fod::from_float<T>(ok ? fmaxf(acc[i][j] + w.b1[n], 0.f) : 0.f);
        }
      }
      m0 += 16 * TM;
    });
  }
  __syncthreads();

  // 2. h2 = relu(conv3x3(h1) + b2) over the output region
  for (int m0 = 0; m0 < out_px;) {
    with_tm<CMID>(out_px - m0, [&](auto rows_tm) {
      constexpr int TM = decltype(rows_tm)::value;
      const int mc = min(16 * TM, out_px - m0);
      // h1's row under output pixel m0 + m at tap (dy, dx) = (tap / 3, tap % 3)
      auto h1_at = [&](int m, int tap) -> const T* {
        const int o = m0 + m;
        return s.h1 + ((o / wout + tap / 3) * r.win + o % wout + tap % 3) * CMID;
      };
      float acc[TM][M::TN] = {};
      if (s.k_chunk > 0) {
        for (int k0 = 0; k0 < 9 * CMID; k0 += s.k_chunk) {
          const int kc = min(s.k_chunk, 9 * CMID - k0);
          for (int i = threadIdx.x; i < mc * kc; i += kThreads) {
            const int m = i / kc, k = k0 + i % kc;
            s.patch[m * s.k_chunk + i % kc] = h1_at(m, k / CMID)[k % CMID];
          }
          __syncthreads();
          auto load = [&](int m, int kk) { return fod::to_float(s.patch[m * s.k_chunk + kk]); };
          block_gemm<TM, M::TN>(acc, load, mc, kc, w.w2 + (size_t)k0 * CMID, CMID, 0, s.as,
                                s.bs);
        }
      } else {
        for (int tap = 0; tap < 9; ++tap) {
          auto load = [&](int m, int c) { return fod::to_float(h1_at(m, tap)[c]); };
          block_gemm<TM, M::TN>(acc, load, mc, CMID, w.w2 + (size_t)tap * CMID * CMID, CMID, 0,
                                s.as, s.bs);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tm + 16 * i;
        if (m >= mc) continue;
#pragma unroll
        for (int j = 0; j < M::TN; ++j) {
          const int n = tn + 16 * j;
          s.h2[(m0 + m) * CMID + n] = fod::from_float<T>(fmaxf(acc[i][j] + w.b2[n], 0.f));
        }
      }
      m0 += 16 * TM;
    });
  }
  __syncthreads();

  // 3. out = relu(h2 w3 + b3 + residual), 0 outside the image
  auto center = [&](int o) { return (o / wout + 1) * r.win + o % wout + 1; };
  for (int m0 = 0; m0 < out_px; m0 += 16 * kOutTM) {
    for (int n0 = 0; n0 < cout; n0 += 16 * kOutTN) {
      float acc[kOutTM][kOutTN] = {};
      auto load_h2 = [&](int m, int c) { return fod::to_float(s.h2[(m0 + m) * CMID + c]); };
      block_gemm<kOutTM, kOutTN>(acc, load_h2, out_px - m0, CMID, w.w3, cout, n0, s.as, s.bs);
      if (w.wd != nullptr) {
        auto load_x = [&](int m, int c) { return load_in(center(m0 + m), c); };
        block_gemm<kOutTM, kOutTN>(acc, load_x, out_px - m0, cin, w.wd, cout, n0, s.as, s.bs);
      }
#pragma unroll
      for (int i = 0; i < kOutTM; ++i) {
        const int m = m0 + tm + 16 * i;
        if (m >= out_px) continue;
        const bool ok = inside(r.gy0 + 1 + m / wout, r.gx0 + 1 + m % wout);
#pragma unroll
        for (int j = 0; j < kOutTN; ++j) {
          const int n = n0 + tn + 16 * j;
          float v = acc[i][j] + w.b3[n];
          v += w.wd != nullptr ? w.bd[n] : load_in(center(m), n);
          store(m, n, ok ? fmaxf(v, 0.f) : 0.f);
        }
      }
    }
  }
}

// A read of scratch that this block wrote earlier in the same launch: through L2
// (ld.global.cg), never the read-only path, which need not see such writes.
template <typename T>
__device__ __forceinline__ float load_cg(const T* p);
template <>
__device__ __forceinline__ float load_cg<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ float load_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ float load_image(const T* __restrict__ xb, int gy, int gx, int H,
                                            int W, int cin, int c) {
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 0.f;
  return fod::to_float(xb[((size_t)gy * W + gx) * cin + c]);
}

template <typename T, int CMID>
__global__ void __launch_bounds__(kThreads)
bottleneck_v2_kernel(const T* __restrict__ x, const Weights<T> w, T* __restrict__ out, int H,
                     int W, int cin, int cout, int tile_h, int tile_w, int k_chunk) {
  const Region r{(int)blockIdx.y * tile_h - 1, (int)blockIdx.x * tile_w - 1, tile_h + 2,
                 tile_w + 2};
  const Smem<T> s = carve<T, CMID>(r.hin * r.win, tile_h * tile_w, k_chunk);
  const T* xb = x + (size_t)blockIdx.z * H * W * cin;
  T* ob = out + (size_t)blockIdx.z * H * W * cout;
  auto load_x = [&](int m, int c) {
    return load_image(xb, r.gy0 + m / r.win, r.gx0 + m % r.win, H, W, cin, c);
  };
  auto store = [&](int m, int n, float v) {
    const int gy = r.gy0 + 1 + m / tile_w, gx = r.gx0 + 1 + m % tile_w;
    if (gy < H && gx < W) ob[((size_t)gy * W + gx) * cout + n] = fod::from_float<T>(v);
  };
  bottleneck_region<T, CMID>(load_x, r, H, W, cin, cout, w, s, store);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_layer1_kernel(const T* __restrict__ x, const Weights<T> w0, const Weights<T> w1,
                    const Weights<T> w2, T* __restrict__ out, T* scratch, int B, int H, int W,
                    int cin, int tile_h, int tile_w, int k_chunk) {
  constexpr int C = kLayer1Out;
  const int th = tile_h, tw = tile_w;
  const Smem<T> s = carve<T, kLayer1Mid>((th + 6) * (tw + 6), (th + 4) * (tw + 4), k_chunk);
  // this block's scratch: block 0's output on (th+4) x (tw+4), block 1's on (th+2) x (tw+2)
  T* s0 = scratch + (size_t)blockIdx.x * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * C;
  T* s1 = s0 + (size_t)(th + 4) * (tw + 4) * C;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  for (int tile = blockIdx.x; tile < B * tiles_y * tiles_x; tile += gridDim.x) {
    const int img = tile / (tiles_y * tiles_x);
    const int y0 = (tile / tiles_x) % tiles_y * th, x0 = tile % tiles_x * tw;
    const T* xb = x + (size_t)img * H * W * cin;
    T* ob = out + (size_t)img * H * W * C;

    const Region r0{y0 - 3, x0 - 3, th + 6, tw + 6};
    auto load_x = [&](int m, int c) {
      return load_image(xb, r0.gy0 + m / r0.win, r0.gx0 + m % r0.win, H, W, cin, c);
    };
    auto to_s0 = [&](int m, int n, float v) { s0[(size_t)m * C + n] = fod::from_float<T>(v); };
    bottleneck_region<T, kLayer1Mid>(load_x, r0, H, W, cin, C, w0, s, to_s0);
    __syncthreads();

    const Region r1{y0 - 2, x0 - 2, th + 4, tw + 4};
    auto load_s0 = [&](int m, int c) { return load_cg(s0 + (size_t)m * C + c); };
    auto to_s1 = [&](int m, int n, float v) { s1[(size_t)m * C + n] = fod::from_float<T>(v); };
    bottleneck_region<T, kLayer1Mid>(load_s0, r1, H, W, C, C, w1, s, to_s1);
    __syncthreads();

    const Region r2{y0 - 1, x0 - 1, th + 2, tw + 2};
    auto load_s1 = [&](int m, int c) { return load_cg(s1 + (size_t)m * C + c); };
    auto to_out = [&](int m, int n, float v) {
      const int gy = y0 + m / tw, gx = x0 + m % tw;
      if (gy < H && gx < W) ob[((size_t)gy * W + gx) * C + n] = fod::from_float<T>(v);
    };
    bottleneck_region<T, kLayer1Mid>(load_s1, r2, H, W, C, C, w2, s, to_out);
    __syncthreads();
  }
}

// Tile width, patch chunk and shared memory of a launch: the widest tile_w in
// (8, 4, 2, 1) whose intermediates fit; with im2col the widest patch chunk (a
// multiple of kKC, at most 9 * cmid) that fits beside them.
struct Plan {
  int tile_w, k_chunk;
  size_t smem;
};

template <int CMID>
Plan make_plan(bool layer1, int tile_h, bool im2col, size_t item) {
  const int grow = layer1 ? 6 : 2, shrink = layer1 ? 4 : 0;  // input halo; block 0's output halo
  for (int tw = 8; tw >= 1; tw /= 2) {
    const int in_px = (tile_h + grow) * (tw + grow), out_px = (tile_h + shrink) * (tw + shrink);
    const size_t base = smem_bytes<CMID>(in_px, out_px, 0, item);
    if (!im2col) {
      if (base <= kSmemLimit) return {tw, 0, base};
      continue;
    }
    const int rows = out_px < Mid<CMID>::MC ? out_px : Mid<CMID>::MC;
    if (base + item * rows * kKC > kSmemLimit) continue;
    int kp = (int)((kSmemLimit - base) / (item * rows)) / kKC * kKC;
    kp = kp < 9 * CMID ? kp : 9 * CMID;
    return {tw, kp, smem_bytes<CMID>(in_px, out_px, kp, item)};
  }
  return {0, 0, 0};
}

template <typename Kernel>
int prepare(Kernel kern, const Plan& p, int* resident) {
  if (p.tile_w == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, p.smem)) ||
      (err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return static_cast<int>(err);
  *resident = per_sm * sms;
  return 0;
}

template <typename T, int CMID>
int launch_v2(const void* x, const Weights<T>& w, void* out, int B, int H, int W, int cin,
              int cout, int tile_h, int im2col, cudaStream_t stream) {
  const Plan p = make_plan<CMID>(false, tile_h, im2col, sizeof(T));
  int resident = 0;
  const int err = prepare(bottleneck_v2_kernel<T, CMID>, p, &resident);
  if (err != 0) return err;
  const dim3 grid((W + p.tile_w - 1) / p.tile_w, (H + tile_h - 1) / tile_h, B);
  bottleneck_v2_kernel<T, CMID><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), H, W, cin, cout, tile_h, p.tile_w,
      p.k_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int plan_for(int layer1, int tile_h, int cmid, int im2col, Plan* p, int* resident) {
  const size_t item = sizeof(T);
  if (layer1) {
    *p = make_plan<kLayer1Mid>(true, tile_h, true, item);
    return prepare(fused_layer1_kernel<T>, *p, resident);
  }
  if (cmid == 64) {
    *p = make_plan<64>(false, tile_h, im2col, item);
    return prepare(bottleneck_v2_kernel<T, 64>, *p, resident);
  }
  if (cmid == 128) {
    *p = make_plan<128>(false, tile_h, im2col, item);
    return prepare(bottleneck_v2_kernel<T, 128>, *p, resident);
  }
  if (cmid == 256) {
    *p = make_plan<256>(false, tile_h, im2col, item);
    return prepare(bottleneck_v2_kernel<T, 256>, *p, resident);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int plan_any(int layer1, int tile_h, int cmid, int im2col, int dtype, Plan* p, int* resident) {
  if (tile_h <= 0 || tile_h > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fod::kFloat32) return plan_for<float>(layer1, tile_h, cmid, im2col, p, resident);
  if (dtype == fod::kBFloat16)
    return plan_for<__nv_bfloat16>(layer1, tile_h, cmid, im2col, p, resident);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
Weights<T> weights(const void* const* p) {
  return {static_cast<const T*>(p[0]), static_cast<const T*>(p[2]),
          static_cast<const T*>(p[4]), static_cast<const T*>(p[6]),
          static_cast<const float*>(p[1]), static_cast<const float*>(p[3]),
          static_cast<const float*>(p[5]), static_cast<const float*>(p[7])};
}

template <typename T>
int dispatch_v2(const void* x, const void* const* wp, void* out, int B, int H, int W, int cin,
                int cmid, int cout, int tile_h, int im2col, cudaStream_t s) {
  const Weights<T> w = weights<T>(wp);
  if (cmid == 64) return launch_v2<T, 64>(x, w, out, B, H, W, cin, cout, tile_h, im2col, s);
  if (cmid == 128) return launch_v2<T, 128>(x, w, out, B, H, W, cin, cout, tile_h, im2col, s);
  if (cmid == 256) return launch_v2<T, 256>(x, w, out, B, H, W, cin, cout, tile_h, im2col, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_layer1(const void* x, const void* const* wp, void* out, void* scratch, int grid,
                  int B, int H, int W, int cin, int tile_h, cudaStream_t stream) {
  Plan p;
  int resident = 0;
  int err = plan_for<T>(1, tile_h, kLayer1Mid, 1, &p, &resident);
  if (err != 0) return err;
  fused_layer1_kernel<T><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), weights<T>(wp), weights<T>(wp + 8), weights<T>(wp + 16),
      static_cast<T*>(out), static_cast<T*>(scratch), B, H, W, cin, tile_h, p.tile_w,
      p.k_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of fod_bottleneck_v2 (layer1 = 0) or fod_fused_layer1 (layer1 =
// 1; cmid and im2col ignored): out[0] tile_w, out[1] the patch chunk (0: 9 tap
// products), out[2] shared memory bytes a block, out[3] blocks resident on the
// whole card at once. Returns a CUDA status (invalid value: no plan fits).
extern "C" int fod_bottleneck_plan(int layer1, int tile_h, int cmid, int im2col, int dtype,
                                   int* out) {
  Plan p;
  int resident = 0;
  const int err = plan_any(layer1, tile_h, cmid, im2col, dtype, &p, &resident);
  if (err != 0) return err;
  out[0] = p.tile_w;
  out[1] = p.k_chunk;
  out[2] = (int)p.smem;
  out[3] = resident;
  return 0;
}

// x: (B, H, W, cin); w1: (cin, cmid); w2: (9*cmid, cmid), rows in (dy, dx, c) order;
// w3: (cmid, cout); wd: (cin, cout) or null for the identity residual (then cin ==
// cout); biases f32; out: (B, H, W, cout). All contiguous. cmid 64, 128 or 256.
// Returns the launch's CUDA status.
extern "C" int fod_bottleneck_v2(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* w3, const void* b3, const void* wd,
                                 const void* bd, void* out, int B, int H, int W, int cin,
                                 int cmid, int cout, int tile_h, int im2col, int dtype,
                                 void* stream) {
  const bool shapes_ok = B > 0 && B <= 65535 && H > 0 && W > 0 && tile_h > 0 &&
                         (H + tile_h - 1) / tile_h <= 65535 && cin > 0 && cin % kKC == 0 &&
                         cout > 0 && cout % (16 * kOutTN) == 0 &&
                         (cmid == 64 || cmid == 128 || cmid == 256) &&
                         (wd != nullptr || cin == cout) && ((wd == nullptr) == (bd == nullptr));
  if (!shapes_ok) return static_cast<int>(cudaErrorInvalidValue);
  const void* wp[8] = {w1, b1, w2, b2, w3, b3, wd, bd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return dispatch_v2<float>(x, wp, out, B, H, W, cin, cmid, cout, tile_h, im2col, s);
  if (dtype == fod::kBFloat16)
    return dispatch_v2<__nv_bfloat16>(x, wp, out, B, H, W, cin, cmid, cout, tile_h, im2col,
                                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (B, H, W, cin); weights: 24 pointers, for each of layer1's 3 blocks w1, b1, w2,
// b2, w3, b3, wd, bd as in fod_bottleneck_v2 (cmid 64, cout 256; block 0 with the
// downsample, blocks 1 and 2 with wd = bd = null); out: (B, H, W, 256); scratch:
// grid * ((tile_h+4)*(tile_w+4) + (tile_h+2)*(tile_w+2)) * 256 elements of the
// storage type, tile_w from fod_bottleneck_plan. Returns the launch's CUDA status.
extern "C" int fod_fused_layer1(const void* x, const void* const* weights, void* out,
                                void* scratch, int grid, int B, int H, int W, int cin,
                                int tile_h, int dtype, void* stream) {
  const bool shapes_ok = B > 0 && H > 0 && W > 0 && tile_h > 0 && cin > 0 && cin % kKC == 0 &&
                         grid > 0 && weights[6] != nullptr && weights[7] != nullptr &&
                         weights[14] == nullptr && weights[22] == nullptr;
  if (!shapes_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return launch_layer1<float>(x, weights, out, scratch, grid, B, H, W, cin, tile_h, s);
  if (dtype == fod::kBFloat16)
    return launch_layer1<__nv_bfloat16>(x, weights, out, scratch, grid, B, H, W, cin, tile_h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
