// The fused-bottleneck study kernels for Hopper (sm_90a), NHWC, stride 1, frozen BN
// folded into the weights and f32 biases:
//   bottleneck(x) = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x))))) + residual)
// with the residual x itself or a 1x1 downsample of x.
//
// fod_bottleneck_v2 replaces the Pallas TPU kernel
// tools/bench_fused_bottleneck.py::_v2_kernel (behind fused_v2): one bottleneck, the
// function of fused_bottleneck.cu, with the tool's two choices kept:
//   - tile_h, the output rows a block owns. The TPU kernel's strip is the full image
//     width; here a block owns tile_h x tile_w pixels, tile_w 16 (one m16 slab a row) or
//     8 where that does not fit in 227 KB of shared memory, and computes them in bands
//     of band_h rows, band_h = tile_h unless a band that tall does not fit either
//     (fod_bottleneck_plan says which: f32 at cmid 256 takes 8 x 8 bands).
//   - im2col: the 3x3 as one product chain over the 9 cmid reduction rows (the taps'
//     shifted windows of h1 ldmatrix'ed in place: the patch matrix is never built), or
//     as nine tap products, each its own chain, summed in f32.
// fod_fused_layer1 replaces tools/bench_fused_bottleneck.py::_v3_kernel (behind
// fused_layer1): layer1's 3 chained bottlenecks (block 0 with a 64->256 downsample,
// cmid 64) in one kernel, the chain on chip. A block owns tile_h x tile_w output
// pixels in bands of band_h rows; per band it stages x on the band grown by 3 pixels a
// side, and block k's output is computed on the band grown by 2 - k pixels a side, the
// TPU kernel's 3-pixel halos in both directions. Block 0's and block 1's 256-channel
// outputs stay in shared memory in the storage type (block 1's over x's, which is dead
// by then) and are the next block's A operand, ldmatrix'ed in place: at bf16's 8 x 8
// band 76 + 53 KB of the 210 KB a block takes; f32 takes 4 x 4 bands (165 KB). The halos
// recompute: at 8 x 8 layer1 does 1.73x the operations of its three bottlenecks
// (ops/fused_resnet.py::layer1_recompute); fod_bottleneck_plan picks the band that
// fits with the least.
//
// Both run bottleneck_tile.cuh's stages on the tensor cores (K2's: bf16 operands as
// stored, f32 as 3xTF32, a fresh accumulator every 32 reduction rows, bf16 h1 and h2
// near a rounding boundary recomputed as sequential f32 sums). Zero padding holds after
// every block as in the TPU kernels: h1, and every bottleneck output that feeds another,
// are 0 outside the image; input pixels outside the image read as 0 and never reach the
// result.
//
// What bounds them: the products, 2*(cin*cmid + 9*cmid^2 + cmid*cout [+ cin*cout])
// operations a pixel against (cin + cout) elements moved a pixel (v3: the chain's x and
// output, the halos' recompute not counted).
#include "bottleneck_tile.cuh"

namespace {

namespace bn = fod::bneck;
using bn::kFlagBytes;
using bn::kPitchX;
using bn::kThreads;

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kLayer1Mid = 64, kLayer1Out = 256, kLayer1In = 64;

template <typename T>
struct Weights {
  const T *w1, *w2, *w3, *wd;  // (cin, cmid), (9 cmid, cmid), (cmid, cout), (cin, cout) or null
  const float *b1, *b2, *b3, *bd;
  const T *w1t, *w2t;  // bf16: w1 and w2 transposed (the near-tie recompute); f32: null
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// v2's shared memory at a band of bh x tw output pixels: the queue, the B chunks, then
// P (the x chunks of stage 1's row groups, then h2) and Q (h1, then the downsample's x
// chunks of stage 3's row groups).
template <typename T, int CMID>
struct V2Layout {
  using C = bn::Cfg<T, CMID>;
  int halo_px, out_px, stage_x, stage_xc, p_bytes, q_bytes;

  __host__ __device__ V2Layout(int bh, int tw, bool downsample) {
    halo_px = (bh + 2) * (tw + 2), out_px = bh * tw;
    stage_x = imin(halo_px, bn::kGroup1) * kPitchX;
    stage_xc = imin(out_px, bn::kGroup23) * kPitchX;
    p_bytes = imax(2 * stage_x, out_px * C::kPitchH);
    q_bytes = imax(halo_px * C::kPitchH, downsample ? 2 * stage_xc : 0);
  }
  __host__ __device__ int bytes() const { return kFlagBytes + C::kRegionB + p_bytes + q_bytes; }
};

template <typename T, int CMID>
__global__ void __launch_bounds__(kThreads)
bottleneck_v2_kernel(const T* __restrict__ x, const Weights<T> w, T* __restrict__ out, int H,
                     int W, int cin, int cout, int tile_h, int tile_w, int band_h, int im2col) {
  using C = bn::Cfg<T, CMID>;
  extern __shared__ __align__(16) unsigned char smem[];
  const V2Layout<T, CMID> lay(band_h, tile_w, w.wd != nullptr);
  const bn::Queue<CMID> queue(smem);         // bf16: values to recompute
  unsigned char* bbuf = smem + kFlagBytes;   // B chunks, double-buffered
  unsigned char* pbuf = bbuf + C::kRegionB;  // x chunks (1), then h2 (2, 3)
  unsigned char* qbuf = pbuf + lay.p_bytes;  // h1 (1, 2), then x chunks (3)
  const int acol = ((threadIdx.x & 31) >> 4) * 16;
  const int halo_w = tile_w + 2;
  const T* xb = x + (size_t)blockIdx.z * H * W * cin;
  T* ob = out + (size_t)blockIdx.z * H * W * cout;
  const int tile_y = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;
  const auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  queue.init();

  for (int y0 = tile_y; y0 < tile_y + tile_h && y0 < H; y0 += band_h) {
    const int halo_px = (band_h + 2) * halo_w, out_px = band_h * tile_w;
    // 1. h1 = relu(x w1 + b1) over the band's halo, 0 outside the image
    bn::tile_product<T, bn::kSlabs1, C::kNJ12, false>(
        halo_px, CMID, cin / C::kKC, 1,
        [&](int c, int buf, int r0, int n0) {
          bn::stage_x<T>(pbuf + buf * lay.stage_x, xb, H, W, cin, y0 - 1, x0 - 1, halo_w, r0,
                         min(halo_px - r0, bn::kGroup1), c * C::kKC);
          bn::stage_b<T, C::kNB12>(bbuf + buf * C::kStageB, w.w1, CMID, c * C::kKC, n0,
                                   C::kPitchB12);
        },
        [&](int, int buf, int r0, int p) {
          return fod::smem_addr(pbuf + buf * lay.stage_x + (p - r0) * kPitchX + acol);
        },
        bbuf, C::kStageB, C::kPitchB12,
        [&](int p) {
          const bool in = inside(y0 - 1 + p / halo_w, x0 - 1 + p % halo_w);
          T* row = reinterpret_cast<T*>(qbuf + p * C::kPitchH);
          return [&, p, in, row](int n, float a0, float a1) {
            float v[2] = {a0, a1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = in ? fmaxf(v[e] + w.b1[n + e], 0.f) : 0.f;
              if (!C::kF32 && in && bn::near_bf16_boundary(v[e])) queue.push(p, n + e);
            }
            bn::store_pair(row + n, v[0], v[1]);
          };
        });
    __syncthreads();
    if constexpr (!C::kF32) {
      queue.drain(halo_px, [&](int p, int n) {
        const int gy = y0 - 1 + p / halo_w, gx = x0 - 1 + p % halo_w;
        if (inside(gy, gx))
          reinterpret_cast<T*>(qbuf + p * C::kPitchH)[n] = fod::from_float<T>(bn::h1_sequential(
              xb + ((size_t)gy * W + gx) * cin, w.w1t + (size_t)n * cin, w.b1[n], cin));
      });
    }

    // 2. h2 = relu(conv3x3(h1) w2 + b2): one chain, or (im2col 0) nine tap chains
    const auto stage2 = [&](int c, int buf, int, int n0) {
      bn::stage_b<T, C::kNB12>(bbuf + buf * C::kStageB, w.w2, CMID, c * C::kKC, n0,
                               C::kPitchB12);
    };
    const auto addr2 = [&](int c, int, int, int m) {
      return bn::tap_addr<T, CMID>(qbuf, c, m, tile_w);
    };
    const auto epi2 = [&](int m) {
      T* row = reinterpret_cast<T*>(pbuf + m * C::kPitchH);
      return [&, m, row](int n, float a0, float a1) {
        float v[2] = {a0, a1};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = fmaxf(v[e] + w.b2[n + e], 0.f);
          if (!C::kF32 && bn::near_bf16_boundary(v[e])) queue.push(m, n + e);
        }
        bn::store_pair(row + n, v[0], v[1]);
      };
    };
    if (im2col) {
      bn::tile_product<T, bn::kSlabs23, C::kNJ12, false>(
          out_px, CMID, 9 * C::kPerTap, 1, stage2, addr2, bbuf, C::kStageB, C::kPitchB12, epi2);
    } else {
      bn::tile_product<T, bn::kSlabs23, C::kNJ12, true>(
          out_px, CMID, 9 * C::kPerTap, 9, stage2, addr2, bbuf, C::kStageB, C::kPitchB12, epi2);
    }
    __syncthreads();
    if constexpr (!C::kF32) {
      queue.drain(out_px, [&](int m, int n) {
        reinterpret_cast<T*>(pbuf + m * C::kPitchH)[n] = fod::from_float<T>(
            bn::h2_sequential<T, CMID>(qbuf, C::kPitchH, m, w.w2t + (size_t)n * 9 * CMID,
                                       w.b2[n], tile_w));
      });
    }

    // 3. out = relu(h2 w3 (+ x wd) + b3 (+ bd or + x)); the downsample's x staged at the
    // row group's output pixels
    constexpr int kK3 = CMID / C::kKC;
    bn::tile_product<T, bn::kSlabs23, C::kNJ3, false>(
        out_px, cout, kK3 + (w.wd != nullptr ? cin / C::kKC : 0), 1,
        [&](int c, int buf, int r0, int n0) {
          unsigned char* dst = bbuf + buf * C::kStageB;
          if (c < kK3) {
            bn::stage_b<T, C::kNB3>(dst, w.w3, cout, c * C::kKC, n0, C::kPitchB3);
          } else {
            const int k0 = (c - kK3) * C::kKC;
            bn::stage_b<T, C::kNB3>(dst, w.wd, cout, k0, n0, C::kPitchB3);
            bn::stage_x<T>(qbuf + buf * lay.stage_xc, xb, H, W, cin, y0, x0, tile_w, r0,
                           min(out_px - r0, bn::kGroup23), k0);
          }
        },
        [&](int c, int buf, int r0, int m) {
          return c < kK3 ? fod::smem_addr(pbuf + m * C::kPitchH + c * fod::kChunkBytes + acol)
                         : fod::smem_addr(qbuf + buf * lay.stage_xc + (m - r0) * kPitchX + acol);
        },
        bbuf, C::kStageB, C::kPitchB3,
        [&](int m) {
          const int gy = y0 + m / tile_w, gx = x0 + m % tile_w;
          const bool in = gy < H && gx < W;
          const size_t pix = (size_t)gy * W + gx;
          return [&, in, pix](int n, float a0, float a1) {
            if (!in) return;
            const float2 r = w.wd != nullptr ? make_float2(w.bd[n], w.bd[n + 1])
                                             : bn::load_pair(xb + pix * cin + n);
            bn::store_pair(ob + pix * cout + n, fmaxf(a0 + w.b3[n] + r.x, 0.f),
                           fmaxf(a1 + w.b3[n + 1] + r.y, 0.f));
          };
        });
    __syncthreads();  // the next band refills every buffer
  }
}

// v3's shared memory at a band of bh x tw output pixels: the queue, the B chunks, block
// 0's output (on the band grown by 2), x on the band grown by 3 and later, in its place,
// block 1's output (grown by 1), then h1 and h2.
template <typename T>
struct L1Layout {
  using C = bn::Cfg<T, kLayer1Mid>;
  static constexpr int kPitchO = kLayer1Out * (int)sizeof(T) + bn::kRowPad;  // an output row
  int out0, xo1, h1, h2;  // byte offsets

  __host__ __device__ L1Layout(int bh, int tw) {
    const int x_px = (bh + 6) * (tw + 6), o0_px = (bh + 4) * (tw + 4),
              o1_px = (bh + 2) * (tw + 2);
    out0 = kFlagBytes + C::kRegionB;
    xo1 = out0 + o0_px * kPitchO;
    h1 = xo1 + imax(x_px * C::kPitchH, o1_px * kPitchO);
    h2 = h1 + x_px * C::kPitchH;
    end = h2 + o0_px * C::kPitchH;
  }
  int end;
  static_assert(kPitchO % 32 == 16, "A pitch");
};

// One of layer1's blocks (k = 0, 1, 2) over its region of the band at (y0, x0), bh x tw:
// its output is the band grown by g = 2 - k pixels a side, its input (in_rows, pitch
// in_pitch, cin channels, on chip) grown by g + 1. Block 0 adds the downsample of x (its
// input), blocks 1 and 2 their input; blocks 0 and 1 write their output, 0 outside the
// image, to out_rows (pitch kPitchO), block 2 writes the image's pixels to ob.
template <typename T>
__device__ void layer1_block(int k, const Weights<T>& w, const unsigned char* in_rows,
                             int in_pitch, int cin, unsigned char* out_rows, T* ob, int H,
                             int W, int y0, int x0, int bh, int tw, unsigned char* smem,
                             const L1Layout<T>& lay, const bn::Queue<kLayer1Mid>& queue) {
  constexpr int CM = kLayer1Mid, CO = kLayer1Out;
  using C = bn::Cfg<T, CM>;
  constexpr int kPitchO = L1Layout<T>::kPitchO;
  const int g = 2 - k, out_w = tw + 2 * g, in_w = out_w + 2;
  const int out_px = (bh + 2 * g) * out_w, in_px = (bh + 2 * g + 2) * in_w;
  const int iy = y0 - g - 1, ix = x0 - g - 1;  // the input region's first pixel
  unsigned char* bbuf = smem + kFlagBytes;
  unsigned char* h1 = smem + lay.h1;
  unsigned char* h2 = smem + lay.h2;
  const int acol = ((threadIdx.x & 31) >> 4) * 16;
  const auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  const auto center = [&](int m) { return (m / out_w + 1) * in_w + m % out_w + 1; };

  // 1. h1 = relu(in w1 + b1) over the input region, 0 outside the image
  bn::tile_product<T, bn::kSlabs1, C::kNJ12, false>(
      in_px, CM, cin / C::kKC, 1,
      [&](int c, int buf, int, int n0) {
        bn::stage_b<T, C::kNB12>(bbuf + buf * C::kStageB, w.w1, CM, c * C::kKC, n0,
                                 C::kPitchB12);
      },
      [&](int c, int, int, int p) {
        return fod::smem_addr(in_rows + p * in_pitch + c * fod::kChunkBytes + acol);
      },
      bbuf, C::kStageB, C::kPitchB12,
      [&](int p) {
        const bool in = inside(iy + p / in_w, ix + p % in_w);
        T* row = reinterpret_cast<T*>(h1 + p * C::kPitchH);
        return [&, p, in, row](int n, float a0, float a1) {
          float v[2] = {a0, a1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = in ? fmaxf(v[e] + w.b1[n + e], 0.f) : 0.f;
            if (!C::kF32 && in && bn::near_bf16_boundary(v[e])) queue.push(p, n + e);
          }
          bn::store_pair(row + n, v[0], v[1]);
        };
      });
  __syncthreads();
  if constexpr (!C::kF32) {
    queue.drain(in_px, [&](int p, int n) {
      if (inside(iy + p / in_w, ix + p % in_w))
        reinterpret_cast<T*>(h1 + p * C::kPitchH)[n] = fod::from_float<T>(bn::h1_sequential(
            reinterpret_cast<const T*>(in_rows + p * in_pitch), w.w1t + (size_t)n * cin,
            w.b1[n], cin));
    });
  }

  // 2. h2 = relu(conv3x3(h1) w2 + b2) over the output region
  bn::tile_product<T, bn::kSlabs23, C::kNJ12, false>(
      out_px, CM, 9 * C::kPerTap, 1,
      [&](int c, int buf, int, int n0) {
        bn::stage_b<T, C::kNB12>(bbuf + buf * C::kStageB, w.w2, CM, c * C::kKC, n0,
                                 C::kPitchB12);
      },
      [&](int c, int, int, int m) { return bn::tap_addr<T, CM>(h1, c, m, out_w); },
      bbuf, C::kStageB, C::kPitchB12,
      [&](int m) {
        T* row = reinterpret_cast<T*>(h2 + m * C::kPitchH);
        return [&, m, row](int n, float a0, float a1) {
          float v[2] = {a0, a1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = fmaxf(v[e] + w.b2[n + e], 0.f);
            if (!C::kF32 && bn::near_bf16_boundary(v[e])) queue.push(m, n + e);
          }
          bn::store_pair(row + n, v[0], v[1]);
        };
      });
  __syncthreads();
  if constexpr (!C::kF32) {
    queue.drain(out_px, [&](int m, int n) {
      reinterpret_cast<T*>(h2 + m * C::kPitchH)[n] = fod::from_float<T>(
          bn::h2_sequential<T, CM>(h1, C::kPitchH, m, w.w2t + (size_t)n * 9 * CM, w.b2[n],
                                   out_w));
    });
  }

  // 3. out = relu(h2 w3 (+ in wd) + b3 (+ bd or + in)) over the output region
  constexpr int kK3 = CM / C::kKC;
  const bool downsample = w.wd != nullptr;
  bn::tile_product<T, bn::kSlabs23, C::kNJ3, false>(
      out_px, CO, kK3 + (downsample ? cin / C::kKC : 0), 1,
      [&](int c, int buf, int, int n0) {
        unsigned char* dst = bbuf + buf * C::kStageB;
        if (c < kK3) {
          bn::stage_b<T, C::kNB3>(dst, w.w3, CO, c * C::kKC, n0, C::kPitchB3);
        } else {
          bn::stage_b<T, C::kNB3>(dst, w.wd, CO, (c - kK3) * C::kKC, n0, C::kPitchB3);
        }
      },
      [&](int c, int, int, int m) {
        return c < kK3 ? fod::smem_addr(h2 + m * C::kPitchH + c * fod::kChunkBytes + acol)
                       : fod::smem_addr(in_rows + center(m) * in_pitch +
                                        (c - kK3) * fod::kChunkBytes + acol);
      },
      bbuf, C::kStageB, C::kPitchB3,
      [&](int m) {
        const int gy = y0 - g + m / out_w, gx = x0 - g + m % out_w;
        const bool in = inside(gy, gx);
        const T* res = reinterpret_cast<const T*>(in_rows + center(m) * in_pitch);
        T* dst = ob != nullptr ? ob + (in ? ((size_t)gy * W + gx) * CO : 0)
                               : reinterpret_cast<T*>(out_rows + m * kPitchO);
        return [&, in, res, dst](int n, float a0, float a1) {
          if (ob != nullptr && !in) return;
          const float2 r = downsample ? make_float2(w.bd[n], w.bd[n + 1]) : bn::load_pair(res + n);
          const float v0 = in ? fmaxf(a0 + w.b3[n] + r.x, 0.f) : 0.f;
          const float v1 = in ? fmaxf(a1 + w.b3[n + 1] + r.y, 0.f) : 0.f;
          bn::store_pair(dst + n, v0, v1);
        };
      });
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_layer1_kernel(const T* __restrict__ x, const Weights<T> w0, const Weights<T> w1,
                    const Weights<T> w2, T* __restrict__ out, int H, int W, int tile_h,
                    int tile_w, int band_h) {
  using C = bn::Cfg<T, kLayer1Mid>;
  constexpr int kPitchXr = C::kPitchH;  // x rows on chip: 64 channels
  constexpr int kPitchO = L1Layout<T>::kPitchO;
  extern __shared__ __align__(16) unsigned char smem[];
  const L1Layout<T> lay(band_h, tile_w);
  const bn::Queue<kLayer1Mid> queue(smem);
  unsigned char* out0 = smem + lay.out0;
  unsigned char* xo1 = smem + lay.xo1;
  const T* xb = x + (size_t)blockIdx.z * H * W * kLayer1In;
  T* ob = out + (size_t)blockIdx.z * H * W * kLayer1Out;
  const int tile_y = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;
  queue.init();

  for (int y0 = tile_y; y0 < tile_y + tile_h && y0 < H; y0 += band_h) {
    // x on the band grown by 3 pixels a side, zero outside the image
    const int x_w = tile_w + 6, x_px = (band_h + 6) * x_w;
    constexpr int kPieces = kLayer1In * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < x_px * kPieces; i += kThreads) {
      const int p = i / kPieces, piece = i % kPieces;
      const int gy = y0 - 3 + p / x_w, gx = x0 - 3 + p % x_w;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const char* src = reinterpret_cast<const char*>(
          in ? xb + ((size_t)gy * W + gx) * kLayer1In : xb);
      fod::cp_async16(fod::smem_addr(xo1 + p * kPitchXr + piece * 16), src + piece * 16,
                      in ? 16 : 0);
    }
    fod::cp_async_commit();
    fod::cp_async_wait_all();
    __syncthreads();
    layer1_block<T>(0, w0, xo1, kPitchXr, kLayer1In, out0, nullptr, H, W, y0, x0, band_h,
                    tile_w, smem, lay, queue);
    layer1_block<T>(1, w1, out0, kPitchO, kLayer1Out, xo1, nullptr, H, W, y0, x0, band_h,
                    tile_w, smem, lay, queue);
    layer1_block<T>(2, w2, xo1, kPitchO, kLayer1Out, nullptr, ob, H, W, y0, x0, band_h,
                    tile_w, smem, lay, queue);
  }
}

// Operations fused_layer1 does at a bh x tw band over those layer1's three blocks
// need: ops/fused_resnet.py::layer1_recompute.
double layer1_recompute(int bh, int tw) {
  const auto grown = [&](int g) { return double(bh + 2 * g) * (tw + 2 * g) / (double(bh) * tw); };
  const double c = kLayer1Out, m = kLayer1Mid;
  double done = 0, need = 0;
  for (int k = 0; k < 3; ++k) {
    const double first = (k == 0 ? kLayer1In : c) * m;
    const double rest = 9 * m * m + m * c + (k == 0 ? kLayer1In * c : 0);
    done += first * grown(3 - k) + rest * grown(2 - k);
    need += first + rest;
  }
  return done / need;
}

// A launch's tile width, band rows and shared memory: v2 the tallest band (a divisor of
// tile_h by halving), then the widest tile (16, 8) that fits; v3 the fitting band with
// the least recompute.
struct Plan {
  int tile_w, band_h;
  size_t smem;
};

template <typename T, int CMID>
Plan v2_plan(int tile_h, bool downsample) {
  for (int bh = tile_h; bh >= 1; bh = bh % 2 == 0 ? bh / 2 : 0) {
    for (int tw = 16; tw >= 8; tw /= 2) {
      if (bh * tw % 16 != 0) continue;
      const size_t bytes = V2Layout<T, CMID>(bh, tw, downsample).bytes();
      if (bytes <= kSmemLimit) return {tw, bh, bytes};
    }
  }
  return {0, 0, 0};
}

template <typename T>
Plan layer1_plan(int tile_h) {
  Plan best{0, 0, 0};
  double least = 0;
  for (int bh = tile_h; bh >= 1; bh = bh % 2 == 0 ? bh / 2 : 0) {
    for (int tw = 16; tw >= 4; tw /= 2) {
      if (bh * tw % 16 != 0) continue;
      const size_t bytes = L1Layout<T>(bh, tw).end;
      const double r = layer1_recompute(bh, tw);
      if (bytes <= kSmemLimit && (best.tile_w == 0 || r < least)) best = {tw, bh, bytes}, least = r;
    }
  }
  return best;
}

// The kernel's attributes at the plan's shared memory: registers, local (spill) bytes,
// resident blocks an SM and on the whole card.
struct Resources {
  int registers, local_bytes, blocks_per_sm, resident;
};

template <typename Kernel>
int prepare(Kernel kern, const Plan& p, Resources* r) {
  if (p.tile_w == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaFuncGetAttributes(&attr, kern)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, p.smem)) ||
      (err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return static_cast<int>(err);
  *r = {attr.numRegs, (int)attr.localSizeBytes, per_sm, per_sm * sms};
  return 0;
}

template <typename T>
int plan_for(int layer1, int tile_h, int cmid, bool downsample, Plan* p, Resources* r) {
  if (layer1) {
    *p = layer1_plan<T>(tile_h);
    return prepare(fused_layer1_kernel<T>, *p, r);
  }
  if (cmid == 64) {
    *p = v2_plan<T, 64>(tile_h, downsample);
    return prepare(bottleneck_v2_kernel<T, 64>, *p, r);
  }
  if (cmid == 128) {
    *p = v2_plan<T, 128>(tile_h, downsample);
    return prepare(bottleneck_v2_kernel<T, 128>, *p, r);
  }
  if (cmid == 256) {
    *p = v2_plan<T, 256>(tile_h, downsample);
    return prepare(bottleneck_v2_kernel<T, 256>, *p, r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int plan_any(int layer1, int tile_h, int cmid, bool downsample, int dtype, Plan* p,
             Resources* r) {
  if (tile_h <= 0 || tile_h > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fod::kFloat32) return plan_for<float>(layer1, tile_h, cmid, downsample, p, r);
  if (dtype == fod::kBFloat16)
    return plan_for<__nv_bfloat16>(layer1, tile_h, cmid, downsample, p, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

// w: w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t
template <typename T>
Weights<T> weights(const void* const* p) {
  return {static_cast<const T*>(p[0]), static_cast<const T*>(p[2]),
          static_cast<const T*>(p[4]), static_cast<const T*>(p[6]),
          static_cast<const float*>(p[1]), static_cast<const float*>(p[3]),
          static_cast<const float*>(p[5]), static_cast<const float*>(p[7]),
          static_cast<const T*>(p[8]), static_cast<const T*>(p[9])};
}

template <typename T>
int launch_v2(const void* x, const void* const* wp, void* out, int B, int H, int W, int cin,
              int cmid, int cout, int tile_h, int im2col, cudaStream_t stream) {
  const Weights<T> w = weights<T>(wp);
  Plan p;
  Resources r;
  const int err = plan_for<T>(0, tile_h, cmid, w.wd != nullptr, &p, &r);
  if (err != 0) return err;
  const dim3 grid((W + p.tile_w - 1) / p.tile_w, (H + tile_h - 1) / tile_h, B);
  const auto run = [&](auto kern) {
    kern<<<grid, kThreads, p.smem, stream>>>(static_cast<const T*>(x), w, static_cast<T*>(out),
                                             H, W, cin, cout, tile_h, p.tile_w, p.band_h,
                                             im2col);
  };
  if (cmid == 64) run(bottleneck_v2_kernel<T, 64>);
  if (cmid == 128) run(bottleneck_v2_kernel<T, 128>);
  if (cmid == 256) run(bottleneck_v2_kernel<T, 256>);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_layer1(const void* x, const void* const* wp, void* out, int B, int H, int W,
                  int tile_h, cudaStream_t stream) {
  Plan p;
  Resources r;
  const int err = plan_for<T>(1, tile_h, kLayer1Mid, true, &p, &r);
  if (err != 0) return err;
  const dim3 grid((W + p.tile_w - 1) / p.tile_w, (H + tile_h - 1) / tile_h, B);
  fused_layer1_kernel<T><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), weights<T>(wp), weights<T>(wp + 10), weights<T>(wp + 20),
      static_cast<T*>(out), H, W, tile_h, p.tile_w, p.band_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of fod_bottleneck_v2 (layer1 = 0) or fod_fused_layer1 (layer1 = 1;
// cmid, im2col and downsample ignored): out[0] tile_w, out[1] the 3x3's reduction rows
// a chain (9 cmid with im2col, cmid without), out[2] shared memory bytes a block,
// out[3] blocks resident on the whole card at once, out[4] band_h, out[5] registers a
// thread, out[6] local (spill) bytes a thread, out[7] resident blocks an SM. Returns a
// CUDA status (invalid value: no plan fits).
extern "C" int fod_bottleneck_plan(int layer1, int tile_h, int cmid, int im2col, int downsample,
                                   int dtype, int* out) {
  Plan p;
  Resources r;
  const int err = plan_any(layer1, tile_h, layer1 ? kLayer1Mid : cmid, downsample != 0, dtype,
                           &p, &r);
  if (err != 0) return err;
  const int mid = layer1 ? kLayer1Mid : cmid;
  const int vals[8] = {p.tile_w, (layer1 || im2col ? 9 : 1) * mid, (int)p.smem, r.resident,
                       p.band_h, r.registers, r.local_bytes, r.blocks_per_sm};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// x: (B, H, W, cin); w1: (cin, cmid); w2: (9*cmid, cmid), rows in (dy, dx, c) order;
// w3: (cmid, cout); wd: (cin, cout) or null for the identity residual (then cin ==
// cout); biases f32; w1t (cmid, cin), w2t (cmid, 9*cmid): w1 and w2 transposed, bf16
// only (null for f32); out: (B, H, W, cout). All contiguous, 16-byte aligned; cin a
// multiple of 64, cout of 128; cmid 64, 128 or 256. Returns the launch's CUDA status.
extern "C" int fod_bottleneck_v2(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* w3, const void* b3, const void* wd,
                                 const void* bd, const void* w1t, const void* w2t, void* out,
                                 int B, int H, int W, int cin, int cmid, int cout, int tile_h,
                                 int im2col, int dtype, void* stream) {
  const bool shapes_ok = B > 0 && B <= 65535 && H > 0 && W > 0 && tile_h > 0 &&
                         (H + tile_h - 1) / tile_h <= 65535 && cin > 0 && cin % 64 == 0 &&
                         cout > 0 && cout % 128 == 0 &&
                         (cmid == 64 || cmid == 128 || cmid == 256) &&
                         (wd != nullptr || cin == cout) && ((wd == nullptr) == (bd == nullptr)) &&
                         ((w1t != nullptr && w2t != nullptr) == (dtype == fod::kBFloat16));
  if (!shapes_ok) return static_cast<int>(cudaErrorInvalidValue);
  const void* wp[10] = {w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32)
    return launch_v2<float>(x, wp, out, B, H, W, cin, cmid, cout, tile_h, im2col, s);
  if (dtype == fod::kBFloat16)
    return launch_v2<__nv_bfloat16>(x, wp, out, B, H, W, cin, cmid, cout, tile_h, im2col, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (B, H, W, 64); weights: 30 pointers, for each of layer1's 3 blocks w1, b1, w2, b2,
// w3, b3, wd, bd, w1t, w2t as in fod_bottleneck_v2 (cmid 64, cout 256; block 0 with the
// downsample, blocks 1 and 2 with wd = bd = null); out: (B, H, W, 256). Returns the
// launch's CUDA status.
extern "C" int fod_fused_layer1(const void* x, const void* const* weights, void* out, int B,
                                int H, int W, int cin, int tile_h, int dtype, void* stream) {
  const bool bf16 = dtype == fod::kBFloat16;
  bool ok = B > 0 && B <= 65535 && H > 0 && W > 0 && tile_h > 0 &&
            (H + tile_h - 1) / tile_h <= 65535 && cin == kLayer1In &&
            weights[6] != nullptr && weights[7] != nullptr && weights[16] == nullptr &&
            weights[17] == nullptr && weights[26] == nullptr && weights[27] == nullptr;
  for (int k = 0; k < 3; ++k)
    ok = ok && (weights[10 * k + 8] != nullptr && weights[10 * k + 9] != nullptr) == bf16;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fod::kFloat32) return launch_layer1<float>(x, weights, out, B, H, W, tile_h, s);
  if (bf16) return launch_layer1<__nv_bfloat16>(x, weights, out, B, H, W, tile_h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
