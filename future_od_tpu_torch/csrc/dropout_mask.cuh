// K7: the attention-weight dropout mask of the training flash kernels.
//
// Replaces future_od_tpu/ops/flash_attention.py::_dropout_mask, which the Pallas
// kernels _flash_fwd_kernel, _flash_dq_kernel and _flash_dkv_kernel call per tile.
// A stateless PCG-style hash of the element's flat index in the padded geometry of
// the JAX kernels, (bh * nq_pad + row) * nk_pad + col, XOR seed * 0x9E3779B9, all
// in wrapping uint32: the forward and both backward kernels regenerate the same
// mask whatever their tiling, and it equals the TPU kernels' mask bit for bit as
// long as nq_pad / nk_pad are the JAX block geometry (the wrappers pass it). An
// element is kept when its bits are >= the threshold min(int(rate * 2^32),
// 2^32 - 1), computed on the host as the TPU kernel computes it, and a kept
// element's value is 1 / (1 - rate). Threshold 0 keeps every element.
#pragma once

#include <cstdint>

namespace fod {

struct Dropout {
  uint32_t seed_mix;   // seed * 0x9E3779B9 (wrapping)
  uint32_t threshold;  // drop when bits < threshold; 0: no dropout
  float keep;          // value of a kept element, 1 / (1 - rate) in f32
  uint32_t nq_pad, nk_pad;

  __host__ __device__ bool active() const { return threshold != 0u; }
};

inline Dropout make_dropout(uint32_t seed, uint32_t threshold, float keep, int nq_pad,
                            int nk_pad) {
  return Dropout{seed * 0x9E3779B9u, threshold, keep, static_cast<uint32_t>(nq_pad),
                 static_cast<uint32_t>(nk_pad)};
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t bh, uint32_t row, uint32_t col,
                                                 const Dropout& dp) {
  uint32_t x = ((bh * dp.nq_pad + row) * dp.nk_pad + col) ^ dp.seed_mix;
  x = x * 747796405u + 2891336453u;
  const uint32_t w = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (w >> 22) ^ w;
}

// The mask's value at (bh, row, col): 0 or dp.keep.
__device__ __forceinline__ float dropout_value(uint32_t bh, uint32_t row, uint32_t col,
                                               const Dropout& dp) {
  return dropout_bits(bh, row, col, dp) >= dp.threshold ? dp.keep : 0.f;
}

}  // namespace fod
