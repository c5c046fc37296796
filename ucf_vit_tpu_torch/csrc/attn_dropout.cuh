// Counter-hash attention-dropout mask, shared by the flash forward and backward kernels.
//
// Replaces `keep_mask` (ucf_vit_tpu/ops/attn_dropout.py:70, with `_lowbias32` :55), which
// runs inside the Pallas flash kernels. The mask is a function of GLOBAL coordinates
//   keep(bh, row, col) = lowbias32(row * 0x9E3779B1 ^ col * 0x85EBCA77
//                                  ^ seed * 0xC2B2AE3D ^ (bh + 1) * 0x27D4EB2F) >= threshold
// in uint32 arithmetic (wrap-around multiplies, logical shifts), where bh = b * H + h and
// threshold = round(rate * 2^32). So the forward and the backward kernels may tile
// differently and still drop the same elements, bit for bit with the JAX package's
// `dense_keep_mask` and with `ucf_vit_tpu_torch.ops.attn_dropout.dense_keep_mask`.
//
// Cost: about a dozen integer operations per score element, beside the 2 * dh float
// operations of each product that touches it; no memory traffic (nothing is stored).

#pragma once

#include <cstdint>

namespace ucf {

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The part of the hash input that is the same for a whole (batch*head) slice.
__device__ __forceinline__ uint32_t dropout_slice_key(uint32_t seed, uint32_t bh) {
  return seed * 0xC2B2AE3Du ^ (bh + 1u) * 0x27D4EB2Fu;
}

// True where the element at global (row, col) of the slice with key `slice_key` is kept.
__device__ __forceinline__ bool dropout_keep(uint32_t slice_key, int row, int col,
                                             uint32_t threshold) {
  const uint32_t x = (uint32_t)row * 0x9E3779B1u ^ (uint32_t)col * 0x85EBCA77u ^ slice_key;
  return lowbias32(x) >= threshold;
}

}  // namespace ucf
