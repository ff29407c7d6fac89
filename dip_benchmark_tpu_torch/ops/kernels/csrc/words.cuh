// Word helpers of the uint8 kernels that work on aligned 32-bit words of a
// row (window.cu's window_u8_strip, chain.cu's chain_u8): bytes and 16-bit
// fields taken out of a thread's words and its neighbours', and packed
// back.
//
// A thread's view of one input row is x[0 .. W + 1]: its W words in
// x[1 .. W], the word left of them in x[0] and the word right of them in
// x[W + 1]. Byte b of the thread's span is byte b & 3 of x[1 + (b >> 2)].
#pragma once

#include <cstdint>

namespace dip {

// Byte b of the span (-4 <= b < 4 W + 4), zero-extended.
template <int W>
__device__ __forceinline__ int byte_at(const uint32_t (&x)[W + 2], int b) {
  return static_cast<int>(
      __byte_perm(x[(b + 4) >> 2], 0, 0x4440 | ((b + 4) & 3)));
}

// Bytes 0 and 2, and bytes 1 and 3, of w as two 16-bit fields.
__device__ __forceinline__ uint32_t even_bytes(uint32_t w) {
  return __byte_perm(w, 0, 0x4240);
}
__device__ __forceinline__ uint32_t odd_bytes(uint32_t w) {
  return __byte_perm(w, 0, 0x4341);
}

// in[4 i + k] and in[4 i + k + 2] as the low and high 16-bit fields, for
// word i of the span and -2 <= k <= 5: the taps at offset k of the word's
// even outputs (bytes 0, 2), and at offset k - 1 of its odd ones (1, 3).
template <int W>
__device__ __forceinline__ uint32_t field_pair(const uint32_t (&x)[W + 2],
                                               int i, int k) {
  const uint32_t prev = x[i], cur = x[i + 1], next = x[i + 2];
  switch (k) {
    case -2: return __funnelshift_r(even_bytes(prev), even_bytes(cur), 16);
    case -1: return __funnelshift_r(odd_bytes(prev), odd_bytes(cur), 16);
    case 0: return even_bytes(cur);
    case 1: return odd_bytes(cur);
    case 2: return __funnelshift_r(even_bytes(cur), even_bytes(next), 16);
    case 3: return __funnelshift_r(odd_bytes(cur), odd_bytes(next), 16);
    case 4: return even_bytes(next);
    default: return odd_bytes(next);
  }
}

// The word of outputs from the even-output and odd-output fields (<= 255).
__device__ __forceinline__ uint32_t pack_fields(uint32_t even, uint32_t odd) {
  return __byte_perm(even, odd, 0x6240);
}

// Four int outputs in [0, 255] as one word.
__device__ __forceinline__ uint32_t pack_bytes(const int* v) {
  const uint32_t lo = __byte_perm(v[0], v[1], 0x0040);
  const uint32_t hi = __byte_perm(v[2], v[3], 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// max(min(v, 255), 0): one Hopper DPX instruction.
__device__ __forceinline__ int clamp_u8(int v) {
  return __vimin_s32_relu(v, 255);
}

__host__ __device__ __forceinline__ int half_of(int shift) {
  return shift > 0 ? 1 << (shift - 1) : 0;
}

// Min and max of two registers of 16-bit fields: one VIMNMX.U16x2 each on
// sm_90a. (__vminu4/__vmaxu4 on four bytes have no instruction there and
// compile to a sequence of logic ops, so the bodies split bytes into
// fields instead.)
struct FieldMin {
  __device__ static uint32_t apply(uint32_t a, uint32_t b) {
    return __vminu2(a, b);
  }
};

struct FieldMax {
  __device__ static uint32_t apply(uint32_t a, uint32_t b) {
    return __vmaxu2(a, b);
  }
};

}  // namespace dip
