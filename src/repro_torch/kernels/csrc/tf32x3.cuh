// 3xTF32 products on the tensor cores (mma.sync.m16n8k8), shared by the
// port's kernels that run f32 products there (paged_attention.cu's ragged
// kernel, mla_attention.cu, rwkv6_scan.cu).
//
// x = big + small with big = tf32(x) and small = tf32(x - big); a*b ~
// a_small*b_big + a_big*b_small + a_big*b_big, accumulated in f32, which
// keeps f32 accuracy (one-pass TF32 keeps about 3 digits).
//
// Fragments of m16n8k8 (g = lane / 4, q = lane % 4):
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
#pragma once

#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand of one m16n8k8 step, split once and reused across n-tiles.
struct Frag3 {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], big[i], small[i]);
  }
};

// B operand of one m16n8k8 step, split once.
struct FragB3 {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// c += a * b in 3xTF32: the two small cross terms first, then big * big.
__device__ __forceinline__ void mma3(float (&c)[4], const Frag3& a, const FragB3& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// c[n] += a * b[n] in 3xTF32 for N n-tiles: per accumulator the two small
// cross terms first, then big * big, each round issued over all N n-tiles
// so that N independent MMA chains interleave.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const Frag3& a, const float (&b0)[N],
                                     const float (&b1)[N]) {
  uint32_t bb0[N], bs0[N], bb1[N], bs1[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b0[n], bb0[n], bs0[n]);
    split_tf32(b1[n], bb1[n], bs1[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.small, bb0[n], bb1[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, bs0[n], bs1[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, bb0[n], bb1[n]);
}

}  // namespace tf32x3
