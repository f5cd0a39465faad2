// Causal / sliding-window GQA flash attention forward, written by hand for
// sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_fa_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py:93.  For query row
// i of head h (position i + q_offset) and key j of KV head h / G:
//     s_ij = (q_i . k_j) * scale,   visible iff j < sk_valid
//            and (not causal or j <= i + q_offset)
//            and (no window or i + q_offset - j < window)
//     o_i  = sum_j p_ij v_j / max(sum_j p_ij, 1e-30),  p = online softmax
// in f32.  Masked keys weigh exactly 0 (the reference scores them NEG_INF =
// -1e30, whose exp underflows to 0 next to a visible score), so a row that
// sees no key at all writes 0.
//
// Bound on this card: operations.  Each visible (query, key) pair costs
// 4*hd flops (QK^T and PV), hundreds of flops per byte of Q, K, V and O at
// Jamba's S = 4096, hd = 128.  Two bounds: the f32 CUDA-core peak (67
// TFLOP/s: 2.05 ms at Jamba causal S 4096) and, for this kernel's tensor-
// core products, three TF32 products per f32 product at 495 TFLOP/s (0.83
// ms).
//
// Step 0 (the previous kernel: CUDA-core f32, 64 x 64 tiles, synchronous K/V
// loads between barriers; bench.py on an H100 SXM at 700 W): 21.5-22.8
// TFLOP/s at S 1024-8192 (32-34% of the f32 peak, 13-14% of the 3xTF32
// one), 106 registers.  A CUDA-core design cannot go below the f32 bound,
// so the products move to the tensor cores.
//
// Design:
//   * Both products run on mma.sync.m16n8k8 in 3xTF32 (x = big + small,
//     three TF32 products, f32 sums; kernels/csrc/tf32x3.cuh's mma_tf32),
//     which keeps f32 accuracy.  The split clears the 13 low mantissa bits
//     for big (the MMA reads only the top bits, so big costs nothing) and
//     takes small = x - big with one FADD.  A block is NW = 8 warps and BQ
//     = 128 query rows of one head; each warp owns 16 rows and walks the
//     block's BK = 64-key tiles.
//   * QK^T: the 16 x 64 scores of a warp are 8 n-tiles of accumulators.
//     The head dimension is the reduction, so its order is free: lane quad
//     q takes dims 16p + 4q .. 16p + 4q + 3 for the k-step pair p.  Q is
//     staged once per block in fragment order (rows g and g + 8
//     interleaved), so one 16-byte read is an A fragment; one 16-byte read
//     of a K row (rows padded to 16 mod 32 floats: conflict-free) is the B
//     fragments of two k-steps.
//   * The online softmax runs on the score fragments: a row's max is a
//     max over the thread's 16 scores and the 4 lanes of its quad (two
//     shuffles); its sum stays per thread until the end.  exp is ex2 of
//     s * scale * log2(e) minus the scaled running max.  Tiles that mask
//     nothing for a warp skip the mask; tiles that mask everything for a
//     warp skip its MMAs.
//   * PV: P's A fragment is the score accumulator itself: the k-step over
//     the tile's 8-key group j maps tokens 2q, 2q + 1 to lane quad q.  V is
//     staged by key pairs (keys 2r, 2r + 1 side by side, pair rows padded
//     to 8 mod 32 floats) and the output dims are permuted in pairs of
//     n-tiles (n-tile 2m col c -> dim 16m + 2c, 2m + 1 -> 16m + 2c + 1), so
//     one conflict-free 16-byte read is the B fragments of two n-tiles and
//     each lane's 4 dims of a row are contiguous: the output leaves as
//     float4 stores.
//   * K and V tiles stream through a two-stage cp.async ring (K rows in
//     16-byte copies, V elements in 4-byte copies to their pair slots):
//     tile j + 1 is in flight while tile j is computed.  Fully masked
//     tiles (causal, window, sk_valid) are never loaded, keys past
//     sk_valid read zeros, and causal tiles run heaviest first.
//   * q, k, v and out are read and written through their (batch, head,
//     row) strides (last stride 1, rows aligned to a copy chunk:
//     chunk_elems), so the model's (B, S, H, hd) tensors need no
//     transposed copy.  The head dimension
//     is padded to a multiple of 16 (HDP; Q and K pads read as zeros),
//     instantiated for HDP in {16, 32, 48, 64, 96, 128}.
// Measured (bench.py, same card): about 50 TFLOP/s at Jamba causal S 4096
// (30% of the 3xTF32 bound, 182 registers, no spills).  Tried and not
// kept: the rounded (cvt.rna) split, 20% slower; Q and V read row-major,
// whose fragments the compiler gathered with register moves, about 7%
// slower (across calls); 32-key tiles with two or three stages and 4 warps
// a block, 4-12% slower.
// Left: wgmma (tf32 takes K-major B only: PV needs V transposed in shared
// memory) and TMA.
//
// Element types.  q (and the output, which has q's type) and k/v (one type
// for both) are each float or bf16, independently, as in the TPU kernel,
// which reads any float, computes in f32 and writes q.dtype
// (kernels/csrc/bf16.cuh).  Q becomes f32 where it is staged; K and V stay
// in their own type in the ring and each element becomes an f32 where a
// fragment reads it.  Every multiply and add after that is the f32
// kernel's in its order (tiles and the ring unchanged), and the one
// rounding is the output store, so a call on bf16 inputs gives exactly the
// f32 kernel's result on the upcast inputs rounded to q's type.  bf16 K
// rows copy in 16-byte chunks of 8 elements, or 8-byte chunks of 4 where
// hd is not a multiple of 8 (their rows sit 8 bytes off 16), and are
// padded to 16 mod 64 elements (8 mod 32 words), so the 8-byte fragment
// reads of each half warp hit 32 banks.  bf16 V pair rows interleave the
// two keys by dim pairs (key 2r's dims d, d + 1, then key 2r + 1's), one
// 4-byte copy a pair: one 8-byte read is still the B fragments of two
// n-tiles; rows are padded to 2 HDP + 16 elements (8 or 24 mod 32 words),
// conflict-free as well.  A bf16 value is exact in TF32, so its small part
// is 0 and two of the three products add nothing; they are kept, so the
// bf16 schedule is the f32 one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/bf16.cuh"
#include "../../csrc/tf32x3.cuh"

// A named namespace, not an anonymous one: a profiler's trace names each
// kernel by its demangled signature, and "(anonymous namespace)::" opens
// with a parenthesis that tools cutting the parameter list cut at.
namespace flash_attention {

using namespace elem;

constexpr int NW = 8;             // warps per block, 16 query rows each
constexpr int BQ = NW * 16;       // query rows per block
constexpr int NT = NW * 32;
constexpr int BK = 64;            // keys per tile
constexpr int NJ = BK / 8;        // score n-tiles (key groups of 8) a tile
constexpr int STAGES = 2;         // K/V ring
constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename TQ, typename TKV>
struct Params {
  const TQ* q;
  const TKV* k;
  const TKV* v;
  TQ* o;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int H, KV, Sq, Sk, hd, sk_valid, q_offset, causal, window;
  float sl2;                      // scale * log2(e)
};

// Shared memory: Q in fragment order (BQ x HDP floats), then the ring of
// K tiles (BK rows of LDK elements of TKV) and V tiles stored by key pairs
// (BK / 2 rows of LDV2 elements: f32 V[2r][d], V[2r + 1][d] side by side;
// bf16 V[2r][d], V[2r][d + 1], V[2r + 1][d], V[2r + 1][d + 1] for even d).
template <int HDP, typename TKV>
struct Geom {
  static constexpr bool F32 = sizeof(TKV) == 4;
  // K rows: f32 16 mod 32 words; bf16 16 mod 64 elements
  static constexpr int LDK = F32 ? (HDP + 31) / 32 * 32 + 16 : (HDP + 63) / 64 * 64 + 16;
  // V pair rows: f32 8 mod 32 words; bf16 2 HDP + 16 elements
  static constexpr int LDV2 = F32 ? 2 * HDP + 8 : 2 * HDP + 16;
  static constexpr int KT = BK * LDK, VT = BK / 2 * LDV2;
  static constexpr size_t SMEM = sizeof(float) * BQ * HDP + sizeof(TKV) * STAGES * (KT + VT);
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// rows [row0, row0 + n) of a (rows, hd) matrix of row stride `stride` into
// shared rows of LD elements, columns [0, hd); rows at or past `end` read
// zeros.
template <int LD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int row0,
                                          int n, int end, int hd) {
  const int ch = chunk_elems<T>(hd);
  const int hdc = hd / ch;
  const bool wide = ch * sizeof(T) == 16;
  for (int i = threadIdx.x; i < n * hdc; i += NT) {
    const int r = i / hdc, c = (i - r * hdc) * ch;
    T* d = dst + r * LD + c;
    if (row0 + r < end) {
      const T* s = src + static_cast<long long>(row0 + r) * stride + c;
      if (wide)
        cp_async16(d, s);
      else
        cp_async8(d, s);
    } else if (wide) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    }
  }
}

// keys [row0, row0 + BK) of a (rows, hd) V into pair rows of LDV2 elements,
// keys at or past `end` read zeros.  f32: key r's dim d at (r / 2) * LDV2 +
// 2 * d + r % 2, one element a 4-byte copy.  bf16: key r's dims 2p, 2p + 1
// at (r / 2) * LDV2 + 4 * p + 2 * (r % 2), one dim pair a 4-byte copy.
template <int LDV2>
__device__ __forceinline__ void load_v_pairs(float* dst, const float* src, long long stride,
                                             int row0, int end, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BK; r += NW) {
    float* d = dst + (r >> 1) * LDV2 + (r & 1);
    const float* s = src + static_cast<long long>(row0 + r) * stride;
    if (row0 + r < end)
      for (int c = lane; c < hd; c += 32) cp_async4(d + 2 * c, s + c);
    else
      for (int c = lane; c < hd; c += 32) d[2 * c] = 0.f;
  }
}

template <int LDV2>
__device__ __forceinline__ void load_v_pairs(bf16* dst, const bf16* src, long long stride,
                                             int row0, int end, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pairs = hd >> 1;
  for (int r = warp; r < BK; r += NW) {
    bf16* d = dst + (r >> 1) * LDV2 + 2 * (r & 1);
    const bf16* s = src + static_cast<long long>(row0 + r) * stride;
    if (row0 + r < end)
      for (int p = lane; p < pairs; p += 32) cp_async4(d + 4 * p, s + 2 * p);
    else
      for (int p = lane; p < pairs; p += 32) *reinterpret_cast<uint32_t*>(d + 4 * p) = 0u;
  }
}

// The B fragments of n-tiles 2mm and 2mm + 1 at pair row r of a V tile:
// {V[2r][d], V[2r + 1][d], V[2r][d + 1], V[2r + 1][d + 1]} as floats, from
// one 16-byte (f32) or 8-byte (bf16) read at p.
__device__ __forceinline__ float4 v_frags(const float* p) { return load4(p); }
__device__ __forceinline__ float4 v_frags(const bf16* p) {
  const float4 t = load4(p);
  return make_float4(t.x, t.z, t.y, t.w);
}

// x = big + small: big is x with its 13 low mantissa bits cleared (a TF32
// value) and small = x - big, exact in f32, whose top bits the MMA reads as
// TF32.  Two instructions (LOP3, FADD) where a rounded split takes three;
// the product keeps about 2^-21 of relative error, as the rounded split's
// 3xTF32 does.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// A operand of one m16n8k8 step, split once
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
};

// c[n] += a * b[n] in 3xTF32 over N n-tiles, each round of products
// issued over all of them so that N independent MMA chains interleave
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const FragA& a, const float (&b0)[N],
                                     const float (&b1)[N]) {
  uint32_t bb0[N], bs0[N], bb1[N], bs1[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b0[n], bb0[n], bs0[n]);
    split(b1[n], bb1[n], bs1[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) tf32x3::mma_tf32(c[n], a.small, bb0[n], bb1[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32x3::mma_tf32(c[n], a.big, bs0[n], bs1[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32x3::mma_tf32(c[n], a.big, bb0[n], bb1[n]);
}

// c[n] += a * b[n] over NO n-tiles, at most 8 interleaved at a time
template <int NO>
__device__ __forceinline__ void mma_tiles(float (&c)[NO][4], const FragA& a,
                                          const float (&b0)[NO], const float (&b1)[NO]) {
  if constexpr (NO <= 8) {
    mma3<NO>(c, a, b0, b1);
  } else {
    constexpr int L = NO - 8;
    mma3<8>(*reinterpret_cast<float(*)[8][4]>(&c[0]), a,
            *reinterpret_cast<const float(*)[8]>(&b0[0]),
            *reinterpret_cast<const float(*)[8]>(&b1[0]));
    mma3<L>(*reinterpret_cast<float(*)[L][4]>(&c[8]), a,
            *reinterpret_cast<const float(*)[L]>(&b0[8]),
            *reinterpret_cast<const float(*)[L]>(&b1[8]));
  }
}

template <int HDP, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(const Params<TQ, TKV> p) {
  using G = Geom<HDP, TKV>;
  constexpr int LDK = G::LDK, LDV2 = G::LDV2;
  constexpr int NP = HDP / 16;    // 16-dim groups: k-step pairs of QK^T
  constexpr int NO = 2 * NP;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);              // [warp][kp][lane][8]
  TKV* sK = reinterpret_cast<TKV*>(sQ + BQ * HDP);             // STAGES x KT
  TKV* sV = sK + STAGES * G::KT;                               // STAGES x VT
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const TQ* qb = p.q + b * p.q_b + h * p.q_h;
  const TKV* kb = p.k + b * p.k_b + kvh * p.k_h;
  const TKV* vb = p.v + b * p.v_b + kvh * p.v_h;
  const int hd = p.hd;
  const int q0 = qi * BQ;                     // first row of the tile
  const int pos0 = q0 + p.q_offset;           // its position
  const int kv_end = min(p.Sk, p.sk_valid);

  // the keys any row of the tile can see: [k_lo, k_hi)
  int k_hi = kv_end;
  if (p.causal) k_hi = min(k_hi, pos0 + BQ);
  int k_lo = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int ntile = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (ntile > 0) {
    load_rows<LDK>(sK, kb, p.k_s, k_lo, BK, kv_end, hd);
    load_v_pairs<LDV2>(sV, vb, p.v_s, k_lo, kv_end, hd);
  }
  cp_commit();
  // the pad columns [hd, HDP) of both K stages are never copied
  if (hd < HDP) {
    const int pad = HDP - hd;
    for (int i = tid; i < STAGES * BK * pad; i += NT) {
      const int r = i / pad;
      sK[(r / BK) * G::KT + (r % BK) * LDK + hd + i - r * pad] = from_f32<TKV>(0.f);
    }
  }
  // Q once, in the order of the QK^T A fragments: for the k-step pair kp,
  // lane (g, q) holds rows g and g + 8 of its warp at dims 16kp + 4q .. + 3,
  // interleaved {g: d, g + 8: d, g: d + 1, g + 8: d + 1, ...}, so that one
  // 16-byte read is one A fragment.  Rows past Sq and dims past hd are 0.
  {
    const int ra = q0 + warp * 16 + g;
#pragma unroll
    for (int kp = 0; kp < NP; ++kp) {
      const int dim = 16 * kp + 4 * qd;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
      if (dim < hd) {
        if (ra < p.Sq) a = load4(qb + static_cast<long long>(ra) * p.q_s + dim);
        if (ra + 8 < p.Sq) c = load4(qb + static_cast<long long>(ra + 8) * p.q_s + dim);
      }
      float4* f = reinterpret_cast<float4*>(sQ + ((warp * NP + kp) * 32 + lane) * 8);
      f[0] = make_float4(a.x, c.x, a.y, c.y);
      f[1] = make_float4(a.z, c.z, a.w, c.w);
    }
  }

  float o[NO][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  const int wrow = q0 + warp * 16;            // the warp's first row
  const int wr0 = pos0 + warp * 16;           // ... and its position
  const int wr1 = wr0 + 15;
  const int r0 = wr0 + g, r1 = r0 + 8;        // this thread's two rows
  const float sl2 = p.sl2;
  const float* sQf = sQ + (warp * NP * 32 + lane) * 8;

  for (int it = 0; it < ntile; ++it) {
    const int k0 = k_lo + it * BK;
    if (it + 1 < ntile) {
      const int st = (it + 1) % STAGES;
      load_rows<LDK>(sK + st * G::KT, kb, p.k_s, k0 + BK, BK, kv_end, hd);
      load_v_pairs<LDV2>(sV + st * G::VT, vb, p.v_s, k0 + BK, kv_end, hd);
    }
    cp_commit();
    cp_wait<1>();                             // tile it (and Q) landed
    __syncthreads();
    const bool skip = wrow >= p.Sq || k0 >= kv_end || (p.causal && k0 > wr1) ||
                      (p.window > 0 && wr0 - (k0 + BK - 1) >= p.window);
    if (!skip) {
      const bool full = k0 + BK <= kv_end && (!p.causal || k0 + BK - 1 <= wr0) &&
                        (p.window == 0 || wr1 - k0 < p.window);
      const TKV* kt = sK + (it % STAGES) * G::KT;
      const TKV* vt = sV + (it % STAGES) * G::VT;

      // S = Q K^T: 16 rows x BK keys, NJ n-tiles
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < NP; ++kp) {
        const float4 f0 = *reinterpret_cast<const float4*>(sQf + kp * 256);
        const float4 f1 = *reinterpret_cast<const float4*>(sQf + kp * 256 + 4);
        float kx[NJ], ky[NJ], kz[NJ], kw[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kk = load4(kt + (8 * j + g) * LDK + 16 * kp + 4 * qd);
          kx[j] = kk.x, ky[j] = kk.y, kz[j] = kk.z, kw[j] = kk.w;
        }
        FragA a;
        const float a_lo[4] = {f0.x, f0.y, f0.z, f0.w};
        a.set(a_lo);
        mma3<NJ>(s, a, kx, ky);
        const float a_hi[4] = {f1.x, f1.y, f1.z, f1.w};
        a.set(a_hi);
        mma3<NJ>(s, a, kz, kw);
      }

      // mask, then the online softmax of the thread's two rows
      if (!full) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * qd + (e & 1);
            const int row = e < 2 ? r0 : r1;
            const bool vis = key < kv_end && (!p.causal || key <= row) &&
                             (p.window == 0 || row - key < p.window);
            if (!vis) s[j][e] = NEG_INF;
          }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
      const float c0 = ex2((m[0] - mn0) * sl2), c1 = ex2((m[1] - mn1) * sl2);
      m[0] = mn0, m[1] = mn1;
      const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked keys weigh exactly 0, also before the row has seen a key
          float pe = ex2(fmaf(s[j][e], sl2, -(e < 2 ? ms0 : ms1)));
          if (!full && s[j][e] <= 0.5f * NEG_INF) pe = 0.f;
          s[j][e] = pe;
        }
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l[0] = l[0] * c0 + sum0;
      l[1] = l[1] * c1 + sum1;
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        o[t][0] *= c0, o[t][1] *= c0;
        o[t][2] *= c1, o[t][3] *= c1;
      }

      // O += P V: k-step j takes the tile's keys 8j .. 8j + 7, token 2q and
      // 2q + 1 to lane quad q
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA a;
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        a.set(pa);
        // keys 8j + 2q, 8j + 2q + 1 at dims 16mm + 2g, + 1: the B
        // fragments of n-tiles 2mm and 2mm + 1 in one 16-byte read
        const TKV* v2 = vt + (4 * j + qd) * LDV2 + 4 * g;
        float b0[NO], b1[NO];
#pragma unroll
        for (int mm = 0; mm < NP; ++mm) {
          const float4 x = v_frags(v2 + 32 * mm);
          b0[2 * mm] = x.x, b1[2 * mm] = x.y;
          b0[2 * mm + 1] = x.z, b1[2 * mm + 1] = x.w;
        }
        mma_tiles<NO>(o, a, b0, b1);
      }
    }
    __syncthreads();                          // stage it % STAGES is free
  }
  cp_wait<0>();

  // finish the rows: the quad's partial sums, then the float4 stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  TQ* ob = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wrow + g + 8 * half;
    if (row >= p.Sq) continue;
    const float den = half ? den1 : den0;
    TQ* orow = ob + static_cast<long long>(row) * p.o_s;
#pragma unroll
    for (int mm = 0; mm < NP; ++mm) {
      const int dim = 16 * mm + 4 * qd;
      if (dim < hd)             // the one rounding, to q's type
        store4(orow + dim,
               make_float4(o[2 * mm][2 * half] / den, o[2 * mm + 1][2 * half] / den,
                           o[2 * mm][2 * half + 1] / den, o[2 * mm + 1][2 * half + 1] / den));
    }
  }
}

template <int HDP, typename TQ, typename TKV>
cudaError_t launch(const Params<TQ, TKV>& p, int B, cudaStream_t stream) {
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {                       // once per device
    err = cudaFuncSetAttribute(flash_fwd_kernel<HDP, TQ, TKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Geom<HDP, TKV>::SMEM));
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<HDP, TQ, TKV><<<grid, NT, Geom<HDP, TKV>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash_attention

using namespace flash_attention;

// q, out: (B, H, Sq, hd); k, v: (B, KV, Sk, hd).  q_dtype is the code of
// q's (and out's) element type, kv_dtype that of k and v (DT_F32 = 0,
// DT_BF16 = 1).  Each is read or written through its (batch, head, row)
// strides in elements, last stride 1, pointers and strides a multiple of
// chunk_elems (16 bytes; 8 for bf16 where hd is not a multiple of 8); hd a
// multiple of 4 up to 128; H a multiple of KV; sk_valid <= Sk; window 0 =
// none.
extern "C" int flash_attention_launch(int q_dtype, int kv_dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int H, int KV, int Sq,
                                      int Sk, int hd,
                                      int sk_valid, int q_offset, int causal, int window,
                                      float scale, long long q_b, long long q_h, long long q_s,
                                      long long k_b, long long k_h, long long k_s,
                                      long long v_b, long long v_h, long long v_s,
                                      long long o_b, long long o_h, long long o_s,
                                      void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KV <= 0 || H % KV || Sq <= 0 ||
      Sk < 0 || hd <= 0 || hd % 4 || hd > MAX_HD || sk_valid > Sk || window < 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return elem::with_types(q_dtype, kv_dtype, [&](auto tq, auto tkv) -> cudaError_t {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    const Params<TQ, TKV> p{static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                            static_cast<const TKV*>(v), static_cast<TQ*>(out),
                            q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
                            H, KV, Sq, Sk, hd, sk_valid, q_offset, causal, window,
                            scale * LOG2E};
    if (hd <= 16) return launch<16>(p, B, s);
    if (hd <= 32) return launch<32>(p, B, s);
    if (hd <= 48) return launch<48>(p, B, s);
    if (hd <= 64) return launch<64>(p, B, s);
    if (hd <= 96) return launch<96>(p, B, s);
    return launch<128>(p, B, s);
  });
}
