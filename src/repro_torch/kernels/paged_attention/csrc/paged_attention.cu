// Paged GQA attention over the FPR block tables, written by hand for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention/
// paged_attention.py:
//   paged_decode_kernel<DEPTH>  paged_attention_fused_fwd (:239, depth 1),
//                               paged_attention_fused_pipelined_fwd (:352,
//                               depth 2 and 4) and the split-pool
//                               paged_attention_fwd (:152), through strides
//   ragged_plan_kernel,         ragged_fused_fwd (:464)
//   ragged_kernel<KQ>
//   merge_kernel                the second pass of both (split-K merge)
//
// What bounds them on this card.
//   * Decode reads every visible K/V row of a KV head once and does 4*hd
//     flops per key and query head: G flops per 8 bytes, far below the
//     H100's ~20 flops per byte.  Bound: visible K/V bytes over 3.35 TB/s.
//   * Ragged reuses each K/V row across the QT*G = 32 query rows of a tile
//     (at G = 4), so in f32 on CUDA cores it is bound by operations (67
//     TFLOP/s); on the tensor cores in 3xTF32 (three TF32 products per f32
//     product, 495 TFLOP/s) the bound is 3*flops/495 TFLOP/s or bytes.
//
// Design against that.
//   * Split-K (flash-decoding).  Each slot's key axis is cut into splits of
//     `split` keys (a multiple of the 32-key tile, chosen from shapes by
//     kernels/paged_attention/split.py), so the host never reads a length.
//     A unit (a decode slot or a ragged query tile, one KV head group)
//     touches the splits s0..s1 holding its visible keys.  If s0 == s1, that
//     split's CTA writes the output directly.  Otherwise each touched split
//     writes its (m, l, acc) partial to scratch (a split of holes writes
//     m = NEG_INF, l = 0, acc = 0) and merge_kernel combines them in split
//     order by the log-sum-exp rule: no atomics on the data, so the output
//     is the same on every run.  A unit that sees nothing writes zeros.
//   * Decode: grid (split, slot, KV head group); CTAs of untouched splits
//     exit at once.  At granite's kernel check (B 8, KV 8, 4096-key table,
//     256-key splits) that is up to 1024 CTAs instead of 64, and the
//     longest slot walks 8 tiles per CTA instead of 128.  One wrapper call
//     is two launches (kernel, merge) when there is more than one split.
//   * Ragged: most (tile, split) pairs of a step touch nothing (padding
//     tiles, short rows), and a grid over all of them spent most of its
//     time launching CTAs that exit.  So ragged_plan_kernel (one CTA) lists
//     the touched pairs on the device, and ragged_kernel runs as many CTAs
//     as the card holds at once, each taking (pair, head group) units from
//     a queue (an atomic counter) until it is empty.  A unit's result does
//     not depend on which CTA runs it.  One wrapper call is three launches
//     (plan, kernel, merge) or two with one split.
//   * Decode stays on CUDA cores: G = 4 query rows would fill a quarter of
//     an m16 MMA tile, and the kernel is bound by bytes.  Four warps share
//     each K/V tile across all the CTA's heads: for the scores lane t takes
//     key t and warp w the float4 columns w, w+4, ..., so a thread keeps one
//     independent 32-deep chain per head instead of one 128-deep chain; the
//     four column partials meet in shared memory in a fixed order.  For
//     P.V thread d owns output column d of every head.  Copies stay cp.async
//     (16 B per thread, DEPTH tiles of 32 KB in flight per CTA, one to five
//     CTAs per SM as DEPTH allows): the walk skips holes and tiles outside
//     the window, so the tile addresses are data-dependent gathers of 32
//     K and 32 V rows of 512 B, which plain cp.async issues without the
//     tensor-map setup TMA would need per pool, strides and head.
//   * Ragged runs both products on the tensor cores with
//     mma.sync.m16n8k8 in 3xTF32: x = big + small with big = tf32(x) and
//     small = tf32(x - big); a*b ~ a_small*b_big + a_big*b_small +
//     a_big*b_big, accumulated in f32, which keeps f32 accuracy (one-pass
//     TF32 keeps about 3 digits).  The tile's QT*gc query rows (row
//     m = r*gc + g) are the M side, padded with zeros to a multiple of 16;
//     hd is padded to 32*KQ.  Four warps share each 16-row slab: each
//     computes S over a quarter of the hd k-steps; the partials meet in
//     shared memory (fixed order), each warp finishes the softmax of 8 of
//     the tile's 32 keys (row maxima and sums meet in shared memory), and
//     each computes O += P.V for a quarter of the hd columns.  Rows at or
//     past kv_len see nothing and write zeros, as do padding tiles.
//   * Pipeline depth only changes when bytes arrive: the float operations
//     and their order are the same at every depth, so depths 1, 2 and 4 give
//     bit-identical output.  Arithmetic uses explicit fmaf/__fmul_rn/expf so
//     no contraction choice can differ between instantiations.
//   * Masked keys score NEG_INF = -1e30 (finite) and weigh exactly 0.
//
// Element types.  q (and the output, which has q's type) and the pool are
// each float or bf16, independently, as in the TPU kernels, which upcast to
// f32, compute in f32 and write q.dtype.  Pages are staged in shared memory
// in the pool's own type and each element becomes an f32 (exactly) where
// it is read from the ring; q is staged as f32.  Every multiply and add
// after that is the f32 kernel's, in the same order, and the split-K
// scratch stays f32, so a bf16 call gives exactly the f32 kernel's result
// on the upcast inputs, rounded once to q's type (to nearest even) where it
// is written.  A 16-byte cp.async moves 8 bf16 elements; where hd is not a
// multiple of 8, bf16 rows are copied in 8-byte chunks of 4 elements.  bf16
// ring rows are padded by 8 elements, so they stay 16-byte aligned: decode's
// 8-byte K reads then meet 2-way bank conflicts (a 4-word row stride), the
// ragged fragment reads none.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "../../csrc/bf16.cuh"
#include "../../csrc/tf32x3.cuh"

// A named namespace, not an anonymous one: a profiler's trace names each
// kernel by its demangled signature, and "(anonymous namespace)::" opens
// with a parenthesis that tools cutting the parameter list cut at.
namespace paged_attention {

using namespace elem;

// Row stride (elements) of the decode ring: f32 hd + 4 (4 mod 32 words);
// bf16 hd + 8, 16-byte aligned for the 16-byte copies, else hd + 4.
template <typename T>
__host__ __device__ __forceinline__ int decode_ld(int hd) {
  return sizeof(T) == 4 ? hd + 4 : (hd % 8 == 0 ? hd + 8 : hd + 4);
}

constexpr int TILE = 32;                    // key tokens per ring slot
constexpr int MAX_HD = 128;
constexpr int QT = 8;                       // ragged query-tile height
constexpr int MAX_GC = 8;                   // query heads per CTA (decode)
constexpr int RAGGED_MAX_GC = 6;            // ragged: QT * gc <= 48 rows
constexpr int DEC_THREADS = 128;
constexpr int MERGE_THREADS = 256;
constexpr int LDS = 36;                     // row stride of the score slabs
constexpr int QW = 4;                       // ragged: warps per 16-row slab
constexpr int RAGGED_DEPTH = 2;             // ragged: tiles in the cp.async ring
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Butterfly reductions: every lane ends with the same value (IEEE addition
// is commutative), in an order fixed by the code.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One KV head of a paged pool.  Fused pool: k = pool + 2*kvh*hd, v = k + hd.
// Split pools: k = k_pool + kvh*hd, v = v_pool + kvh*hd.
template <typename T>
struct HeadPool {
  const T* k;
  const T* v;
  long long blk_stride;   // elements between physical blocks
  long long tok_stride;   // elements between tokens of one block
};

// The slot's table row and the range of 32-token tiles to walk.
struct Walk {
  const int* trow;
  int tiles_per_blk;
  int j_end;

  // First tile at or after j whose block is resident.
  __device__ __forceinline__ int next(int j) const {
    while (j < j_end && trow[j / tiles_per_blk] < 0) ++j;
    return j;
  }
};

// Keys [lo, hi] that some row of a unit may see, and the splits s0..s1
// holding them.  A unit that sees nothing (hi < lo) gets s0 = s1 = 0.
// Mirrored by repro_torch.kernels.paged_attention.split.unit_range.
struct Span {
  int lo, hi, s0, s1;
};

__device__ __forceinline__ Span unit_span(int qpos0, int qrows, int kv_len, int window,
                                          int split) {
  Span sp;
  sp.lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  sp.hi = min(qpos0 + qrows - 1, kv_len - 1);
  sp.s0 = sp.hi < sp.lo ? 0 : sp.lo / split;
  sp.s1 = sp.hi < sp.lo ? 0 : sp.hi / split;
  return sp;
}

// The tiles of split s of a unit: keys [max(lo, s*split), min(hi, ...)].
__device__ __forceinline__ Walk split_walk(const Span& sp, int s, int split, const int* trow,
                                           int M, int bs, int* j0) {
  const int klo = max(sp.lo, s * split);
  const int khi = min(sp.hi, s * split + split - 1);
  const int tpb = bs / TILE;
  *j0 = klo / TILE;
  return Walk{trow, tpb, khi >= klo ? min(khi / TILE + 1, M * tpb) : *j0};
}

__device__ __forceinline__ const int* table_row(const int* tables, int b, int W, int Bs, int M) {
  return tables + static_cast<long long>(b % W) * Bs * M + static_cast<long long>(b / W) * M;
}

// The chunks (ce elements: 16 bytes, or 8 for chunk_elems' narrow bf16
// rows) of a tile this thread copies: token tok0, chunk column c0, then
// steps of blockDim.x chunks (no division per chunk).
struct TileCopy {
  int tok0, c0, dtok, dc, nc, ce;
  __device__ __forceinline__ TileCopy(int hd, int ce_) : nc(hd / ce_), ce(ce_) {
    tok0 = threadIdx.x / nc;
    c0 = threadIdx.x - tok0 * nc;
    dtok = blockDim.x / nc;
    dc = blockDim.x - dtok * nc;
  }
};

// Copy tile j (32 tokens x hd of K and of V) into rows of ldk / ldv
// elements, in the pool's type.
template <typename T>
__device__ __forceinline__ void load_tile(T* kdst, int ldk, T* vdst, int ldv,
                                          const HeadPool<T>& kv, const Walk& w, int j,
                                          const TileCopy& tc) {
  const long long off = w.trow[j / w.tiles_per_blk] * kv.blk_stride +
                        static_cast<long long>((j % w.tiles_per_blk) * TILE) * kv.tok_stride;
  const T* kb = kv.k + off;
  const T* vb = kv.v + off;
  const int ts = static_cast<int>(kv.tok_stride);
  const bool wide = sizeof(T) == 4 || tc.ce == 8;    // 16-byte chunks
  int tok = tc.tok0;
  int c = tc.c0;
  while (tok < TILE) {
    const int e = tc.ce * c;
    const int src = tok * ts + e;
    if (wide) {
      cp_async16(kdst + tok * ldk + e, kb + src);
      cp_async16(vdst + tok * ldv + e, vb + src);
    } else {
      cp_async8(kdst + tok * ldk + e, kb + src);
      cp_async8(vdst + tok * ldv + e, vb + src);
    }
    tok += tc.dtok;
    c += tc.dc;
    if (c >= tc.nc) {
      c -= tc.nc;
      ++tok;
    }
  }
}

// ------------------------------------------------------------------ decode
// q, out: (B, KV, G, hd) of TQ; pools of TP.  Grid (nsplit, B, KV * G/gc),
// 128 threads.  part_o: (nsplit, B, KV, G, hd), part_ml: (nsplit, B, KV, G,
// 2), both f32.
template <int DEPTH, typename TQ, typename TP>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ kbase,
                    const TP* __restrict__ vbase, long long blk_stride,
                    long long tok_stride, long long head_stride,
                    const int* __restrict__ tables, const int* __restrict__ lengths,
                    TQ* __restrict__ out, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int B, int KV, int G, int gc, int hd, int bs,
                    int W, int Bs, int M, int window, float scale, int split) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int ngr = G / gc;
  const int kvh = blockIdx.z / ngr;
  const int g0 = (blockIdx.z - kvh * ngr) * gc;
  const int length = lengths[b];
  const Span sp = unit_span(length - 1, 1, length, window, split);
  if (s < sp.s0 || s > sp.s1) return;
  const bool direct = sp.s0 == sp.s1;
  const int tid = threadIdx.x;
  const long long head0 = (static_cast<long long>(b) * KV + kvh) * G + g0;
  if (sp.hi < sp.lo) {                               // sees nothing: zeros
    for (int i = tid; i < gc * hd; i += DEC_THREADS)
      out[head0 * hd + i] = from_f32<TQ>(0.f);
    return;
  }

  extern __shared__ __align__(16) float smem[];
  const int hd4 = hd >> 2;
  const int ld = decode_ld<TP>(hd);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* qs = smem;                                  // gc x hd
  float* red = qs + gc * hd;                         // 4 warps x gc x TILE
  float* ps = red + 4 * gc * TILE;                   // gc x TILE probabilities
  float* st = ps + gc * TILE;                        // alpha, l, m: 3 x MAX_GC
  TP* ring = reinterpret_cast<TP*>(st + 3 * MAX_GC); // DEPTH x {K, V} x TILE x ld
  const int slot_elems = 2 * TILE * ld;

  for (int i = tid; i < gc * hd4; i += DEC_THREADS)
    store4(qs + 4 * i, load4(q + head0 * hd + 4 * i));

  const HeadPool<TP> kv{kbase + kvh * head_stride, vbase + kvh * head_stride, blk_stride,
                        tok_stride};
  int j0;
  const Walk walk = split_walk(sp, s, split, table_row(tables, b, W, Bs, M), M, bs, &j0);
  const TileCopy tc(hd, chunk_elems<TP>(hd));

  float m_i[2] = {NEG_INF, NEG_INF};                 // heads warp, warp + 4
  float l_i[2] = {0.f, 0.f};
  float acc[MAX_GC];
#pragma unroll
  for (int g = 0; g < MAX_GC; ++g) acc[g] = 0.f;

  int issue = walk.next(j0);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    if (issue < walk.j_end) {
      TP* kt = ring + d * slot_elems;
      load_tile(kt, ld, kt + TILE * ld, ld, kv, walk, issue, tc);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }

  int k = 0;
  for (int j = walk.next(j0); j < walk.j_end; j = walk.next(j + 1), ++k) {
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
    const int slot = k % DEPTH;
    const TP* kt = ring + slot * slot_elems;
    const TP* vt = kt + TILE * ld;

    // scores: lane = key, warp = 4-element columns warp, warp + 4, ...
    float dot[MAX_GC];
#pragma unroll
    for (int g = 0; g < MAX_GC; ++g) dot[g] = 0.f;
    const TP* krow = kt + lane * ld;
    for (int c = warp; c < hd4; c += 4) {
      const float4 kk = load4(krow + 4 * c);
#pragma unroll
      for (int g = 0; g < MAX_GC; ++g) {
        if (g < gc) {
          const float4 a = reinterpret_cast<const float4*>(qs + g * hd)[c];
          dot[g] = fmaf(a.x, kk.x, dot[g]);
          dot[g] = fmaf(a.y, kk.y, dot[g]);
          dot[g] = fmaf(a.z, kk.z, dot[g]);
          dot[g] = fmaf(a.w, kk.w, dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_GC; ++g)
      if (g < gc) red[(warp * gc + g) * TILE + lane] = dot[g];
    __syncthreads();

    // online softmax: warp w owns heads w and w + 4
    const int kp = j * TILE + lane;
    const bool vis = kp >= sp.lo && kp <= sp.hi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = warp + 4 * h;
      if (g < gc) {                                  // warp-uniform
        float sc = __fadd_rn(__fadd_rn(__fadd_rn(red[g * TILE + lane],
                                                 red[(gc + g) * TILE + lane]),
                                       red[(2 * gc + g) * TILE + lane]),
                             red[(3 * gc + g) * TILE + lane]);
        sc = vis ? __fmul_rn(sc, scale) : NEG_INF;
        const float m_new = fmaxf(m_i[h], warp_max(sc));
        const float p = vis ? expf(__fsub_rn(sc, m_new)) : 0.f;
        const float alpha = expf(__fsub_rn(m_i[h], m_new));
        l_i[h] = fmaf(l_i[h], alpha, warp_sum(p));
        m_i[h] = m_new;
        ps[g * TILE + lane] = p;
        if (lane == 0) st[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: thread d owns output column d of every head
    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < MAX_GC; ++g)
        if (g < gc) acc[g] = __fmul_rn(acc[g], st[g]);
      for (int t = 0; t < TILE; ++t) {
        const float v = to_f32(vt[t * ld + tid]);
#pragma unroll
        for (int g = 0; g < MAX_GC; ++g)
          if (g < gc) acc[g] = fmaf(ps[g * TILE + t], v, acc[g]);
      }
    }
    __syncthreads();                                 // slot consumed by every warp
    if (issue < walk.j_end) {
      TP* kn = ring + slot * slot_elems;
      load_tile(kn, ld, kn + TILE * ld, ld, kv, walk, issue, tc);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = warp + 4 * h;
      if (g < gc) {
        st[MAX_GC + g] = l_i[h];
        st[2 * MAX_GC + g] = m_i[h];
      }
    }
  }
  __syncthreads();
  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < MAX_GC; ++g) {
      if (g < gc) {
        const long long o = (head0 + g) * hd + tid;
        if (direct)
          out[o] = from_f32<TQ>(__fdiv_rn(acc[g], fmaxf(st[MAX_GC + g], 1e-30f)));
        else
          part_o[static_cast<long long>(s) * B * KV * G * hd + o] = acc[g];
      }
    }
  }
  if (!direct && tid < gc) {
    float* ml = part_ml + 2 * (static_cast<long long>(s) * B * KV * G + head0 + tid);
    ml[0] = st[2 * MAX_GC + tid];
    ml[1] = st[MAX_GC + tid];
  }
}

// ------------------------------------------------------------------ ragged
// 3xTF32 helpers: to_tf32, split_tf32, mma_tf32, Frag3, mma3 (kernels/csrc/tf32x3.cuh).
using namespace tf32x3;

// Row strides of the ragged tiles for HD = 32 * KQ padded columns: Q (f32)
// and an f32 K at HD + 4 (= 4 mod 32 words: the A and B fragment reads of a
// warp hit 32 banks), an f32 V at HD + 8 (= 8 mod 32, for V's B
// fragments).  bf16 K and V rows at HD + 8 elements (16-byte aligned; 4 or
// 20 mod 32 words: a fragment read's 8 rows x 2 words, or 4 rows x 4
// words, hit distinct banks).
__host__ __device__ constexpr int ragged_ldq(int kq) { return 32 * kq + 4; }
template <typename T>
__host__ __device__ constexpr int ragged_ldk(int kq) {
  return sizeof(T) == 4 ? 32 * kq + 4 : 32 * kq + 8;
}
__host__ __device__ constexpr int ragged_ldv(int kq) { return 32 * kq + 8; }

// One work unit of the ragged kernel: query tile t, split s, head group hz
// (KV head hz / (G/gc)).  q, out: (T, KV, G, hd) of TQ, T = QT * tiles, hd
// <= 32 * KQ; the pool of TP; 2 * QW * mp threads (QW warps per 16-row
// slab), mp = QT*gc rounded up to 16.  part_o: (nsplit, T, KV, G, hd),
// part_ml: (nsplit, T, KV, G, 2), both f32.
//
// Per 32-key tile: (1) warp `part` of a slab computes S over its KQ
// k-steps of hd for all 32 keys and stores the partial; (2) it sums the QW
// partials (fixed order) for keys part*8 .. part*8+7 only, and the slab's
// row maxima meet in shared memory; (3) it writes those keys' P and the
// row sums meet likewise; (4) it runs P.V for its KQ n-tiles of hd with the
// whole slab's P.  So the softmax is computed once, not once per warp.
template <int KQ, typename TQ, typename TP>
__device__ __forceinline__ void ragged_unit(
    const TQ* __restrict__ q, const TP* __restrict__ pool, long long blk_stride,
    long long tok_stride, const int* __restrict__ tables, const int* __restrict__ tile_row,
    const int* __restrict__ tile_pos, const int* __restrict__ kv_lens, TQ* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int tiles, int KV, int G, int gc,
    int hd, int bs, int W, int Bs, int M, int window, float scale, int split, int s, int t,
    int hz, float* smem) {
  constexpr int HD = 32 * KQ;
  constexpr int LDQ = ragged_ldq(KQ);
  constexpr int LDK = ragged_ldk<TP>(KQ);
  constexpr int LDV = ragged_ldv(KQ);
  const int ngr = G / gc;
  const int kvh = hz / ngr;
  const int g0 = (hz - kvh * ngr) * gc;
  const int row = tile_row[t];
  const int slot = max(row, 0);
  const int qpos0 = tile_pos[t];
  const int kv_len = row >= 0 ? kv_lens[slot] : 0;
  const Span sp = unit_span(qpos0, QT, kv_len, window, split);
  if (s < sp.s0 || s > sp.s1) return;
  const bool direct = sp.s0 == sp.s1;
  const int tid = threadIdx.x;
  const long long rstride = static_cast<long long>(KV) * G;   // heads per packed row
  const long long head_t = static_cast<long long>(t) * QT * rstride + kvh * G + g0;
  if (sp.hi < sp.lo) {                               // padding tile or nothing seen
    for (int i = tid; i < QT * gc * hd; i += blockDim.x) {
      const int r = i / (gc * hd);
      const int rem = i - r * gc * hd;
      out[(head_t + r * rstride) * hd + rem] = from_f32<TQ>(0.f);
    }
    return;
  }

  const int mr = QT * gc;                            // real rows: m = r * gc + g
  const int mp = (mr + 15) & ~15;
  const int hd4 = hd >> 2;
  float* qs = smem;                                  // mp x LDQ
  float* ss = qs + mp * LDQ;                         // QW partial S slabs, mp x LDS; P in slab 0
  float* red = ss + QW * mp * LDS;                   // mp x QW row maxima, then row sums
  // RAGGED_DEPTH x {K: TILE x LDK, V: TILE x LDV}, in the pool's type
  TP* ring = reinterpret_cast<TP*>(red + 2 * mp * QW);
  constexpr int SLOT = TILE * (LDK + LDV);

  // zeros in Q's padding rows and columns and in K's padding columns (the
  // copies never write them, and 0 * garbage may be NaN)
  for (int i = tid; i < mp * LDQ; i += blockDim.x) qs[i] = 0.f;
  if (HD > hd)
    for (int i = tid; i < RAGGED_DEPTH * TILE * (HD - hd); i += blockDim.x) {
      const int r = i / (HD - hd);
      ring[(r / TILE) * SLOT + (r % TILE) * LDK + hd + i % (HD - hd)] = from_f32<TP>(0.f);
    }
  __syncthreads();
  for (int i = tid; i < mr * hd4; i += blockDim.x) {
    const int m = i / hd4;
    const int d4 = i - m * hd4;
    const int r = m / gc;
    store4(qs + m * LDQ + 4 * d4, load4(q + (head_t + r * rstride + (m - r * gc)) * hd + 4 * d4));
  }

  const TP* kb = pool + 2LL * kvh * hd;
  const HeadPool<TP> kv{kb, kb + hd, blk_stride, tok_stride};
  int j0;
  const Walk walk = split_walk(sp, s, split, table_row(tables, slot, W, Bs, M), M, bs, &j0);
  const TileCopy tc(hd, chunk_elems<TP>(hd));

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;                          // MMA group: rows gq, gq + 8
  const int tq = lane & 3;
  const int mt = warp / QW;                          // 16-row slab
  const int part = warp - mt * QW;                   // its k-steps, keys and n-tiles

  // the two rows this thread holds: visible keys [lo_r, hi_r]; a padding
  // row (qpos >= kv_len, or past the tile's QT*gc rows) sees nothing
  int lo_r[2], hi_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = mt * 16 + gq + 8 * rr;
    const int qpos = qpos0 + m / gc;
    lo_r[rr] = window > 0 ? max(0, qpos - window + 1) : 0;
    hi_r[rr] = (m < mr && qpos < kv_len) ? qpos : -1;
  }
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  float oacc[KQ][4];
#pragma unroll
  for (int n = 0; n < KQ; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;

  int issue = walk.next(j0);
#pragma unroll
  for (int d = 0; d < RAGGED_DEPTH; ++d) {
    if (issue < walk.j_end) {
      TP* kt = ring + d * SLOT;
      load_tile(kt, LDK, kt + TILE * LDK, LDV, kv, walk, issue, tc);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }

  const float* qa = qs + (mt * 16 + gq) * LDQ + part * KQ * 8 + tq;
  float* slab = ss + (mt * 16) * LDS;                // this slab's rows in slab 0
  float* rmax = red + (mt * 16) * QW;
  float* rsum = red + mp * QW + (mt * 16) * QW;
  int k = 0;
  for (int j = walk.next(j0); j < walk.j_end; j = walk.next(j + 1), ++k) {
    cp_async_wait<RAGGED_DEPTH - 1>();
    __syncthreads();
    const TP* kt = ring + (k % RAGGED_DEPTH) * SLOT;
    const TP* vt = kt + TILE * LDK;

    // (1) partial S over this warp's KQ k-steps: 16 rows x 32 keys
    float sacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[n][i] = 0.f;
#pragma unroll
    for (int x = 0; x < KQ; ++x) {
      Frag3 a;
      const float av[4] = {qa[x * 8], qa[8 * LDQ + x * 8], qa[x * 8 + 4],
                           qa[8 * LDQ + x * 8 + 4]};
      a.set(av);
      float b0[4], b1[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const TP* kr = kt + (n * 8 + gq) * LDK + (part * KQ + x) * 8 + tq;
        b0[n] = to_f32(kr[0]);
        b1[n] = to_f32(kr[4]);
      }
      mma3(sacc, a, b0, b1);
    }
    float* sw = ss + (part * mp + mt * 16) * LDS;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(sw + gq * LDS + n * 8 + 2 * tq) =
          make_float2(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<float2*>(sw + (gq + 8) * LDS + n * 8 + 2 * tq) =
          make_float2(sacc[n][2], sacc[n][3]);
    }
    __syncthreads();

    // (2) scores of keys part*8 + 2tq, +1 for rows gq, gq + 8: the QW
    // partials summed in order, scaled, masked; the rows' maxima
    const int c0 = part * 8 + 2 * tq;
    const int kp = j * TILE + c0;
    float sc[2][2];
    float mx[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* src = ss + (mt * 16 + gq + 8 * rr) * LDS + c0;
      float2 v = *reinterpret_cast<const float2*>(src);
#pragma unroll
      for (int w = 1; w < QW; ++w) {
        const float2 u = *reinterpret_cast<const float2*>(src + w * mp * LDS);
        v.x = __fadd_rn(v.x, u.x);
        v.y = __fadd_rn(v.y, u.y);
      }
      sc[rr][0] = (kp >= lo_r[rr] && kp <= hi_r[rr]) ? __fmul_rn(v.x, scale) : NEG_INF;
      sc[rr][1] = (kp + 1 >= lo_r[rr] && kp + 1 <= hi_r[rr]) ? __fmul_rn(v.y, scale) : NEG_INF;
      float m = fmaxf(sc[rr][0], sc[rr][1]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      mx[rr] = m;
    }
    if (tq == 0) {
      rmax[gq * QW + part] = mx[0];
      rmax[(gq + 8) * QW + part] = mx[1];
    }
    __syncthreads();

    // (3) the rows' new maxima; P of this warp's keys; the rows' sums
    float alpha[2];
    float ps[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* rm = rmax + (gq + 8 * rr) * QW;
      float m_new = m_r[rr];
#pragma unroll
      for (int w = 0; w < QW; ++w) m_new = fmaxf(m_new, rm[w]);
      const float p0 = (kp >= lo_r[rr] && kp <= hi_r[rr]) ? expf(__fsub_rn(sc[rr][0], m_new))
                                                          : 0.f;
      const float p1 = (kp + 1 >= lo_r[rr] && kp + 1 <= hi_r[rr])
                           ? expf(__fsub_rn(sc[rr][1], m_new))
                           : 0.f;
      *reinterpret_cast<float2*>(slab + (gq + 8 * rr) * LDS + c0) = make_float2(p0, p1);
      float sum = __fadd_rn(p0, p1);
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      ps[rr] = sum;
      alpha[rr] = expf(__fsub_rn(m_r[rr], m_new));
      m_r[rr] = m_new;
    }
    if (tq == 0) {
      rsum[gq * QW + part] = ps[0];
      rsum[(gq + 8) * QW + part] = ps[1];
    }
    __syncthreads();

    // (4) l and O: O = alpha * O + P.V over this warp's KQ n-tiles of hd
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* rs = rsum + (gq + 8 * rr) * QW;
      float sum = rs[0];
#pragma unroll
      for (int w = 1; w < QW; ++w) sum = __fadd_rn(sum, rs[w]);
      l_r[rr] = fmaf(l_r[rr], alpha[rr], sum);
    }
#pragma unroll
    for (int n = 0; n < KQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) oacc[n][i] = __fmul_rn(oacc[n][i], alpha[i >> 1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag3 a;
      const float* pa = slab + gq * LDS + kk * 8 + tq;
      const float av[4] = {pa[0], pa[8 * LDS], pa[4], pa[8 * LDS + 4]};
      a.set(av);
      const TP* vr = vt + (kk * 8 + tq) * LDV + part * KQ * 8 + gq;
      float b0[KQ], b1[KQ];
#pragma unroll
      for (int n = 0; n < KQ; ++n) {
        b0[n] = to_f32(vr[n * 8]);
        b1[n] = to_f32(vr[4 * LDV + n * 8]);
      }
      mma3(oacc, a, b0, b1);
    }
    __syncthreads();                                 // slot, slabs and sums consumed
    if (issue < walk.j_end) {
      TP* kn = ring + (k % RAGGED_DEPTH) * SLOT;
      load_tile(kn, LDK, kn + TILE * LDK, LDV, kv, walk, issue, tc);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  const long long heads_total = static_cast<long long>(tiles) * QT * rstride;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = mt * 16 + gq + 8 * rr;
    if (m >= mr) continue;
    const int r = m / gc;
    const long long h = head_t + r * rstride + (m - r * gc);
    const float den = fmaxf(l_r[rr], 1e-30f);
#pragma unroll
    for (int n = 0; n < KQ; ++n) {
      const int col = (part * KQ + n) * 8 + 2 * tq;
      if (col >= hd) continue;                       // hd is even: col + 1 < hd too
      const float o0 = oacc[n][2 * rr];
      const float o1 = oacc[n][2 * rr + 1];
      if (direct) {
        out[h * hd + col] = from_f32<TQ>(__fdiv_rn(o0, den));
        out[h * hd + col + 1] = from_f32<TQ>(__fdiv_rn(o1, den));
      } else {
        float* po = part_o + (static_cast<long long>(s) * heads_total + h) * hd + col;
        po[0] = o0;
        po[1] = o1;
      }
    }
    if (!direct && part == 0 && tq == 0) {
      float* ml = part_ml + 2 * (static_cast<long long>(s) * heads_total + h);
      ml[0] = m_r[rr];
      ml[1] = l_r[rr];
    }
  }
}

constexpr int PLAN_THREADS = 1024;

// The ragged kernel's work list: one item t * nsplit + s per (tile t, split
// s) the tile touches, in tile order and then split order (a tile that sees
// nothing is one item, split 0, which writes its zeros).  ctrl[0] gets the
// item count, ctrl[1] the work queue's head (0).  One CTA; the grid of the
// ragged kernel then holds only as many CTAs as the card runs at once
// instead of tiles * nsplit * heads, most of which would see nothing.
__global__ void __launch_bounds__(PLAN_THREADS)
ragged_plan_kernel(const int* __restrict__ tile_row, const int* __restrict__ tile_pos,
                   const int* __restrict__ kv_lens, int tiles, int window, int split,
                   int nsplit, int* __restrict__ items, int* __restrict__ ctrl) {
  __shared__ int warp_off[PLAN_THREADS / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int c0 = 0; c0 < tiles; c0 += PLAN_THREADS) {
    const int t = c0 + threadIdx.x;
    Span sp{0, -1, 0, 0};
    int n = 0;
    if (t < tiles) {
      const int row = tile_row[t];
      sp = unit_span(tile_pos[t], QT, row >= 0 ? kv_lens[row] : 0, window, split);
      n = sp.s1 - sp.s0 + 1;
    }
    int incl = n;                                    // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {                                 // exclusive scan of the warp sums
      const int v = warp_off[lane];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      warp_off[lane] = x - v;
    }
    __syncthreads();
    const int off = base + warp_off[warp] + incl - n;
    for (int k = 0; k < n; ++k) items[off + k] = t * nsplit + sp.s0 + k;
    __syncthreads();
    if (threadIdx.x == PLAN_THREADS - 1) base = off + n;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ctrl[0] = base;
    ctrl[1] = 0;
  }
}

// The ragged kernel: each CTA takes work units (item, head group) from the
// queue until it is empty.  A unit's result does not depend on which CTA
// runs it, so the output is the same on every run.
template <int KQ, typename TQ, typename TP>
__global__ void __launch_bounds__(2 * QW * 48)
ragged_kernel(const TQ* __restrict__ q, const TP* __restrict__ pool,
              long long blk_stride, long long tok_stride, const int* __restrict__ tables,
              const int* __restrict__ tile_row, const int* __restrict__ tile_pos,
              const int* __restrict__ kv_lens, TQ* __restrict__ out,
              float* __restrict__ part_o, float* __restrict__ part_ml,
              const int* __restrict__ items, int* __restrict__ ctrl, int tiles, int KV, int G,
              int gc, int hd, int bs, int W, int Bs, int M, int window, float scale, int split,
              int nsplit) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;
  const int nh = KV * (G / gc);
  const int total = ctrl[0] * nh;
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(ctrl + 1, 1);
    __syncthreads();
    const int w = next;
    __syncthreads();
    if (w >= total) break;
    const int item = items[w / nh];
    ragged_unit<KQ, TQ, TP>(q, pool, blk_stride, tok_stride, tables, tile_row, tile_pos,
                            kv_lens, out, part_o, part_ml, tiles, KV, G, gc, hd, bs, W, Bs, M,
                            window, scale, split, item % nsplit, item / nsplit, w % nh, smem);
    __syncthreads();                                 // shared memory free for the next unit
  }
}

// ------------------------------------------------------------------- merge
// Second pass of both kernels: for each unit spanning splits s0..s1, out =
// sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s in split order.  Decode:
// units are slots (qrows 1, a = lengths); ragged: units are tiles (qrows QT,
// a = tile_row, b = tile_pos, c = kv_lens).  Grid (units, KV); shared
// memory holds each head row's split weights and denominator.  The
// partials are f32; out has q's type.
template <typename TQ>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             TQ* __restrict__ out, const int* __restrict__ a, const int* __restrict__ b,
             const int* __restrict__ c, int ragged, int units, int qrows, int KV, int G, int hd,
             int window, int split) {
  const int u = blockIdx.x;
  const int kvh = blockIdx.y;
  Span sp;
  if (ragged) {
    const int row = a[u];
    sp = unit_span(b[u], qrows, row >= 0 ? c[row] : 0, window, split);
  } else {
    sp = unit_span(a[u] - 1, 1, a[u], window, split);
  }
  if (sp.s0 == sp.s1) return;                        // written by the main kernel
  extern __shared__ float wts[];                     // nh x (ns weights, 1 denominator)
  const int ns = sp.s1 - sp.s0 + 1;
  const int nh = qrows * G;                          // head rows: hr = r * G + g
  const long long per_split = static_cast<long long>(units) * qrows * KV * G;
  const long long h0 = (static_cast<long long>(u) * qrows * KV + kvh) * G;
  for (int hr = threadIdx.x; hr < nh; hr += MERGE_THREADS) {
    const int r = hr / G;
    const long long h = h0 + static_cast<long long>(r) * KV * G + (hr - r * G);
    const float* ml = part_ml + 2 * (sp.s0 * per_split + h);
    float mx = NEG_INF;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * s * per_split]);
    float den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(__fsub_rn(ml[2 * s * per_split], mx));
      wts[hr * (ns + 1) + s] = w;
      den = fmaf(w, ml[2 * s * per_split + 1], den);
    }
    wts[hr * (ns + 1) + ns] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int hd4 = hd >> 2;
  const long long stride4 = per_split * hd4;         // float4s between splits
  for (int i = threadIdx.x; i < nh * hd4; i += MERGE_THREADS) {
    const int hr = i / hd4;
    const int d4 = i - hr * hd4;
    const int r = hr / G;
    const long long h = h0 + static_cast<long long>(r) * KV * G + (hr - r * G);
    const float4* po = reinterpret_cast<const float4*>(part_o) + (sp.s0 * per_split + h) * hd4 + d4;
    const float* w = wts + hr * (ns + 1);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float4 o = po[s * stride4];
      num.x = fmaf(w[s], o.x, num.x);
      num.y = fmaf(w[s], o.y, num.y);
      num.z = fmaf(w[s], o.z, num.z);
      num.w = fmaf(w[s], o.w, num.w);
    }
    store4(out + h * hd + 4 * d4,
           make_float4(__fdiv_rn(num.x, w[ns]), __fdiv_rn(num.y, w[ns]), __fdiv_rn(num.z, w[ns]),
                       __fdiv_rn(num.w, w[ns])));
  }
}

bool shapes_ok(int hd, int bs, int G, int gc, int split, int nsplit, int M) {
  return hd > 0 && hd % 4 == 0 && hd <= MAX_HD && bs > 0 && bs % TILE == 0 && gc > 0 &&
         gc <= MAX_GC && G % gc == 0 && split > 0 && split % TILE == 0 && nsplit >= 1 &&
         static_cast<long long>(nsplit) * split >= static_cast<long long>(M) * bs;
}

template <typename TP>
size_t decode_smem(int depth, int gc, int hd) {
  return sizeof(float) * (static_cast<size_t>(gc) * hd + 5 * gc * TILE + 3 * MAX_GC) +
         sizeof(TP) * static_cast<size_t>(depth) * 2 * TILE * decode_ld<TP>(hd);
}

template <typename TP>
size_t ragged_smem(int mp, int kq) {
  return sizeof(float) * (static_cast<size_t>(mp) * ragged_ldq(kq) + QW * mp * LDS +
                          2 * mp * QW) +
         sizeof(TP) * RAGGED_DEPTH * TILE * (ragged_ldk<TP>(kq) + ragged_ldv(kq));
}

// Launch setup that depends only on the kernel and the device (raising a
// kernel's shared-memory limit, the occupancy query) is done on the first
// launch on each device and kept, so later calls pay for the launches alone.
constexpr int MAX_DEVICES = 64;

// Raise fn's dynamic shared-memory limit to smem once per device; done[dev]
// records it.  Devices past MAX_DEVICES set it on every call.
cudaError_t smem_limit_once(const void* fn, size_t smem, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

// The CTAs of ragged_kernel<KQ, TQ, TP> resident at once on the current
// device at mp padded rows (16, 32 or 48): the persistent grid's size.
template <int KQ, typename TQ, typename TP>
cudaError_t ragged_fill(int mp, long long* fill) {
  static std::atomic<bool> limit_set[MAX_DEVICES];
  static std::atomic<int> cached[MAX_DEVICES][3];      // 0 = not yet known
  constexpr int MAX_MP = (QT * RAGGED_MAX_GC + 15) & ~15;
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(ragged_kernel<KQ, TQ, TP>),
                                    ragged_smem<TP>(MAX_MP, KQ), limit_set);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  std::atomic<int>* slot = dev < MAX_DEVICES ? &cached[dev][mp / 16 - 1] : nullptr;
  if (slot != nullptr) {
    const int v = slot->load(std::memory_order_relaxed);
    if (v > 0) {
      *fill = v;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ragged_kernel<KQ, TQ, TP>, 2 * QW * mp, ragged_smem<TP>(mp, KQ))) !=
      cudaSuccess)
    return err;
  const int v = (per_sm > 0 ? per_sm : 1) * sms;
  if (slot != nullptr) slot->store(v, std::memory_order_relaxed);
  *fill = v;
  return cudaSuccess;
}

template <typename TQ>
cudaError_t launch_merge(const float* part_o, const float* part_ml, TQ* out, const int* a,
                         const int* b, const int* c, int ragged, int units, int qrows, int KV,
                         int G, int hd, int window, int split, int nsplit, cudaStream_t stream) {
  const size_t smem = sizeof(float) * qrows * G * (nsplit + 1);
  if (smem > 48 * 1024) {                            // past the default limit (rare)
    cudaError_t err = cudaFuncSetAttribute(merge_kernel<TQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  merge_kernel<TQ><<<dim3(units, KV), MERGE_THREADS, smem, stream>>>(
      part_o, part_ml, out, a, b, c, ragged, units, qrows, KV, G, hd, window, split);
  return cudaGetLastError();
}

template <int KQ, typename TQ, typename TP>
cudaError_t launch_ragged(const TQ* q, const TP* pool, long long blk_stride,
                          long long tok_stride, const int* tables, const int* tr, const int* tp,
                          const int* kl, TQ* out, float* po, float* pm, int* plan, int tiles,
                          int KV, int G, int gc, int hd, int bs, int W, int Bs, int M,
                          int window, float scale, int split, int nsplit, cudaStream_t st) {
  const int mp = (QT * gc + 15) & ~15;
  long long fill = 0;
  cudaError_t err = ragged_fill<KQ, TQ, TP>(mp, &fill);
  if (err != cudaSuccess) return err;
  int* items = plan + 2;
  ragged_plan_kernel<<<1, PLAN_THREADS, 0, st>>>(tr, tp, kl, tiles, window, split, nsplit,
                                                 items, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long units = static_cast<long long>(tiles) * nsplit * KV * (G / gc);
  const int grid = static_cast<int>(units < fill ? units : fill);
  ragged_kernel<KQ, TQ, TP><<<grid, 2 * QW * mp, ragged_smem<TP>(mp, KQ), st>>>(
      q, pool, blk_stride, tok_stride, tables, tr, tp, kl, out, po, pm, items, plan, tiles, KV,
      G, gc, hd, bs, W, Bs, M, window, scale, split, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess || nsplit == 1) return err;
  return launch_merge<TQ>(po, pm, out, tr, tp, kl, 1, tiles, QT, KV, G, hd, window, split,
                          nsplit, st);
}

template <int DEPTH, typename TQ, typename TP>
cudaError_t launch_decode(const TQ* q, const TP* kbase, const TP* vbase, long long blk_stride,
                          long long tok_stride, long long head_stride, const int* tables,
                          const int* lengths, TQ* out, float* part_o, float* part_ml, int B,
                          int KV, int G, int gc, int hd, int bs, int W, int Bs, int M,
                          int window, float scale, int split, int nsplit, cudaStream_t stream) {
  static std::atomic<bool> limit_set[MAX_DEVICES];
  cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(paged_decode_kernel<DEPTH, TQ, TP>),
      decode_smem<TP>(DEPTH, MAX_GC, MAX_HD), limit_set);
  if (err != cudaSuccess) return err;
  const size_t smem = decode_smem<TP>(DEPTH, gc, hd);
  paged_decode_kernel<DEPTH, TQ, TP>
      <<<dim3(nsplit, B, KV * (G / gc)), DEC_THREADS, smem, stream>>>(
          q, kbase, vbase, blk_stride, tok_stride, head_stride, tables, lengths, out, part_o,
          part_ml, B, KV, G, gc, hd, bs, W, Bs, M, window, scale, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_merge<TQ>(part_o, part_ml, out, lengths, nullptr, nullptr, 0, B, 1, KV, G, hd,
                          window, split, nsplit, stream);
}

}  // namespace paged_attention

using namespace paged_attention;

// q_dtype is the code of q's (and out's) element type, pool_dtype the
// pools'; DT_F32 = 0, DT_BF16 = 1.
extern "C" int paged_decode_launch(int depth, int q_dtype, int pool_dtype, const void* q,
                                   const void* kbase, const void* vbase, long long blk_stride,
                                   long long tok_stride, long long head_stride,
                                   const void* tables, const void* lengths, void* out,
                                   void* part_o, void* part_ml, int B, int KV, int G, int gc,
                                   int hd, int bs, int W, int Bs, int M, int window, float scale,
                                   int split, int nsplit, void* stream) {
  if (!shapes_ok(hd, bs, G, gc, split, nsplit, M) || B <= 0 || B > 65535 || KV <= 0 ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const auto* tb = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  auto st = static_cast<cudaStream_t>(stream);
  return elem::with_types(q_dtype, pool_dtype, [&](auto tq, auto tp) -> cudaError_t {
    using TQ = typename decltype(tq)::type;
    using TP = typename decltype(tp)::type;
    const auto* qt = static_cast<const TQ*>(q);
    const auto* kt = static_cast<const TP*>(kbase);
    const auto* vt = static_cast<const TP*>(vbase);
    auto* ot = static_cast<TQ*>(out);
    switch (depth) {
      case 1:
        return launch_decode<1>(qt, kt, vt, blk_stride, tok_stride, head_stride, tb, ln, ot, po,
                                pm, B, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      case 2:
        return launch_decode<2>(qt, kt, vt, blk_stride, tok_stride, head_stride, tb, ln, ot, po,
                                pm, B, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      case 4:
        return launch_decode<4>(qt, kt, vt, blk_stride, tok_stride, head_stride, tb, ln, ot, po,
                                pm, B, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

extern "C" int ragged_launch(int q_dtype, int pool_dtype, const void* q, const void* pool,
                             long long blk_stride, long long tok_stride, const void* tables,
                             const void* tile_row, const void* tile_pos, const void* kv_lens,
                             void* out, void* part_o, void* part_ml, void* plan, int tiles,
                             int KV, int G, int gc, int hd, int bs, int W, int Bs, int M,
                             int window, float scale, int split, int nsplit, void* stream) {
  if (!shapes_ok(hd, bs, G, gc, split, nsplit, M) || tiles <= 0 || tiles > 65535 || KV <= 0 ||
      gc > RAGGED_MAX_GC || plan == nullptr ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const int*>(tables);
  const auto* tr = static_cast<const int*>(tile_row);
  const auto* tp = static_cast<const int*>(tile_pos);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  auto* pl = static_cast<int*>(plan);
  return elem::with_types(q_dtype, pool_dtype, [&](auto tyq, auto typ) -> cudaError_t {
    using TQ = typename decltype(tyq)::type;
    using TP = typename decltype(typ)::type;
    const auto* qt = static_cast<const TQ*>(q);
    const auto* pt = static_cast<const TP*>(pool);
    auto* ot = static_cast<TQ*>(out);
    switch ((hd + 31) / 32) {
      case 1:
        return launch_ragged<1>(qt, pt, blk_stride, tok_stride, tb, tr, tp, kl, ot, po, pm, pl,
                                tiles, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      case 2:
        return launch_ragged<2>(qt, pt, blk_stride, tok_stride, tb, tr, tp, kl, ot, po, pm, pl,
                                tiles, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      case 3:
        return launch_ragged<3>(qt, pt, blk_stride, tok_stride, tb, tr, tp, kl, ot, po, pm, pl,
                                tiles, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
      default:
        return launch_ragged<4>(qt, pt, blk_stride, tok_stride, tb, tr, tp, kl, ot, po, pm, pl,
                                tiles, KV, G, gc, hd, bs, W, Bs, M, window, scale, split,
                                nsplit, st);
    }
  });
}
