// Absorbed-MLA paged decode over the FPR block tables, written by hand for
// sm_90a.
//
// Replaces the Pallas TPU kernel mla_paged_ctx_fwd (_mla_kernel) of
// src/repro/kernels/mla_attention/mla_attention.py:86.  For each slot b and
// head h, over the slot's resident pages:
//     s_t    = (q_lat[h] . c_t + q_rope[h] . kr_t) * scale
//     ctx[h] = sum_t p_t c_t / max(sum_t p_t, 1e-30),  p = online softmax of s
// in f32.  W_UK (before) and W_UV (after) stay outside, in PyTorch.
//
// Bound on this card.  Every visible token is read once per slot (rank +
// rope elements, 2,304 bytes at DeepSeek-V2 widths in f32, 1,152 in bf16)
// and costs H * (2*(rank + rope) + 2*rank) = 278,528 flops at H = 128:
// about 121 flops per f32 byte.  On
// CUDA cores in f32 the bound is those flops over 67 TFLOP/s; on the tensor
// cores in 3xTF32 (three TF32 products per f32 product, 495 TFLOP/s) it is
// max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s).
//
// Design (mla_ctx_kernel):
//   * The heads of a slot share every key, so heads are the M side of
//     mma.sync.m16n8k8 in 3xTF32 (kernels/csrc/tf32x3.cuh), as FlashMLA
//     does it: a block takes HG = 16 heads of one slot (one m-tile), so each
//     page tile is read by H / 16 blocks (8 at H = 128), not by every head.
//     Heads past H are zero rows that are never stored.
//   * Scores S (16 x 32) = [q_lat | q_rope] (16 x DK) . [c | kr]^T (DK x 32),
//     DK = rank + rope: the DK / 8 k-steps are dealt to the 8 warps (9 each
//     at DeepSeek-V2), each warp keeps its k-steps' query fragments split
//     into TF32 big and small parts in registers for the whole walk (72
//     registers), and the partial scores meet in shared memory, summed in
//     warp order by one pass over the tile (the one shared-memory reduction;
//     masked tokens get NEG_INF there).
//   * Context O (16 x rank) += P (16 x 32) . c (32 x rank): the warps split
//     the rank / 8 n-tiles (8 each at rank 512, 32 accumulator registers a
//     thread).  Every warp runs the online softmax itself on the score
//     fragments it reads back (row max and sum by quad shuffles, rescaling
//     its O in registers), and the P fragment is the score fragment itself:
//     the context's k-step x takes tokens x*8 + 2q and x*8 + 2q + 1 for
//     lanes of quad index q, which is where the score accumulator holds
//     them.  The same order makes the c reads of the B fragments hit 32
//     banks with the tile's row stride of DK + 4 floats.
//   * Split-K over pages: splits of MLA_SPLIT = 256 tokens (8 tiles), grid
//     (nsplit, ceil(H / 16), B), nsplit = ceil(M * bs / 256) from shapes, no
//     host sync.  A slot whose visible tokens (t < length) lie in split 0
//     only is written directly by that block; otherwise each split s <=
//     (length - 1) / 256 writes its (m, l, unnormalised O) to scratch (a
//     split of holes writes m = NEG_INF, l = 0, O = 0) and mla_merge_kernel
//     combines them in split order (no atomics: the same output every run).
//     Blocks of splits past the length exit at once.  A slot that sees
//     nothing comes out exactly 0.
//   * A two-slot ring of 32-token [c | kr] tiles filled by bulk copies
//     (cp.async.bulk, one instruction a row's c or kr, completed on an
//     mbarrier a slot; kernels/csrc/bulk_copy.cuh): the next tile is in
//     flight while the current one is used, and three barriers a tile.  The
//     page walk reads the split's entries of the slot's row of the (W, Bs,
//     M) shard stack ((b % W)*Bs*M + (b / W)*M + m) into shared memory once,
//     and copies only tiles that hold a visible token: holes (< 0) and tiles
//     at or past the length are never read.  Inside a tile, positions at or
//     past the length score the finite NEG_INF = -1e30 and weigh exactly 0.
// What holds it back: the block is alone on its SM (169 KB of shared
// memory, about 200 registers a thread) and its phases are split by
// barriers, so the tensor pipe idles through the softmax, the reduction
// and the copies' issue, and each f32 product costs three mma.sync.  A
// clock64 probe build (not kept) put the score and the context MMAs at
// most of a tile's time; a producer warp issuing the copies did not move
// it.
// More heads a block (32 would need 144 registers of query fragments, or
// 74 KB of shared memory beside the 148 KB ring), wgmma on 64-head tiles
// and a producer warp with more blocks per SM are later work.
//
// Element types.  The queries (q_lat, q_rope) and the pools (c, kr) are
// each float or bf16, independently, as in the TPU kernel, which reads any
// float, computes in f32 and writes f32 (kernels/csrc/bf16.cuh).  Query
// elements become f32 where the fragments are read; pages are bulk-copied
// into the ring in the pool's own type (a bf16 row part is rank * 2 or
// rope * 2 bytes, a multiple of 16) and each element becomes an f32 where
// a B fragment reads it.  Every multiply and add after that is the f32
// kernel's in its order, the scratch and the merge stay f32, and so does
// the output: a call on bf16 inputs gives exactly the f32 kernel's result
// on the upcast inputs.  The bf16 ring's row stride is dk + 8 elements
// (16-byte aligned row parts; (dk + 8) / 2 words, 4 mod 32 at dk = 576):
// the score reads then touch 16 words a warp, rows gq at banks 4 gq and
// 4 gq + 1 with lanes tq = 0, 1 and 2, 3 sharing a word, and the context
// reads 16 words at banks 8 tq + gq / 2 (+ 4 nt), gq even and odd sharing
// one: no conflicts, as the f32 ring's dk + 4 floats gives.

#include <cuda_runtime.h>

#include "../../csrc/bf16.cuh"
#include "../../csrc/bulk_copy.cuh"
#include "../../csrc/tf32x3.cuh"

// A named namespace, not an anonymous one: a profiler's trace names each
// kernel by its demangled signature, and "(anonymous namespace)::" opens
// with a parenthesis that tools cutting the parameter list cut at.
namespace mla_attention {

using namespace elem;
using namespace tf32x3;

constexpr int TILE = 32;                  // tokens per ring slot
constexpr int HG = 16;                    // heads a block: one m-tile
constexpr int NT = 256;                   // threads a block
constexpr int NW = NT / 32;
constexpr int MAX_RANK = 512;
constexpr int MAX_ROPE = 64;
constexpr int KPW = ((MAX_RANK + MAX_ROPE) / 8 + NW - 1) / NW;   // k-steps a warp, at most
constexpr int NPW = (MAX_RANK / 8 + NW - 1) / NW;     // context n-tiles a warp, at most
constexpr int MAX_TPS = 8;                // tiles a split, at most
constexpr int LDP = TILE + 4;             // row stride of the score slabs
constexpr int MERGE_THREADS = MAX_RANK / 4;
constexpr float NEG_INF = -1e30f;

// The last of nsplit splits holding a visible token of a slot of `length`
// (0 for a slot that sees nothing: split 0 writes its zeros).
__device__ __forceinline__ int last_split(int length, int split, int nsplit) {
  return length > 0 ? min((length - 1) / split, nsplit - 1) : 0;
}

// Row stride (elements) of the ring's [c | kr] rows: f32 dk + 4 (4 mod 32
// words), bf16 dk + 8 (16-byte aligned row parts); see the head comment.
template <typename TP>
__host__ __device__ __forceinline__ int ring_ld(int dk) {
  return sizeof(TP) == 4 ? dk + 4 : dk + 8;
}

template <typename TP>
struct Pages {
  const TP* c;          // (N, bs, rank)
  const TP* kr;         // (N, bs, rope)
  const int* trow;      // the split's table entries (shared memory), from page p0
  int p0;
  int bs, rank, rope;
  int tiles_per_blk;
  int j_end;            // tiles [.., j_end) may hold a visible token

  // First tile at or after j whose page is resident.
  __device__ __forceinline__ int next(int j) const {
    while (j < j_end && trow[j / tiles_per_blk - p0] < 0) ++j;
    return j;
  }

  // Tile j's [c | kr] rows into dst (TILE rows of ld elements), one bulk
  // copy a row part: thread (part tid / 32, row tid % 32) of the first two
  // warps copies row's c (part 0) or kr (part 1).  The announced bytes are
  // the pool's: a wrong count would leave the wait hanging.
  __device__ __forceinline__ void load(TP* dst, uint64_t* bar, int j, int ld) const {
    constexpr unsigned ES = sizeof(TP);
    const int tid = threadIdx.x;
    if (tid >= 2 * TILE) return;
    if (tid == 0) bulk::expect(bar, ES * TILE * (rank + rope));
    const int t = tid % TILE;
    const long long tok = trow[j / tiles_per_blk - p0] * static_cast<long long>(bs) +
                          (j % tiles_per_blk) * TILE + t;
    if (tid < TILE)
      bulk::copy(dst + t * ld, c + tok * rank, ES * rank, bar);
    else
      bulk::copy(dst + t * ld + rank, kr + tok * rope, ES * rope, bar);
  }
};

// q_lat, out: (B, H, rank); q_rope: (B, H, rope); part_o: (nsplit, B, H,
// rank); part_ml: (nsplit, B, H, 2).  Grid (nsplit, ceil(H / HG), B), NT
// threads; rank and rope multiples of 8.  TQ: the queries' element type,
// TP: the pools'; out and the scratch are f32.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(NT, 1)
mla_ctx_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
               const TP* __restrict__ c_pool, const TP* __restrict__ rope_pool,
               const int* __restrict__ tables, const int* __restrict__ lengths,
               float* __restrict__ out, float* __restrict__ part_o,
               float* __restrict__ part_ml, int B, int H, int rank, int rope, int bs, int W,
               int Bs, int M, float scale, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int b = blockIdx.z;
  const int length = lengths[b];
  const int s1 = last_split(length, split, gridDim.x);
  if (s > s1) return;
  const bool direct = s1 == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int dk = rank + rope;
  const int ld = ring_ld<TP>(dk);
  const int ksteps = dk >> 3;
  const int ntiles = rank >> 3;
  TP* ring = reinterpret_cast<TP*>(smem_raw);  // 2 x TILE x ld
  float* spart = reinterpret_cast<float*>(ring + 2 * TILE * ld);   // NW x HG x LDP partials
  float* sfin = spart + NW * HG * LDP;         // HG x LDP scores
  uint64_t* bars = reinterpret_cast<uint64_t*>(sfin + HG * LDP);   // one a ring slot
  if (tid == 0) {
    bulk::init(bars);
    bulk::init(bars + 1);
  }
  // the split's table entries, read once: pages p0 .. p0 + np - 1
  int* spage = reinterpret_cast<int*>(bars + 2);
  const int tpb = bs / TILE;
  const int tps = split / TILE;
  const int p0 = s * tps / tpb;
  const int np = min(((s + 1) * tps - 1) / tpb - p0 + 1, M - p0);
  if (tid < np)
    spage[tid] = tables[static_cast<long long>(b % W) * Bs * M +
                        static_cast<long long>(b / W) * M + p0 + tid];
  __syncthreads();

  const int j_vis = min((length + TILE - 1) / TILE, M * tpb);   // tiles with a visible token
  const Pages<TP> pages{c_pool, rope_pool, spage, p0, bs, rank, rope, tpb,
                        min(j_vis, (s + 1) * tps)};

  // this warp's k-steps x = warp + NW * i of the query rows gq, gq + 8
  Frag3 qf[KPW];
  {
    const int h_a = h0 + gq, h_b = h0 + gq + 8;
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int x = warp + NW * i;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (x < ksteps) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e & 1 ? h_b : h_a;
          const int d = x * 8 + tq + (e & 2 ? 4 : 0);
          if (hh < H) {
            const long long row = static_cast<long long>(b) * H + hh;
            a[e] = to_f32(d < rank ? q_lat[row * rank + d] : q_rope[row * rope + d - rank]);
          }
        }
      }
      qf[i].set(a);
    }
  }


  float m_r[2] = {NEG_INF, NEG_INF};           // rows gq, gq + 8 (same in every warp)
  float l_r[2] = {0.f, 0.f};
  float oacc[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  int j = pages.next(s * tps);
  if (j < pages.j_end) pages.load(ring, bars, j, ld);
  for (int it = 0; j < pages.j_end; ++it) {
    bulk::wait(bars + (it & 1), (it >> 1) & 1);
    __syncthreads();                           // (0) tile j landed; the other slot is free
    const int jn = pages.next(j + 1);
    if (jn < pages.j_end)
      pages.load(ring + ((it + 1) & 1) * TILE * ld, bars + ((it + 1) & 1), jn, ld);
    const TP* tile = ring + (it & 1) * TILE * ld;

    // partial scores over this warp's k-steps: 16 heads x 32 tokens
    {
      float sacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const int x = warp + NW * i;
        if (x >= ksteps) break;
        float b0[4], b1[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const TP* kp = tile + (n * 8 + gq) * ld + x * 8 + tq;
          b0[n] = to_f32(kp[0]);
          b1[n] = to_f32(kp[4]);
        }
        mma3(sacc, qf[i], b0, b1);
      }
      float* sw = spart + warp * HG * LDP;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(sw + gq * LDP + n * 8 + 2 * tq) =
            make_float2(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<float2*>(sw + (gq + 8) * LDP + n * 8 + 2 * tq) =
            make_float2(sacc[n][2], sacc[n][3]);
      }
    }
    __syncthreads();                           // (1)
    // the warps' partials summed in warp order, scaled, masked
    for (int idx = tid; idx < HG * TILE; idx += NT) {
      const int r = idx >> 5, t = idx & 31;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) v = __fadd_rn(v, spart[(w * HG + r) * LDP + t]);
      sfin[r * LDP + t] = j * TILE + t < length ? __fmul_rn(v, scale) : NEG_INF;
    }
    __syncthreads();                           // (2)

    // online softmax on the score fragments (every warp, the same values)
    float p[4][4];
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m_r[rr];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 v = *reinterpret_cast<const float2*>(sfin + (gq + 8 * rr) * LDP + n * 8 + 2 * tq);
        p[n][2 * rr] = v.x;
        p[n][2 * rr + 1] = v.y;
        mx = fmaxf(mx, fmaxf(v.x, v.y));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = j * TILE + n * 8 + 2 * tq + e;
          const float pv = t < length ? expf(__fsub_rn(p[n][2 * rr + e], mx)) : 0.f;
          p[n][2 * rr + e] = pv;
          sum = __fadd_rn(sum, pv);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      alpha[rr] = expf(__fsub_rn(m_r[rr], mx));
      l_r[rr] = fmaf(l_r[rr], alpha[rr], sum);
      m_r[rr] = mx;
    }
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      oacc[n][0] = __fmul_rn(oacc[n][0], alpha[0]);
      oacc[n][1] = __fmul_rn(oacc[n][1], alpha[0]);
      oacc[n][2] = __fmul_rn(oacc[n][2], alpha[1]);
      oacc[n][3] = __fmul_rn(oacc[n][3], alpha[1]);
    }

    // O += P . c: k-step x holds tokens x*8 + 2q (a0, a1) and x*8 + 2q + 1
    // (a2, a3), the score accumulator's own layout
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      Frag3 a;
      a.set({p[x][0], p[x][2], p[x][1], p[x][3]});
      const TP* c0 = tile + (x * 8 + 2 * tq) * ld + gq;
      float b0[NPW], b1[NPW];
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const int nt = min(warp + NW * n, ntiles - 1);   // clamped: stored only if < ntiles
        b0[n] = to_f32(c0[nt * 8]);
        b1[n] = to_f32(c0[ld + nt * 8]);
      }
      mma3(oacc, a, b0, b1);
    }
    j = jn;
  }

  // write: rows gq, gq + 8 of the block's heads; columns 8 * nt + 2q
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int h = h0 + gq + 8 * rr;
    if (h >= H) continue;
    const long long row = static_cast<long long>(b) * H + h;
    float* dst = direct ? out + row * rank
                        : part_o + (static_cast<long long>(s) * B * H + row) * rank;
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      const int nt = warp + NW * n;
      if (nt >= ntiles) break;
      float2 v = make_float2(oacc[n][2 * rr], oacc[n][2 * rr + 1]);
      if (direct) {
        const float den = fmaxf(l_r[rr], 1e-30f);
        v = make_float2(__fdiv_rn(v.x, den), __fdiv_rn(v.y, den));
      }
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * tq) = v;
    }
    if (!direct && warp == 0 && tq == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * (static_cast<long long>(s) * B * H + row)) =
          make_float2(m_r[rr], l_r[rr]);
  }
}

// Second pass: for a slot whose visible tokens span splits 0..s1 > 0,
// out = sum_s e^(m_s - M) O_s / max(sum_s e^(m_s - M) l_s, 1e-30) in split
// order.  Grid (H, B), MERGE_THREADS threads (float4 columns).
__global__ void __launch_bounds__(MERGE_THREADS)
mla_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                 const int* __restrict__ lengths, float* __restrict__ out, int B, int H,
                 int rank, int split, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s1 = last_split(lengths[b], split, nsplit);
  if (s1 == 0) return;                         // written by the main kernel
  const long long row = static_cast<long long>(b) * H + h;
  const long long per_split = static_cast<long long>(B) * H;
  const float* ml = part_ml + 2 * row;
  float mx = NEG_INF;
  for (int s = 0; s <= s1; ++s) mx = fmaxf(mx, ml[2 * s * per_split]);
  float den = 0.f;
  for (int s = 0; s <= s1; ++s)
    den = fmaf(expf(__fsub_rn(ml[2 * s * per_split], mx)), ml[2 * s * per_split + 1], den);
  den = fmaxf(den, 1e-30f);
  const int d4 = threadIdx.x;
  if (4 * d4 >= rank) return;
  const float4* po = reinterpret_cast<const float4*>(part_o + row * rank) + d4;
  const long long stride4 = per_split * (rank >> 2);
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s <= s1; ++s) {
    const float w = expf(__fsub_rn(ml[2 * s * per_split], mx));
    const float4 o = po[s * stride4];
    num.x = fmaf(w, o.x, num.x);
    num.y = fmaf(w, o.y, num.y);
    num.z = fmaf(w, o.z, num.z);
    num.w = fmaf(w, o.w, num.w);
  }
  reinterpret_cast<float4*>(out + row * rank)[d4] =
      make_float4(__fdiv_rn(num.x, den), __fdiv_rn(num.y, den), __fdiv_rn(num.z, den),
                  __fdiv_rn(num.w, den));
}

// The ring in the pool's element type, then the f32 score slabs, the
// barriers and the split's table entries.
template <typename TP>
size_t smem_bytes(int rank, int rope) {
  return sizeof(TP) * 2ull * TILE * ring_ld<TP>(rank + rope) +
         sizeof(float) * (NW * HG * LDP + HG * LDP) + 2 * sizeof(uint64_t) +
         MAX_TPS * sizeof(int);
}

template <typename TQ, typename TP>
cudaError_t launch_ctx(const TQ* q_lat, const TQ* q_rope, const TP* c_pool,
                       const TP* rope_pool, const int* tables, const int* lengths, float* out,
                       float* part_o, float* part_ml, int B, int H, int rank, int rope, int bs,
                       int W, int Bs, int M, float scale, int split, int nsplit,
                       cudaStream_t st) {
  const size_t smem = smem_bytes<TP>(rank, rope);
  cudaError_t err = cudaFuncSetAttribute(mla_ctx_kernel<TQ, TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mla_ctx_kernel<TQ, TP><<<dim3(nsplit, (H + HG - 1) / HG, B), NT, smem, st>>>(
      q_lat, q_rope, c_pool, rope_pool, tables, lengths, out, part_o, part_ml, B, H, rank,
      rope, bs, W, Bs, M, scale, split);
  return cudaGetLastError();
}

}  // namespace mla_attention

using namespace mla_attention;

// q_lat, out: (B, H, rank); q_rope: (B, H, rope); c_pool: (N, bs, rank);
// rope_pool: (N, bs, rope); tables: the (W, Bs, M) shard stack; lengths:
// (B,); part_o: (nsplit, B, H, rank) and part_ml: (nsplit, B, H, 2) when
// nsplit > 1 (else unused).  q_dtype is the code of q_lat's and q_rope's
// element type, pool_dtype that of c_pool's and rope_pool's (DT_F32 = 0,
// DT_BF16 = 1); out, the scratch (f32), tables and lengths (int32) have
// one type each.  All contiguous, 16-byte aligned.  rank and rope
// multiples of 8 up to 512 and 64; bs and split multiples of 32 with
// nsplit * split >= M * bs.
extern "C" int mla_ctx_launch(int q_dtype, int pool_dtype, const void* q_lat,
                              const void* q_rope, const void* c_pool, const void* rope_pool,
                              const void* tables, const void* lengths, void* out,
                              void* part_o, void* part_ml, int B, int H, int rank, int rope,
                              int bs, int W, int Bs, int M, float scale, int split, int nsplit,
                              void* stream) {
  if (B <= 0 || H <= 0 || rank <= 0 || rank % 8 || rank > MAX_RANK || rope <= 0 || rope % 8 ||
      rope > MAX_ROPE || bs <= 0 || bs % TILE || W <= 0 || Bs <= 0 || M <= 0 || split <= 0 ||
      split % TILE || split > MAX_TPS * TILE || nsplit <= 0 || static_cast<long long>(nsplit) * split < 1LL * M * bs ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  const auto* ln = static_cast<const int*>(lengths);
  cudaError_t err = elem::with_types(q_dtype, pool_dtype, [&](auto tq, auto tp) -> cudaError_t {
    using TQ = typename decltype(tq)::type;
    using TP = typename decltype(tp)::type;
    return launch_ctx(static_cast<const TQ*>(q_lat), static_cast<const TQ*>(q_rope),
                      static_cast<const TP*>(c_pool), static_cast<const TP*>(rope_pool),
                      static_cast<const int*>(tables), ln, o, po, pm, B, H, rank, rope, bs, W,
                      Bs, M, scale, split, nsplit, st);
  });
  if (err != cudaSuccess || nsplit == 1) return err;
  mla_merge_kernel<<<dim3(H, B), MERGE_THREADS, 0, st>>>(po, pm, ln, o, B, H, rank, split, nsplit);
  return cudaGetLastError();
}
