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
// Bound on this card: operations.  Every visible token is read once per
// slot (rank + rope floats, 2,304 bytes at DeepSeek-V2 widths) and costs
// H * (2*(rank+rope) + 2*rank) = 278,528 flops at H = 128: about 121 flops
// per byte against an f32 CUDA-core ridge of about 20.  The least time is
// the visible tokens' flops over the f32 peak.
//
// Design:
//   * 128 heads x 512 f32 accumulators are 256 KB, more than one block's
//     shared memory, so the grid is (B, H / hg) with hg <= 8 heads per block
//     (128 blocks for B = 8, H = 128) and two warps per head, to hide
//     latency with 16 warps on the SM.  Each block streams the slot's pages
//     itself; the other head groups of the slot read the same pages, which
//     L2 serves.
//   * A 32-token tile of the page ([c | kr] rows, 32 x 576 floats = 72 KB)
//     goes to shared memory with cp.async into a two-deep ring, so tile j+1
//     is in flight while tile j is used.  Row strides are an odd number of
//     16-byte words, so lane-per-row float4 reads hit distinct banks.
//   * Both products reuse each shared-memory read across heads, since
//     shared-memory bandwidth, not arithmetic, is what a CUDA-core kernel
//     runs out of here:
//       - score (hg x 32 = Q . C^T): warp w takes a slice of the 576-wide
//         dot product, lane t token t; one float4 of c_t feeds all hg
//         heads (query float4s are warp broadcasts).  The warps' partial
//         sums meet in shared memory and warp h adds them for head h;
//       - context (hg x rank += P . C): thread i owns columns i, i + 64 hg,
//         ... (NCOL of them) of every head of the block, so one read of
//         c_t[col] feeds hg multiply-adds (the hg probabilities of token t
//         are broadcasts).
//   * Online softmax per head in f32 (warp h, lane t = token t, shuffles
//     for the tile's max and sum); the running max and sum live in warp h's
//     registers, the rescale factor and the probabilities go through
//     shared memory to the threads that own the accumulators.
//   * The page walk reads the slot's row of the (W, Bs, M) shard stack
//     ((b % W)*Bs*M + (b / W)*M + m) and issues copies only for tiles that
//     hold a visible token: holes (< 0) and tiles at or past the length are
//     never read.  Inside a tile, positions at or past the length score the
//     finite NEG_INF = -1e30, whose expf underflows to exactly 0.  A slot
//     that sees nothing writes 0.
// Tensor cores (TF32 or bf16 wgmma), split-K over pages for long slots and
// TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                  // tokens per ring slot
constexpr int MAX_HG = 8;                 // heads per block
constexpr int MAX_NW = 2 * MAX_HG;        // warps per block: two per head
constexpr int MAX_RANK = 512;
constexpr int MAX_ROPE = 64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

struct Pages {
  const float* c;       // (N, bs, rank)
  const float* kr;      // (N, bs, rope)
  const int* trow;      // the slot's M table entries
  int bs, rank, rope;
  int tiles_per_blk;
  int j_end;            // tiles [0, j_end) may hold a visible token

  // First tile at or after j whose page is resident.
  __device__ __forceinline__ int next(int j) const {
    while (j < j_end && trow[j / tiles_per_blk] < 0) ++j;
    return j;
  }

  // Tile j's [c | kr] rows into dst (TILE rows of ld floats).
  __device__ __forceinline__ void load(float* dst, int j, int ld) const {
    const long long blk = trow[j / tiles_per_blk];
    const long long tok0 = blk * bs + (j % tiles_per_blk) * TILE;
    const int dk4 = (rank + rope) >> 2;
    const int rank4 = rank >> 2;
    for (int i = threadIdx.x; i < TILE * dk4; i += blockDim.x) {
      const int t = i / dk4;
      const int d4 = i - t * dk4;
      const float* src = d4 < rank4 ? c + (tok0 + t) * rank + d4 * 4
                                    : kr + (tok0 + t) * rope + (d4 - rank4) * 4;
      cp_async16(dst + t * ld + d4 * 4, src);
    }
  }
};

// Row stride of a tile in floats: an odd number of float4s past dk.
__host__ __device__ __forceinline__ int tile_ld(int dk) {
  const int dk4 = dk >> 2;
  return 4 * (dk4 % 2 ? dk4 + 2 : dk4 + 1);
}

// q_lat, out: (B, H, rank); q_rope: (B, H, rope).  Grid (B, H / hg),
// 64 * hg threads, NCOL * 64 * hg >= rank.  Block heads h0 .. h0 + hg - 1,
// h0 = blockIdx.y * hg; warp h < hg keeps the softmax state of head h.
template <int NCOL>
__global__ void __launch_bounds__(MAX_NW * 32)
mla_ctx_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
               const float* __restrict__ c_pool, const float* __restrict__ rope_pool,
               const int* __restrict__ tables, const int* __restrict__ lengths,
               float* __restrict__ out, int H, int hg, int rank, int rope, int bs, int W,
               int Bs, int M, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * hg;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nthr >> 5;
  const int dk = rank + rope;
  const int dk4 = dk >> 2;
  const int rank4 = rank >> 2;
  const int ld = tile_ld(dk);
  float* qs = smem;                          // (MAX_HG, dk): [q_lat | q_rope]
  float* ring = qs + MAX_HG * dk;            // 2 x TILE x ld
  float* part = ring + 2 * TILE * ld;        // (nw, MAX_HG, TILE) partial scores
  float* ps = part + MAX_NW * MAX_HG * TILE; // (TILE, MAX_HG) probabilities
  float* alpha_s = ps + TILE * MAX_HG;       // (MAX_HG,) rescale of this tile
  float* l_s = alpha_s + MAX_HG;             // (MAX_HG,) final softmax sums
  const int slot_elems = TILE * ld;

  // queries; heads past hg stay zero so every loop below runs MAX_HG wide
  for (int i = tid; i < MAX_HG * dk4; i += nthr) {
    const int hh = i / dk4;
    const int d4 = i - hh * dk4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hh < hg) {
      const long long row = static_cast<long long>(b) * H + h0 + hh;
      const float* src = d4 < rank4 ? q_lat + row * rank + d4 * 4
                                    : q_rope + row * rope + (d4 - rank4) * 4;
      v = *reinterpret_cast<const float4*>(src);
    }
    reinterpret_cast<float4*>(qs)[i] = v;
  }
  for (int i = tid; i < TILE * MAX_HG; i += nthr) ps[i] = 0.f;

  const int length = lengths[b];
  const int tpb = bs / TILE;
  const Pages pages{c_pool,
                    rope_pool,
                    tables + static_cast<long long>(b % W) * Bs * M +
                        static_cast<long long>(b / W) * M,
                    bs,
                    rank,
                    rope,
                    tpb,
                    length > 0 ? min((length + TILE - 1) / TILE, M * tpb) : 0};

  // softmax state of head `warp` (lanes agree; warps < hg)
  float m_i = NEG_INF;
  float l_i = 0.f;
  // context columns tid, tid + nthr, ... of every head
  float acc[MAX_HG][NCOL];
#pragma unroll
  for (int h = 0; h < MAX_HG; ++h)
#pragma unroll
    for (int k = 0; k < NCOL; ++k) acc[h][k] = 0.f;

  int issue = pages.next(0);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (issue < pages.j_end) {
      pages.load(ring + s * slot_elems, issue, ld);
      issue = pages.next(issue + 1);
    }
    cp_async_commit();
  }

  int it = 0;
  for (int j = pages.next(0); j < pages.j_end; j = pages.next(j + 1), ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* tile = ring + (it & 1) * slot_elems;

    // score partials: warp w, lane t, float4 columns w, w + nw, ...
    {
      float sacc[MAX_HG];
#pragma unroll
      for (int h = 0; h < MAX_HG; ++h) sacc[h] = 0.f;
      const float4* c4 = reinterpret_cast<const float4*>(tile + lane * ld);
      for (int d4 = warp; d4 < dk4; d4 += nw) {
        const float4 c = c4[d4];
#pragma unroll
        for (int h = 0; h < MAX_HG; ++h) {
          const float4 q = reinterpret_cast<const float4*>(qs + h * dk)[d4];
          sacc[h] = fmaf(q.x, c.x, sacc[h]);
          sacc[h] = fmaf(q.y, c.y, sacc[h]);
          sacc[h] = fmaf(q.z, c.z, sacc[h]);
          sacc[h] = fmaf(q.w, c.w, sacc[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < MAX_HG; ++h) part[(warp * MAX_HG + h) * TILE + lane] = sacc[h];
    }
    __syncthreads();

    // online softmax: warp h, lane t = token t of the tile
    if (warp < hg) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s = __fadd_rn(s, part[(w * MAX_HG + warp) * TILE + lane]);
      // token j*TILE (lane 0) is visible: j < ceil(length / TILE)
      s = j * TILE + lane < length ? __fmul_rn(s, scale) : NEG_INF;
      const float m_new = fmaxf(m_i, warp_max(s));
      const float p = expf(__fsub_rn(s, m_new));
      const float alpha = expf(__fsub_rn(m_i, m_new));
      l_i = fmaf(l_i, alpha, warp_sum(p));
      m_i = m_new;
      ps[lane * MAX_HG + warp] = p;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // context: acc[h][col] = acc[h][col] * alpha[h] + sum_t p[t][h] c_t[col]
#pragma unroll
    for (int h = 0; h < MAX_HG; ++h) {
      const float a = h < hg ? alpha_s[h] : 0.f;
#pragma unroll
      for (int k = 0; k < NCOL; ++k) acc[h][k] = __fmul_rn(acc[h][k], a);
    }
    for (int t = 0; t < TILE; ++t) {
      const float* crow = tile + t * ld;
      float cv[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const int col = tid + k * nthr;
        cv[k] = col < rank ? crow[col] : 0.f;
      }
      const float4* p4 = reinterpret_cast<const float4*>(ps + t * MAX_HG);
#pragma unroll
      for (int h4 = 0; h4 < MAX_HG / 4; ++h4) {
        const float4 p = p4[h4];
#pragma unroll
        for (int k = 0; k < NCOL; ++k) {
          acc[4 * h4 + 0][k] = fmaf(p.x, cv[k], acc[4 * h4 + 0][k]);
          acc[4 * h4 + 1][k] = fmaf(p.y, cv[k], acc[4 * h4 + 1][k]);
          acc[4 * h4 + 2][k] = fmaf(p.z, cv[k], acc[4 * h4 + 2][k]);
          acc[4 * h4 + 3][k] = fmaf(p.w, cv[k], acc[4 * h4 + 3][k]);
        }
      }
    }
    __syncthreads();                         // ring slot, part and ps used by all
    if (issue < pages.j_end) {
      pages.load(ring + (it & 1) * slot_elems, issue, ld);
      issue = pages.next(issue + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (lane == 0 && warp < hg) l_s[warp] = fmaxf(l_i, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < MAX_HG; ++h) {
    if (h >= hg) break;
    float* o = out + (static_cast<long long>(b) * H + h0 + h) * rank;
    const float denom = l_s[h];
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int col = tid + k * nthr;
      if (col < rank) o[col] = __fdiv_rn(acc[h][k], denom);
    }
  }
}

size_t smem_bytes(int rank, int rope) {
  const int dk = rank + rope;
  return sizeof(float) * (static_cast<size_t>(MAX_HG) * dk + 2ull * TILE * tile_ld(dk) +
                          MAX_NW * MAX_HG * TILE + TILE * MAX_HG + 2 * MAX_HG);
}

template <int NCOL>
cudaError_t launch(const float* q_lat, const float* q_rope, const float* c_pool,
                   const float* rope_pool, const int* tables, const int* lengths, float* out,
                   int B, int H, int hg, int rank, int rope, int bs, int W, int Bs, int M,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(rank, rope);
  cudaError_t err = cudaFuncSetAttribute(mla_ctx_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mla_ctx_kernel<NCOL><<<dim3(B, H / hg), 64 * hg, smem, stream>>>(
      q_lat, q_rope, c_pool, rope_pool, tables, lengths, out, H, hg, rank, rope, bs, W, Bs, M,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mla_ctx_launch(const void* q_lat, const void* q_rope, const void* c_pool,
                              const void* rope_pool, const void* tables, const void* lengths,
                              void* out, int B, int H, int hg, int rank, int rope, int bs, int W,
                              int Bs, int M, float scale, void* stream) {
  if (B <= 0 || H <= 0 || hg <= 0 || hg > MAX_HG || H % hg || rank <= 0 || rank % 4 ||
      rank > MAX_RANK || rope <= 0 || rope % 4 || rope > MAX_ROPE || bs <= 0 || bs % TILE ||
      W <= 0 || Bs <= 0 || M <= 0)
    return cudaErrorInvalidValue;
  const auto* ql = static_cast<const float*>(q_lat);
  const auto* qr = static_cast<const float*>(q_rope);
  const auto* cp = static_cast<const float*>(c_pool);
  const auto* rp = static_cast<const float*>(rope_pool);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int nthr = 64 * hg;
  if (rank <= nthr)
    return launch<1>(ql, qr, cp, rp, tb, ln, o, B, H, hg, rank, rope, bs, W, Bs, M, scale, st);
  if (rank <= 2 * nthr)
    return launch<2>(ql, qr, cp, rp, tb, ln, o, B, H, hg, rank, rope, bs, W, Bs, M, scale, st);
  if (rank <= 4 * nthr)
    return launch<4>(ql, qr, cp, rp, tb, ln, o, B, H, hg, rank, rope, bs, W, Bs, M, scale, st);
  if (rank <= 8 * nthr)
    return launch<8>(ql, qr, cp, rp, tb, ln, o, B, H, hg, rank, rope, bs, W, Bs, M, scale, st);
  return cudaErrorInvalidValue;
}
