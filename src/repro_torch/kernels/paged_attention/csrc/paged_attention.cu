// Paged GQA attention over the FPR block tables, written by hand for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention/
// paged_attention.py:
//   paged_decode_kernel<DEPTH>  paged_attention_fused_fwd (:239, depth 1),
//                               paged_attention_fused_pipelined_fwd (:352,
//                               depth 2 and 4) and the split-pool
//                               paged_attention_fwd (:152), through strides
//   ragged_kernel               ragged_fused_fwd (:464)
//
// Bound on this card: bytes.  Each query row of a decode slot (or each
// 8-row ragged tile) reads every visible K/V row of its KV head once and
// does 4*hd flops per key and query head, about G flops per byte in f32,
// far below the H100's ~20 flops per byte.  The least time is the visible
// K/V bytes over 3.35 TB/s.
//
// Design against that bound:
//   * One CTA serves all G query heads of one KV head (grid (B, KV) for
//     decode, (T/QT, KV) for ragged), so each K/V byte crosses HBM once per
//     slot (or tile) and is reused G times (QT*G for ragged) from shared
//     memory.
//   * The page walk reads the slot's row of the (W, Bs, M) shard stack
//     directly (_table_index: (b % W)*Bs*M + (b / W)*M + m) and only issues
//     copies for tiles a query can see: holes (< 0), keys at or past the
//     length and keys outside the sliding window are never read.
//   * Tiles of 32 tokens (one per lane) stream through a DEPTH-deep cp.async
//     ring in shared memory, so tile j+DEPTH is in flight while tile j is
//     consumed.  DEPTH only changes when bytes arrive: the float operations
//     and their order are the same at every depth, so depths 1, 2 and 4 give
//     bit-identical output.  Arithmetic uses explicit fmaf/__fmul_rn/expf so
//     no contraction choice can differ between instantiations.
//   * A warp owns one (query row, head) pair: lane t scores key t of the
//     tile, warp shuffles give the tile max and sum, and the PV product walks
//     the tile's 32 keys with each lane owning hd/32 output columns.  Rows of
//     the K tile are padded by 4 floats so the lane-per-row reads hit 32
//     distinct banks.
//   * Masked keys score NEG_INF = -1e30 (finite) and expf(NEG_INF - m)
//     underflows to exactly 0, as in the reference.
// Later work (tensor-core QK^T/PV, TMA, split-K over long contexts) is not
// done here.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                    // key tokens per ring slot
constexpr int MAX_HD = 128;
constexpr int HD_CHUNKS = MAX_HD / 32;      // output columns per lane
constexpr int QT = 8;                       // ragged query-tile height
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
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
struct HeadPool {
  const float* k;
  const float* v;
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

__device__ __forceinline__ void load_tile(float* dst, const HeadPool& kv, const Walk& w,
                                          int j, int hd) {
  const int hd4 = hd >> 2;
  const int ld = hd + 4;
  const long long blk = w.trow[j / w.tiles_per_blk];
  const int t0 = (j % w.tiles_per_blk) * TILE;
  const int per = TILE * hd4;
  for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
    const int which = i / per;
    const int rem = i - which * per;
    const int tok = rem / hd4;
    const int d4 = rem - tok * hd4;
    const float* src = (which ? kv.v : kv.k) + blk * kv.blk_stride +
                       static_cast<long long>(t0 + tok) * kv.tok_stride + d4 * 4;
    cp_async16(dst + which * TILE * ld + tok * ld + d4 * 4, src);
  }
}

// Attention of QROWS consecutive query rows (positions qpos0 ..) times gc
// query heads against one slot's paged keys.  Row r, head g of q and out
// sits at r * row_stride + g * hd.  Key kpos is visible to row r iff it is
// resident, kpos <= qpos, kpos < kv_len and kpos > qpos - window.
template <int DEPTH, int QROWS>
__device__ __forceinline__ void attend(const float* __restrict__ q, float* __restrict__ out,
                                       long long row_stride, int gc, int hd, float scale,
                                       const HeadPool& kv, const int* __restrict__ trow,
                                       int M, int bs, int qpos0, int kv_len, int window) {
  extern __shared__ __align__(16) float smem[];
  const int hd4 = hd >> 2;
  const int ld = hd + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = warp / gc;
  const int g = warp - r * gc;
  float* qs = smem;                              // (QROWS * gc, hd)
  float* ring = smem + QROWS * gc * hd;          // DEPTH x {K, V} x TILE x ld
  const int slot_elems = 2 * TILE * ld;

  for (int i = threadIdx.x; i < QROWS * gc * hd4; i += blockDim.x) {
    const int vec = i / hd4;
    const int d4 = i - vec * hd4;
    const int rr = vec / gc;
    const int gg = vec - rr * gc;
    reinterpret_cast<float4*>(qs)[i] =
        *reinterpret_cast<const float4*>(q + rr * row_stride + gg * hd + d4 * 4);
  }

  // keys this warp's row may see, and keys any row of the CTA may see
  const int qpos = qpos0 + r;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, kv_len - 1);
  const int cta_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  const int cta_hi = min(qpos0 + QROWS - 1, kv_len - 1);
  const int tpb = bs / TILE;
  const int j0 = cta_lo / TILE;
  const Walk walk{trow, tpb, cta_hi >= cta_lo ? min(cta_hi / TILE + 1, M * tpb) : j0};

  float m_i = NEG_INF;
  float l_i = 0.f;
  float acc[HD_CHUNKS];
#pragma unroll
  for (int c = 0; c < HD_CHUNKS; ++c) acc[c] = 0.f;

  int issue = walk.next(j0);
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    if (issue < walk.j_end) {
      load_tile(ring + s * slot_elems, kv, walk, issue, hd);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }

  int k = 0;
  for (int j = walk.next(j0); j < walk.j_end; j = walk.next(j + 1), ++k) {
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
    const int slot = k % DEPTH;
    const float* kt = ring + slot * slot_elems;
    const float* vt = kt + TILE * ld;
    const int t0 = j * TILE;
    if (max(lo, t0) <= min(hi, t0 + TILE - 1)) {   // warp-uniform: >= 1 visible key
      const int kp = t0 + lane;
      const float4* q4 = reinterpret_cast<const float4*>(qs + warp * hd);
      const float4* k4 = reinterpret_cast<const float4*>(kt + lane * ld);
      float s = 0.f;
      for (int d4 = 0; d4 < hd4; ++d4) {
        const float4 a = q4[d4];
        const float4 b = k4[d4];
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
      s = (kp >= lo && kp <= hi) ? __fmul_rn(s, scale) : NEG_INF;
      const float m_new = fmaxf(m_i, warp_max(s));
      const float p = expf(__fsub_rn(s, m_new));
      const float alpha = expf(__fsub_rn(m_i, m_new));
      l_i = fmaf(l_i, alpha, warp_sum(p));
#pragma unroll
      for (int c = 0; c < HD_CHUNKS; ++c) acc[c] = __fmul_rn(acc[c], alpha);
      for (int t = 0; t < TILE; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const float* vrow = vt + t * ld;
#pragma unroll
        for (int c = 0; c < HD_CHUNKS; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[c] = fmaf(pt, vrow[d], acc[c]);
        }
      }
      m_i = m_new;
    }
    __syncthreads();                               // slot consumed by every warp
    if (issue < walk.j_end) {
      load_tile(ring + slot * slot_elems, kv, walk, issue, hd);
      issue = walk.next(issue + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  const float denom = fmaxf(l_i, 1e-30f);
  float* o = out + r * row_stride + g * hd;
#pragma unroll
  for (int c = 0; c < HD_CHUNKS; ++c) {
    const int d = lane + 32 * c;
    if (d < hd) o[d] = __fdiv_rn(acc[c], denom);
  }
}

__device__ __forceinline__ const int* table_row(const int* tables, int b, int W, int Bs, int M) {
  return tables + static_cast<long long>(b % W) * Bs * M + static_cast<long long>(b / W) * M;
}

// q, out: (B, KV, G, hd).  Grid (B, KV, G / gc), gc * 32 threads.
template <int DEPTH>
__global__ void __launch_bounds__(256)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ kbase,
                    const float* __restrict__ vbase, long long blk_stride,
                    long long tok_stride, long long head_stride,
                    const int* __restrict__ tables, const int* __restrict__ lengths,
                    float* __restrict__ out, int KV, int G, int gc, int hd, int bs, int W,
                    int Bs, int M, int window, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const long long qoff = ((static_cast<long long>(b) * KV + kvh) * G + blockIdx.z * gc) * hd;
  const HeadPool kv{kbase + kvh * head_stride, vbase + kvh * head_stride, blk_stride,
                    tok_stride};
  const int length = lengths[b];
  attend<DEPTH, 1>(q + qoff, out + qoff, 0, gc, hd, scale, kv, table_row(tables, b, W, Bs, M),
                   M, bs, length - 1, length, window);
}

// q, out: (T, KV, G, hd), T = QT * tiles.  Grid (tiles, KV, G / gc),
// QT * gc * 32 threads.  Padding tiles (tile_row < 0) see no key and
// write zeros.
__global__ void __launch_bounds__(1024)
ragged_kernel(const float* __restrict__ q, const float* __restrict__ pool,
              long long blk_stride, long long tok_stride, const int* __restrict__ tables,
              const int* __restrict__ tile_row, const int* __restrict__ tile_pos,
              const int* __restrict__ kv_lens, float* __restrict__ out, int KV, int G, int gc,
              int hd, int bs, int W, int Bs, int M, int window, float scale) {
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int row = tile_row[t];
  const int slot = max(row, 0);
  const long long row_stride = static_cast<long long>(KV) * G * hd;
  const long long qoff = static_cast<long long>(t) * QT * row_stride +
                         (static_cast<long long>(kvh) * G + blockIdx.z * gc) * hd;
  const float* k = pool + 2LL * kvh * hd;
  const HeadPool kv{k, k + hd, blk_stride, tok_stride};
  attend<2, QT>(q + qoff, out + qoff, row_stride, gc, hd, scale, kv,
                table_row(tables, slot, W, Bs, M), M, bs, tile_pos[t],
                row >= 0 ? kv_lens[slot] : 0, window);
}

bool shapes_ok(int hd, int bs, int G, int gc) {
  return hd > 0 && hd % 4 == 0 && hd <= MAX_HD && bs > 0 && bs % TILE == 0 && gc > 0 &&
         G % gc == 0;
}

size_t smem_bytes(int depth, int qrows, int gc, int hd) {
  return sizeof(float) * (static_cast<size_t>(qrows) * gc * hd +
                          static_cast<size_t>(depth) * 2 * TILE * (hd + 4));
}

template <int DEPTH>
int launch_decode(const float* q, const float* kbase, const float* vbase, long long blk_stride,
                  long long tok_stride, long long head_stride, const int* tables,
                  const int* lengths, float* out, int B, int KV, int G, int gc, int hd, int bs,
                  int W, int Bs, int M, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(DEPTH, 1, gc, hd);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<DEPTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_decode_kernel<DEPTH><<<dim3(B, KV, G / gc), gc * 32, smem, stream>>>(
      q, kbase, vbase, blk_stride, tok_stride, head_stride, tables, lengths, out, KV, G, gc, hd,
      bs, W, Bs, M, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(int depth, const void* q, const void* kbase, const void* vbase,
                                   long long blk_stride, long long tok_stride,
                                   long long head_stride, const void* tables,
                                   const void* lengths, void* out, int B, int KV, int G, int gc,
                                   int hd, int bs, int W, int Bs, int M, int window, float scale,
                                   void* stream) {
  if (!shapes_ok(hd, bs, G, gc) || gc * 32 > 256 || B <= 0 || KV <= 0)
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(kbase);
  const auto* vf = static_cast<const float*>(vbase);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1:
      return launch_decode<1>(qf, kf, vf, blk_stride, tok_stride, head_stride, tb, ln, of, B, KV,
                              G, gc, hd, bs, W, Bs, M, window, scale, st);
    case 2:
      return launch_decode<2>(qf, kf, vf, blk_stride, tok_stride, head_stride, tb, ln, of, B, KV,
                              G, gc, hd, bs, W, Bs, M, window, scale, st);
    case 4:
      return launch_decode<4>(qf, kf, vf, blk_stride, tok_stride, head_stride, tb, ln, of, B, KV,
                              G, gc, hd, bs, W, Bs, M, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ragged_launch(const void* q, const void* pool, long long blk_stride,
                             long long tok_stride, const void* tables, const void* tile_row,
                             const void* tile_pos, const void* kv_lens, void* out, int tiles,
                             int KV, int G, int gc, int hd, int bs, int W, int Bs, int M,
                             int window, float scale, void* stream) {
  if (!shapes_ok(hd, bs, G, gc) || QT * gc * 32 > 1024 || tiles <= 0 || KV <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(2, QT, gc, hd);
  cudaError_t err = cudaFuncSetAttribute(ragged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ragged_kernel<<<dim3(tiles, KV, G / gc), QT * gc * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool), blk_stride, tok_stride,
      static_cast<const int*>(tables), static_cast<const int*>(tile_row),
      static_cast<const int*>(tile_pos), static_cast<const int*>(kv_lens),
      static_cast<float*>(out), KV, G, gc, hd, bs, W, Bs, M, window, scale);
  return cudaGetLastError();
}
