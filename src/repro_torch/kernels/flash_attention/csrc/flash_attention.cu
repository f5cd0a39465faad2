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
// 4*hd flops (QK^T and PV) while each byte of Q, K, V and O crosses HBM once:
// at Jamba's S = 4096, hd = 128 that is hundreds of flops per byte, far
// above the f32 ridge of about 20.  The least time is the visible pairs'
// flops over the f32 CUDA-core peak (no tensor cores here).
//
// Design:
//   * Grid (Sq / 64, H, B): one block per 64-row query tile of one head,
//     walking its visible 64-key tiles with the running max, sum and output
//     in registers.  Tiles fully masked by causality, the window or sk_valid
//     are never loaded; causal tiles run heaviest first.
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows
//     ty + 16i and keys tx + 16j (i, j < 4) of the 64 x 64 score tile, so
//     the 16 threads of a row sit in one half-warp and reduce the row's max
//     and sum with four shuffles.  Q and K rows are padded to hd + 4 floats,
//     so the float4 reads of 8 consecutive key rows hit distinct banks;
//     every 8 float4 reads feed 64 FMAs.
//   * P goes through shared memory transposed, each thread's four rows
//     contiguous (one float4 read per key in PV); thread (ty, tx) owns
//     output columns 4tx..4tx+3 and 64+4tx..64+4tx+3 of its four rows.
//   * Q, K and V tiles are loaded with coalesced 16-byte reads; rows past
//     the buffers read zeros.  115 KiB of dynamic shared memory, one block
//     per SM.
// Tensor cores (TF32 with a 3xTF32 split to keep f32 accuracy, or bf16
// wgmma), TMA and a cp.async ring over K/V tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int MAX_HD = 128;
constexpr int LDQ = MAX_HD + 4;   // padded Q and K rows
constexpr int LDV = MAX_HD;
constexpr int LDP = BQ + 4;       // P^T rows
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * LDQ + BK * LDQ + BK * LDV + BK * LDP);

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a (rows, hd) matrix into shared rows of ld
// floats; rows at or past n_rows read zeros
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int row0, int n_rows, int hd) {
  const int hd4 = hd >> 2;
  for (int i = threadIdx.x; i < 64 * hd4; i += NT) {
    const int r = i / hd4, c4 = i - r * hd4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * hd) + c4);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c4) = val;
  }
}

__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int H, int KV,
                     int Sq, int Sk, int hd, int sk_valid, int q_offset, int causal, int window,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDQ;
  float* sP = sV + BK * LDV;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qh = (static_cast<long long>(b) * H + h) * Sq * hd;
  const long long kh = (static_cast<long long>(b) * KV + kvh) * Sk * hd;
  const int q0 = qi * BQ;                       // first row of the tile
  const int pos0 = q0 + q_offset;               // its position

  // the keys any row of the tile can see: [k_lo, k_hi)
  int k_hi = min(Sk, sk_valid);
  if (causal) k_hi = min(k_hi, pos0 + BQ);
  int k_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  load_rows(sQ, LDQ, q + qh, q0, Sq, hd);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const int hd4 = hd >> 2;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();                            // the last tile's K, V, P are used
    load_rows(sK, LDQ, k + kh, k0, Sk, hd);
    load_rows(sV, LDV, v + kh, k0, Sk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c4 = 0; c4 < hd4; ++c4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LDQ + 4 * c4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDQ + 4 * c4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = pos0 + ty + 16 * i;
      float mx = NEG_INF;
      bool vis[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        vis[j] = kp < sk_valid && (!causal || kp <= qp) && (window == 0 || qp - kp < window);
        s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked keys weigh exactly 0, also before the row has seen a key
        s[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tx + 16 * j) * LDP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sP + kk * LDP + 4 * ty);
      const float4 v0 = *reinterpret_cast<const float4*>(sV + kk * LDV + 4 * tx);
      const float4 v1 = *reinterpret_cast<const float4*>(sV + kk * LDV + 64 + 4 * tx);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(pr[i], v0.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], v0.y, acc[i][1]);
        acc[i][2] = fmaf(pr[i], v0.z, acc[i][2]);
        acc[i][3] = fmaf(pr[i], v0.w, acc[i][3]);
        acc[i][4] = fmaf(pr[i], v1.x, acc[i][4]);
        acc[i][5] = fmaf(pr[i], v1.y, acc[i][5]);
        acc[i][6] = fmaf(pr[i], v1.z, acc[i][6]);
        acc[i][7] = fmaf(pr[i], v1.w, acc[i][7]);
      }
    }
  }

  // columns 64.. of sV past hd were never written; their accumulators are
  // never stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + qh + static_cast<long long>(row) * hd;
    if (4 * tx < hd)
      *reinterpret_cast<float4*>(o + 4 * tx) = make_float4(
          acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    if (64 + 4 * tx < hd)
      *reinterpret_cast<float4*>(o + 64 + 4 * tx) = make_float4(
          acc[i][4] / den, acc[i][5] / den, acc[i][6] / den, acc[i][7] / den);
  }
}

}  // namespace

// q, out: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); f32, contiguous; hd a
// multiple of 4 up to 128; H a multiple of KV; sk_valid <= Sk; window 0 =
// none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int Sq, int Sk, int hd,
                                      int sk_valid, int q_offset, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KV <= 0 || H % KV || Sq <= 0 ||
      Sk < 0 || hd <= 0 || hd % 4 || hd > MAX_HD || sk_valid > Sk || window < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, KV, Sq, Sk, hd, sk_valid, q_offset, causal, window, scale);
  return cudaGetLastError();
}
