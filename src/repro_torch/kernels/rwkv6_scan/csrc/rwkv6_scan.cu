// RWKV-6 ("Finch") WKV recurrence written by hand for sm_90a.
//
// Replaces the Pallas TPU kernel rwkv6_scan_fwd (_rwkv_kernel) of
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:80.  Per (b, head), with the
// hd x hd state S carried from S0, in f32:
//     y_t[v]  = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//     S[k][v] = w_t[k] * S[k][v] + k_t[k] * v_t[v]
// returning y and S_last.  This is the sequential form; the TPU kernel's
// chunked direct form is the same function and divides by cumulated decays
// (k / Wincl), which the sequential form never needs.
//
// Bound on this card: bytes.  r, k, v, w and y are B*nH*S*hd floats each,
// touched once; per (b, head, t, channel) the scan does about 3*hd flops
// (an FMA into y, a product and an FMA into S per state element), so at
// hd = 64 about 10 flops per byte, below the f32 ridge of about 20.  The
// least time is the bytes over 3.35 TB/s.
//
// Design:
//   * One block per (b, head): 128 blocks at RWKV-6-7B (B = 2, 64 heads).
//     The state lives in registers: thread (v, q) owns column v of S for the
//     hd/4 rows k = 4j + q, so the four adjacent lanes q = 0..3 split the k
//     sum of y_t[v] and meet with two shuffles (256 threads at hd = 64).
//   * y_t = r_t S + (sum_k r_t[k] u[k] k_t[k]) v_t: the bonus term is one
//     number per token, computed once per token by one warp while staging.
//   * TC = 16 tokens of r, w and k, interleaved per channel as float4
//     [r, w, k, 0] so one 16-byte shared read feeds one state row, and of v
//     are staged in shared memory with coalesced loads; y collects in shared
//     memory and leaves with coalesced stores.  Four partial sums break the
//     FMA chain of y_t[v].
// Double-buffered staging (cp.async) and more blocks per head (splitting v
// across blocks) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TC = 16;   // tokens staged per chunk

template <int HD>
__global__ void __launch_bounds__(4 * HD)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_last, int nH, int S) {
  constexpr int NT = 4 * HD;
  constexpr int KPT = HD / 4;          // state rows per thread
  constexpr int NW = NT / 32;
  __shared__ float4 s_rwk[TC][HD];     // [r, w, k, 0]
  __shared__ float s_v[TC][HD];
  __shared__ float s_y[TC][HD];
  __shared__ float s_a[TC];            // sum_k r u k of each token
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int col = tid >> 2;            // v
  const int q = tid & 3;               // rows k = 4j + q
  const int head = blockIdx.x % nH;
  const long long bh = blockIdx.x;     // b * nH + head
  const long long seq = bh * S * HD;   // (b, head, t = 0, 0)

  float st[KPT];
  const float* s0h = s0 + bh * HD * HD;
#pragma unroll
  for (int j = 0; j < KPT; ++j) st[j] = s0h[(4 * j + q) * HD + col];
  // u of the channels this lane sums in the bonus term
  float ul[(HD + 31) / 32];
#pragma unroll
  for (int i = 0; i < (HD + 31) / 32; ++i) {
    const int kk = lane + 32 * i;
    ul[i] = kk < HD ? u[head * HD + kk] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                   // the previous chunk's y has left s_y
    for (int i = tid; i < tc * HD; i += NT) {
      const long long off = seq + static_cast<long long>(t0) * HD + i;
      const int t = i / HD, kk = i % HD;
      s_rwk[t][kk] = make_float4(r[off], w[off], k[off], 0.f);
      s_v[t][kk] = v[off];
    }
    __syncthreads();
    for (int t = warp; t < tc; t += NW) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < (HD + 31) / 32; ++i) {
        const int kk = lane + 32 * i;
        if (kk < HD) a += s_rwk[t][kk].x * ul[i] * s_rwk[t][kk].z;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) s_a[t] = a;
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const float vv = s_v[t][col];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 e = s_rwk[t][4 * j + q];
        acc[j & 3] = fmaf(e.x, st[j], acc[j & 3]);
        st[j] = fmaf(e.y, st[j], e.z * vv);
      }
      float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (q == 0) s_y[t][col] = fmaf(s_a[t], vv, sum);
    }
    __syncthreads();
    for (int i = tid; i < tc * HD; i += NT)
      y[seq + static_cast<long long>(t0) * HD + i] = s_y[i / HD][i % HD];
  }
  float* slh = s_last + bh * HD * HD;
#pragma unroll
  for (int j = 0; j < KPT; ++j) slh[(4 * j + q) * HD + col] = st[j];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_last, int B, int nH, int S, cudaStream_t stream) {
  rwkv6_scan_kernel<HD><<<B * nH, 4 * HD, 0, stream>>>(r, k, v, w, u, s0, y, s_last, nH, S);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (B, nH, S, hd); u: (nH, hd); s0, s_last: (B, nH, hd, hd);
// all f32, contiguous; hd is 16, 32 or 64.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* y, void* s_last, int B,
                                 int nH, int S, int hd, void* stream) {
  if (B <= 0 || nH <= 0 || S <= 0) return cudaErrorInvalidValue;
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fw = static_cast<const float*>(w);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs = static_cast<const float*>(s0);
  auto* fy = static_cast<float*>(y);
  auto* fl = static_cast<float*>(s_last);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(fr, fk, fv, fw, fu, fs, fy, fl, B, nH, S, st);
    case 32: return launch<32>(fr, fk, fv, fw, fu, fs, fy, fl, B, nH, S, st);
    case 64: return launch<64>(fr, fk, fv, fw, fu, fs, fy, fl, B, nH, S, st);
    default: return cudaErrorInvalidValue;
  }
}
