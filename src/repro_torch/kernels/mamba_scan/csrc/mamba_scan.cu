// Selective scan (Mamba / S6) written by hand for sm_90a.
//
// Replaces the Pallas TPU kernel mamba_scan_fwd (_ms_kernel) of
// src/repro/kernels/mamba_scan/mamba_scan.py:57.  For every (b, d, n), from
// h0 and in f32:
//     h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + dt_t[d] * x_t[d] * B_t[n]
//     y_t[d]    = sum_n h_t[d, n] * C_t[n]
// returning y (B, S, DI) and the last state h_last (B, DI, N).
//
// Bound on this card: bytes.  dt, x and y are B*S*DI floats each, touched
// once; B and C (B*S*N) are shared by every channel.  Per (b, t, d) the scan
// does about 7*N flops (N exponentials among them) over 12 bytes: at N = 16
// about 9 flops per byte, below the f32 ridge of about 20.  The least time is
// the bytes over 3.35 TB/s.
//
// Design:
//   * The recurrence is independent per (b, d, n), so one thread owns one
//     (d, n) state in a register for the whole sequence.  The N states of a
//     channel sit in N adjacent lanes and y_t[d] is their sum by an
//     __shfl_xor_sync butterfly.  A block holds CH = 16 channels (16*N
//     threads, 256 at N = 16) and the grid is (ceil(DI / 16), B): 1,024
//     blocks at Jamba's DI = 8192 and B = 2, enough for 132 SMs where one
//     thread per channel would leave 64 blocks per sequence.
//   * The sequential loop over S stays inside the block.  TC = 64 time steps
//     of dt and x (64 x 16 floats each) and of B and C (64 x N) are staged in
//     shared memory with coalesced loads; y of the chunk collects in shared
//     memory and leaves with coalesced stores.
//   * Channels past DI read dt = 0 and h0 = 0 and store nothing.
// Double-buffered staging (cp.async) and reducing y over several steps per
// shuffle round are later work.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 16;   // channels per block
constexpr int TC = 64;   // time steps staged per chunk

template <int N>
__global__ void __launch_bounds__(CH * N)
    mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ x, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int S, int DI) {
  __shared__ float s_dt[TC][CH];
  __shared__ float s_x[TC][CH];
  __shared__ float s_y[TC][CH];
  __shared__ float s_b[TC][N];
  __shared__ float s_c[TC][N];
  constexpr int NT = CH * N;
  const int tid = threadIdx.x;
  const int c = tid / N;              // channel within the block
  const int n = tid % N;              // state index: lanes of a channel are adjacent
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < DI;
  const long long row0 = static_cast<long long>(b) * S;        // (b, t = 0)
  const long long st = (static_cast<long long>(b) * DI + d) * N + n;
  const float a = live ? A[static_cast<long long>(d) * N + n] : 0.f;
  float h = live ? h0[st] : 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                  // the previous chunk's y has left s_y
    for (int i = tid; i < tc * CH; i += NT) {
      const int t = i / CH, cc = i % CH, dd = d0 + cc;
      const long long off = (row0 + t0 + t) * DI + dd;
      s_dt[t][cc] = dd < DI ? dt[off] : 0.f;
      s_x[t][cc] = dd < DI ? x[off] : 0.f;
    }
    for (int i = tid; i < tc * N; i += NT) {
      const int t = i / N, nn = i % N;
      const long long off = (row0 + t0 + t) * N + nn;
      s_b[t][nn] = Bm[off];
      s_c[t][nn] = Cm[off];
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
      const float dtv = s_dt[t][c];
      const float dA = expf(dtv * a);
      h = dA * h + (dtv * s_x[t][c]) * s_b[t][n];
      float p = h * s_c[t][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) s_y[t][c] = p;
    }
    __syncthreads();
    for (int i = tid; i < tc * CH; i += NT) {
      const int t = i / CH, cc = i % CH, dd = d0 + cc;
      if (dd < DI) y[(row0 + t0 + t) * DI + dd] = s_y[t][cc];
    }
  }
  if (live) h_last[st] = h;
}

template <int N>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm, const float* x,
           const float* h0, float* y, float* h_last, int B, int S, int DI, cudaStream_t stream) {
  const dim3 grid((DI + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, CH * N, 0, stream>>>(dt, A, Bm, Cm, x, h0, y, h_last, S, DI);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y: (B, S, DI); A: (DI, N); Bm, Cm: (B, S, N); h0, h_last: (B, DI, N);
// all f32, contiguous.  N is a power of two up to 32.
extern "C" int mamba_scan_launch(const void* dt, const void* A, const void* Bm, const void* Cm,
                                 const void* x, const void* h0, void* y, void* h_last, int B,
                                 int S, int DI, int N, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0) return cudaErrorInvalidValue;
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_a = static_cast<const float*>(A);
  const auto* f_b = static_cast<const float*>(Bm);
  const auto* f_c = static_cast<const float*>(Cm);
  const auto* f_x = static_cast<const float*>(x);
  const auto* f_h0 = static_cast<const float*>(h0);
  auto* f_y = static_cast<float*>(y);
  auto* f_hl = static_cast<float*>(h_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    case 2: return launch<2>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    case 4: return launch<4>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    case 8: return launch<8>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    case 16: return launch<16>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    case 32: return launch<32>(f_dt, f_a, f_b, f_c, f_x, f_h0, f_y, f_hl, B, S, DI, s);
    default: return cudaErrorInvalidValue;
  }
}
