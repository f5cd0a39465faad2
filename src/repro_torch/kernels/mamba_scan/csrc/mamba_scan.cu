// Selective scan (Mamba / S6) written by hand for sm_90a.
//
// Replaces the Pallas TPU kernel mamba_scan_fwd (_ms_kernel) of
// src/repro/kernels/mamba_scan/mamba_scan.py:57.  For every (b, d, n), from
// h0 and in f32:
//     h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + dt_t[d] * x_t[d] * B_t[n]
//     y_t[d]    = sum_n h_t[d, n] * C_t[n]
// returning y (B, S, DI) and the last state h_last (B, DI, N).
//
// Bound on this card: two floors.  Bytes: dt, x and y are B*S*DI floats
// each, touched once, and B, C (B*S*N) are shared by every channel, so at
// Jamba's widths (B 2, S 2000, DI 8192, N 16) the bytes take 0.118 ms at
// 3.35 TB/s.  Exponentials: B*S*DI*N = 5.2e8 of them, one MUFU ex2 each;
// the SFUs run 16 a clock on each SM, so at 1.98 GHz on 132 SMs they take
// 0.125 ms.  The other arithmetic is four FP32 operations per state and
// step.
//
// Step 0 (the previous kernel: one thread per (d, n) state, a shuffle butterfly
// per step for y, 64-step chunks staged between barriers; bench.py on an
// H100 SXM at 700 W): the time was linear in S (0.44 us a step) and grew
// with B * DI (0.49, 0.88, 3.08 ms at B 1, 2, 8, S 2000): the card was
// full and instruction throughput set the time, not the serial chain.
// Probe builds took 12% off without the shuffles, 11% without expf and 38%
// without both: every state-step paid for a channel's shared loads,
// shuffles and stores, 16 threads over.  The op's padding and contiguous
// copies added 0.31 ms.
//
// Design:
//   * One thread owns one channel d of one batch row and its N states in
//     registers, with A[d, :] * log2(e).  y_t[d] is a sum inside the
//     thread (four partial sums): no shuffles, and a warp stores 32
//     consecutive channels of y_t with one coalesced 128-byte store.  The
//     N state updates are independent, so a thread has N-fold parallel
//     work per step; each exponential is one ex2.approx (MUFU).
//   * A block is one warp of CH = 32 channels (grid ceil(DI / 32) x B: 512
//     warps at Jamba's widths, about 4 an SM).  Its inputs stream through
//     a ring of STAGES = 3 shared-memory stages of TC = 32 time steps:
//     dt and x (TC x 32 floats, coalesced across channels) and B and C (TC
//     x N, read back as broadcasts), filled by cp.async two chunks ahead
//     of the one being scanned.  16-byte copies where rows and pointers
//     are 16-byte aligned, else 4-byte copies.
//   * dt, x, B and C are read through their (batch, token) strides (last
//     stride 1), so B and C may be column views of the x_proj output and
//     no padding or copy is needed: the kernel stops at S itself.
//   * Channels past DI read dt = x = 0 and store nothing.
// Measured (bench.py, same card): about 0.16 us a step at any S, and the
// same time at B 1 and B 2: each SM sub-partition runs one warp, whose
// per-step stream of about 65 FP32 operations, 16 ex2 and 10 shared loads
// sets the time.  Tried and not kept: evaluating half of the exponentials
// as a polynomial on the FMA pipe (slower: the FP32 work grew), two
// threads per channel with one shuffle (no faster), unrolling the step
// loop by 1, 2 or 8 instead of 4 (1 slower, the others equal).  Left:
// about 2.6x above the ex2 floor.
#include <cuda_runtime.h>
#include <stdint.h>

// A named namespace, not an anonymous one: a profiler's trace names each
// kernel by its demangled signature, and "(anonymous namespace)::" opens
// with a parenthesis that tools cutting the parameter list cut at.
namespace mamba_scan {

constexpr int TC = 32;       // time steps per ring stage
constexpr int STAGES = 3;    // ring stages
constexpr float LOG2E = 1.4426950408889634f;

constexpr int CH = 32;       // channels per block: one warp, a channel a thread

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

struct Args {
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* x;
  const float* h0;
  float* y;
  float* h_last;
  long long dt_b, dt_t, x_b, x_t, b_b, b_t, c_b, c_t;   // (batch, token) strides
  int S, DI;
  int vec_dx, vec_bc;    // 16-byte copies allowed for dt/x, for B/C
};

// A ring stage: s_dt[TC][CH], s_x[TC][CH], s_b[TC][N], s_c[TC][N].
template <int N>
constexpr int STAGE_FLOATS = 2 * TC * CH + 2 * TC * N;

// Issue the copies of chunk t0 (tc steps) into stage st.  Rows past tc are
// left as they are (never read); channels past DI are zeroed.
template <int N>
__device__ __forceinline__ void load_chunk(const Args& a, float* st, int b, int d0, int t0,
                                           int tc) {
  const int lane = threadIdx.x;
  float* s_dt = st;
  float* s_x = s_dt + TC * CH;
  float* s_b = s_x + TC * CH;
  float* s_c = s_b + TC * N;
  const float* dt = a.dt + b * a.dt_b + t0 * a.dt_t + d0;
  const float* x = a.x + b * a.x_b + t0 * a.x_t + d0;
  if (a.vec_dx) {
    // 8 lanes a row of 32 channels, 4 rows an instruction
    const int c4 = (lane & 7) * 4, r0 = lane >> 3;
    const bool in = d0 + c4 < a.DI;     // DI % 4 == 0 here
    for (int t = r0; t < tc; t += 4) {
      if (in) {
        cp_async16(s_dt + t * CH + c4, dt + t * a.dt_t + c4);
        cp_async16(s_x + t * CH + c4, x + t * a.x_t + c4);
      } else {
        *reinterpret_cast<float4*>(s_dt + t * CH + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(s_x + t * CH + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const bool in = d0 + lane < a.DI;
    for (int t = 0; t < tc; ++t) {
      if (in) {
        cp_async4(s_dt + t * CH + lane, dt + t * a.dt_t + lane);
        cp_async4(s_x + t * CH + lane, x + t * a.x_t + lane);
      } else {
        s_dt[t * CH + lane] = 0.f;
        s_x[t * CH + lane] = 0.f;
      }
    }
  }
  const float* Bm = a.Bm + b * a.b_b + t0 * a.b_t;
  const float* Cm = a.Cm + b * a.c_b + t0 * a.c_t;
  if constexpr (N % 4 == 0) {
    if (a.vec_bc) {
      constexpr int Q = N / 4;          // 16-byte pieces a row
      for (int i = lane; i < tc * Q; i += 32) {
        const int t = i / Q, c = (i % Q) * 4;
        cp_async16(s_b + t * N + c, Bm + t * a.b_t + c);
        cp_async16(s_c + t * N + c, Cm + t * a.c_t + c);
      }
      return;
    }
  }
  for (int i = lane; i < tc * N; i += 32) {
    const int t = i / N, n = i % N;
    cp_async4(s_b + t * N + n, Bm + t * a.b_t + n);
    cp_async4(s_c + t * N + n, Cm + t * a.c_t + n);
  }
}

template <int N>
__global__ void __launch_bounds__(CH) mamba_scan_kernel(const Args a) {
  constexpr int SF = STAGE_FLOATS<N>;
  constexpr int YS = N < 4 ? N : 4;    // partial sums of y
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + lane;
  const bool live = d < a.DI;
  const int S = a.S;
  const int nchunk = (S + TC - 1) / TC;

  // the first STAGES - 1 chunks in flight before the state is read
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunk) load_chunk<N>(a, smem + s * SF, b, d0, s * TC, min(TC, S - s * TC));
    cp_commit();
  }

  float h[N], a2[N];
  const long long st = (static_cast<long long>(b) * a.DI + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? a.h0[st + n] : 0.f;
    a2[n] = live ? a.A[static_cast<long long>(d) * N + n] * LOG2E : 0.f;
  }
  float* yp = a.y + (static_cast<long long>(b) * S) * a.DI + d;

  for (int c = 0; c < nchunk; ++c) {
    cp_wait<STAGES - 2>();             // chunk c's copies (this thread's) landed
    __syncthreads();                   // ... and every lane's; chunk c - 1 is read
    {
      const int cn = c + STAGES - 1;   // refill the stage chunk c - 1 used
      if (cn < nchunk)
        load_chunk<N>(a, smem + (cn % STAGES) * SF, b, d0, cn * TC, min(TC, S - cn * TC));
      cp_commit();
    }
    const float* s_dt = smem + (c % STAGES) * SF;
    const float* s_x = s_dt + TC * CH;
    const float* s_b = s_x + TC * CH;
    const float* s_c = s_b + TC * N;
    const int t0 = c * TC;
    const int tc = min(TC, S - t0);
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
      const float dtv = s_dt[t * CH + lane];
      const float dtx = dtv * s_x[t * CH + lane];
      float bv[N], cv[N];
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 bb = *reinterpret_cast<const float4*>(s_b + t * N + n);
          const float4 cc = *reinterpret_cast<const float4*>(s_c + t * N + n);
          bv[n] = bb.x, bv[n + 1] = bb.y, bv[n + 2] = bb.z, bv[n + 3] = bb.w;
          cv[n] = cc.x, cv[n + 1] = cc.y, cv[n + 2] = cc.z, cv[n + 3] = cc.w;
        }
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) bv[n] = s_b[t * N + n], cv[n] = s_c[t * N + n];
      }
      float ys[YS];
#pragma unroll
      for (int i = 0; i < YS; ++i) ys[i] = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(ex2(dtv * a2[n]), h[n], dtx * bv[n]);
        ys[n % YS] = fmaf(h[n], cv[n], ys[n % YS]);
      }
      float yv = ys[0];
#pragma unroll
      for (int i = 1; i < YS; ++i) yv += ys[i];
      if (live) yp[static_cast<long long>(t0 + t) * a.DI] = yv;
    }
  }
  cp_wait<0>();
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.h_last[st + n] = h[n];
  }
}

template <int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  // at most 48 KiB (N = 32): no opt-in needed
  const size_t smem = sizeof(float) * STAGES * STAGE_FLOATS<N>;
  const dim3 grid((a.DI + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, CH, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mamba_scan

using namespace mamba_scan;

// dt, x: (B, S, DI) and Bm, Cm: (B, S, N), read through their (batch,
// token) strides in floats (last stride 1); A: (DI, N), h0, h_last:
// (B, DI, N) and y: (B, S, DI) contiguous; all f32.  N is a power of two up
// to 32.  vec_dx / vec_bc allow 16-byte copies of dt and x / B and C (the
// caller checks pointers and strides for 16-byte alignment).
extern "C" int mamba_scan_launch(const void* dt, const void* A, const void* Bm, const void* Cm,
                                 const void* x, const void* h0, void* y, void* h_last, int B,
                                 int S, int DI, int N, long long dt_b, long long dt_t,
                                 long long x_b, long long x_t, long long b_b, long long b_t,
                                 long long c_b, long long c_t, int vec_dx, int vec_bc,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0) return cudaErrorInvalidValue;
  if (vec_dx && DI % 4) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(Bm), static_cast<const float*>(Cm),
         static_cast<const float*>(x),  static_cast<const float*>(h0),
         static_cast<float*>(y),        static_cast<float*>(h_last),
         dt_b, dt_t, x_b, x_t, b_b, b_t, c_b, c_t, S, DI, vec_dx, vec_bc};
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    case 32: return launch<32>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
