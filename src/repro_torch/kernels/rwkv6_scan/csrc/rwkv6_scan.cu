// RWKV-6 ("Finch") WKV recurrence written by hand for sm_90a.
//
// Replaces the Pallas TPU kernel rwkv6_scan_fwd (_rwkv_kernel) of
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:80.  Per (b, head), with the
// hd x hd state S carried from S0, in f32:
//     y_t[v]  = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//     S[k][v] = w_t[k] * S[k][v] + k_t[k] * v_t[v]
// returning y and S_last.
//
// Bound on this card: bytes.  r, k, v, w and y are B*nH*S*hd floats each,
// touched once; the chunked form below does about 5*hd flops per (token,
// channel), so at hd = 64 about 16 flops per byte, below the f32 ridge of
// about 20 (and far below the tensor cores').  The least time is the bytes
// over 3.35 TB/s.
//
// What held the sequential form back: one step per token in a chain of S
// steps (2016 at RWKV-6-7B's chip_smoke.py case), about 1,000 cycles each,
// with one block per (b, head), so 128 blocks on 132 SMs.  The time grew
// with S and not with B*nH (bench.py), and the staging loads took about
// 12% of it.
//
// Design: the TPU kernel's chunked direct form, C = 32 tokens a chunk, so
// the serial chain is ceil(S / 32) chunk steps.  Per chunk and channel d,
// with logw = log w and cum its inclusive cumsum over the chunk:
//     rW = r * exp(cum - logw),  kW = k * exp(-cum),  kT = k * exp(cum_last - cum)
//     y  = rW . S + (mask_strict(rW . kW^T) + diag(sum_d r u k)) . v
//     S <- exp(cum_last) * S + kT^T . v
//   * Grid (hd / VC, nH, B): the value columns of S are independent, so a
//     block owns VC of them (col_split = hd / VC blocks per head; 2 at hd 64
//     gives 256 blocks of 256 threads, two per SM).  Each block recomputes
//     the chunk's 32 x 32 attention, which is cheap.
//   * The four products run on the tensor cores with mma.sync.m16n8k8 in
//     3xTF32 (kernels/csrc/tf32x3.cuh), each warp one or more 16 x 8 tiles:
//     rW . kW^T (32 x 32, K = hd) and rW . S (32 x VC, K = hd), then after
//     one barrier att . v (K = 32) into the same y tiles and kT^T . v (hd x
//     VC, K = 32) into the state.  The state lives in registers as MMA
//     accumulator fragments; it passes through shared memory once a chunk
//     to become the B operand of rW . S (no barrier of its own: the next
//     chunk's first two cover it).  Three barriers a chunk.
//   * A three-slot ring of chunks filled by bulk copies (cp.async.bulk, one
//     instruction a token row, completed on an mbarrier a slot;
//     kernels/csrc/bulk_copy.cuh): chunks j + 1 and j + 2 are in flight while
//     chunk j is used.  The cumsum is a warp shuffle scan with lane = token,
//     each lane a float4 of channels; the transforms overwrite r, k and w in
//     their slot.  log and exp are the MUFU lg2/ex2 (about 2^-22 relative).
//   * Token-major input through strides ((B, S, nH, hd) in ops.py): no
//     transposed or padded copies.  Tokens past S read as zeros (stored
//     directly) with logw = 0, i.e. w = 1, r = k = v = 0, which adds
//     nothing; y is written only for tokens < S.
//   * The division form needs exp(-cum) finite.  A chunk whose smallest
//     cum_last over the head's channels is below -DECAY_LIMIT = -60 (natural
//     log; exp(60) ~ 1.1e26), or is not a number (a w of 0 gives -inf), runs
//     the sequential recurrence inside this kernel instead, token by token
//     from the raw inputs (reloaded from global memory), which is exact for
//     any decay.  The test is over values the block computed itself: no
//     host sync.
// What holds it back: the chunk's four products in 3xTF32 are three
// mma.sync each, in short dependent chains split by barriers, with two
// blocks of 8 warps an SM; the time still grows with the chunk count
// (bench.py).  A clock64 probe build (not kept) put most of a chunk in the
// two MMA phases and the shuffle scan; a producer warp issuing the copies
// did not move it.  wgmma on 64-token chunks is later work.

#include <cuda_runtime.h>

#include "../../csrc/bulk_copy.cuh"
#include "../../csrc/tf32x3.cuh"

// A named namespace, not an anonymous one: a profiler's trace names each
// kernel by its demangled signature, and "(anonymous namespace)::" opens
// with a parenthesis that tools cutting the parameter list cut at.
namespace rwkv6_scan {

using namespace tf32x3;

constexpr int C = 32;           // tokens a chunk
constexpr int NT = 256;         // threads a block
constexpr int NW = NT / 32;
constexpr int DEPTH = 3;        // chunks in the ring
constexpr float DECAY_LIMIT = 60.f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory layout in floats.  Row strides: r and k at hd + 4 (the A
// and B fragment reads of a warp hit 32 banks), w (kT after the transform,
// read transposed) at hd + 8, v and S at VC + 8 (read as B fragments).
template <int HD, int VC>
struct Geo {
  static constexpr int LD4 = HD + 4, LD8 = HD + 8, LDV = VC + 8, LDA = C + 4, LDS = VC + 8;
  static constexpr int K = C * LD4, W = 2 * C * LD4, V = W + C * LD8, SLOT = V + C * LDV;
  static constexpr int ATT = DEPTH * SLOT, SS = ATT + C * LDA, APART = SS + HD * LDS;
  static constexpr int DEC = APART + NW * C, WMIN = DEC + HD;
  static constexpr int BAR = (WMIN + NW + 1) & ~1;  // DEPTH 8-byte ring barriers
  static constexpr int TOTAL = BAR + 2 * DEPTH;
};

// Chunk starting at token t0 into a ring slot, one bulk copy a row: even
// thread 2i copies token i % 32's row of r, k, w (all hd channels) or v
// (columns c0 .. c0 + VC) for array i / 32, so every warp issues 16.  The
// rows of tokens at or past S are zeros, stored directly.
template <int HD, int VC>
__device__ __forceinline__ void load_chunk(float* slot, uint64_t* bar, const float* r,
                                           const float* k, const float* w, const float* v,
                                           int t0, int S, long long sT, int c0) {
  using G = Geo<HD, VC>;
  const int tid = threadIdx.x;
  if (tid & 1) return;
  const int a = (tid >> 1) / C, t = (tid >> 1) % C;
  if (tid == 0) bulk::expect(bar, 4u * min(C, S - t0) * (3 * HD + VC));
  float* dst = slot + (a == 0   ? t * G::LD4
                       : a == 1 ? G::K + t * G::LD4
                       : a == 2 ? G::W + t * G::LD8
                                : G::V + t * G::LDV);
  const int n = a == 3 ? VC : HD;
  if (t0 + t < S) {
    const float* src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v + c0) +
                       static_cast<long long>(t0 + t) * sT;
    bulk::copy(dst, src, 4u * n, bar);
  } else {
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// r, k, v, w: element (b, h, t, d) at b*sB + h*sH + t*sT + d; y likewise
// with yB, yH, yT; u: (nH, HD); s0, s_last: (B, nH, HD, HD).  Grid
// (HD / VC, nH, B), NT threads.
template <int HD, int VC>
__global__ void __launch_bounds__(NT, 2)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_last, int nH, int S,
                      long long sB, long long sH, long long sT, long long yB, long long yH,
                      long long yT) {
  using G = Geo<HD, VC>;
  constexpr int Q = HD / 4;
  constexpr int QPW = (Q + NW - 1) / NW;          // channel quads a warp transforms
  constexpr int YNT = VC / 8, YT = 2 * YNT;       // y tiles: 2 x YNT of 16 x 8
  constexpr int YPW = (YT + NW - 1) / NW;
  constexpr int SNT = VC / 8, ST = (HD / 16) * SNT;  // state tiles
  constexpr int SPW = (ST + NW - 1) / NW;
  extern __shared__ __align__(16) float sm[];
  float* att_s = sm + G::ATT;
  float* S_s = sm + G::SS;
  float* apart = sm + G::APART;
  float* dec = sm + G::DEC;
  float* wmin = sm + G::WMIN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BAR);   // one a ring slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int c0 = blockIdx.x * VC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * nH + h;
  const long long in0 = b * sB + h * sH;
  const float* rb = r + in0;
  const float* kb = k + in0;
  const float* wb = w + in0;
  const float* vb = v + in0;
  float* yb = y + b * yB + h * yH;
  const int nC = (S + C - 1) / C;

  if (tid == 0)
    for (int d = 0; d < DEPTH; ++d) bulk::init(bars + d);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DEPTH - 1; ++d)
    if (d < nC) load_chunk<HD, VC>(sm + d * G::SLOT, bars + d, rb, kb, wb, vb, d * C, S, sT, c0);

  float4 uq[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int q = warp + NW * i;
    uq[i] = q < Q ? reinterpret_cast<const float4*>(u + h * HD)[q] : make_float4(0, 0, 0, 0);
  }
  const float* s0h = s0 + bh * HD * HD;
  for (int i = tid; i < HD * VC / 4; i += NT) {
    const int d = i / (VC / 4);
    const int c4 = i - d * (VC / 4);
    *reinterpret_cast<float4*>(S_s + d * G::LDS + 4 * c4) =
        *reinterpret_cast<const float4*>(s0h + d * HD + c0 + 4 * c4);
  }
  __syncthreads();
  // the state's accumulator fragments: tile i = warp + NW * jj, rows
  // (channels) 16 * (i / SNT), columns 8 * (i % SNT)
  float sacc[SPW][4];
  auto load_state = [&]() {
#pragma unroll
    for (int jj = 0; jj < SPW; ++jj) {
      const int i = warp + NW * jj;
      if (i >= ST) break;
      const float* p = S_s + ((i / SNT) * 16 + gq) * G::LDS + (i % SNT) * 8 + 2 * tq;
      sacc[jj][0] = p[0];
      sacc[jj][1] = p[1];
      sacc[jj][2] = p[8 * G::LDS];
      sacc[jj][3] = p[8 * G::LDS + 1];
    }
  };
  load_state();

  for (int j = 0; j < nC; ++j) {
    bulk::wait(bars + j % DEPTH, (j / DEPTH) & 1);
    __syncthreads();                               // (0) chunk j landed; j - 1 done
    {
      const int jn = j + DEPTH - 1;
      if (jn < nC)
        load_chunk<HD, VC>(sm + (jn % DEPTH) * G::SLOT, bars + jn % DEPTH, rb, kb, wb, vb,
                           jn * C, S, sT, c0);
    }
    float* rs = sm + (j % DEPTH) * G::SLOT;
    float* ks = rs + G::K;
    float* ws = rs + G::W;
    const float* vs = rs + G::V;
    const int t0 = j * C;

    // (A) lane = token: logw, the cumsum by a shuffle scan, the transforms
    // in place, the bonus sum_d r u k, exp(cum_last) and min cum_last
    {
      float ap = 0.f;
      float mn = __int_as_float(0x7f800000);     // +inf
      const bool live = t0 + lane < S;
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const int q = warp + NW * i;
        if (q >= Q) break;
        float4* r4 = reinterpret_cast<float4*>(rs + lane * G::LD4) + q;
        float4* k4 = reinterpret_cast<float4*>(ks + lane * G::LD4) + q;
        float4* w4 = reinterpret_cast<float4*>(ws + lane * G::LD8) + q;
        const float4 rv = *r4, kv = *k4, wv = *w4;
        float lw[4] = {live ? lg2(wv.x) : 0.f, live ? lg2(wv.y) : 0.f,
                       live ? lg2(wv.z) : 0.f, live ? lg2(wv.w) : 0.f};
        float cum[4] = {lw[0], lw[1], lw[2], lw[3]};
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float n = __shfl_up_sync(0xffffffffu, cum[c], o);
            if (lane >= o) cum[c] = __fadd_rn(cum[c], n);
          }
        }
        float last[4], el[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          last[c] = __shfl_sync(0xffffffffu, cum[c], 31);
          el[c] = lane == 31 ? ex2(last[c]) : 0.f;
          el[c] = __shfl_sync(0xffffffffu, el[c], 31);
        }
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
        const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
        const float uu[4] = {uq[i].x, uq[i].y, uq[i].z, uq[i].w};
        float rw[4], kw[4], kt[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ap = fmaf(__fmul_rn(rr[c], uu[c]), kk[c], ap);
          rw[c] = __fmul_rn(rr[c], ex2(__fsub_rn(cum[c], lw[c])));
          kw[c] = __fmul_rn(kk[c], ex2(-cum[c]));
          kt[c] = __fmul_rn(kw[c], el[c]);
          mn = fminf(mn, last[c]);
        }
        *r4 = make_float4(rw[0], rw[1], rw[2], rw[3]);
        *k4 = make_float4(kw[0], kw[1], kw[2], kw[3]);
        *w4 = make_float4(kt[0], kt[1], kt[2], kt[3]);
        if (lane == 0) *reinterpret_cast<float4*>(dec + 4 * q) = make_float4(el[0], el[1], el[2], el[3]);
        // a NaN cum_last must reach the test below: fminf drops NaNs
        if (!(last[0] == last[0] && last[1] == last[1] && last[2] == last[2] &&
              last[3] == last[3]))
          mn = __int_as_float(0xff800000);       // -inf
      }
      apart[warp * C + lane] = ap;
      if (lane == 0) wmin[warp] = mn;
    }
    __syncthreads();                               // (1)
    float mn = wmin[0];
#pragma unroll
    for (int i = 1; i < NW; ++i) mn = fminf(mn, wmin[i]);
    // cum is in log2 units: the fast path needs cum_last >= -DECAY_LIMIT / ln 2
    if (mn >= -DECAY_LIMIT * LOG2E) {
      // (B) att = mask(rW . kW^T) + diag(a): warp = (rows 16 * (warp / 4),
      // keys 8 * (warp % 4)); y = rW . S over the warp's y tiles
      const int amt = warp >> 2, ant = warp & 3;
      float acc_a[2][4] = {};
      float yacc[YPW][2][4] = {};
#pragma unroll
      for (int x = 0; x < HD / 8; ++x) {
        const float* ra = rs + (amt * 16 + gq) * G::LD4 + x * 8 + tq;
        Frag3 a;
        a.set({ra[0], ra[8 * G::LD4], ra[4], ra[8 * G::LD4 + 4]});
        const float* kr = ks + (ant * 8 + gq) * G::LD4 + x * 8 + tq;
        FragB3 bk;
        bk.set(kr[0], kr[4]);
        mma3(acc_a[x & 1], a, bk);
#pragma unroll
        for (int jj = 0; jj < YPW; ++jj) {
          const int i = warp + NW * jj;
          if (i >= YT) break;
          const float* ry = rs + ((i / YNT) * 16 + gq) * G::LD4 + x * 8 + tq;
          Frag3 ay;
          ay.set({ry[0], ry[8 * G::LD4], ry[4], ry[8 * G::LD4 + 4]});
          const float* sb = S_s + (x * 8 + tq) * G::LDS + (i % YNT) * 8 + gq;
          FragB3 bs;
          bs.set(sb[0], sb[4 * G::LDS]);
          mma3(yacc[jj][x & 1], ay, bs);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = amt * 16 + gq + 8 * (e >> 1);
        const int s = ant * 8 + 2 * tq + (e & 1);
        float val = 0.f;
        if (s < t) {
          val = __fadd_rn(acc_a[0][e], acc_a[1][e]);
        } else if (s == t) {
          for (int i = 0; i < NW; ++i) val = __fadd_rn(val, apart[i * C + t]);
        }
        att_s[t * G::LDA + s] = val;
      }
      __syncthreads();                             // (2)

      // (C) y += att . v, stored token-major; S = exp(cum_last) S + kT^T . v
#pragma unroll
      for (int jj = 0; jj < YPW; ++jj) {
        const int i = warp + NW * jj;
        if (i >= YT) break;
        const int ymt = i / YNT, ynt = i % YNT;
#pragma unroll
        for (int x = 0; x < C / 8; ++x) {
          const float* pa = att_s + (ymt * 16 + gq) * G::LDA + x * 8 + tq;
          Frag3 a;
          a.set({pa[0], pa[8 * G::LDA], pa[4], pa[8 * G::LDA + 4]});
          const float* pv = vs + (x * 8 + tq) * G::LDV + ynt * 8 + gq;
          FragB3 bv;
          bv.set(pv[0], pv[4 * G::LDV]);
          mma3(yacc[jj][x & 1], a, bv);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + ymt * 16 + gq + 8 * hh;
          if (t < S)
            *reinterpret_cast<float2*>(yb + t * yT + c0 + ynt * 8 + 2 * tq) =
                make_float2(__fadd_rn(yacc[jj][0][2 * hh], yacc[jj][1][2 * hh]),
                            __fadd_rn(yacc[jj][0][2 * hh + 1], yacc[jj][1][2 * hh + 1]));
        }
      }
#pragma unroll
      for (int jj = 0; jj < SPW; ++jj) {
        const int i = warp + NW * jj;
        if (i >= ST) break;
        const int smt = i / SNT, snt = i % SNT;
        float kv[2][4] = {};
#pragma unroll
        for (int x = 0; x < C / 8; ++x) {
          const float* pk = ws + (x * 8 + tq) * G::LD8 + smt * 16 + gq;
          Frag3 a;
          a.set({pk[0], pk[8], pk[4 * G::LD8], pk[4 * G::LD8 + 8]});
          const float* pv = vs + (x * 8 + tq) * G::LDV + snt * 8 + gq;
          FragB3 bv;
          bv.set(pv[0], pv[4 * G::LDV]);
          mma3(kv[x & 1], a, bv);
        }
        const float d0 = dec[smt * 16 + gq], d1 = dec[smt * 16 + gq + 8];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[jj][e] = fmaf(e < 2 ? d0 : d1, sacc[jj][e], __fadd_rn(kv[0][e], kv[1][e]));
        float* p = S_s + (smt * 16 + gq) * G::LDS + snt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p) = make_float2(sacc[jj][0], sacc[jj][1]);
        *reinterpret_cast<float2*>(p + 8 * G::LDS) = make_float2(sacc[jj][2], sacc[jj][3]);
      }
    } else {
      // slow path: the raw chunk back into the slot (the transforms
      // overwrote r, k and w), then the recurrence token by token.  Thread
      // (column col, group g) owns rows g, g + GS, ...; the GS groups of a
      // column are neighbouring lanes and sum y by shuffles.
      constexpr int GS = NT / VC < HD ? NT / VC : HD;
      constexpr int RPT = HD / GS;
      for (int i = tid; i < C * 3 * Q; i += NT) {
        const int t = i / (3 * Q);
        const int e = i - t * 3 * Q;
        if (t0 + t >= S) continue;
        const long long off = static_cast<long long>(t0 + t) * sT;
        const int m = e / Q, d4 = e - m * Q;
        const float* src = (m == 0 ? rb : m == 1 ? kb : wb) + off + 4 * d4;
        float* dst = m == 0 ? rs + t * G::LD4 : m == 1 ? ks + t * G::LD4 : ws + t * G::LD8;
        *reinterpret_cast<float4*>(dst + 4 * d4) = *reinterpret_cast<const float4*>(src);
      }
      __syncthreads();
      const int col = tid / GS, g = tid % GS;
      const bool own = col < VC;
      float st[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) st[i] = own ? S_s[(g + GS * i) * G::LDS + col] : 0.f;
      const int tc = min(C, S - t0);
      for (int t = 0; t < tc; ++t) {
        const float vv = own ? vs[t * G::LDV + col] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int d = g + GS * i;
          acc = fmaf(rs[t * G::LD4 + d], st[i], acc);
          st[i] = fmaf(ws[t * G::LD8 + d], st[i], __fmul_rn(ks[t * G::LD4 + d], vv));
        }
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
        if (own && g == 0) {
          float a = 0.f;
          for (int i = 0; i < NW; ++i) a = __fadd_rn(a, apart[i * C + t]);
          yb[(t0 + t) * yT + c0 + col] = fmaf(a, vv, acc);
        }
      }
      if (own)
#pragma unroll
        for (int i = 0; i < RPT; ++i) S_s[(g + GS * i) * G::LDS + col] = st[i];
      __syncthreads();
      load_state();
    }
  }

  float* slh = s_last + bh * HD * HD + c0;
#pragma unroll
  for (int jj = 0; jj < SPW; ++jj) {
    const int i = warp + NW * jj;
    if (i >= ST) break;
    float* p = slh + ((i / SNT) * 16 + gq) * HD + (i % SNT) * 8 + 2 * tq;
    *reinterpret_cast<float2*>(p) = make_float2(sacc[jj][0], sacc[jj][1]);
    *reinterpret_cast<float2*>(p + 8 * HD) = make_float2(sacc[jj][2], sacc[jj][3]);
  }
}

template <int HD, int VC>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_last, int B, int nH, int S, long long sB,
           long long sH, long long sT, long long yB, long long yH, long long yT,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Geo<HD, VC>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<HD, VC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rwkv6_scan_kernel<HD, VC><<<dim3(HD / VC, nH, B), NT, smem, stream>>>(
      r, k, v, w, u, s0, y, s_last, nH, S, sB, sH, sT, yB, yH, yT);
  return cudaGetLastError();
}

}  // namespace rwkv6_scan

using namespace rwkv6_scan;

// r, k, v, w: element (b, h, t, d) at b*sB + h*sH + t*sT + d (16-byte
// aligned rows: every stride a multiple of 4); y: likewise with yB, yH,
// yT; u: (nH, hd); s0, s_last: (B, nH, hd, hd) contiguous; all f32.  hd is
// 16, 32 or 64; col_split (blocks per head) divides hd / 8.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* y, void* s_last, int B,
                                 int nH, int S, int hd, int col_split, long long sB,
                                 long long sH, long long sT, long long yB, long long yH,
                                 long long yT, void* stream) {
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
#define RWKV6_LAUNCH(HD, VC)                                                                   \
  return launch<HD, VC>(fr, fk, fv, fw, fu, fs, fy, fl, B, nH, S, sB, sH, sT, yB, yH, yT, st)
  switch (hd * 8 + col_split) {
    case 16 * 8 + 1: RWKV6_LAUNCH(16, 16);
    case 16 * 8 + 2: RWKV6_LAUNCH(16, 8);
    case 32 * 8 + 1: RWKV6_LAUNCH(32, 32);
    case 32 * 8 + 2: RWKV6_LAUNCH(32, 16);
    case 32 * 8 + 4: RWKV6_LAUNCH(32, 8);
    case 64 * 8 + 1: RWKV6_LAUNCH(64, 64);
    case 64 * 8 + 2: RWKV6_LAUNCH(64, 32);
    case 64 * 8 + 4: RWKV6_LAUNCH(64, 16);
    default: return cudaErrorInvalidValue;
  }
#undef RWKV6_LAUNCH
}
