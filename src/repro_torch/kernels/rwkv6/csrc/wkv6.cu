// WKV6 chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py::wkv6 (body _kernel)
// and computes the same function: per (b, h), walk the sequence in chunks of
// L tokens carrying a K x V f32 state S (V = K) that starts at zero.  Inside
// a chunk, with cum the inclusive cumulative sum of log_w and cum_ex = cum -
// log_w (the exclusive one):
//   att[t, s] = sum_k r[t,k] k[s,k] exp(min(cum_ex[t,k] - cum[s,k], 0))  (s < t)
//   y[t]      = sum_{s<t} att[t,s] v[s] + (sum_k r[t,k] u[k] k[t,k]) v[t]
//               + (r[t] * exp(cum_ex[t])) @ S
//   S'        = exp(cum[L-1]) * S + (k * exp(cum[L-1] - cum))^T v
// Inputs r, k, v in bf16 or f32, log_w and u in f32; all arithmetic in f32;
// y in r's dtype, the final state in f32.
//
// Design.  Only the state has to be carried from chunk to chunk; everything
// else in a chunk depends on that chunk's inputs alone, and column j of S
// depends on column j of v alone.  So wkv6_fwd launches two kernels back to
// back on one stream, with f32 scratch in device memory between them:
//   wkv6_intra_kernel, one block of 128 threads per (b, h, chunk): stages r,
//     k and log_w, forms the compensated cumulative sums, and writes att
//     (L x L, the bonus on the diagonal, zeros above it), rd = r exp(cum_ex),
//     kd = k exp(cum_L - cum) (L x K each) and dec = exp(cum_L) (K).  Each
//     thread owns a whole 2 x 2 block of att below the diagonal, so every
//     float4 of cum, r and k that it reads from shared memory serves two
//     exponentials and no sum ends in a shuffle.  The rest of the lower
//     triangle, the bonuses and the pairs (t, t - 1) whose exponent is exactly
//     0, takes no exponential and is spread over all threads afterwards.
//     att's exponentials are ex2.approx.ftz (exp_approx); rd, kd and dec keep
//     expf.
//   wkv6_state_kernel, one block of 128 threads per (b, h, VB = 16 columns of
//     V): walks the chunks in order.  Warps 0-1 compute y[t, slice] =
//     att[t] . v[:, slice] + rd[t] . S[:, slice]; warps 2-3 keep the K x VB
//     slice of S in registers for the whole sequence and update it, S[:, slice]
//     = dec * S[:, slice] + kd^T v[:, slice].  Both read only the S entering
//     the chunk (a copy in shared memory, double-buffered), so they run side
//     by side.  The next chunk's att, rd, kd and dec arrive by cp.async, and
//     its v through registers, while the block works on this one.
// All arithmetic is on the CUDA cores: no tensor cores.
//
// Stability.  The clipped per-step log-decay reaches -e^8 = -2981, so cum over
// a chunk reaches about -95,000.  Every exponent is a difference of
// cumulative log-decays that is <= 0, as in the Pallas body, and the product
// is never factored into (r exp(cum_ex)) (k exp(-cum))^T, which overflows.
// The difference itself loses its small value when the two sums are large
// (at -95,000 one f32 step is 0.008), so each cumulative sum is kept as an
// unevaluated pair hi + lo of f32 (compensated summation) and a difference is
// (hi_t - hi_s) + (lo_t - lo_s): hi_t - hi_s is exact whenever it is small.
//
// Ragged S.  Positions >= S of the last chunk are staged as k = v = 0 and
// log_w = 0 (decay 1), as wkv_chunked pads them, and their y is not written:
// the final state is the recurrence's state after exactly S tokens.
//
// Bound.  At the serving path's prefill shape (B=4, S=512, H=32, K=64, bf16
// r/k/v, f32 log_w): r, k, v and y 8.39 MB each, log_w 16.8 MB, the state
// 2.10 MB, 52.4 MB in all, 15.7 us at 3.35 TB/s (H100 SXM).  Operations: the
// pairwise products and sums, att @ v, the cross term and the state update
// come to about 1.5 GFLOP of f32 (22 us on the 67 TFLOP/s CUDA cores), plus
// 73 M exponentials on the special-function units (67 M of them in att, 16
// us at 16 a clock an SM).  So the bound is operations.  The scratch adds 42
// MB written and read again, and each of a head's four state blocks reads
// all of its att, rd and kd.  On the card neither kernel is held by device
// memory but by issue: the intra kernel spends eight instructions an
// exponential, the special-function unit's among them, and the state kernel
// about one load for every two FMAs, each step of its chain waiting on the
// one before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT_INTRA = 128;
constexpr int NT_STATE = 128;
constexpr int VB = 16;  // columns of V a state block owns

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;  // (H, K), contiguous
  void* y;
  float* state;  // (B, H, K, K), contiguous
  // scratch, contiguous: att (B, H, NC, L, L), rd and kd (B, H, NC, L, K),
  // dec (B, H, NC, K)
  float* att;
  float* rd;
  float* kd;
  float* dec;
  int H, S, NC;
  // (batch, seq, head) strides in elements; the K axis is contiguous
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// two consecutive elements (8-byte aligned for f32, 4-byte for bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float comp(const float4& x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

// Copies `rows` rows of K elements (row stride `ld`) into L rows of shared
// f32, row t at dst_row(t); rows past `rows` are zero.
template <int NT, int L, int K, typename T, typename Row>
__device__ __forceinline__ void load_tile(Row dst_row, const T* src, long long ld, int rows) {
  constexpr int V4 = K / 4;
  for (int idx = threadIdx.x; idx < L * V4; idx += NT) {
    const int t = idx / V4;
    const int c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < rows) x = load4(src + t * ld + c);
    *reinterpret_cast<float4*>(dst_row(t) + c) = x;
  }
}

// s + e = a + b exactly (Knuth's two-sum); the _rn intrinsics keep the
// compiler from reassociating.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// exp(x) as 2^(x log2 e) on the special-function unit, results below 2^-126
// flushed to zero
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// acc += r k exp(min((eh - ch) + (el - cl), 0)) over the four lanes of float4s
__device__ __forceinline__ float pair4(float acc, const float4& r, const float4& k,
                                       const float4& eh, const float4& el, const float4& ch,
                                       const float4& cl) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float d = __fadd_rn(__fsub_rn(comp(eh, q), comp(ch, q)),
                              __fsub_rn(comp(el, q), comp(cl, q)));
    acc = fmaf(comp(r, q) * comp(k, q), exp_approx(fminf(d, 0.f)), acc);
  }
  return acc;
}

// ---- intra: one block per (b, h, chunk) --------------------------------------

template <int K, int L>
constexpr int intra_smem_floats() {
  // r, k (L rows); cum hi and lo with a leading zero row (L + 1 rows), all of
  // row stride K + 4; u
  return 2 * L * (K + 4) + 2 * (L + 1) * (K + 4) + K;
}

template <int K, int L, typename T>
__global__ void __launch_bounds__(NT_INTRA) wkv6_intra_kernel(const Params p) {
  // Shared tiles keep their even rows first and their odd rows after them,
  // each of stride K + 4: the rows that a quarter warp reads at one k are
  // consecutive there and start on distinct bank groups.
  constexpr int LDK = K + 4;
  constexpr int NB = L / 2;   // 2 x 2 blocks of att per side
  constexpr int N_OFF = NB * (NB - 1) / 2;
  static_assert(N_OFF <= NT_INTRA, "att mapping");
  extern __shared__ float4 smem4[];
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ks = Rs + L * LDK;
  float* CH = Ks + L * LDK;  // row 0 zero, row t + 1 cum[t] (placed by cm below)
  float* CL = CH + (L + 1) * LDK;
  float* Us = CL + (L + 1) * LDK;

  auto rk = [&](int t) { return ((t & 1) * (L / 2) + (t >> 1)) * LDK; };      // L rows
  auto cm = [&](int t) { return ((t & 1) * (L / 2 + 1) + (t >> 1)) * LDK; };  // L + 1 rows

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = c * L;
  const int rows = min(L, p.S - c0);
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh + c0 * p.r_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + c0 * p.k_ss;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh + c0 * p.w_ss;
  const long long chunk_id = (static_cast<long long>(b) * p.H + h) * p.NC + c;
  float* At = p.att + chunk_id * L * L;  // att goes straight to the scratch

  load_tile<NT_INTRA, L, K>([&](int t) { return Rs + rk(t); }, r, p.r_ss, rows);
  load_tile<NT_INTRA, L, K>([&](int t) { return Ks + rk(t); }, k, p.k_ss, rows);
  // padded rows: log_w = 0
  load_tile<NT_INTRA, L, K>([&](int t) { return CH + cm(t + 1); }, lw, p.w_ss, rows);
  for (int i = tid; i < K; i += NT_INTRA) {
    Us[i] = p.u[h * K + i];
    CH[i] = 0.f;
    CL[i] = 0.f;
  }
  for (int i = tid; i < L * L; i += NT_INTRA) {
    if (i % L > i / L) At[i] = 0.f;  // above the diagonal
  }
  __syncthreads();

  // inclusive cumulative log-decay per column, as hi + lo, in place over log_w
  for (int kk = tid; kk < K; kk += NT_INTRA) {
    float hi = 0.f, lo = 0.f;
    for (int t = 1; t <= L; ++t) {
      float s, e;
      two_sum(hi, CH[cm(t) + kk], s, e);
      hi = s;
      lo = __fadd_rn(lo, e);
      CH[cm(t) + kk] = hi;
      CL[cm(t) + kk] = lo;
    }
  }
  __syncthreads();

  // att below the diagonal: the strictly lower 2 x 2 blocks, one a thread
  if (tid < N_OFF) {
    int bi = 1;  // tid = bi (bi - 1) / 2 + bj, bj < bi
    while ((bi + 1) * bi / 2 <= tid) ++bi;
    const int bj = tid - bi * (bi - 1) / 2;
    const int t0 = 2 * bi, s0 = 2 * bj;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 4) {
      const float4 eh0 = load4(CH + cm(t0) + kk), el0 = load4(CL + cm(t0) + kk);
      const float4 eh1 = load4(CH + cm(t0 + 1) + kk), el1 = load4(CL + cm(t0 + 1) + kk);
      const float4 ch0 = load4(CH + cm(s0 + 1) + kk), cl0 = load4(CL + cm(s0 + 1) + kk);
      const float4 ch1 = load4(CH + cm(s0 + 2) + kk), cl1 = load4(CL + cm(s0 + 2) + kk);
      const float4 r0 = load4(Rs + rk(t0) + kk), r1 = load4(Rs + rk(t0 + 1) + kk);
      const float4 k0 = load4(Ks + rk(s0) + kk), k1 = load4(Ks + rk(s0 + 1) + kk);
      a00 = pair4(a00, r0, k0, eh0, el0, ch0, cl0);
      a01 = pair4(a01, r0, k1, eh0, el0, ch1, cl1);
      a10 = pair4(a10, r1, k0, eh1, el1, ch0, cl0);
      a11 = pair4(a11, r1, k1, eh1, el1, ch1, cl1);
    }
    *reinterpret_cast<float2*>(At + t0 * L + s0) = make_float2(a00, a01);
    *reinterpret_cast<float2*>(At + (t0 + 1) * L + s0) = make_float2(a10, a11);
  }
  // the rest of the lower triangle: the bonuses att[t][t] and the pairs
  // (t, t - 1), whose exponent cum_ex[t] - cum[t - 1] is exactly 0
  for (int e = tid; e < 2 * L - 1; e += NT_INTRA) {
    const int t = e < L ? e : e - L + 1;
    const int s = e < L ? e : t - 1;
    float acc = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 4) {
      const float4 rr = load4(Rs + rk(t) + kk), kv = load4(Ks + rk(s) + kk);
      const float4 w = e < L ? load4(Us + kk) : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc = e < L ? fmaf(comp(rr, q) * comp(w, q), comp(kv, q), acc)
                    : fmaf(comp(rr, q) * comp(kv, q), 1.f, acc);  // exp(0) = 1
      }
    }
    At[t * L + s] = acc;
  }

  // r * exp(cum_ex) and k * exp(cum_L - cum), straight to the scratch; dec
  float* rd = p.rd + chunk_id * L * K;
  float* kd = p.kd + chunk_id * L * K;
  for (int idx = tid; idx < L * K / 4; idx += NT_INTRA) {
    const int t = idx / (K / 4);
    const int kk = (idx % (K / 4)) * 4;
    const float4 rr = load4(Rs + rk(t) + kk), kv = load4(Ks + rk(t) + kk);
    const float4 eh = load4(CH + cm(t) + kk), el = load4(CL + cm(t) + kk);
    const float4 ch = load4(CH + cm(t + 1) + kk), cl = load4(CL + cm(t + 1) + kk);
    const float4 hL = load4(CH + cm(L) + kk), lL = load4(CL + cm(L) + kk);
    float ro[4], ko[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ro[q] = comp(rr, q) * expf(__fadd_rn(comp(eh, q), comp(el, q)));
      const float to_end = __fadd_rn(__fsub_rn(comp(hL, q), comp(ch, q)),
                                     __fsub_rn(comp(lL, q), comp(cl, q)));
      ko[q] = comp(kv, q) * expf(to_end);
    }
    *reinterpret_cast<float4*>(rd + t * K + kk) = make_float4(ro[0], ro[1], ro[2], ro[3]);
    *reinterpret_cast<float4*>(kd + t * K + kk) = make_float4(ko[0], ko[1], ko[2], ko[3]);
  }
  for (int kk = tid; kk < K; kk += NT_INTRA) {
    p.dec[chunk_id * K + kk] = expf(__fadd_rn(CH[cm(L) + kk], CL[cm(L) + kk]));
  }
}

// ---- state: one block per (b, h, VB columns of V) ----------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// att and rd rows padded by 4 floats (see row_off in the state kernel)
template <int K, int L>
__host__ __device__ constexpr int state_buf_floats() {
  return L * (L + 4) + L * (K + 4) + L * K + L * VB + K;  // att, rd, kd, v, dec
}

template <int K, int L>
constexpr int state_smem_floats() {
  return 2 * state_buf_floats<K, L>() + 2 * K * VB;  // two buffers; S twice
}

// N consecutive floats of shared memory (16-byte aligned) into registers
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  static_assert(N % 4 == 0, "row length");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = load4(src + i);
    dst[i] = x.x;
    dst[i + 1] = x.y;
    dst[i + 2] = x.z;
    dst[i + 3] = x.w;
  }
}

// The first two warps compute y, the other two update S: both read only the
// S entering the chunk, so they run side by side.  y threads own TY rows x 2
// columns of y, S threads KS rows x 2 columns of S (in registers).  Four
// blocks an SM: their shared memory fills it (4 x 55.8 KB at K=64, L=32).
template <int K, int L, typename T>
__global__ void __launch_bounds__(NT_STATE, 4) wkv6_state_kernel(const Params p) {
  constexpr int NR = NT_STATE / 2;  // threads of each role
  constexpr int JP = VB / 2;        // threads across the slice, two columns each
  constexpr int G = NR / JP;        // row groups of each role
  constexpr int TY = L / G;         // y rows a y thread
  constexpr int KS = K / G;         // S rows an S thread
  constexpr int BUF = state_buf_floats<K, L>();
  constexpr int V4 = VB / 4;
  constexpr int LDA = L + 4;  // att row stride in shared memory
  constexpr int LDR = K + 4;  // rd row stride
  constexpr int O_RD = L * LDA, O_KD = O_RD + L * LDR, O_V = O_KD + L * K, O_DEC = O_V + L * VB;
  static_assert(NR % 32 == 0 && G * JP == NR && TY * G == L && KS * G == K && KS % 4 == 0,
                "mapping");
  static_assert(L * V4 <= NT_STATE, "one float4 of v a thread");
  static_assert(L * K % (4 * NT_STATE) == 0 && K <= 4 * NT_STATE, "fetch mapping");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* SS = smem + 2 * BUF;  // S[k][j] entering the chunk, two buffers
  // A warp's y threads read rows TY apart; row t starts 4 floats further
  // when t & 8, so those rows fall on distinct bank groups.
  auto row_off = [](int t, int ld) { return t * ld + ((t >> 3) & 1) * 4; };

  const int tid = threadIdx.x;
  const bool y_role = tid < NR;  // warp-uniform
  const int lt = tid % NR;
  const int j0 = (lt % JP) * 2;
  const int g = lt / JP;
  const int t0 = g * TY;
  const int k0 = g * KS;
  const int slice = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int jv = slice * VB;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + jv;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + jv;

  // this thread's float4 of the chunk's v slice (row vt, columns vc .. vc + 3)
  const int vt = tid / V4;
  const int vc = (tid % V4) * 4;
  const bool v_mine = tid < L * V4;

  // att, rd, kd, dec of chunk c by cp.async.  Each thread copies the same
  // places of every chunk: the loops have fixed trip counts, so that their
  // offsets stay out of the chunk loop.
  auto fetch = [&](int c, float* buf) {
    const long long id = bh * p.NC + c;
    const float* att = p.att + id * (L * L);
    const float* rd = p.rd + id * (L * K);
    const float* kd = p.kd + id * (L * K);
#pragma unroll
    for (int n = 0; n < (L * L / 4 + NT_STATE - 1) / NT_STATE; ++n) {
      const int i = (n * NT_STATE + tid) * 4;
      if (i < L * L) cp_async16(buf + row_off(i / L, LDA) + i % L, att + i);
    }
#pragma unroll
    for (int n = 0; n < L * K / 4 / NT_STATE; ++n) {
      const int i = (n * NT_STATE + tid) * 4;
      cp_async16(buf + O_RD + row_off(i / K, LDR) + i % K, rd + i);
      cp_async16(buf + O_KD + i, kd + i);
    }
    if (tid < K / 4) cp_async16(buf + O_DEC + tid * 4, p.dec + id * K + tid * 4);
  };
  auto v_load = [&](int c) {
    const int t = c * L + vt;
    return (v_mine && t < p.S) ? load4(v + static_cast<long long>(t) * p.v_ss + vc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto v_store = [&](float* buf, float4 x) {
    if (v_mine) *reinterpret_cast<float4*>(buf + O_V + vt * VB + vc) = x;
  };

  float St[KS][2];  // S threads: S[k0 + i][j0 + jj]
#pragma unroll
  for (int i = 0; i < KS; ++i) St[i][0] = St[i][1] = 0.f;
  for (int i = tid; i < K * VB; i += NT_STATE) SS[i] = 0.f;
  fetch(0, smem);
  v_store(smem, v_load(0));
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < p.NC; ++c) {
    const float* cur = smem + (c & 1) * BUF;
    float* nxt = smem + ((c + 1) & 1) * BUF;
    const float* Vs = cur + O_V;
    const bool more = c + 1 < p.NC;
    float4 v_next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (more) {
      fetch(c + 1, nxt);
      v_next = v_load(c + 1);
    }

    if (y_role) {
      // y[t][j] for TY rows and two columns from the S entering the chunk;
      // att is zero above the diagonal, so s stops at the thread's last row
      const float* At = cur;
      const float* Rd = cur + O_RD;
      const float* Sc = SS + (c & 1) * K * VB;
      float acc[TY][2];
#pragma unroll
      for (int i = 0; i < TY; ++i) acc[i][0] = acc[i][1] = 0.f;
      const int s_end = min(L, (t0 + TY + 3) & ~3);
      for (int s = 0; s < s_end; s += 4) {
        float a[TY][4];
#pragma unroll
        for (int i = 0; i < TY; ++i) load_row<4>(a[i], At + row_off(t0 + i, LDA) + s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 vs = *reinterpret_cast<const float2*>(Vs + (s + q) * VB + j0);
#pragma unroll
          for (int i = 0; i < TY; ++i) {
            acc[i][0] = fmaf(a[i][q], vs.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][q], vs.y, acc[i][1]);
          }
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 4) {
        float a[TY][4];
#pragma unroll
        for (int i = 0; i < TY; ++i) load_row<4>(a[i], Rd + row_off(t0 + i, LDR) + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 sk = *reinterpret_cast<const float2*>(Sc + (kk + q) * VB + j0);
#pragma unroll
          for (int i = 0; i < TY; ++i) {
            acc[i][0] = fmaf(a[i][q], sk.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][q], sk.y, acc[i][1]);
          }
        }
      }
      T* yt = y + static_cast<long long>(c * L + t0) * p.y_ss + j0;
#pragma unroll
      for (int i = 0; i < TY; ++i) {
        if (c * L + t0 + i < p.S) store2(yt, acc[i][0], acc[i][1]);
        yt += p.y_ss;
      }
    } else {
      // S[k][j] = exp(cum_L[k]) S[k][j] + sum_s kd[s][k] v[s][j]
      const float* Kd = cur + O_KD;
      float dc[KS];
      load_row<KS>(dc, cur + O_DEC + k0);
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        St[i][0] *= dc[i];
        St[i][1] *= dc[i];
      }
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        float kd[KS];
        load_row<KS>(kd, Kd + s * K + k0);
        const float2 vs = *reinterpret_cast<const float2*>(Vs + s * VB + j0);
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          St[i][0] = fmaf(kd[i], vs.x, St[i][0]);
          St[i][1] = fmaf(kd[i], vs.y, St[i][1]);
        }
      }
      float* Sn = SS + ((c + 1) & 1) * K * VB;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        *reinterpret_cast<float2*>(Sn + (k0 + i) * VB + j0) = make_float2(St[i][0], St[i][1]);
      }
    }
    if (more) v_store(nxt, v_next);
    cp_async_wait_all();
    __syncthreads();
  }

  if (!y_role) {
    float* out = p.state + bh * K * K + jv + j0;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      *reinterpret_cast<float2*>(out + (k0 + i) * K) = make_float2(St[i][0], St[i][1]);
    }
  }
}

template <int K, int L, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem_a = intra_smem_floats<K, L>() * sizeof(float);
  const int smem_b = state_smem_floats<K, L>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_intra_kernel<K, L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      wkv6_state_kernel<K, L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return err;
  wkv6_intra_kernel<K, L, T><<<dim3(p.NC, p.H, B), NT_INTRA, smem_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<K, L, T><<<dim3(K / VB, p.H, B), NT_STATE, smem_b, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int K, int chunk, cudaStream_t stream) {
  if (K == 64 && chunk == 32) return launch<64, 32, T>(p, B, stream);
  if (K == 64 && chunk == 16) return launch<64, 16, T>(p, B, stream);
  if (K == 32 && chunk == 32) return launch<32, 32, T>(p, B, stream);
  if (K == 32 && chunk == 16) return launch<32, 16, T>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, log_w, y: (B, S, H, K); strides holds the (batch, seq, head)
// strides in elements of r, k, v, log_w and y, in that order; the K axis is
// contiguous.  u: (H, K) f32 and state: (B, H, K, K) f32, both contiguous.
// Scratch, f32 and contiguous, with NC = ceil(S / chunk): att (B, H, NC,
// chunk, chunk), rd and kd (B, H, NC * chunk, K), dec (B, H, NC, K).
// Launches the intra kernel and then the state kernel on `stream`; returns
// the first cudaError_t of the two (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* log_w,
                        const float* u, void* y, float* state, float* att, float* rd, float* kd,
                        float* dec, int is_bf16, int B, int S, int H, int K, int chunk,
                        const long long* strides, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.lw = log_w;
  p.u = u;
  p.y = y;
  p.state = state;
  p.att = att;
  p.rd = rd;
  p.kd = kd;
  p.dec = dec;
  p.H = H;
  p.S = S;
  p.NC = (S + chunk - 1) / chunk;
  p.r_sb = strides[0];
  p.r_ss = strides[1];
  p.r_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.w_sb = strides[9];
  p.w_ss = strides[10];
  p.w_sh = strides[11];
  p.y_sb = strides[12];
  p.y_ss = strides[13];
  p.y_sh = strides[14];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, B, K, chunk, s)
                                  : dispatch<float>(p, B, K, chunk, s);
  return static_cast<int>(err);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
