// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention (body _kernel)
// and computes the same function: GQA attention with an online softmax whose
// running max m, sum l and accumulator acc stay in f32; q pre-scaled by
// dh^-0.5; optional softcap * tanh(s / softcap); causal and sliding-window
// masks on absolute positions shifted by q_offset; masked scores set to
// NEG_INF; fully masked rows guarded (m_safe = max(m, -1e30), l floored at
// 1e-30, so such a row comes out as 0); output in the input dtype.
//
// Design.  The TPU kernel walks a (B*H, Sq/bq, Sk/bk) grid in order and keeps
// the softmax state in VMEM scratch across the sequential kv axis.  Here one
// thread block owns one (b*h, 64-row q tile) and runs the kv loop itself, over
// exactly the key tiles its causal and window limits allow (no visit-and-
// predicate of dead tiles).  Q is staged once in shared memory, K and V tiles
// of 64 keys are staged per step, all converted to f32.  Four threads share
// one query row: each computes 16 of the tile's 64 scores, the row max and
// row sum are reduced with two warp shuffles, and each thread keeps dh/4
// columns of the f32 accumulator in registers.  Query head h reads K/V group
// h / (H/G) directly; K/V are never repeated.  Ragged edges (Sq or Sk not a
// multiple of 64) are masked in the kernel, so every sequence length runs here.
// Strides are passed in, so the model's (B, S, H, dh) buffers are read in place.
//
// Bound.  At the serving path's prefill shape (B=4, H=32, G=8, S=512, dh=64,
// bf16, causal) the kernel must move q + o = 2 x 8.39 MB and k + v =
// 2 x 2.10 MB (21.0 MB), and do 4 * dh * B * H * S(S+1)/2 = 4.30 GFLOP.  On an
// H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) that is 6.3 us from memory against
// 4.3 us of tensor-core work: the bound is bytes.  This first version does
// its products as f32 FMAs on the CUDA cores (67 TFLOP/s), so it runs far
// above that bound; wgmma and TMA are the way down to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int TPR = 4;              // threads per query row
constexpr int NTHREADS = BQ * TPR;  // 256
constexpr int PAD = 4;              // f32 padding per shared row: no bank conflicts
constexpr int LDP = BK + PAD;       // leading dimension of the P tile
constexpr float NEG_INF = -2.3819763e38f;

static_assert(BQ == BK, "load_tile assumes one tile height");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Sk;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, q_offset;
  float softcap, scale;
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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

// Copies `rows` rows of DH elements (row stride `ld` elements) into a
// BK x (DH + PAD) f32 shared tile, scaled by `mul`; rows past `rows` are zero.
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld,
                                          int rows, float mul) {
  constexpr int V = DH / 4;
  for (int idx = threadIdx.x; idx < BK * V; idx += NTHREADS) {
    const int r = idx / V;
    const int c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      x = load4(src + r * ld + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    store4(dst + r * (DH + PAD) + c, x);
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const Params p) {
  constexpr int LD = DH + PAD;
  constexpr int SPT = BK / TPR;  // scores per thread per tile
  constexpr int APT = DH / TPR;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, p.Sq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  load_tile<DH>(Qs, q, p.q_ss, q_rows, p.scale);

  const int r = threadIdx.x / TPR;  // query row within the tile
  const int c = threadIdx.x % TPR;  // this thread's share of the row
  const int q_pos = q0 + r + p.q_offset;

  // Key range this tile can see: causal stops at the tile's last query,
  // the window starts at its first query's window.
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + q_rows - 1 + p.q_offset + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 + p.q_offset - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m = -INFINITY;
  float l = 0.f;
  float acc[APT];
#pragma unroll
  for (int i = 0; i < APT; ++i) acc[i] = 0.f;
  float s[SPT];

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const int k_rows = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<DH>(Ks, k + k0 * p.k_ss, p.k_ss, k_rows, 1.f);
    load_tile<DH>(Vs, v + k0 * p.v_ss, p.v_ss, k_rows, 1.f);
    __syncthreads();

    // s[jj] = q_row . k[c + TPR * jj]
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) s[jj] = 0.f;
    const float* q_row = Qs + r * LD;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_row + d);
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (c + TPR * jj) * LD + d);
        s[jj] = fmaf(qv.x, kv.x, s[jj]);
        s[jj] = fmaf(qv.y, kv.y, s[jj]);
        s[jj] = fmaf(qv.z, kv.z, s[jj]);
        s[jj] = fmaf(qv.w, kv.w, s[jj]);
      }
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int k_pos = k0 + c + TPR * jj;
      float x = s[jj];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      bool ok = k_pos < p.Sk;
      if (p.causal) ok = ok && k_pos <= q_pos;
      if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
      s[jj] = ok ? x : NEG_INF;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

    const float m_new = fmaxf(m, tile_max);
    const float m_safe = fmaxf(m_new, -1e30f);  // fully masked rows stay finite
    const float alpha = expf(fmaxf(m, -1e30f) - m_safe);
    float row_sum = 0.f;
    float* p_row = Ps + r * LDP;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const float pj = expf(s[jj] - m_safe);
      row_sum += pj;
      p_row[c + TPR * jj] = pj;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < APT; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's four threads share one warp

    // acc += P V; this thread owns columns 16 * i + 4 * c + {0..3}.
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(p_row + j);
      const float pj4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* v_row = Vs + (j + u) * LD + 4 * c;
#pragma unroll
        for (int i = 0; i < DH / 16; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + 16 * i);
          acc[4 * i + 0] = fmaf(pj4[u], vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pj4[u], vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pj4[u], vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pj4[u], vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  if (r < q_rows) {
    const float den = fmaxf(l, 1e-30f);
    T* o_row = o + r * p.o_ss;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      store4(o_row + 16 * i + 4 * c,
             make_float4(acc[4 * i + 0] / den, acc[4 * i + 1] / den,
                         acc[4 * i + 2] / den, acc[4 * i + 3] / den));
    }
  }
}

template <int DH, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = (BQ * (DH + PAD) + 2 * BK * (DH + PAD) + BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<DH, T><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32, T>(p, B, stream);
    case 64: return launch<64, T>(p, B, stream);
    case 128: return launch<128, T>(p, B, stream);
    case 256: return launch<256, T>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, dh); k, v: (B, G, Sk, dh); o like q.  strides holds the
// (batch, head, sequence) strides in elements of q, k, v and o, in that order;
// the dh axis is contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int B, int H, int G, int Sq, int Sk,
                                   int dh, const long long* strides, int causal,
                                   int window, int q_offset, float softcap, float scale,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.H = H;
  p.G = G;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, B, dh, s)
                                  : dispatch<float>(p, B, dh, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
