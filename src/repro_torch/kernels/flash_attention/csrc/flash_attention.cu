// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention (body _kernel)
// and computes the same function: GQA attention (query head h reads K/V group
// h / (H/G), K/V never repeated) with an online softmax whose running max m,
// sum l and accumulator stay in f32; scores scaled by dh^-0.5 in f32; optional
// softcap * tanh(s / softcap); causal and sliding-window masks on absolute
// positions shifted by q_offset; masked scores set to NEG_INF; fully masked
// rows guarded (m_safe = max(m, -1e30), l floored at 1e-30, so such a row is
// 0); output in the input dtype with q's layout.  Strides are passed in, so
// the model's (B, S, H, dh) buffers are read in place.  Two kernels:
//
// bf16: flash_fwd_wgmma_kernel (flash_fwd_hopper.cuh).  Bound: at llama3.2-1b's
// prefill shape (B=4 H=32 G=8 S=512 dh=64, causal) it must move q, o, k, v
// once, 20.97 MB = 6.26 us at 3.35 TB/s, against 4.30 GFLOP = 4.35 us at 989
// TFLOP/s; at recurrentgemma-9b's (B=4 H=16 G=1 S=512 dh=256, window 2048)
// 35.65 MB = 10.64 us against 8.61 GFLOP = 8.70 us.  Both are bounded by
// bytes, with the tensor cores close behind.  What the first, CUDA-core
// design lost, and what this one does about it:
//  - Products were f32 FMAs (67 TFLOP/s, 64 and 128 us of work alone): both
//    are wgmma on the bf16 tensor cores.  S = Q K^T reads Q and K from shared
//    memory, unscaled (bf16 x bf16 products are exact in f32, so the scores
//    match q.astype(f32) * scale up to the order of summation; dh^-0.5 is
//    applied in f32, since it is no power of two at dh 32 and 128: to the row
//    max and inside the exponent's FMA, or before the softcap).
//    O += P V takes P from registers and V as an MN-major (transposed) operand.
//  - Each shared-memory load fed four FMAs: wgmma reads its operands from
//    shared memory once per 64-row warpgroup tile.
//  - K and V were widened to f32 in shared memory (217 KB a block at dh=256,
//    one block of 8 warps an SM): tiles stay bf16.
//  - Loads were synchronous behind two __syncthreads a tile: one producer
//    thread issues TMA loads into a K ring and a V ring of two tiles each,
//    every slot with a full and an empty mbarrier; a K tile is released as
//    soon as its product is done, a V tile after P V.  Blocks are persistent:
//    each walks work items (a query tile of one batch and head), the heaviest
//    first, so the next item's Q, K and V load while this one finishes.
//    setmaxnreg moves the producer warpgroup's registers to the consumers
//    (24 left to it, 240 or 232 to each consumer thread).
//    The tensor maps are built on the host for each call from the strides
//    (4-d: dh, seq, head, batch, unit boxes on the last two), with a 128-byte
//    swizzle (64-byte at dh=32) that the wgmma descriptors name; a 256-column
//    tile is four 64-column boxes.  TMA fills rows past the end with zeros;
//    the ragged edge of Sk is still masked in the scores.
//    cuTensorMapEncodeTiled is taken with cudaGetDriverEntryPoint, so the
//    build flags stay as they are (no -lcuda).
//  - P went through shared memory: the f32 accumulator's pairs, packed to
//    bf16x2, are the register A operand of the next wgmma as they lie.  This
//    is the one rounding the Pallas kernel does not make; l is summed from the
//    f32 probabilities before it.
//  - Nothing overlapped the softmax: Q K^T of tile i + 1 and P V of tile i are
//    issued together, and the softmax of tile i + 1 runs while P V of tile i
//    is on the tensor cores.  ptxas serializes every wgmma of a kernel where
//    an instruction between a batch and its wait branches (a divergent
//    predicate counts) or writes a wgmma's registers, so the softmax has no
//    branch: softcap is a template argument, and the mask is chosen per tile
//    before the batch is issued.
//  - Every tile computed the mask: only tiles that cross the diagonal, the
//    window's edge or the end of the keys do; they lead (window) and trail
//    (diagonal, ragged end) the key range, so each item runs three loops:
//    masked, unmasked, masked.  Tiles a mask kills entirely are never loaded.
// Blocks: dh <= 64, one warpgroup of 64 query rows and two blocks an SM
// (128-key tiles), so that one block's loads, first product and epilogue
// overlap the other's work; dh >= 128, two warpgroups (128 rows) and one
// block an SM, with 128-key tiles at dh=128 and 64-key tiles at dh=256.

// float32: flash_fwd_kernel, the first design, kept for the f32 route, where
// its f32 FMAs are exact to the 1e-4 parity tolerances.  One block per
// (b*h, 64-row q tile) runs the kv loop over the key tiles its limits allow;
// Q (pre-scaled) and K/V tiles of 64 keys are staged in shared memory; four
// threads share a query row, reducing its max and sum with two shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>

#include "flash_fwd_hopper.cuh"

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Copies `rows` rows of DH elements (row stride `ld` elements) into a
// BK x (DH + PAD) f32 shared tile, scaled by `mul`; rows past `rows` are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld,
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

template <int DH>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + g * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + g * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

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
    float* o_row = o + r * p.o_ss;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      store4(o_row + 16 * i + 4 * c,
             make_float4(acc[4 * i + 0] / den, acc[4 * i + 1] / den,
                         acc[4 * i + 2] / den, acc[4 * i + 3] / den));
    }
  }
}

template <int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = (BQ * (DH + PAD) + 2 * BK * (DH + PAD) + BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    case 256: return launch<256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, dh); k, v: (B, G, Sk, dh); o like q.  strides holds the
// (batch, head, sequence) strides in elements of q, k, v and o, in that order;
// the dh axis is contiguous.  bf16 goes to the wgmma kernel, f32 to the
// CUDA-core one.  Returns 0 on success, else a cudaError_t, or a code of
// hopper::ERR_TENSOR_MAP, hopper::ERR_ENTRY_POINT or hopper::ERR_REGISTERS
// (flash_attention_error_string names each).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int B, int H, int G, int Sq, int Sk,
                                   int dh, const long long* strides, int causal,
                                   int window, int q_offset, float softcap, float scale,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    hopper::Params hp;
    hp.o = o;
    hp.o_sb = strides[9];
    hp.o_sh = strides[10];
    hp.o_ss = strides[11];
    hp.H = H;
    hp.G = G;
    hp.Sq = Sq;
    hp.Sk = Sk;
    hp.BH = B * H;
    hp.causal = causal;
    hp.window = window;
    hp.q_offset = q_offset;
    hp.softcap = softcap;
    hp.softcap_inv = softcap > 0.f ? 1.f / softcap : 0.f;
    hp.scale = scale;
    return hopper::dispatch(q, k, v, hp, B, dh, strides, s);
  }
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
  return static_cast<int>(dispatch_f32(p, B, dh, s));
}

extern "C" const char* flash_attention_error_string(int err) {
  static char buf[96];
  if (err == hopper::ERR_ENTRY_POINT) return "cuTensorMapEncodeTiled not found in the driver";
  if (err == hopper::ERR_REGISTERS)
    return "flash_fwd_wgmma_kernel was built with another entry register count than its "
           "setmaxnreg budget assumes";
  if (err >= hopper::ERR_TENSOR_MAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - hopper::ERR_TENSOR_MAP);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
