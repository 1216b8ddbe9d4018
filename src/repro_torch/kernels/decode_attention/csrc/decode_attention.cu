// One-token decode attention over a KV cache for Hopper (sm_90a), written by hand.
//
// Replaces no TPU kernel: the JAX package's decode attention
// (src/repro/models/attention.py::decode_attention) is plain jnp, which XLA
// fuses on the TPU.  The port's plain version of it (kernels/decode_attention/
// ref.py, the math of models/attention.py::_attend_dense) casts the whole K
// cache to f32, builds an f32 mask, and permutes V for a second batched GEMV on
// every layer of every step: several passes over a cache that holds most of a
// chat batch's bytes.  This kernel computes the same function in one pass:
//
//   out[b, h] = softmax_t(mask(softcap(scale * q[b, h] . k[b, t, g]))) . v[b, t, g]
//
// for the query heads h = g * M .. g * M + M - 1 of each KV head g, over the
// cache slots t whose position k_pos[t] is attendable from pos:
// 0 <= k_pos[t] <= pos and, with a window, k_pos[t] > pos - window.  That
// holds for the padded layout (slots above pos carry -1) and for the ring.
// q is (B, H, dh) with a contiguous last axis; k and v are (B, cap, G, dh)
// in q's type (bf16 or f32) with a contiguous last axis and 16-byte strides;
// out is a contiguous (B, H, dh) in q's type.  Logits, the online softmax and
// the P.V sum are f32 in registers (the plain version rounds P to the
// cache's type before P.V); nothing but the output, and for a split cache f32
// partials of (B, H, splits), is written to device memory.
//
// What bounds it.  Each attendable K/V slot is read once: 2 * dh * elsize
// bytes a (b, g, slot), against 4 * dh * M FLOPs.  At M <= 16 that is at most
// 16 FLOPs a byte in bf16, under the card's f32 rate over its memory rate, so
// the bound is the cache's bytes at 3.35 TB/s (olmo-1b's chat batch: B=64,
// G=16, dh=128, 1152 filled slots at step 128: 604 MB a layer, 0.180 ms).
//
// Design.  One block per (b, g, split): all M query heads of a KV head read
// each K/V tile once.  A block has 128 threads per group of HM <= 8 heads
// (two groups for M = 9..16).  Before anything else, the block reads its
// split's k_pos and marks each tile of BT slots live where any slot is
// attendable; dead tiles (slots above pos early in a batch) are never loaded.
// Live K/V tiles stream through a ring of STAGES shared-memory stages with
// cp.async (16-byte vectors, neighbouring threads on neighbouring addresses),
// the tile's k_pos beside them.  KL lanes share one key, each holding
// EPT = dh / KL elements of the row: a lane multiplies its part of K by its
// part of each head's q, and KL lanes sum by xor shuffles.  Each of the
// 128 / KL key slots of a head group keeps its own online softmax (max m,
// sum l, output o) over the keys it sees, so a tile needs no block-wide max;
// at the end the slots merge through shared memory in a fixed order.  Softcap
// is applied before the mask, as the plain version applies it.  Where B * G
// blocks would not fill the card the wrapper splits the slots into ranges
// (a count chosen from the shapes and the card's multiprocessors alone, so
// fixed for a captured graph);
// each split writes f32 (m, l, o) and decode_attention_merge combines them,
// a split with no attendable slot weighing 0.  Everything is deterministic:
// a replayed step equals its eager run bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NTHREADS = 128;       // threads of one head group
constexpr int MAX_HEAD_GROUPS = 2;  // so M <= 2 * 8
constexpr int MAX_HM = 8;           // query heads a head group holds
constexpr int STAGES = 3;           // K/V tiles in shared memory at once
constexpr int TILE_BYTES = 8192;    // K (and V) of one tile
constexpr int MAX_TILES = 1024;     // tiles of one split: a byte of liveness each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* k_pos;  // (cap,)
  const int* pos;    // 0-d
  void* out;         // (B, H, dh), contiguous
  float* part_o;     // (B, H, n_split, dh) where n_split > 1
  float* part_ml;    // (B, H, n_split, 2): the split's max and sum
  int B, H, G, M, cap, window, n_split, split_len;
  long long q_sb, q_sh, k_sb, k_ss, k_sg, v_sb, v_ss, v_sg;  // strides in elements
  float scale, softcap;
};

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;  // elements in 16 bytes
  __device__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16(x); }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float from(float x) { return x; }
};

template <typename T, int DH>
struct Shape {
  static constexpr int VEC = Elem<T>::VEC;
  static constexpr int ROWV = DH / VEC;                  // 16-byte vectors in a row
  static constexpr int KL = ROWV < 32 ? ROWV : 32;       // lanes on one key
  static constexpr int NV = ROWV / KL;                   // vectors a lane holds of a row
  static constexpr int EPT = NV * VEC;                   // elements a lane holds of a row
  static constexpr int NSLOT = NTHREADS / KL;            // keys a head group takes at once
  static constexpr int BT = TILE_BYTES / (DH * static_cast<int>(sizeof(T)));  // keys a tile
  static constexpr int R = BT / NSLOT;                   // keys of a tile a lane takes
  static constexpr int STAGE = 2 * TILE_BYTES + BT * 4;  // K, V and k_pos of a tile
  static_assert(R >= 1 && BT % NSLOT == 0, "a tile holds a whole number of key slots");
};

// shared memory of a block: the stages (later the slots' merge), then the
// tiles' liveness bytes
template <typename T, int DH, int HM>
__host__ __device__ constexpr int area_bytes(int head_groups) {
  using S = Shape<T, DH>;
  const int merge = head_groups * S::NSLOT * HM * (DH + 2) * 4;
  return STAGES * S::STAGE > merge ? STAGES * S::STAGE : merge;
}

__device__ __forceinline__ bool attendable(int kp, int pos, int window) {
  return kp >= 0 && kp <= pos && (window == 0 || kp > pos - window);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the last 16 - bytes of them zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int DH, int HM>
__global__ void __launch_bounds__(NTHREADS* MAX_HEAD_GROUPS)
    decode_attention_kernel(const Params p) {
  using E = Elem<T>;
  using S = Shape<T, DH>;
  constexpr int VEC = S::VEC, ROWV = S::ROWV, KL = S::KL, NV = S::NV, EPT = S::EPT;
  constexpr int NSLOT = S::NSLOT, BT = S::BT, R = S::R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x / p.G, g = blockIdx.x - b * p.G;
  const int split = blockIdx.y;
  const int hg = threadIdx.y, tid = threadIdx.x;
  const int flat = hg * NTHREADS + tid, nthreads = NTHREADS * blockDim.y;
  const int slot = tid / KL, lane = tid - slot * KL;
  const int pos = *p.pos;
  const int s0 = split * p.split_len;
  const int s1 = min(s0 + p.split_len, p.cap);
  const int n_tiles = s1 > s0 ? (s1 - s0 + BT - 1) / BT : 0;
  unsigned char* live = smem + area_bytes<T, DH, HM>(blockDim.y);

  // which tiles hold an attendable slot
  for (int t = flat; t < n_tiles; t += nthreads) live[t] = 0;
  __syncthreads();
  for (int s = s0 + flat; s < s1; s += nthreads) {
    if (attendable(p.k_pos[s], pos, p.window)) live[(s - s0) / BT] = 1;
  }
  __syncthreads();

  // this head group's query heads, the lane's columns of each, in f32
  float qf[HM][EPT];
#pragma unroll
  for (int m = 0; m < HM; ++m) {
    const int hl = hg * HM + m;
    const T* qr = static_cast<const T*>(p.q) + b * p.q_sb + (g * p.M + hl) * p.q_sh;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[m][v * VEC + e] = hl < p.M ? E::load(qr + (v * KL + lane) * VEC + e) : 0.f;
      }
    }
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  auto next_live = [&](int t) {
    for (++t; t < n_tiles && !live[t]; ++t) {
    }
    return t;
  };
  auto load_tile = [&](int t, int st) {
    T* ks = reinterpret_cast<T*>(smem + st * S::STAGE);
    T* vs = ks + BT * DH;
    int* ps = reinterpret_cast<int*>(vs + BT * DH);
    const int first = s0 + t * BT;
    for (int i = flat; i < BT * ROWV; i += nthreads) {
      const int r = i / ROWV, c = i - r * ROWV;
      const bool in = first + r < s1;  // else zeros: the slot is another split's or past cap
      const long long s = in ? first + r : first;
      cp_async16(ks + r * DH + c * VEC, kb + s * p.k_ss + c * VEC, in ? 16 : 0);
      cp_async16(vs + r * DH + c * VEC, vb + s * p.v_ss + c * VEC, in ? 16 : 0);
    }
    for (int r = flat; r < BT; r += nthreads) {
      if (first + r < s1) {
        cp_async4(ps + r, p.k_pos + first + r);
      } else {
        ps[r] = -1;
      }
    }
  };

  float m_run[HM], l_run[HM], o[HM][EPT];
#pragma unroll
  for (int m = 0; m < HM; ++m) {
    m_run[m] = -INFINITY;
    l_run[m] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) o[m][e] = 0.f;
  }

  int load_t = next_live(-1);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (load_t < n_tiles) {
      load_tile(load_t, st);
      load_t = next_live(load_t);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int t = next_live(-1); t < n_tiles; t = next_live(t)) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the tile has landed, and every thread is done with the last one
    if (load_t < n_tiles) {
      load_tile(load_t, (stage + STAGES - 1) % STAGES);
      load_t = next_live(load_t);
    }
    cp_async_commit();

    const T* ks = reinterpret_cast<const T*>(smem + stage * S::STAGE);
    const T* vs = ks + BT * DH;
    const int* ps = reinterpret_cast<const int*>(vs + BT * DH);
    float sc[R][HM];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = slot + r * NSLOT;
      float acc[HM];
#pragma unroll
      for (int m = 0; m < HM; ++m) acc[m] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kf[VEC];
        E::unpack(*reinterpret_cast<const uint4*>(ks + row * DH + (v * KL + lane) * VEC), kf);
#pragma unroll
        for (int m = 0; m < HM; ++m) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[m] = fmaf(qf[m][v * VEC + e], kf[e], acc[m]);
        }
      }
#pragma unroll
      for (int off = KL / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int m = 0; m < HM; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      }
      const bool ok = attendable(ps[row], pos, p.window);
#pragma unroll
      for (int m = 0; m < HM; ++m) {
        float s = acc[m] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        sc[r][m] = ok ? s : -INFINITY;
      }
    }
    // the slot's online softmax over the tile's keys it took
#pragma unroll
    for (int m = 0; m < HM; ++m) {
      float mx = m_run[m];
#pragma unroll
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, sc[r][m]);
      const float mu = mx == -INFINITY ? 0.f : mx;  // nothing attendable yet: all weights 0
      const float alpha = expf(m_run[m] - mu);
      m_run[m] = mx;
      l_run[m] *= alpha;
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[m][e] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sc[r][m] = expf(sc[r][m] - mu);
        l_run[m] += sc[r][m];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = slot + r * NSLOT;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float vf[VEC];
        E::unpack(*reinterpret_cast<const uint4*>(vs + row * DH + (v * KL + lane) * VEC), vf);
#pragma unroll
        for (int m = 0; m < HM; ++m) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o[m][v * VEC + e] = fmaf(sc[r][m], vf[e], o[m][v * VEC + e]);
          }
        }
      }
    }
    stage = (stage + 1) % STAGES;
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the key slots of each head, in slot order
  float* mo = reinterpret_cast<float*>(smem);          // [group][slot][head][dh]
  float* mml = mo + blockDim.y * NSLOT * HM * DH;       // [group][slot][head][2]
  const int base = (hg * NSLOT + slot) * HM;
#pragma unroll
  for (int m = 0; m < HM; ++m) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) mo[(base + m) * DH + (v * KL + lane) * VEC + e] = o[m][v * VEC + e];
    }
    if (lane == 0) {
      mml[(base + m) * 2] = m_run[m];
      mml[(base + m) * 2 + 1] = l_run[m];
    }
  }
  __syncthreads();
  for (int i = tid; i < HM * DH; i += NTHREADS) {
    const int m = i / DH, d = i - m * DH;
    const int hl = hg * HM + m;
    if (hl >= p.M) continue;
    float mx = -INFINITY;
    for (int s = 0; s < NSLOT; ++s) mx = fmaxf(mx, mml[((hg * NSLOT + s) * HM + m) * 2]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < NSLOT; ++s) {
      const int j = (hg * NSLOT + s) * HM + m;
      const float w = expf(mml[j * 2] - mu);
      l = fmaf(w, mml[j * 2 + 1], l);
      acc = fmaf(w, mo[j * DH + d], acc);
    }
    const long long row = static_cast<long long>(b) * p.H + g * p.M + hl;
    if (p.n_split == 1) {
      static_cast<T*>(p.out)[row * DH + d] = E::from(l > 0.f ? acc / l : 0.f);
    } else {
      const long long at = row * p.n_split + split;
      p.part_o[at * DH + d] = acc;
      if (d == 0) {
        p.part_ml[at * 2] = mx;
        p.part_ml[at * 2 + 1] = l;
      }
    }
  }
}

// the splits of one (b, h): one thread a column, the splits in order
template <typename T>
__global__ void decode_attention_merge(const Params p, int dh) {
  const long long row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float* ml = p.part_ml + row * p.n_split * 2;
  float mx = -INFINITY;
  for (int s = 0; s < p.n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < p.n_split; ++s) {
    const float w = expf(ml[2 * s] - mu);  // a split with nothing attendable: m = -inf, w = 0
    l = fmaf(w, ml[2 * s + 1], l);
    acc = fmaf(w, p.part_o[(row * p.n_split + s) * dh + d], acc);
  }
  static_cast<T*>(p.out)[row * dh + d] = Elem<T>::from(l > 0.f ? acc / l : 0.f);
}

template <typename T, int DH, int HM>
cudaError_t launch(const Params& p, int head_groups, cudaStream_t stream) {
  using S = Shape<T, DH>;
  if (p.split_len % S::BT != 0 || p.split_len / S::BT > MAX_TILES) return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<T, DH, HM>;
  const int smem = area_bytes<T, DH, HM>(head_groups) + MAX_TILES;
  // on every call, for the current device (the attribute is a device's), at
  // the largest block, so that a graph captured at a larger block than this
  // call's still launches; not a stream operation, so a capture allows it
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         area_bytes<T, DH, HM>(MAX_HEAD_GROUPS) + MAX_TILES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.B * p.G, p.n_split), dim3(NTHREADS, head_groups), smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  decode_attention_merge<T><<<p.B * p.H, DH, 0, stream>>>(p, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_heads(const Params& p, cudaStream_t stream) {
  if (p.M == 1) return launch<T, DH, 1>(p, 1, stream);
  if (p.M == 2) return launch<T, DH, 2>(p, 1, stream);
  if (p.M <= 4) return launch<T, DH, 4>(p, 1, stream);
  return launch<T, DH, MAX_HM>(p, (p.M + MAX_HM - 1) / MAX_HM, stream);
}

template <typename T>
cudaError_t dispatch(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return dispatch_heads<T, 32>(p, stream);
    case 64: return dispatch_heads<T, 64>(p, stream);
    case 128: return dispatch_heads<T, 128>(p, stream);
    case 256: return dispatch_heads<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, dh); k, v: (B, cap, G, dh); k_pos: (cap,) int32; pos: 0-d int32;
// out: (B, H, dh) contiguous, q's type.  strides holds, in elements, q's
// (batch, head) strides, then k's and v's (batch, slot, head) strides; the dh
// axis is contiguous.  The cache's slots split into n_split ranges of
// split_len (a multiple of the tile's keys; the last range may be short);
// with n_split > 1, part_o holds B * H * n_split * dh floats and part_ml
// B * H * n_split * 2.  Returns the launches' cudaError_t (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* k_pos, const int* pos, void* out, float* part_o,
                                    float* part_ml, int is_bf16, int B, int H, int G, int cap,
                                    int dh, const long long* strides, int window,
                                    float softcap, float scale, int n_split, int split_len,
                                    void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || cap <= 0 || H % G != 0 || H / G > MAX_HM * MAX_HEAD_GROUPS ||
      n_split <= 0 || n_split > 65535 || split_len <= 0 ||
      static_cast<long long>(B) * G > 0x7fffffffLL || static_cast<long long>(B) * H > 0x7fffffffLL ||
      static_cast<long long>(n_split - 1) * split_len >= cap ||
      static_cast<long long>(n_split) * split_len < cap ||
      (n_split > 1 && (part_o == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_pos = k_pos;
  p.pos = pos;
  p.out = out;
  p.part_o = part_o;
  p.part_ml = part_ml;
  p.B = B;
  p.H = H;
  p.G = G;
  p.M = H / G;
  p.cap = cap;
  p.window = window;
  p.n_split = n_split;
  p.split_len = split_len;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_ss = strides[3];
  p.k_sg = strides[4];
  p.v_sb = strides[5];
  p.v_ss = strides[6];
  p.v_sg = strides[7];
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, dh, s) : dispatch<float>(p, dh, s);
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
