// RG-LRU diagonal linear scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/kernel.py::rglru_scan (body _kernel)
// and computes the same function, for each of the B*W channels:
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0,   y_t = h_t
// a and b are (B, S, W) in f32 or bf16 with a contiguous last axis; y is a
// contiguous (B, S, W) in a's dtype; the carry and all arithmetic are f32.
//
// What bounds it.  One multiply-add per element, so the card's memory rate:
// at the serving path's prefill shape (B=4, S=512, W=4096, f32) a and b are
// read once and y written once, 3 x 33.55 MB = 100.66 MB, 30.0 us at
// 3.35 TB/s (H100 SXM).  The 8.4 M multiply-adds are nothing beside that.
//
// Design.  The TPU kernel walks a (B, W/128, S/128) grid with the chunk axis
// in order and carries h in VMEM.  A block per channel tile that loops over
// the whole of S in order would leave the card with B*W = 16,384 threads at
// that shape, each waiting on one load after another: bound by load latency,
// not bandwidth.  So S is cut into C <= MAX_CHUNKS chunks of L steps (L a
// multiple of SUB), and each (chunk, 128-channel tile, batch) is a block of
// its own, 2,048 blocks at the serving shape.  Two launches:
//   1. rglru_chunk_summary: for each chunk but the last, per channel, the
//      product of its a and its h from a zero carry, into an f32 workspace
//      (B, C-1, W) of each;
//   2. rglru_scan_kernel: each block folds the summaries of the chunks before
//      its own into its carry-in (at most C-1 multiply-adds), then runs the
//      recurrence over its chunk from that carry and writes y.
// Each thread keeps SUB steps of a and b in registers, all loads of them in
// flight before the first multiply-add, with neighbouring threads on
// neighbouring channels (one 128-byte row per warp in f32).  The price is a
// second read of a and b (about 1.6x the bound's bytes at the serving shape);
// launch 2 walks its blocks in the reverse order of launch 1, so that it
// starts on the tiles launch 1 read last, which are the likeliest to be in
// the 50 MB L2.  A single pass with a decoupled look-back would read them
// once; that is for a later version.
//
// Ragged S and W.  Steps at or past S take the identity (a = 1, b = 0) and
// write nothing; channels at or past W return at once.  So any S and W run
// here, and no shape goes to the plain version on the card.
//
// Decays reach about e^-48 at the model's draw, and products of a underflow
// to 0: that is the right limit, and nothing here divides by one.  Built
// without fast math, so denormals are kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 128;  // channels per block, one per thread
constexpr int SUB = 32;        // steps of a and b a thread holds in registers
constexpr int MAX_CHUNKS = 16;

struct Params {
  const void* a;
  const void* b;
  void* y;           // (B, S, W), contiguous
  float* sum_a;      // (B, C-1, W): product of a over each chunk but the last
  float* sum_h;      // (B, C-1, W): each such chunk's h from a zero carry
  int B, S, W;
  int L, C;          // chunk length (a multiple of SUB) and number of chunks
  long long a_sb, a_ss, b_sb, b_ss;  // batch and step strides, in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// SUB steps of one channel from step t0 into registers; steps at or past
// t_end take the identity.
template <typename T>
__device__ __forceinline__ void load_steps(const T* pa, const T* pb, const Params& p, int t0,
                                           int t_end, float (&av)[SUB], float (&bv)[SUB]) {
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int t = t0 + i;
    av[i] = t < t_end ? to_f32(pa[t * p.a_ss]) : 1.f;
    bv[i] = t < t_end ? to_f32(pb[t * p.b_ss]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) rglru_chunk_summary(Params p) {
  const int w = blockIdx.x * NTHREADS + threadIdx.x;
  if (w >= p.W) return;
  const int c = blockIdx.y;  // 0 .. C-2
  const int bi = blockIdx.z;
  const T* pa = static_cast<const T*>(p.a) + bi * p.a_sb + w;
  const T* pb = static_cast<const T*>(p.b) + bi * p.b_sb + w;
  const int t_begin = c * p.L;
  const int t_end = min(t_begin + p.L, p.S);
  float A = 1.f, H = 0.f;
  for (int t0 = t_begin; t0 < t_end; t0 += SUB) {
    float av[SUB], bv[SUB];
    load_steps(pa, pb, p, t0, t_end, av, bv);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      H = fmaf(av[i], H, bv[i]);
      A *= av[i];
    }
  }
  const long long o = (static_cast<long long>(bi) * (p.C - 1) + c) * p.W + w;
  p.sum_a[o] = A;
  p.sum_h[o] = H;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) rglru_scan_kernel(Params p) {
  const int w = blockIdx.x * NTHREADS + threadIdx.x;
  if (w >= p.W) return;
  // the reverse of rglru_chunk_summary's block order (see the note above)
  const int c = gridDim.y - 1 - blockIdx.y;
  const int bi = gridDim.z - 1 - blockIdx.z;
  float h = 0.f;
  const long long s0 = static_cast<long long>(bi) * (p.C - 1) * p.W + w;
  for (int j = 0; j < c; ++j) {
    h = fmaf(p.sum_a[s0 + static_cast<long long>(j) * p.W], h,
             p.sum_h[s0 + static_cast<long long>(j) * p.W]);
  }
  const T* pa = static_cast<const T*>(p.a) + bi * p.a_sb + w;
  const T* pb = static_cast<const T*>(p.b) + bi * p.b_sb + w;
  T* py = static_cast<T*>(p.y) + static_cast<long long>(bi) * p.S * p.W + w;
  const int t_begin = c * p.L;
  const int t_end = min(t_begin + p.L, p.S);
  for (int t0 = t_begin; t0 < t_end; t0 += SUB) {
    float av[SUB], bv[SUB];
    load_steps(pa, pb, p, t0, t_end, av, bv);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      h = fmaf(av[i], h, bv[i]);
      if (t0 + i < t_end) py[static_cast<long long>(t0 + i) * p.W] = from_f32<T>(h);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const unsigned tiles = (p.W + NTHREADS - 1) / NTHREADS;
  if (p.C > 1) {
    rglru_chunk_summary<T><<<dim3(tiles, p.C - 1, p.B), NTHREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_scan_kernel<T><<<dim3(tiles, p.C, p.B), NTHREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a, b: (B, S, W) with a contiguous last axis, (batch, step) strides in
// elements; y: (B, S, W) contiguous, in a's type.  L, the chunk length, is a
// multiple of 32 with ceil(S / L) <= 16 chunks; workspace holds 2 * B *
// (ceil(S / L) - 1) * W floats (none for a single chunk).  Returns the
// launches' cudaError_t (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* y, float* workspace,
                              int is_bf16, int B, int S, int W, int L, long long a_sb,
                              long long a_ss, long long b_sb, long long b_ss, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || L <= 0 || L % SUB != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = a;
  p.b = b;
  p.y = y;
  p.B = B;
  p.S = S;
  p.W = W;
  p.L = L;
  p.C = (S + L - 1) / L;
  if (p.C > MAX_CHUNKS || (p.C > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_sum = static_cast<long long>(B) * (p.C - 1) * W;
  p.sum_a = workspace;
  p.sum_h = workspace == nullptr ? nullptr : workspace + n_sum;
  p.a_sb = a_sb;
  p.a_ss = a_ss;
  p.b_sb = b_sb;
  p.b_ss = b_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
