// The bf16 flash-attention forward for Hopper (sm_90a): wgmma on the tensor
// cores, TMA loads into rings of K and V tiles kept full by one producer
// thread.  Included by flash_attention.cu, whose note at the top gives the
// function, the bound and the design; this file holds the device code and
// its launch.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace hopper {

constexpr int STAGES = 2;         // K and V tiles in each ring
constexpr int PRODUCER_REGS = 24;  // setmaxnreg of the producer warpgroup: one thread
                                   // works, and a spill there costs nothing that waits
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

// Tile shapes for one head dimension.  A block is NWG consumer warpgroups
// of 64 query rows and one producer warpgroup; MINB blocks share an SM.  A
// shared-memory row is one TMA box row: 64 columns (128 bytes, 128-byte
// swizzle) or, at dh=32, 32 columns (64 bytes, 64-byte swizzle).  A tile of
// DH columns is NBOX such boxes, each a [rows][BOX] block, one after another.
// dh <= 64: one consumer warpgroup, several blocks an SM, so that one
// block's loads, first product and epilogue overlap another's work; dh >=
// 128: two consumer warpgroups, one block an SM (its tiles fill shared memory).
template <int DH>
struct Cfg {
  static constexpr int NWG = DH <= 64 ? 1 : 2;
  static constexpr int MINB = DH <= 64 ? 2 : 1;
  static constexpr int BQ = 64 * NWG;                // query rows per block
  static constexpr int NTHREADS = 128 * (NWG + 1);   // + the producer warpgroup
  static constexpr int BK = DH == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int BOX = DH < 64 ? DH : 64;
  static constexpr int NBOX = DH / BOX;
  static constexpr int ROW = BOX * 2;  // bytes
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;  // K or V, one stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment
  static_assert(MINB * (SMEM + 1024) <= 233472, "the blocks of an SM exceed its shared memory");
  // Registers.  ptxas gives each thread at entry what the SM's four 16384-
  // register files allow for MINB blocks of warps spread over them; setmaxnreg
  // then moves the producer warpgroup's share to the consumers within the
  // block's total.
  static constexpr int WARPS_PER_FILE = (NTHREADS / 32 * MINB + 3) / 4;
  static constexpr int ENTRY_REGS = 16384 / (32 * WARPS_PER_FILE) / 8 * 8;
  static constexpr int CONSUMER_REGS_MAX =
      (NTHREADS * ENTRY_REGS - 128 * PRODUCER_REGS) / (128 * NWG) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_MAX < 240 ? CONSUMER_REGS_MAX : 240;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;  // descriptor: 128B or 64B swizzle
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;
  int H, G, Sq, Sk, BH;
  int causal, window, q_offset;
  float softcap, softcap_inv, scale;
};

// One work item: a query tile of one (batch, head) and the key tiles it sees.
struct Item {
  int q0, b, h, g, t_begin, n_tiles;
};

// Items are numbered so that the last query tiles, which see the most keys
// under a causal mask, come first.  The key range starts at the first
// query's window and stops, under a causal mask, at the last query; tiles
// outside it are never loaded.
template <int BQ, int BK>
__device__ __forceinline__ Item item_at(const Params& p, int it) {
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int bh = it % p.BH;
  Item w;
  w.q0 = (n_qt - 1 - it / p.BH) * BQ;
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.g = w.h / (p.H / p.G);
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, min(BQ, p.Sq - w.q0) + w.q0 + p.q_offset);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, w.q0 + p.q_offset - p.window + 1);
  w.t_begin = k_begin / BK;
  w.n_tiles = max(0, (k_end + BK - 1) / BK - w.t_begin);
  return w;
}

// The item a persistent block takes in its round r: rows of gridDim.x items,
// walked forward on even rounds and backward on odd ones, so that a block
// that drew a heavy item early draws a light one next.
__device__ __forceinline__ int item_of_round(int r) {
  const int n = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  return r * n + ((r & 1) ? n - 1 - b : b);
}

// -- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives only where `cond` holds, without a branch (a branch between a
// wgmma and its wait makes ptxas serialize the wgmmas).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, uint32_t cond) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(cond)
      : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the registers across an
// asynchronous wgmma (it sees each asm as complete when issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// m64nNk16 products, f32 accumulators.  Thread t of the warpgroup holds
// d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2; the register A operand of `rs` is the same
// layout for a 64 x 16 tile, two bf16 a register.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d += A B: A (64 x 16) bf16 in registers, B (16 x 32) MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A B: A (64 x 16) and B (16 x 64) both K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += A B: A (64 x 16) bf16 in registers, B (16 x 64) MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A B: A (64 x 16) and B (16 x 128) both K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += A B: A (64 x 16) bf16 in registers, B (16 x 128) MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d += A B: A (64 x 16) bf16 in registers, B (16 x 256) MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65,"
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81,"
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
        "%125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
          "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
          "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// -- the kernel -----------------------------------------------------------------

// Ring slot and phase parity of the n-th tile through a ring of `stages`.
struct Slot {
  int s;
  uint32_t parity;
};

template <int STAGES>
__device__ __forceinline__ Slot slot(int n) {
  return {n % STAGES, static_cast<uint32_t>((n / STAGES) & 1)};
}

// What a consumer thread knows of its item: its two query rows' absolute
// positions, its warpgroup's first and last, and its columns in a chunk.
struct Rows {
  int qp0, wg_first, wg_last, col;
};

// Whether the key tile at k0 crosses the diagonal, the window's edge or the
// end of the keys for any row of the warpgroup; only such tiles are masked.
template <int BK>
__device__ __forceinline__ bool needs_mask(const Params& p, const Rows& rw, int k0) {
  return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > rw.wg_first) ||
         (p.window > 0 && k0 <= rw.wg_last - p.window);
}

// S = Q K^T for this warpgroup's 64 rows (issued, not awaited): Q and the K
// tile in slot `sK` are both K-major; the k loop steps across the boxes.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<DH>::BK / 2], uint32_t sQ, uint32_t sK,
                                         int wg) {
  using C = Cfg<DH>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t box = kk * 16 / C::BOX, within = (kk * 16 % C::BOX) * 2;
    const uint64_t da = smem_desc(sQ + box * C::BQ * C::ROW + 64 * wg * C::ROW + within, 16,
                                  8 * C::ROW, C::LAYOUT);
    const uint64_t db = smem_desc(sK + box * C::BK * C::ROW + within, 16, 8 * C::ROW, C::LAYOUT);
    Wgmma<C::BK>::ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V (issued, not awaited): P from registers, V (keys x dh, dh
// contiguous) an MN-major operand whose dh boxes are LBO apart.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&pa)[Cfg<DH>::BK / 16][4], uint32_t sV) {
  using C = Cfg<DH>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    Wgmma<DH>::rs(o, pa[kk],
                  smem_desc(sV + kk * 16 * C::ROW, C::BK * C::ROW, 8 * C::ROW, C::LAYOUT));
  wgmma_commit();
}

// One tile of scores through the online softmax: scale (dh^-0.5 in f32),
// softcap, mask (MASK: tiles that need_mask), update the running max and sum
// of this thread's two rows, leave the f32 probabilities in sc (l sums them)
// and return in al0, al1 the factors the accumulator's rows must shrink by.
// A row's values lie in the four threads of a quad.  It has no branch: it
// runs while a P V is in flight.
template <int BK, bool MASK, bool SOFTCAP>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& al0, float& al1, const Params& p,
                                             const Rows& rw, int k0) {
  // Without softcap the scores stay unscaled: dh^-0.5 > 0 keeps their order,
  // so the row max is scaled once and the scale joins the exponent's FMA.  A
  // masked score is then NEG_INF unscaled; the m_safe guard treats it alike.
  if constexpr (SOFTCAP) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = p.softcap * tanhf(sc[j] * p.scale * p.softcap_inv);
  }
  const float sscale = SOFTCAP ? 1.f : p.scale;  // what still multiplies sc
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kp = k0 + 8 * (j / 4) + rw.col + j % 2;
      const int qp = rw.qp0 + ((j % 4) < 2 ? 0 : 8);
      const bool ok = (kp < p.Sk) & (!p.causal | (kp <= qp)) &
                      ((p.window <= 0) | (kp > qp - p.window));
      sc[j] = ok ? sc[j] : NEG_INF;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if ((j % 4) < 2) mx0 = fmaxf(mx0, sc[j]);
    else mx1 = fmaxf(mx1, sc[j]);
  }
#pragma unroll
  for (int x = 1; x <= 2; x *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  mx0 *= sscale;
  mx1 *= sscale;
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float ms0 = fmaxf(mn0, -1e30f), ms1 = fmaxf(mn1, -1e30f);  // fully masked rows
  al0 = exp2f((fmaxf(m0, -1e30f) - ms0) * LOG2E);
  al1 = exp2f((fmaxf(m1, -1e30f) - ms1) * LOG2E);
  m0 = mn0;
  m1 = mn1;
  const float nb0 = -ms0 * LOG2E, nb1 = -ms1 * LOG2E, sl2 = sscale * LOG2E;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const bool first = (j % 4) < 2;
    sc[j] = ex2(fmaf(sc[j], sl2, first ? nb0 : nb1));
    if (first) sum0 += sc[j];
    else sum1 += sc[j];
  }
#pragma unroll
  for (int x = 1; x <= 2; x *= 2) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
}

// P in bf16 as the A operand of P V: pairs of the accumulator layout, as
// they lie (the one rounding the Pallas kernel does not make).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2) pa[j / 8][(j % 8) / 2] = pack_bf16(sc[j], sc[j + 1]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(Cfg<DH>::NTHREADS, Cfg<DH>::MINB)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<DH>;
  constexpr int ST = STAGES, NWG = C::NWG;
  extern __shared__ uint8_t smem_raw[];
  // Q full and empty, then full[ST] and empty[ST] of the K ring, the same of the V ring
  __shared__ __align__(8) uint64_t bars[2 + 4 * ST];
  // swizzled tiles start on 1024-byte boundaries, where the swizzle pattern does
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;  // slot s at sK + s * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_k_full = bar_q + 16;  // + 8 s
  const uint32_t bar_k_empty = bar_k_full + 8 * ST;
  const uint32_t bar_v_full = bar_k_empty + 8 * ST;
  const uint32_t bar_v_empty = bar_v_full + 8 * ST;
  const int n_items = (p.Sq + C::BQ - 1) / C::BQ * p.BH;
  constexpr uint32_t CONSUMERS = NWG * 128;  // each thread arrives once on an empty barrier

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k_full + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, CONSUMERS);
      mbar_init(bar_v_full + 8 * s, 1);
      mbar_init(bar_v_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // Producer warpgroup: one thread keeps Q and both rings full, item after
    // item, so that the next item's loads overlap this one's last tiles; the
    // rest give their registers to the consumers and leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NWG * 128) {
      int n = 0;  // tiles loaded so far
      for (int r = 0, it; (it = item_of_round(r)) < n_items; ++r) {
        const Item w = item_at<C::BQ, C::BK>(p, it);
        mbar_wait(bar_q_empty, (r & 1) ^ 1);  // passes at once in round 0
        mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NBOX; ++c)
          tma_load(sQ + c * C::BQ * C::ROW, &tm_q, bar_q, c * C::BOX, w.q0, w.h, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++n) {
          const Slot sl = slot<ST>(n);
          const int k0 = (w.t_begin + i) * C::BK;
          const uint32_t off = sl.s * C::KV_BYTES;
          // a slot's empty phase passes at once on the first lap
          mbar_wait(bar_k_empty + 8 * sl.s, sl.parity ^ 1);
          mbar_expect_tx(bar_k_full + 8 * sl.s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NBOX; ++c)
            tma_load(sK + off + c * C::BK * C::ROW, &tm_k, bar_k_full + 8 * sl.s, c * C::BOX, k0,
                     w.g, w.b);
          mbar_wait(bar_v_empty + 8 * sl.s, sl.parity ^ 1);
          mbar_expect_tx(bar_v_full + 8 * sl.s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NBOX; ++c)
            tma_load(sV + off + c * C::BK * C::ROW, &tm_v, bar_v_full + 8 * sl.s, c * C::BOX, k0,
                     w.g, w.b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of each item's
    // tile.  Tile i's P V runs on the tensor cores while the softmax of tile
    // i + 1, whose Q K^T was issued just before it, runs beside it.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = 64 * wg + 16 * (t / 32) + lane / 4;  // this thread's rows: row, row + 8
    int n = 0;  // tiles consumed so far
    for (int r = 0, it; (it = item_of_round(r)) < n_items; ++r) {
      const Item w = item_at<C::BQ, C::BK>(p, it);
      Rows rw;
      rw.qp0 = w.q0 + row + p.q_offset;
      rw.wg_first = w.q0 + 64 * wg + p.q_offset;
      rw.wg_last = rw.wg_first + 63;
      rw.col = 2 * (lane % 4);  // + 8 j: this thread's columns in chunk j

      float o[DH / 2];
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
      uint32_t pa[C::BK / 16][4];

      mbar_wait(bar_q, r & 1);
      if (w.n_tiles == 0) {
        mbar_arrive(bar_q_empty);
      } else {
        // tile 0: Q K^T alone, then its softmax
        float sc[C::BK / 2];
        Slot sl = slot<ST>(n);
        int k0 = w.t_begin * C::BK;
        mbar_wait(bar_k_full + 8 * sl.s, sl.parity);
        issue_qk<DH>(sc, sQ, sK + sl.s * C::KV_BYTES, wg);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(bar_k_empty + 8 * sl.s);
        mbar_arrive_if(bar_q_empty, w.n_tiles == 1);  // Q is read
        if (needs_mask<C::BK>(p, rw, k0))
          softmax_tile<C::BK, true, SOFTCAP>(sc, m0, m1, l0, l1, al0, al1, p, rw, k0);
        else
          softmax_tile<C::BK, false, SOFTCAP>(sc, m0, m1, l0, l1, al0, al1, p, rw, k0);
        pack_p<C::BK>(sc, pa);

        // Tiles i and i + 1 together: wait for K of i + 1 and V of i, issue
        // Q K^T of i + 1 and P V of i back to back, run the softmax of i + 1
        // while P V of i is on the tensor cores.  Nothing between a batch and
        // its wait branches or writes a wgmma's registers (ptxas would
        // serialize the wgmmas), so the mask is chosen before the batch.
        auto step = [&](auto mask, int i) {
          const Slot nx = slot<ST>(n + 1);
          float sn[C::BK / 2];
          mbar_wait(bar_k_full + 8 * nx.s, nx.parity);
          mbar_wait(bar_v_full + 8 * sl.s, sl.parity);
          fence_regs(o);
          issue_qk<DH>(sn, sQ, sK + nx.s * C::KV_BYTES, wg);
          issue_pv<DH>(o, pa, sV + sl.s * C::KV_BYTES);
          wgmma_wait<1>();  // Q K^T of tile i + 1 is done
          fence_regs(sn);
          mbar_arrive(bar_k_empty + 8 * nx.s);
          mbar_arrive_if(bar_q_empty, i + 2 == w.n_tiles);  // Q is read
          softmax_tile<C::BK, decltype(mask)::value, SOFTCAP>(sn, m0, m1, l0, l1, al0, al1, p,
                                                              rw, k0);
          wgmma_wait<0>();  // P V of tile i is done; it read pa until now, so P
                            // of tile i + 1 is packed only here
          fence_regs(o);
          fence_regs(pa);
          mbar_arrive(bar_v_empty + 8 * sl.s);
#pragma unroll
          for (int j = 0; j < DH / 2; ++j) o[j] *= (j % 4) < 2 ? al0 : al1;
          pack_p<C::BK>(sn, pa);
        };
        // tiles 1 .. a and b .. n - 1 need a mask, the ones between do not
        int a = 0, b = w.n_tiles;
        while (a + 1 < w.n_tiles && needs_mask<C::BK>(p, rw, (w.t_begin + a + 1) * C::BK)) ++a;
        while (b - 1 > a && needs_mask<C::BK>(p, rw, (w.t_begin + b - 1) * C::BK)) --b;
        int i = 0;
        for (; i + 1 <= a; ++i, ++n) {
          sl = slot<ST>(n);
          k0 += C::BK;
          step(std::true_type{}, i);
        }
        for (; i + 1 < b; ++i, ++n) {
          sl = slot<ST>(n);
          k0 += C::BK;
          step(std::false_type{}, i);
        }
        for (; i + 1 < w.n_tiles; ++i, ++n) {
          sl = slot<ST>(n);
          k0 += C::BK;
          step(std::true_type{}, i);
        }
        sl = slot<ST>(n);  // the last tile's P V
        mbar_wait(bar_v_full + 8 * sl.s, sl.parity);
        fence_regs(o);
        issue_pv<DH>(o, pa, sV + sl.s * C::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(bar_v_empty + 8 * sl.s);
        ++n;
      }

      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + w.b * p.o_sb + w.h * p.o_sh;
#pragma unroll
      for (int j = 0; j < DH / 2; j += 2) {
        const bool first = (j % 4) < 2;
        const int r_out = w.q0 + row + (first ? 0 : 8);
        if (r_out < p.Sq) {
          const float inv = first ? inv0 : inv1;
          *reinterpret_cast<__nv_bfloat162*>(out + r_out * p.o_ss + 8 * (j / 4) + rw.col) =
              __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
        }
      }
    }
  }
}

// -- host -----------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function.  It is taken through the
// runtime's cudaGetDriverEntryPoint, so the library links against the
// runtime alone and the build flags need no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_ENTRY_POINT = 200000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 100000;   // + the CUresult of a failed encode
constexpr int ERR_REGISTERS = 300000;    // the entry register count is not Cfg's

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (batch, heads, seq, dh) bf16 view with element strides (sb, sh, ss) and
// a contiguous dh axis, as a 4-d map whose boxes are `rows` x BOX, unit on
// the batch and head axes.  Rows past `seq` read as zeros.
template <int DH>
int tensor_map(CUtensorMap* map, const void* ptr, int batch, int heads, int seq, long long sb,
               long long sh, long long ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Cfg<DH>::BOX),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              Cfg<DH>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(res);
}

// strides: (batch, head, seq) element strides of q, k, v and o, in that order.
template <int DH, bool SOFTCAP>
int launch(const void* q, const void* k, const void* v, Params p, int B, const long long* st,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map<DH>(&tq, q, B, p.H, p.Sq, st[0], st[1], st[2], Cfg<DH>::BQ);
  if (err == 0) err = tensor_map<DH>(&tk, k, B, p.G, p.Sk, st[3], st[4], st[5], Cfg<DH>::BK);
  if (err == 0) err = tensor_map<DH>(&tv, v, B, p.G, p.Sk, st[6], st[7], st[8], Cfg<DH>::BK);
  if (err != 0) return err;
  // setmaxnreg.inc waits for registers the block does not have if ptxas gave
  // the kernel another entry count than Cfg assumes: refuse to launch then
  static int entry_ok = 0;  // 1 checked and right, -1 checked and wrong
  cudaError_t cerr;
  if (entry_ok == 0) {
    cudaFuncAttributes attr;
    cerr = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_kernel<DH, SOFTCAP>);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    entry_ok = attr.numRegs == Cfg<DH>::ENTRY_REGS ? 1 : -1;
  }
  if (entry_ok < 0) return ERR_REGISTERS;
  cerr = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH, SOFTCAP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DH>::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int device = 0, n_sm = 0;
  cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  using C = Cfg<DH>;
  const int n_items = (p.Sq + C::BQ - 1) / C::BQ * p.BH;
  const int grid = n_items < n_sm * C::MINB ? n_items : n_sm * C::MINB;  // persistent blocks
  flash_fwd_wgmma_kernel<DH, SOFTCAP><<<grid, C::NTHREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool SOFTCAP>
int dispatch(const void* q, const void* k, const void* v, const Params& p, int B, int dh,
             const long long* strides, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32, SOFTCAP>(q, k, v, p, B, strides, stream);
    case 64: return launch<64, SOFTCAP>(q, k, v, p, B, strides, stream);
    case 128: return launch<128, SOFTCAP>(q, k, v, p, B, strides, stream);
    case 256: return launch<256, SOFTCAP>(q, k, v, p, B, strides, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The softcap is a template argument: the softmax runs beside an in-flight
// wgmma and must not branch.
inline int dispatch(const void* q, const void* k, const void* v, const Params& p, int B, int dh,
                    const long long* strides, cudaStream_t stream) {
  return p.softcap > 0.f ? dispatch<true>(q, k, v, p, B, dh, strides, stream)
                         : dispatch<false>(q, k, v, p, B, dh, strides, stream);
}

}  // namespace hopper
