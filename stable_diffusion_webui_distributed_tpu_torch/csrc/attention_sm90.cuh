// The Hopper (sm_90a) bf16 mainloop shared by the attention kernels K1
// (flash_attention.cu) and K2 (ragged_attention.cu): one kernel template,
// instantiated per padded head dim, block height and length policy (dense
// for K1, a per-batch-row true_len for K2), so that a K2 call at full length
// runs K1's instructions in K1's order and gives K1's bits.
//
// Design.
// - Warp specialisation. Warpgroup 0 is the producer: one thread issues TMA
//   loads (cp.async.bulk.tensor through CUtensorMaps encoded on the host per
//   launch, passed as __grid_constant__ parameters) of the block's Q tile
//   once and of K/V tiles into a ring of stages, each with a full
//   and an empty mbarrier. Warpgroups 1..NC are consumers of 64 query rows
//   each; setmaxnreg moves registers from the producer to them.
// - Tensor cores through wgmma. S = Q K^T is m64nBKk16 with Q and K read
//   from shared memory, K-major. O += P V takes P from registers (the S
//   accumulator's layout is the A-operand layout, rounded to bf16) and V
//   from shared memory in its natural [key][dim] layout through the
//   transposed-B form (MN-major), so no thread transposes V.
// - Overlap (FA3's intra-warpgroup pipelining). Each iteration issues
//   S(j) = Q K(j)^T and then O += P(j-1) V(j-1) before it waits for S(j),
//   so the softmax of tile j (exps on the MUFUs) runs while the tensor
//   cores fold tile j-1 into O. A consumer holds two stages at a time (K of
//   tile j, V of tile j-1), so a ring of S stages runs S - 2 tiles ahead.
//   A second score buffer (issuing S(j+1) before the softmax of tile j)
//   does not fit: ptxas holds the consumers of a 384-thread block to the
//   168 registers a thread of the launch, setmaxnreg notwithstanding, and
//   two 128-key score buffers spilled.
// - Ping-pong (two consumer warpgroups, D >= 64): each issues its
//   products only after the other has issued its own (named barriers 3
//   and 4), so one warpgroup's softmax runs while the other's products are
//   on the tensor cores. At D = 40 the products are short and taking turns
//   measured slower, so there the two issue freely.
// - Layout without swizzle. D = 40 and 80 rows are 80 and 160 bytes, not
//   128, so a 128-byte swizzle would need D padded to 64 or 128 (1.6x the
//   tensor work at D = 40). Instead each tensor map is 5-D,
//   {8 elements, rows, D/8 chunks, heads, batch} with strides {2 bytes,
//   row, 16 bytes, head, batch}, and its box {8, rows, DP/8, 1, 1} lands in
//   shared memory as [chunk][row][8]: the no-swizzle core-matrix layout
//   (8 rows x 16 bytes contiguous) that wgmma reads directly. DP is D
//   rounded up to 16 (a k-step); the chunks past D are out of bounds and
//   TMA fills them with zeros, so D = 40 costs 48, 1.2x. Column slices of
//   a fused QKV projection (row strides 1920, 3840, 7680 bytes, head
//   offsets 80, 160, 320 bytes) are read in place.
// - Tiles (BK keys per stage, BQ = 64 * NC query rows per block):
//     DP  BK  stages  smem (NC = 2)            consumer registers (S, P, O)
//     48  128   5     12 + 5 x 24 KB = 132 KB  64 + 32 + 24
//     64  128   4     16 + 4 x 32 KB = 144 KB  64 + 32 + 32
//     80  128   4     20 + 4 x 40 KB = 180 KB  64 + 32 + 40
//    160   64   4     40 + 4 x 40 KB = 200 KB  32 + 16 + 80
//   within 227 KB and the 168 registers a thread of a 384-thread block
//   (setmaxnreg still hands the producer's share to the consumers at run
//   time); a 256-thread block (NC = 1) has 255 a thread and needs no
//   move. NC = 1 (64-row blocks) where T <= 256: level 2 and the
//   mid block have few query tiles, and 64-row blocks double their count.
// - Ragged lengths (K2). kv = min(true_len, S) keys and qv query rows. The
//   key loop ends at cdiv(kv, BK); keys at or past kv are masked by a
//   select on the last tile (see online_softmax). TMA brings whole boxes, so the last tile may
//   hold rows of the padded tail, which may be inf or NaN: the consumers
//   zero the V rows in [kv, S) of that stage before any product reads them
//   (0 * NaN would be NaN in P V; K's rows only reach masked scores). A
//   block whose first query row is at or past qv writes zeros and exits.
//
// Bounds and what this design does about them are in the note of each
// kernel's source. Shapes this path cannot take (bf16 with D % 8 != 0, DP
// not in {48, 64, 80, 160}, a base not 16-byte aligned, a stride that is no
// multiple of 16 bytes) go to the general mma.sync kernel; sm90_path()
// chooses before the launch, from shape, strides and alignment alone, and
// the C entry points return the path they launched (launched()).

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "attention_tiles.cuh"

// Internal linkage: each kernel's library holds its own copy, and the
// statics below (the per-kernel shared-memory flag, the encoder) are never
// merged across libraries loaded into one process.
namespace sdt_attn {
namespace sm90 {
namespace {

constexpr int kProducerRegs = 40;   // with two consumer warpgroups:
constexpr int kConsumerRegs = 232;  // 40 + 2 x 232 = 504 = 3 x 168

__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr bool padded_dim(int dp) {
  return dp == 48 || dp == 64 || dp == 80 || dp == 160;
}
__host__ __device__ constexpr int block_keys(int dp) {
  return dp > 128 ? 64 : 128;
}
// K/V stages of the ring: as many as fit beside the Q tile (see the table)
__host__ __device__ constexpr int ring_stages(int dp) {
  return dp == 48 ? 5 : 4;
}
constexpr size_t smem_bytes(int dp, int nc) {
  return 128  // alignment slack
         + size_t(64 * nc) * dp * 2 +
         size_t(2 * ring_stages(dp)) * block_keys(dp) * dp * 2 +
         size_t(1 + 2 * ring_stages(dp)) * 8;
}

// ------------------------------------------------------------ PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a pipeline fault) traps after some seconds, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c1, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %3, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1),
      "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders a register after the wgmma wait before it (an async product's
// operands and results are read or reused only after that wait).
__device__ __forceinline__ void hold(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// 2^x on the MUFU, one instruction (subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor, no swizzle: lbo is the byte step between
// core matrices along K, sbo along M/N (CUTLASS make_gmma_desc, INTERLEAVE).
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. ss: A and B from shared
// memory, both K-major; ScaleD 0 overwrites d. rs: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B MN-major, d accumulates.

template <int ScaleD>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(ScaleD));
}

template <int ScaleD>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(ScaleD));
}

__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "n"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, bool first) {
  if constexpr (N == 64) {
    first ? wgmma_ss_n64<0>(d, a, b) : wgmma_ss_n64<1>(d, a, b);
  } else {
    static_assert(N == 128, "score tiles are 64 or 128 keys");
    first ? wgmma_ss_n128<0>(d, a, b) : wgmma_ss_n128<1>(d, a, b);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (N == 48) wgmma_rs_n48(d, a0, a1, a2, a3, b);
  if constexpr (N == 64) wgmma_rs_n64(d, a0, a1, a2, a3, b);
  if constexpr (N == 80) wgmma_rs_n80(d, a0, a1, a2, a3, b);
  if constexpr (N == 160) wgmma_rs_n160(d, a0, a1, a2, a3, b);
}

// ------------------------------------------------------------ softmax ----

// Online softmax over one tile of BK keys for the thread's rows g and g + 8
// of its warp, base 2 (log2(e) is in qk_scale, which is > 0 on this path).
// A row's scores lie on the four lanes 4g..4g+3. The max is taken on the
// raw scores and the scale folded into one FFMA per exp: p = 2^(s * scale
// - m), m the scaled running max. kTail masks keys at or past kv by a
// select (whatever the product gave, inf or NaN included) to -inf, whose
// exp is exactly 0: the same as the JAX package's -1e30 score, since every
// tile the loop reaches holds a valid key (the new max is finite).
// kRowSum adds the exps into l; without it the row sums come from the
// tensor cores (a column of ones in V, see the kernel). The exps replace
// the scores.
template <int BK, bool kTail, bool kRowSum>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float& m0,
                                               float& m1, float& l0,
                                               float& l1, float& alpha0,
                                               float& alpha1, float qk_scale,
                                               int k0, int kv, int i2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    float* s = sc + 4 * n;
    if (kTail) {
      const bool in0 = k0 + 8 * n + i2 < kv;
      const bool in1 = k0 + 8 * n + i2 + 1 < kv;
      s[0] = in0 ? s[0] : -INFINITY;
      s[1] = in1 ? s[1] : -INFINITY;
      s[2] = in0 ? s[2] : -INFINITY;
      s[3] = in1 ? s[3] : -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[0], s[1]));
    mx1 = fmaxf(mx1, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * qk_scale);
  const float mn1 = fmaxf(m1, mx1 * qk_scale);
  alpha0 = ex2(m0 - mn0);
  alpha1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    float* s = sc + 4 * n;
    s[0] = ex2(fmaf(s[0], qk_scale, -mn0));
    s[1] = ex2(fmaf(s[1], qk_scale, -mn0));
    s[2] = ex2(fmaf(s[2], qk_scale, -mn1));
    s[3] = ex2(fmaf(s[3], qk_scale, -mn1));
    if (kRowSum) {
      rs0 += s[0] + s[1];
      rs1 += s[2] + s[3];
    }
  }
  if (kRowSum) {
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
  }
}

// ------------------------------------------------------------ kernel ----

// q, k, v: tensor maps of (B, rows, H, D) bf16 (see the note above); o
// (B, T, H, D) contiguous. kRagged: true_len (B,) int32 on the device,
// mask_q != 0 writes query rows at or past it as 0.
template <int DP, int NC, bool kRagged>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
attn_sm90(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
          int t_len, int s_len, int heads, int d, float qk_scale,
          const int* __restrict__ true_len, int mask_q) {
  constexpr int BK = block_keys(DP);
  constexpr int kStages = ring_stages(DP);
  // taking turns pays where the products are long (D >= 64); at DP = 48
  // they are short and the turns only delay their issue (measured with
  // tools/torch_attn_limits.py)
  constexpr bool kPingPong = NC == 2 && DP > 48;
  constexpr int BQ = 64 * NC;
  constexpr uint32_t kQBytes = BQ * DP * 2;
  constexpr uint32_t kTileBytes = BK * DP * 2;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  int kv = s_len, qv = t_len;
  if (kRagged) {
    const int tl = max(true_len[b], 0);
    kv = min(tl, s_len);
    if (mask_q) qv = min(tl, t_len);
    if (q0 >= qv) {  // a query tile wholly past the valid rows
      const int rows = min(BQ, t_len - q0);
      for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
        const int r = i / d;
        o[(((long long)b * t_len + q0 + r) * heads + h) * d + i - r * d] =
            __float2bfloat16(0.f);
      }
      return;
    }
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const uint32_t sq = smem_u32(smem);
  const uint32_t sk = sq + kQBytes;
  const uint32_t sv = sk + kStages * kTileBytes;
  const uint32_t bar_q = sv + kStages * kTileBytes;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  // D % 16 == 8 (D = 40 in DP = 48): K and V boxes carry the D/8 data
  // chunks and the last chunk of each stage is set here once and never
  // loaded: zeros in K, a column of ones (then zeros) in V. So P V also
  // yields each row's sum of P (bf16, as the product uses it), scaled by
  // alpha with the rest of O, and the softmax needs no row-sum adds.
  const bool ones = d % 16 != 0;
  if (ones) {
    uint8_t* spare = smem + kQBytes + (DP / 8 - 1) * BK * 16;
    for (int i = threadIdx.x; i < kStages * BK; i += blockDim.x) {
      const int st = i / BK, r = i - st * BK;
      *reinterpret_cast<uint4*>(spare + st * kTileBytes + r * 16) =
          make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(spare + (kStages + st) * kTileBytes +
                                r * 16) = make_uint4(0x3F80u, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const uint32_t kv_bytes = 2 * BK * (ones ? d : DP) * 2;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nt = (kv + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    if constexpr (NC == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      tma_load_5d(sq, &tq, bar_q, q0, h, b);
      for (int j = 0; j < nt; ++j) {
        const int s = j % kStages;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, kv_bytes);
        tma_load_5d(sk + s * kTileBytes, &tk, bar_full + 8 * s, j * BK, h, b);
        tma_load_5d(sv + s * kTileBytes, &tv, bar_full + 8 * s, j * BK, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    if constexpr (NC == 2) setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int i2 = 2 * (lane & 3);
    const uint32_t q_rows = sq + c * 64 * 16;

    float sc[BK / 2];
    float acc[DP / 2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float alpha0, alpha1;

    // S = Q K(j)^T
    auto issue_qk = [&](int j) {
      const uint32_t ks = sk + (j % kStages) * kTileBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t a = mat_desc(q_rows + kk * 2 * BQ * 16, BQ * 16, 128);
        const uint64_t bd = mat_desc(ks + kk * 2 * BK * 16, BK * 16, 128);
        wgmma_ss<BK>(sc, a, bd, kk == 0);
      }
      wg_commit();
    };
    // O += P V(j)
    auto issue_pv = [&](int j) {
      const uint32_t vs = sv + (j % kStages) * kTileBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bd = mat_desc(vs + kk * 256, 128, BK * 16);
        wgmma_rs<DP>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                     p[4 * kk + 3], bd);
      }
      wg_commit();
    };
    // waits for tile j; in K2 zeroes the V rows of its stage in [kv, S)
    auto acquire = [&](int j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      if (kRagged) {
        const int k0 = j * BK;
        const int r0 = kv - k0, r1 = min(BK, s_len - k0);
        if (r0 < r1) {
          uint8_t* vs = smem + (sv - sq) + s * kTileBytes;
          for (int i = tid; i < (r1 - r0) * (d / 8); i += 128) {
            const int r = r0 + i % (r1 - r0);
            const int ch = i / (r1 - r0);
            *reinterpret_cast<uint4*>(vs + (ch * BK + r) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        }
      }
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
    };
    auto softmax = [&](int j) {
      const int k0 = j * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hold(sc[i]);
      const bool tail = k0 + BK > kv;
      if (ones) {
        if (tail)
          online_softmax<BK, true, false>(sc, m0, m1, l0, l1, alpha0, alpha1,
                                          qk_scale, k0, kv, i2);
        else
          online_softmax<BK, false, false>(sc, m0, m1, l0, l1, alpha0,
                                           alpha1, qk_scale, k0, kv, i2);
      } else if (tail) {
        online_softmax<BK, true, true>(sc, m0, m1, l0, l1, alpha0, alpha1,
                                       qk_scale, k0, kv, i2);
      } else {
        online_softmax<BK, false, true>(sc, m0, m1, l0, l1, alpha0, alpha1,
                                        qk_scale, k0, kv, i2);
      }
    };
    // P V is read from p and written to acc: both wait for its end
    auto hold_pv = [&]() {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) hold(acc[i]);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) hold(p[i]);
    };
    auto to_p = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };
    // ping-pong: wait for this warpgroup's turn to issue products, and
    // pass the turn on after issuing (the other's last issue keeps it)
    auto turn = [&]() {
      if constexpr (kPingPong)
        asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
    };
    auto pass = [&](bool last) {
      if constexpr (kPingPong)
        if (!(last && c == 1))
          asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
    };

    mbar_wait(bar_q, 0);
    if (nt > 0) {
      if (kPingPong && c == 1)  // the first turn is warpgroup 0's
        asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      acquire(0);
      turn();
      issue_qk(0);
      pass(false);
      wg_wait<0>();
      softmax(0);
      to_p();
      for (int j = 1; j < nt; ++j) {
        acquire(j);
        turn();
        issue_qk(j);
        issue_pv(j - 1);
        pass(false);
        wg_wait<1>();  // S(j) is in; P(j-1) V(j-1) may still run
        softmax(j);
        wg_wait<0>();
        hold_pv();
        release(j - 1);
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          acc[4 * i] *= alpha0;
          acc[4 * i + 1] *= alpha0;
          acc[4 * i + 2] *= alpha1;
          acc[4 * i + 3] *= alpha1;
        }
        to_p();
      }
      turn();
      issue_pv(nt - 1);
      pass(true);
      wg_wait<0>();
      hold_pv();
      release(nt - 1);
    }

    if (ones) {  // the ones column, held by lane 4g of each quad
      l0 = __shfl_sync(0xffffffffu, acc[4 * (DP / 8 - 1)], lane & ~3);
      l1 = __shfl_sync(0xffffffffu, acc[4 * (DP / 8 - 1) + 2], lane & ~3);
    } else {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
    }
    const int ta = q0 + 64 * c + 16 * warp + g, tb = ta + 8;
    const bool keep0 = ta < qv && l0 > 0.f, keep1 = tb < qv && l1 > 0.f;
    const float inv0 = keep0 ? 1.f / l0 : 0.f, inv1 = keep1 ? 1.f / l1 : 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + i2;  // d % 8 == 0: col + 1 < d when col < d
      if (col >= d) continue;
      if (ta < t_len)
        *reinterpret_cast<uint32_t*>(
            o + (((long long)b * t_len + ta) * heads + h) * d + col) =
            pack_bf16(keep0 ? acc[4 * j] * inv0 : 0.f,
                      keep0 ? acc[4 * j + 1] * inv0 : 0.f);
      if (tb < t_len)
        *reinterpret_cast<uint32_t*>(
            o + (((long long)b * t_len + tb) * heads + h) * d + col) =
            pack_bf16(keep1 ? acc[4 * j + 2] * inv1 : 0.f,
                      keep1 ? acc[4 * j + 3] * inv1 : 0.f);
    }
  }
}

// ------------------------------------------------------------ host ----

// Whether a launch takes this path: bf16, a head dim with an instantiation,
// a positive scale (the softmax folds it into its exps), 16-byte aligned
// bases and strides that are multiples of 16 bytes (a stride of a dim of
// size 1 is never used and not checked).
inline bool sm90_path(const void* q, const void* k, const void* v, int batch,
                      int t_len, int s_len, int heads, int d, Strides sq,
                      Strides sk, Strides sv, float scale, int dtype) {
  if (dtype != 1 || d % 8 != 0 || !padded_dim(round16(d)) || !(scale > 0))
    return false;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  auto ok = [](long long stride, int size) {
    return size == 1 || stride % 8 == 0;
  };
  return ok(sq.b, batch) && ok(sq.t, t_len) && ok(sq.h, heads) &&
         ok(sk.b, batch) && ok(sk.t, s_len) && ok(sk.h, heads) &&
         ok(sv.b, batch) && ok(sv.t, s_len) && ok(sv.h, heads);
}

// What a C entry point returns for a launch that gave err: the path it took
// (0 = f32, 1 = the general bf16 kernel, 2 = this Hopper kernel), which the
// wrappers count, or the negated cudaError_t when nothing launched.
inline int launched(cudaError_t err, int dtype, bool hopper) {
  if (err != cudaSuccess) return -static_cast<int>(err);
  return hopper ? 2 : dtype == 0 ? 0 : 1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 5-D map {8, rows, D/8, heads, batch} of one (B, rows, H, D) operand
// with element strides s, box {8, box_rows, box_chunks, 1, 1}.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* base,
                   int batch, int rows, int heads, int d, Strides s,
                   int box_rows, int box_chunks) {
  auto bytes = [](long long stride, int size) {
    return cuuint64_t(size == 1 ? 16 : stride * 2);
  };
  const cuuint64_t dims[5] = {8, cuuint64_t(rows), cuuint64_t(d / 8),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[4] = {bytes(s.t, rows), 16, bytes(s.h, heads),
                                 bytes(s.b, batch)};
  const cuuint32_t box[5] = {8, cuuint32_t(box_rows), cuuint32_t(box_chunks),
                             1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared-memory limit is raised once per kernel and device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes,
                          std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = set_smem(kernel, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DP, int NC, bool kRagged>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int t_len, int s_len, int heads, int d,
                   Strides sq, Strides sk, Strides sv, float qk_scale,
                   const int* true_len, int mask_q, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  // K and V boxes leave out the spare chunk when D % 16 == 8 (the kernel
  // fills it); Q's box covers DP, the spare chunk zero-filled by TMA
  const int kv_chunks = d % 16 != 0 ? d / 8 : DP / 8;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, batch, t_len, heads, d, sq, 64 * NC, DP / 8) ||
      !encode(fn, &tk, k, batch, s_len, heads, d, sk, block_keys(DP),
              kv_chunks) ||
      !encode(fn, &tv, v, batch, s_len, heads, d, sv, block_keys(DP),
              kv_chunks))
    return cudaErrorInvalidValue;
  auto kernel = attn_sm90<DP, NC, kRagged>;
  constexpr size_t bytes = smem_bytes(DP, NC);
  const cudaError_t err = set_smem_once(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + 64 * NC - 1) / (64 * NC), batch * heads);
  kernel<<<grid, 128 * (NC + 1), bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), t_len, s_len, heads, d,
      qk_scale, true_len, mask_q);
  return cudaGetLastError();
}

// Picks the instantiation: 64-row blocks where T <= 256.
template <bool kRagged>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int t_len, int s_len, int heads, int d,
                     Strides sq, Strides sk, Strides sv, float qk_scale,
                     const int* true_len, int mask_q, cudaStream_t stream) {
#define SDT_SM90_CASE(DP)                                                    \
  case DP:                                                                   \
    return t_len > 256                                                       \
               ? launch<DP, 2, kRagged>(q, k, v, o, batch, t_len, s_len,    \
                                        heads, d, sq, sk, sv, qk_scale,      \
                                        true_len, mask_q, stream)            \
               : launch<DP, 1, kRagged>(q, k, v, o, batch, t_len, s_len,    \
                                        heads, d, sq, sk, sv, qk_scale,      \
                                        true_len, mask_q, stream);
  switch (round16(d)) {
    SDT_SM90_CASE(48)
    SDT_SM90_CASE(64)
    SDT_SM90_CASE(80)
    SDT_SM90_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef SDT_SM90_CASE
}

}  // namespace
}  // namespace sm90
}  // namespace sdt_attn
