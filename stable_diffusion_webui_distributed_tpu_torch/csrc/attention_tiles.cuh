// Tile machinery shared by the attention kernels K1 (flash_attention.cu)
// and K2 (ragged_attention.cu): tile sizes, the f32 kernel's shared-memory
// layout, bf16 fragment loads and packing, mma.sync m16n8k16 (bf16 in, f32
// accumulate), and the global -> shared tile copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdt_attn {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // f32 kernel: 16 x 16 threads
constexpr int kWarps = 4;      // bf16 kernel: 16 query rows per warp
constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------- f32 ----

__host__ __device__ constexpr int row_stride(int d) { return d | 1; }

__host__ __device__ constexpr size_t f32_smem_floats(int d) {
  return size_t(kBQ) * row_stride(d)        // q tile, pre-scaled
         + size_t(kBK) * row_stride(d)      // k tile
         + size_t(kBK) * d                  // v tile
         + size_t(kBQ) * (kBK + 1);         // probabilities
}

// --------------------------------------------------------------- bf16 ----
// bf16 values are moved as raw 16-bit words; only the products and the
// softmax see them as numbers.

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p is 4-byte aligned
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b on one m16n8k16 tile: a 16x16 row-major, b 16x8 col-major,
// bf16 in, f32 accumulate. Fragment layouts (lane = 4*g + i):
//   a0 (g, 2i..2i+1)    a1 (g+8, 2i..)    a2 (g, 2i+8..)    a3 (g+8, 2i+8..)
//   b0 (k 2i..2i+1, n g)                  b1 (k 2i+8.., n g)
//   c0 c1 (g, 2i..2i+1)                   c2 c3 (g+8, 2i..2i+1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Row strides in shared memory, in elements. DP + 8 and kBK + 8 are odd
// multiples of 4 words, so the 32-bit fragment reads of a warp (8 rows x 4
// words) land on 32 distinct banks.
__host__ __device__ constexpr int ld_qk(int dp) { return dp + 8; }
constexpr int kLdV = kBK + 8;

__host__ __device__ constexpr size_t bf16_smem_elems(int dp) {
  return size_t(kBQ + kBK) * ld_qk(dp)  // q tile, k tile: [row][dim]
         + size_t(dp) * kLdV;           // v tile, transposed: [dim][key]
}

// Copies rows [r0, r0 + rows) of one head into a [row][dim] tile of DP
// columns, zero past `n` rows or `d` columns. With `vec` (d, the strides and
// the base 8-element aligned) it moves 16 bytes a thread.
template <int DP, bool kTransposed>
__device__ __forceinline__ void load_tile(uint16_t* dst, int ld,
                                          const uint16_t* src,
                                          long long stride, int r0, int rows,
                                          int n, int d, bool vec) {
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < rows * kChunks; i += kWarps * 32) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n && c < d)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
      if (kTransposed) {
        const uint16_t* e = reinterpret_cast<const uint16_t*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = e[j];
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kWarps * 32) {
      const int r = i / DP;
      const int c = i - r * DP;
      const uint16_t val =
          r0 + r < n && c < d ? src[(r0 + r) * stride + c] : uint16_t(0);
      dst[kTransposed ? c * ld + r : r * ld + c] = val;
    }
  }
}

// ------------------------------------------------------------ launch ----

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// 16-byte loads need d, every stride and every base 8-element aligned
inline bool vec_loads(const void* q, const void* k, const void* v, int d,
                      Strides sq, Strides sk, Strides sv) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return d % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
         (sq.b | sq.t | sq.h | sk.b | sk.t | sk.h | sv.b | sv.t | sv.h) % 8 ==
             0;
}

// both kernels of each file are instantiated per 16 columns of head dim
#define SDT_CASES(X)                                                    \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
      X(14) X(15) X(16)

}  // namespace sdt_attn
