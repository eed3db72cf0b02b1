// Flash attention forward for Hopper (sm_90a): non-causal
// softmax(q . k^T * scale) . v with an online softmax, output in q's dtype.
//
// Replaces the TPU kernel of the JAX package's ops/flash_attention.py
// (_attn_kernel, _flash_bhtd, wrapper flash_attention): the UNet's latent
// self-attention. Same function: scores and the running (m, l, acc) in f32,
// K/V streamed tile by tile so the (T x S) score matrix never reaches device
// memory.
//
// Translation. The TPU grid is (B*H, T/bq, S/bk) with the key axis run in
// order on one core and (m, l, acc) carried in VMEM scratch between grid
// steps. Here one block owns one (b*h, 64-row query tile) and a loop over
// 64-key tiles inside the block takes the place of the sequential third grid
// axis. K/V tiles are staged in shared memory. Any T and S are taken: the
// ragged edge is masked in the kernel (keys past S score -inf, query rows
// past T are not stored), so no dense fallback is needed. Any head dim
// D <= 256 is taken: the tiles are zero-padded to a multiple of 16 and the
// columns past D are neither read nor stored (40, 80 and 160 in SD1.5).
// Inputs have strides (b, t, h) and a contiguous last axis, so the q/k/v
// column slices of a fused QKV projection are read in place.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s, 132 SMs;
// the exp rate is 16 MUFU results per clock per SM at the 1.98 GHz boost
// clock, 4.18e12/s). At SD1.5 512^2 level 0 with CFG (B*H = 16,
// T = S = 4096, D = 40): 4*16*4096^2*40 = 42.9 GFLOP is 43 us on the tensor
// cores; 16*4096^2 = 268 M exp is 64 us on the MUFUs; q, k, v and o in bf16
// are 21 MB, 6 us. So at head dim 40 the exp throughput, not the tensor
// cores or the memory, is the bound; at D = 80 and 160 the two products
// catch up with it.
//
// What the design does about it. bf16 (the card policy, the main path)
// takes the Hopper path of attention_sm90.cuh wherever TMA can address the
// operands (D % 8 == 0 with D rounded up to 16 in {48, 64, 80, 160}, bases
// 16-byte aligned, strides multiples of 16 bytes: every K1 launch of the
// UNets): a producer warp keeps TMA loads of K/V tiles in flight in a
// four- or five-stage mbarrier ring, two consumer warpgroups of 64 query
// rows run both products on wgmma (P from registers, V read MN-major in
// place), and each issues a tile's Q.K^T with the previous tile's P.V
// before the tile's softmax, so the exps overlap P.V. 128-key tiles at
// D <= 80, 64 at D = 160; 64-row blocks where T <= 256. D = 40 pads to 48
// by TMA's out-of-bounds zero fill, 20% more tensor work, and the spare
// column of V carries ones, so the tensor cores also sum P. The softmax
// takes its max on the raw scores and folds the scale into one FFMA per
// exp. Measured on the card (tools/torch_attn_limits.py): no one unit
// bounds it at D = 40; dropping the exps, Q.K^T or the reloads saves at
// most a few percent and dropping P.V about a tenth, so the time is the
// latency chain of each consumer (max, exps, P.V) with two math warps a
// scheduler.
// General path (the other head dims, e.g. 33 or 1, and unaligned views):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), four warps of 16 query
// rows, the scores kept in registers between the products, K/V tiles
// loaded with plain loads. f32 (the f32 policy and the tests' reference
// runs): scalar f32 FMAs on the CUDA cores, each thread holding a 4 x 4
// block of scores and a 4 x ceil(D/16) block of the output, so that f32
// inputs keep f32 products (TF32 would not hold 2e-5 against the plain
// version).


#include "attention_sm90.cuh"
#include "attention_tiles.cuh"

using namespace sdt_attn;

namespace {

// ---------------------------------------------------------------- f32 ----

// NJ = ceil(D / 16): output columns each thread accumulates.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int t_len,
             int s_len, int heads, int d, Strides sq, Strides sk, Strides sv,
             float q_scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(d);  // odd: column reads across rows hit
                                 // distinct banks
  float* qs = smem;
  float* ks = qs + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* ps = vs + kBK * d;
  constexpr int kLdP = kBK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx + 16*jj, output cols tx + 16*j
  const int ty = tid >> 4;   // rows 4*ty .. 4*ty + 3
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = q0 + r;
    qs[r * ld + c] = t < t_len ? qb[(long long)t * sq.t + c] * q_scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < s_len; k0 += kBK) {
    __syncthreads();  // the q tile is in; the last tile's reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const int s = k0 + r;
      const bool in = s < s_len;
      ks[r * ld + c] = in ? kb[(long long)s * sk.t + c] : 0.f;
      vs[r * d + c] = in ? vb[(long long)s * sv.t + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * ld + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[(tx + 16 * jj) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (k0 + tx + 16 * jj >= s_len) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][jj] = -INFINITY;
      }
    }

    // Online softmax over this tile, base 2 (log2(e) is in q_scale). The 16
    // threads of a row group are one half-warp, so xor shuffles below 16
    // reduce within it. Every tile holds at least one key below s_len, so
    // m_new is finite and exp2f(-inf - m_new) is 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = exp2f(sc[i][jj] - m_new);
        ps[(4 * ty + i) * kLdP + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < d ? vs[kk * d + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= t_len) continue;
    const float inv = 1.f / l[i];
    float* ob = o + (((long long)b * t_len + t) * heads + h) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[c] = acc[i][j] * inv;
    }
  }
}

// --------------------------------------------------------------- bf16 ----

// The general path (see sm90::sm90_path for the Hopper path's shapes).
// KS = DP / 16: the head dim padded to DP, in k-steps of 16.
template <int KS>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
              int t_len, int s_len, int heads, int d, Strides sq, Strides sk,
              Strides sv, float qk_scale, bool vec) {
  constexpr int DP = 16 * KS;
  constexpr int LD = ld_qk(DP);
  constexpr int NS = kBK / 8;  // 8-key n-tiles of scores per warp
  constexpr int NO = DP / 8;   // 8-column n-tiles of output per warp
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* qs = smem16;
  uint16_t* ks = qs + kBQ * LD;
  uint16_t* vt = ks + kBK * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int i2 = 2 * (lane & 3);  // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int rw = 16 * warp;  // this warp's first row in the tile

  load_tile<DP, false>(qs, LD, q + b * sq.b + h * sq.h, sq.t, q0, kBQ, t_len,
                       d, vec);
  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;

  // rows g and g + 8 of the warp: running max, partial denominator (this
  // lane's columns only; the row's four lanes are summed at the end)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < s_len; k0 += kBK) {
    __syncthreads();  // the q tile is in; the last tile's reads are done
    load_tile<DP, false>(ks, LD, kb, sk.t, k0, kBK, s_len, d, vec);
    load_tile<DP, true>(vt, kLdV, vb, sv.t, k0, kBK, s_len, d, vec);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint16_t* qa = qs + (rw + g) * LD + 16 * kk + i2;
      const uint32_t a0 = ld_pair(qa), a1 = ld_pair(qa + 8 * LD);
      const uint32_t a2 = ld_pair(qa + 8), a3 = ld_pair(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const uint16_t* kp = ks + (8 * n + g) * LD + 16 * kk + i2;
        mma_bf16(sc[n], a0, a1, a2, a3, ld_pair(kp), ld_pair(kp + 8));
      }
    }

    // Online softmax, base 2 (log2(e) is in qk_scale). A row's 64 scores
    // lie on the four lanes 4g..4g+3, so xor shuffles by 1 and 2 reduce
    // it. Every tile holds a key below s_len, so the new max is finite and
    // exp2f(-inf - max) is 0.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const bool in0 = k0 + 8 * n + i2 < s_len;
      const bool in1 = k0 + 8 * n + i2 + 1 < s_len;
      sc[n][0] = in0 ? sc[n][0] * qk_scale : -INFINITY;
      sc[n][1] = in1 ? sc[n][1] * qk_scale : -INFINITY;
      sc[n][2] = in0 ? sc[n][2] * qk_scale : -INFINITY;
      sc[n][3] = in1 ? sc[n][3] * qk_scale : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // O += P V: score tiles 2kk and 2kk + 1 are the A operand of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const uint16_t* vp = vt + (8 * j + g) * kLdV + 16 * kk + i2;
        mma_bf16(acc[j], a0, a1, a2, a3, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int ta = q0 + rw + g, tb = ta + 8;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(o);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + i2 + e;
      if (c >= d) continue;
      if (ta < t_len)
        ob[(((long long)b * t_len + ta) * heads + h) * d + c] =
            __float2bfloat16(acc[j][e] * inv0);
      if (tb < t_len)
        ob[(((long long)b * t_len + tb) * heads + h) * d + c] =
            __float2bfloat16(acc[j][2 + e] * inv1);
    }
  }
}

// ------------------------------------------------------------ launch ----

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_len, int s_len, int heads, int d,
                       Strides sq, Strides sk, Strides sv, float qk_scale,
                       cudaStream_t stream) {
  const size_t bytes = f32_smem_floats(d) * sizeof(float);
  cudaError_t err = set_smem(attn_fwd_f32<NJ>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  attn_fwd_f32<NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_len, s_len,
      heads, d, sq, sk, sv, qk_scale);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int t_len, int s_len, int heads, int d,
                        Strides sq, Strides sk, Strides sv, float qk_scale,
                        cudaStream_t stream) {
  const size_t bytes = bf16_smem_elems(16 * KS) * sizeof(uint16_t);
  cudaError_t err = set_smem(attn_fwd_bf16<KS>, bytes);
  if (err != cudaSuccess) return err;
  const bool vec = vec_loads(q, k, v, d, sq, sk, sv);
  const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  attn_fwd_bf16<KS><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_len,
      s_len, heads, d, sq, sk, sv, qk_scale, vec);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int t_len, int s_len, int heads, int d,
                     Strides sq, Strides sk, Strides sv, float qk_scale,
                     int dtype, bool hopper, cudaStream_t stream) {
  if (hopper)
    return sm90::dispatch<false>(q, k, v, o, batch, t_len, s_len, heads, d,
                                 sq, sk, sv, qk_scale, nullptr, 0, stream);
#define SDT_CASE(N)                                                          \
  case N:                                                                    \
    return dtype == 0                                                        \
               ? launch_f32<N>(q, k, v, o, batch, t_len, s_len, heads, d, sq, \
                               sk, sv, qk_scale, stream)                     \
               : launch_bf16<N>(q, k, v, o, batch, t_len, s_len, heads, d,   \
                                sq, sk, sv, qk_scale, stream);
  switch ((d + 15) / 16) {
    SDT_CASES(SDT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef SDT_CASE
}

}  // namespace

// q (B,T,H,D), k/v (B,S,H,D) with element strides (b, t, h) and a contiguous
// last axis; o (B,T,H,D) contiguous. dtype 0 = f32, 1 = bf16. Returns the
// path it launched (sm90::launched), or the negated cudaError_t.
extern "C" int sdt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch,
    int t_len, int s_len, int heads, int d, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, float scale, int dtype,
    void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || d < 1 ||
      d > kMaxD || batch * heads > 65535 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  const Strides sq{qsb, qst, qsh}, sk{ksb, kst, ksh}, sv{vsb, vst, vsh};
  const bool hopper = sm90::sm90_path(q, k, v, batch, t_len, s_len, heads, d,
                                      sq, sk, sv, scale, dtype);
  return sm90::launched(
      dispatch(q, k, v, o, batch, t_len, s_len, heads, d, sq, sk, sv,
               scale * kLog2e, dtype, hopper,
               static_cast<cudaStream_t>(stream)),
      dtype, hopper);
}
