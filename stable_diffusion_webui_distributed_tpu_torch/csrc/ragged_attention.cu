// Ragged attention forward for Hopper (sm_90a): K1's attention with a
// per-batch-row valid length, for heterogeneous requests padded to one
// shape bucket.
//
// Replaces the TPU kernel of the JAX package's ops/ragged_attention.py
// (_ragged_kernel, _ragged_bhtd, wrapper ragged_attention). Same function
// as its ragged_attention_reference: keys at or past true_len[b] score
// MASK_VALUE = -1e30 before the softmax, and (when query masking is on)
// query rows at or past true_len[b] are written as 0; a row with no valid
// key (l == 0) is written as 0 too. Query masking is off for the UNet's
// cross-attention, whose queries are all kept while the 77*n context
// tokens are masked past each row's prompt length.
//
// Translation. The Pallas kernel scalar-prefetches a (B*H,) length vector
// and skips k-tiles past it with pl.when. Here the block reads true_len[b]
// (b = blockIdx.y / H) from the (B,) int32 device tensor itself: no host
// repeat, no sync, no length in the launch configuration, so one launch
// serves any mix of lengths. The key loop ends at cdiv(min(true_len, S),
// keys per tile), which saves the tail's FLOPs; on the general path K and
// V rows past the valid prefix are never read (the tile is zero-filled),
// on the Hopper path the V rows of the tail that a TMA box brings in are
// zeroed before use, so a padded tail, whatever it holds, leaves the
// output bit for bit unchanged. A query tile that starts
// at or past the valid prefix writes zeros and exits. Every k-tile the
// loop reaches holds at least one valid key, so the running max is finite
// from the first tile on and exp2f(-1e30 - m) underflows to exactly 0:
// the masked scores stay in f32 (they never pass through bf16).
//
// What bounds it on an H100 SXM is what bounds K1 (flash_attention.cu), on
// the valid work only: at SD1.5 512x768 level 0 with CFG and valid rows of
// 4096/5120/6144 tokens (H = 8, D = 40), 4*40*sum(tl^2)*H = 0.30 TFLOP is
// 0.31 ms on the tensor cores and sum(tl^2)*H = 1.9 G exps are 0.45 ms on
// the MUFUs, so the exps bound it. The design is K1's, in the same
// mainloop (attention_sm90.cuh, with the ragged length policy): TMA ring,
// wgmma for both products, the next tile's Q.K^T issued before this
// tile's softmax. Where the mainloop's TMA boxes bring rows of the padded
// tail into the last key tile, its consumers zero those V rows in shared
// memory first, so the tail stays inert. Cross-attention (S = 154 = 77*2,
// not a multiple of 16): both 128-key tiles of the context fit in the ring
// and are loaded once per block of 128 queries (half the reads of 64-query
// blocks), the last masked by min(true_len, S). The general path
// (mma.sync, as K1's) takes the shapes TMA cannot (see K1's note); f32 runs
// on scalar FMAs. Any T, any S and any D <= 256.

#include "attention_sm90.cuh"
#include "attention_tiles.cuh"

using namespace sdt_attn;

namespace {

constexpr float kMaskValue = -1e30f;  // the JAX package's MASK_VALUE

struct Ragged {
  const int* true_len;  // (B,) valid key prefix of each batch row
  bool mask_q;          // query rows at or past true_len are written as 0
};

// Valid keys and valid query rows of batch row b.
struct Valid {
  int kv, qv;
};

__device__ __forceinline__ Valid valid_lengths(const Ragged& rg, int b,
                                               int t_len, int s_len) {
  const int tl = max(rg.true_len[b], 0);
  return {min(tl, s_len), rg.mask_q ? min(tl, t_len) : t_len};
}

// A query tile wholly past the valid rows: write its rows as 0.
template <typename T>
__device__ void zero_tile(T* o, int b, int q0, int t_len, int heads, int h,
                          int d) {
  for (int i = threadIdx.x; i < kBQ * d; i += blockDim.x) {
    const int r = i / d;
    const int t = q0 + r;
    if (t < t_len)
      o[(((long long)b * t_len + t) * heads + h) * d + i - r * d] = T(0);
  }
}

// ---------------------------------------------------------------- f32 ----

// NJ = ceil(D / 16): output columns each thread accumulates.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
ragged_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int t_len,
               int s_len, int heads, int d, Strides sq, Strides sk,
               Strides sv, float q_scale, Ragged rg) {
  extern __shared__ float smem[];
  const int ld = row_stride(d);
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
  const Valid valid = valid_lengths(rg, b, t_len, s_len);
  const int kv = valid.kv, qv = valid.qv;
  if (q0 >= qv) {
    zero_tile(o, b, q0, t_len, heads, h, d);
    return;
  }

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = q0 + r;
    qs[r * ld + c] = t < qv ? qb[(long long)t * sq.t + c] * q_scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv; k0 += kBK) {
    __syncthreads();  // the q tile is in; the last tile's reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const int s = k0 + r;
      const bool in = s < kv;
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
      float qv4[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv4[i] = qs[(4 * ty + i) * ld + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv4[jj] = ks[(tx + 16 * jj) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sc[i][jj] = fmaf(qv4[i], kv4[jj], sc[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (k0 + tx + 16 * jj >= kv) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][jj] = kMaskValue;
      }
    }

    // Online softmax over this tile, base 2 (log2(e) is in q_scale). The 16
    // threads of a row group are one half-warp, so xor shuffles below 16
    // reduce within it. k0 < kv, so the tile holds a valid key and m_new
    // is finite.
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
    const bool keep = t < qv && l[i] > 0.f;
    const float inv = keep ? 1.f / l[i] : 0.f;
    float* ob = o + (((long long)b * t_len + t) * heads + h) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[c] = keep ? acc[i][j] * inv : 0.f;
    }
  }
}

// --------------------------------------------------------------- bf16 ----

// The general path (see sm90::sm90_path for the Hopper path's shapes).
// KS = DP / 16: the head dim padded to DP, in k-steps of 16.
template <int KS>
__global__ void __launch_bounds__(kWarps * 32)
ragged_fwd_bf16(const uint16_t* __restrict__ q,
                const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                int t_len, int s_len, int heads, int d, Strides sq,
                Strides sk, Strides sv, float qk_scale, bool vec, Ragged rg) {
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
  const Valid valid = valid_lengths(rg, b, t_len, s_len);
  const int kv = valid.kv, qv = valid.qv;
  if (q0 >= qv) {
    zero_tile(o, b, q0, t_len, heads, h, d);
    return;
  }

  load_tile<DP, false>(qs, LD, q + b * sq.b + h * sq.h, sq.t, q0, kBQ, qv,
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

  for (int k0 = 0; k0 < kv; k0 += kBK) {
    __syncthreads();  // the q tile is in; the last tile's reads are done
    load_tile<DP, false>(ks, LD, kb, sk.t, k0, kBK, kv, d, vec);
    load_tile<DP, true>(vt, kLdV, vb, sv.t, k0, kBK, kv, d, vec);
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

    // Online softmax, base 2 (log2(e) is in qk_scale), the scores in f32.
    // A row's 64 scores lie on the four lanes 4g..4g+3, so xor shuffles by
    // 1 and 2 reduce it. k0 < kv, so the tile holds a valid key, the new
    // max is finite and exp2f(-1e30 - max) is exactly 0.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const bool in0 = k0 + 8 * n + i2 < kv;
      const bool in1 = k0 + 8 * n + i2 + 1 < kv;
      sc[n][0] = in0 ? sc[n][0] * qk_scale : kMaskValue;
      sc[n][1] = in1 ? sc[n][1] * qk_scale : kMaskValue;
      sc[n][2] = in0 ? sc[n][2] * qk_scale : kMaskValue;
      sc[n][3] = in1 ? sc[n][3] * qk_scale : kMaskValue;
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
  const int ta = q0 + rw + g, tb = ta + 8;
  const bool keep0 = ta < qv && l0 > 0.f, keep1 = tb < qv && l1 > 0.f;
  const float inv0 = keep0 ? 1.f / l0 : 0.f, inv1 = keep1 ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(o);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + i2 + e;
      if (c >= d) continue;
      if (ta < t_len)
        ob[(((long long)b * t_len + ta) * heads + h) * d + c] =
            __float2bfloat16(keep0 ? acc[j][e] * inv0 : 0.f);
      if (tb < t_len)
        ob[(((long long)b * t_len + tb) * heads + h) * d + c] =
            __float2bfloat16(keep1 ? acc[j][2 + e] * inv1 : 0.f);
    }
  }
}

// ------------------------------------------------------------ launch ----

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_len, int s_len, int heads, int d,
                       Strides sq, Strides sk, Strides sv, float qk_scale,
                       Ragged rg, cudaStream_t stream) {
  const size_t bytes = f32_smem_floats(d) * sizeof(float);
  cudaError_t err = set_smem(ragged_fwd_f32<NJ>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  ragged_fwd_f32<NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_len, s_len,
      heads, d, sq, sk, sv, qk_scale, rg);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int t_len, int s_len, int heads, int d,
                        Strides sq, Strides sk, Strides sv, float qk_scale,
                        Ragged rg, cudaStream_t stream) {
  const size_t bytes = bf16_smem_elems(16 * KS) * sizeof(uint16_t);
  cudaError_t err = set_smem(ragged_fwd_bf16<KS>, bytes);
  if (err != cudaSuccess) return err;
  const bool vec = vec_loads(q, k, v, d, sq, sk, sv);
  const dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  ragged_fwd_bf16<KS><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_len,
      s_len, heads, d, sq, sk, sv, qk_scale, vec, rg);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int t_len, int s_len, int heads, int d,
                     Strides sq, Strides sk, Strides sv, float qk_scale,
                     Ragged rg, int dtype, bool hopper, cudaStream_t stream) {
  if (hopper)
    return sm90::dispatch<true>(q, k, v, o, batch, t_len, s_len, heads, d, sq,
                                sk, sv, qk_scale, rg.true_len, rg.mask_q,
                                stream);
#define SDT_CASE(N)                                                          \
  case N:                                                                    \
    return dtype == 0                                                        \
               ? launch_f32<N>(q, k, v, o, batch, t_len, s_len, heads, d, sq, \
                               sk, sv, qk_scale, rg, stream)                 \
               : launch_bf16<N>(q, k, v, o, batch, t_len, s_len, heads, d,   \
                                sq, sk, sv, qk_scale, rg, stream);
  switch ((d + 15) / 16) {
    SDT_CASES(SDT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef SDT_CASE
}

}  // namespace

// q (B,T,H,D), k/v (B,S,H,D) with element strides (b, t, h) and a contiguous
// last axis; true_len (B,) int32 on the device; o (B,T,H,D) contiguous.
// mask_q != 0 writes query rows at or past true_len as 0. dtype 0 = f32,
// 1 = bf16. Returns the path it launched (sm90::launched), or the negated
// cudaError_t.
extern "C" int sdt_ragged_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* true_len, int batch, int t_len, int s_len, int heads, int d,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, float scale, int mask_q, int dtype, void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || d < 1 ||
      d > kMaxD || batch * heads > 65535 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  const Strides sq{qsb, qst, qsh}, sk{ksb, kst, ksh}, sv{vsb, vst, vsh};
  const Ragged rg{true_len, mask_q != 0};
  const bool hopper = sm90::sm90_path(q, k, v, batch, t_len, s_len, heads, d,
                                      sq, sk, sv, scale, dtype);
  return sm90::launched(
      dispatch(q, k, v, o, batch, t_len, s_len, heads, d, sq, sk, sv,
               scale * kLog2e, rg, dtype, hopper,
               static_cast<cudaStream_t>(stream)),
      dtype, hopper);
}
