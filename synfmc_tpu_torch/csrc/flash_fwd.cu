// Flash attention forward on the packed (B, S, H*D) layout.
//
// Replaces synfmc_tpu/ops/flash_attention.py:_fwd_packed_kernel (called from
// _fwd_packed via _flash_fwd): per (batch row, head), softmax(q*scale K^T) V
// reading q/k/v at column offset h*D of each packed row.  The scale is
// applied to q in the operand type, logits and softmax are fp32, P enters PV
// rounded to the operand type, and the fp32 denominator divides the output.
//
// Bound: operations.  At the level-0 shape (B=32, S=1536, H=8, D=40) one call
// is 4*B*H*S^2*D = 96.6 GFLOP on 126 MB of q/k/v/o, ~770 FLOP/byte, above the
// H100's ~295 FLOP/byte ridge.  The TPU kernel kept one head's whole K/V
// resident in VMEM; at S=1536 that is 1536*40*2*2 = 245 KB, more than the
// 227 KB a Hopper block may hold, so this kernel streams K/V tiles through
// shared memory with an online softmax (running max and sum in fp32).
//
// bf16: one block per (q-tile of 64 rows, head, batch row), 4 warps of 16
// query rows each, FlashAttention-2 style on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), whose fragment layout is documented, so:
//   - S = Q K^T and the O accumulator stay in registers; a row's 64 logits
//     sit in the 4 lanes of a quad, so the row max and sum take 2 shuffles;
//   - P goes from the S accumulators straight into the A operand of PV;
//   - Q, K and V reach the tensor cores through ldmatrix (.trans for V)
//     from shared rows padded by 16 bytes against bank conflicts;
//   - K/V tiles of 64 keys are double-buffered with cp.async, the next
//     tile's copy overlapping this tile's math.
// The head dim is padded with zeros to a multiple of 16 (40 -> 48) and is a
// template parameter, so any D that is a multiple of 8 up to 256 works.
//
// When a gradient is wanted the kernel also writes each row's log-sum-exp
// m + log(l) in fp32 to lse (B, H, S), so that the backward (flash_bwd.cu)
// recomputes P = exp(S - lse) without a second softmax pass.
//
// fp32: a CUDA-core kernel (one thread per query row, K/V tiles in shared
// memory) with the same online softmax, for exact float32 checks.
#include "mma.cuh"

namespace {

using namespace synfmc;

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // keys per K/V tile
constexpr int kWarps = BQ / 16;

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int D, float scale) {
  constexpr int LDS = lds<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDS]
  __nv_bfloat16* Ks = Qs + BQ * LDS;                                // [2][BK][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BK * LDS;                            // [2][BK][LDS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nk = cdiv(S, BK);

  load_tile<DP, BK>(k + base, Ks, 0, S, C, h * D, D);
  load_tile<DP, BK>(v + base, Vs, 0, S, C, h * D, D);
  cp_commit();
  // Q tile, multiplied by the scale in bf16 as the TPU kernel does
  load_tile_scaled<DP, BQ>(q + base, Qs, q0, S, C, h * D, D, scale);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g+8

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next tile into the other buffer
      load_tile<DP, BK>(k + base, Ks + (buf ^ 1) * BK * LDS, (kt + 1) * BK, S, C, h * D, D);
      load_tile<DP, BK>(v + base, Vs + (buf ^ 1) * BK * LDS, (kt + 1) * BK, S, C, h * D, D);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BK * LDS;
    const __nv_bfloat16* Vt = Vs + buf * BK * LDS;

    // S = Q K^T for the warp's 16 rows x BK keys, fp32 in registers
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], a, bb[0], bb[1]);
        mma_bf16(s[2 * jp + 1], a, bb[2], bb[3]);
      }
    }

    // online softmax; a row's 64 columns live in the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kt * BK + 8 * j + 2 * t + (c & 1) >= S) s[j][c] = -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = __expf(s[j][c] - m_run[c >> 1]);
        rsum[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, with P (bf16) taken straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Vt + (kk * 16 + (lane & 15)) * LDS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    if (lse != nullptr && t == 0) lse[((size_t)b * H + h) * S + row] = m_run[r] + logf(l_run[r]);
    __nv_bfloat16* orow = o + base + (size_t)row * C + h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

// fp32 reference-precision path on the CUDA cores.
constexpr int FQ = 64;  // query rows (threads) per block
constexpr int FK = 32;  // keys per tile

__global__ void __launch_bounds__(FQ)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int S, int H, int D, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int ldq = D + 1;  // odd stride: per-thread rows on distinct banks
  float* Qs = fsm;
  float* Os = Qs + FQ * ldq;
  float* Ks = Os + FQ * ldq;
  float* Vs = Ks + FK * D;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const int t = threadIdx.x;

  for (int e = t; e < FQ * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    const int row = q0 + rr;
    Qs[rr * ldq + d] = row < S ? q[base + (size_t)row * C + h * D + d] * scale : 0.f;
    Os[rr * ldq + d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();
    for (int e = t; e < FK * D; e += blockDim.x) {
      const int rr = e / D, d = e % D;
      const int row = k0 + rr;
      Ks[e] = row < S ? k[base + (size_t)row * C + h * D + d] : 0.f;
      Vs[e] = row < S ? v[base + (size_t)row * C + h * D + d] : 0.f;
    }
    __syncthreads();
    float s[FK];
#pragma unroll
    for (int j = 0; j < FK; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[t * ldq + d];
#pragma unroll
      for (int j = 0; j < FK; ++j) s[j] += qd * Ks[j * D + d];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK; ++j)
      if (k0 + j < S) mx = fmaxf(mx, s[j]);
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      s[j] = (k0 + j < S) ? expf(s[j] - m_new) : 0.f;
      sum += s[j];
    }
    l_run = l_run * alpha + sum;
    m_run = m_new;
    for (int d = 0; d < D; ++d) {
      float acc = Os[t * ldq + d] * alpha;
#pragma unroll
      for (int j = 0; j < FK; ++j) acc += s[j] * Vs[j * D + d];
      Os[t * ldq + d] = acc;
    }
  }
  const float inv = 1.f / l_run;
  for (int d = 0; d < D; ++d) Os[t * ldq + d] *= inv;
  if (lse != nullptr && q0 + t < S) lse[((size_t)b * H + h) * S + q0 + t] = m_run + logf(l_run);
  __syncthreads();
  for (int e = t; e < FQ * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    if (q0 + rr < S) o[base + (size_t)(q0 + rr) * C + h * D + d] = Os[rr * ldq + d];
  }
}

}  // namespace

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BK) * lds<DP>() * sizeof(__nv_bfloat16);
  cudaError_t e = set_smem((const void*)flash_fwd_bf16<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(S, BQ), H, B);
  flash_fwd_bf16<DP><<<grid, kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, S, H, D, scale);
  return (int)cudaGetLastError();
}

// q, k, v, o: (B, S, H*D) contiguous, 16-byte aligned; D % 8 == 0, D <= 256.
// lse: (B, H, S) fp32, or null when no gradient is wanted.
SYNFMC_API int synfmc_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int S, int H, int D, float scale,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cdiv(D, 16) * 16) {  // head dim padded to the mma depth
#define SYNFMC_CASE(DP) \
  case DP:              \
    return launch_bf16<DP>(q, k, v, o, lse, B, S, H, D, scale, st);
    SYNFMC_FOR_EACH_DP(SYNFMC_CASE)
#undef SYNFMC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

SYNFMC_API int synfmc_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int S, int H, int D, float scale,
                                    void* stream) {
  const size_t smem = (size_t)(2 * FQ * (D + 1) + 2 * FK * D) * sizeof(float);
  cudaError_t e = set_smem((const void*)flash_fwd_f32, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(S, FQ), H, B);
  flash_fwd_f32<<<grid, FQ, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, S, H, D, scale);
  return (int)cudaGetLastError();
}
