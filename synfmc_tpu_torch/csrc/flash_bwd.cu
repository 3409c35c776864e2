// Flash attention backward on the packed (B, S, H*D) layout.
//
// Replaces three TPU kernels of synfmc_tpu/ops/flash_attention.py:
//   _bwd_packed_single_kernel (whole sequence, dK/dV written directly),
//   _bwd_packed_kernel (q-blocked, dK/dV accumulated across q-blocks) and
//   _bwd_kernel (the padded (B*H, S_p, D_p) layout for S % 8 != 0).
// All three compute, per (batch row, head), with q' = q*scale rounded to the
// operand type and P the softmax of q' K^T:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)),
//   dQ = dS K * scale,  dK = dS^T q',
// with P and dS rounded to the operand type before their products and fp32
// accumulation.  One design covers all three: the tiles mask any S, and no
// block needs the whole sequence resident.
//
// Bound: operations at the UNet's level 0 (B=16, S=1536, H=8, D=40: 5 products
// of 2*S^2*D per (b, h), 48 GFLOP on 63 MB), bytes at level 1 (S=384, D=80).
// The TPU kernels carried dK/dV accumulators (or a head's whole K/V) in VMEM
// across a sequential grid.  Hopper blocks run in no order and nothing
// carries over between them, so the work splits three ways, deterministic
// and without atomics:
//   1. flash_bwd_delta: delta = rowsum(dO * O) in fp32 from K1's saved
//      output, one thread per (row, head);
//   2. flash_bwd_dkdv:  one block per (key tile of 64, head, batch row), 4
//      warps of 16 keys; it keeps K, V and the dK/dV accumulators on chip
//      and loops over query tiles, recomputing P^T = exp(K q'^T - lse) from
//      the log-sum-exp K1 saved;
//   3. flash_bwd_dq:    one block per (query tile of 64, head, batch row),
//      4 warps of 16 queries; it loops over key tiles (double-buffered with
//      cp.async) and accumulates dQ in registers.
// Both main kernels run mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// the fragment conventions of flash_fwd.cu: products whose A operand is a
// probability or dS tile take it straight from the accumulator registers,
// B operands come through ldmatrix (.trans where the contraction runs over
// rows), shared rows are padded by 16 bytes.  The head dim is padded to a
// multiple of 16 (40 -> 48) and is a template parameter.
//
// fp32: CUDA-core kernels (one thread per key for dK/dV, one per query for
// dQ) on the same three-pass plan, for exact float32 checks.
#include "mma.cuh"

namespace {

using namespace synfmc;

constexpr int BT = 64;  // rows per tile: keys of a dK/dV block, queries of a dQ block
constexpr int kWarps = BT / 16;

template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                                float* __restrict__ delta, int B, int S, int H, int D) {
  const size_t item = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (size_t)B * S * H) return;
  const int h = (int)(item % H);
  const size_t bs = item / H;  // b * S + s
  const size_t off = bs * ((size_t)H * D) + (size_t)h * D;
  constexpr int VE = 16 / sizeof(T);
  float acc = 0.f;
  for (int d = 0; d < D; d += VE) {
    const uint4 po = *reinterpret_cast<const uint4*>(o + off + d);
    const uint4 pd = *reinterpret_cast<const uint4*>(dout + off + d);
    const T* eo = reinterpret_cast<const T*>(&po);
    const T* ed = reinterpret_cast<const T*>(&pd);
#pragma unroll
    for (int j = 0; j < VE; ++j) acc += to_f(eo[j]) * to_f(ed[j]);
  }
  const int s = (int)(bs % S), b = (int)(bs / S);
  delta[((size_t)b * H + h) * S + s] = acc;
}

// A 16 x 64 warp product C = A B^T with A rows from shared (16 rows at
// `arow`) and B rows from shared (64 rows at `brow`), both [row][d] over DP.
template <int DP>
__device__ __forceinline__ void warp_abt(float (&c)[BT / 8][4], const __nv_bfloat16* arow,
                                         const __nv_bfloat16* brow, int lane) {
  constexpr int LDS = lds<DP>();
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, arow + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < BT / 16; ++jp) {
      uint32_t bb[4];
      ldsm_x4(bb, brow + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * jp], a, bb[0], bb[1]);
      mma_bf16(c[2 * jp + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x DP) += X (16 x 64, fp32 fragments rounded to bf16) times the 64
// shared rows at `rows` ([row][d] over DP): the contraction runs over rows.
template <int DP>
__device__ __forceinline__ void warp_xb(float (&acc)[DP / 8][4], float (&x)[BT / 8][4],
                                        const __nv_bfloat16* rows, int lane) {
  constexpr int LDS = lds<DP>();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bb[4];
      ldsm_x4_t(bb, rows + (kk * 16 + (lane & 15)) * LDS + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
      mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
    }
  }
}

// Rows r (g) and r + 8 (g + 8) of a 16 x DP warp accumulator, times `mul`,
// to bf16 rows [row0 + g + 8r] of one head slice.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[DP / 8][4], int row0, int S, int C,
                                           int col0, int D, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = dst + (size_t)row * C + col0;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                   int D, float scale) {
  constexpr int LDS = lds<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BT][LDS]
  __nv_bfloat16* Vs = Ks + BT * LDS;                                // [BT][LDS]
  __nv_bfloat16* Qs = Vs + BT * LDS;                                // [BT][LDS] q'
  __nv_bfloat16* Ds = Qs + BT * LDS;                                // [BT][LDS] dO
  float* Ls = reinterpret_cast<float*>(Ds + BT * LDS);              // [BT] lse
  float* Es = Ls + BT;                                              // [BT] delta

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;

  load_tile<DP, BT>(k + base, Ks, k0, S, C, h * D, D);
  load_tile<DP, BT>(v + base, Vs, k0, S, C, h * D, D);
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();  // the previous query tile has been read
    load_tile<DP, BT>(dout + base, Ds, q0, S, C, h * D, D);
    cp_commit();
    load_tile_scaled<DP, BT>(q + base, Qs, q0, S, C, h * D, D, scale);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const int row = q0 + i;
      Ls[i] = row < S ? lse[stat + row] : INFINITY;  // P = 0 past the sequence
      Es[i] = row < S ? delta[stat + row] : 0.f;
    }
    cp_wait<0>();
    __syncthreads();

    // P^T = exp(K q'^T - lse): the warp's 16 keys x 64 queries
    float pt[BT / 8][4];
    warp_abt<DP>(pt, Ks + warp * 16 * LDS, Qs, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) pt[j][c] = __expf(pt[j][c] - Ls[8 * j + 2 * t + (c & 1)]);
    warp_xb<DP>(dv_acc, pt, Ds, lane);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta)
    float dst[BT / 8][4];
    warp_abt<DP>(dst, Vs + warp * 16 * LDS, Ds, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[j][c] = pt[j][c] * (dst[j][c] - Es[8 * j + 2 * t + (c & 1)]);
    warp_xb<DP>(dk_acc, dst, Qs, lane);  // dK += dS^T q'
  }
  store_rows<DP>(dk + base, dk_acc, k0 + warp * 16, S, C, h * D, D, 1.f, lane);
  store_rows<DP>(dv + base, dv_acc, k0 + warp * 16, S, C, h * D, D, 1.f, lane);
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int S, int H, int D, float scale) {
  constexpr int LDS = lds<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BT][LDS] q'
  __nv_bfloat16* Ds = Qs + BT * LDS;                                // [BT][LDS] dO
  __nv_bfloat16* Ks = Ds + BT * LDS;                                // [2][BT][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BT * LDS;                            // [2][BT][LDS]

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nk = cdiv(S, BT);

  load_tile<DP, BT>(dout + base, Ds, q0, S, C, h * D, D);
  load_tile<DP, BT>(k + base, Ks, 0, S, C, h * D, D);
  load_tile<DP, BT>(v + base, Vs, 0, S, C, h * D, D);
  cp_commit();
  load_tile_scaled<DP, BT>(q + base, Qs, q0, S, C, h * D, D, scale);
  float row_lse[2], row_delta[2];  // rows g, g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_lse[r] = row < S ? lse[stat + row] : INFINITY;
    row_delta[r] = row < S ? delta[stat + row] : 0.f;
  }
  float dq_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next key tile into the other buffer
      load_tile<DP, BT>(k + base, Ks + (buf ^ 1) * BT * LDS, (kt + 1) * BT, S, C, h * D, D);
      load_tile<DP, BT>(v + base, Vs + (buf ^ 1) * BT * LDS, (kt + 1) * BT, S, C, h * D, D);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BT * LDS;
    const __nv_bfloat16* Vt = Vs + buf * BT * LDS;

    // P = exp(q' K^T - lse), zero past the sequence
    float p[BT / 8][4];
    warp_abt<DP>(p, Qs + warp * 16 * LDS, Kt, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[j][c] = (kt * BT + 8 * j + 2 * t + (c & 1) < S) ? __expf(p[j][c] - row_lse[c >> 1])
                                                           : 0.f;
    // dS = P * (dO V^T - delta)
    float ds[BT / 8][4];
    warp_abt<DP>(ds, Ds + warp * 16 * LDS, Vt, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[j][c] = p[j][c] * (ds[j][c] - row_delta[c >> 1]);
    warp_xb<DP>(dq_acc, ds, Kt, lane);  // dQ += dS K
    __syncthreads();  // the next prefetch overwrites this buffer
  }
  store_rows<DP>(dq + base, dq_acc, q0 + warp * 16, S, C, h * D, D, scale, lane);
}

// fp32 reference-precision kernels on the CUDA cores.
constexpr int FT = 32;  // keys (dK/dV) or queries (dQ) per block, one thread each
constexpr int FS = 16;  // rows of the other side staged per step

__global__ void __launch_bounds__(FT)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int S, int H, int D,
                       float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = D + 1;  // odd stride: per-thread rows on distinct banks
  float* Kr = fsm;
  float* Vr = Kr + FT * ld;
  float* dKr = Vr + FT * ld;
  float* dVr = dKr + FT * ld;
  float* Qt = dVr + FT * ld;  // [FS][D] q'
  float* Dt = Qt + FS * D;    // [FS][D] dO
  float* Lt = Dt + FS * D;
  float* Et = Lt + FS;
  const int k0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int t = threadIdx.x;

  for (int e = t; e < FT * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    const int row = k0 + rr;
    Kr[rr * ld + d] = row < S ? k[base + (size_t)row * C + h * D + d] : 0.f;
    Vr[rr * ld + d] = row < S ? v[base + (size_t)row * C + h * D + d] : 0.f;
    dKr[rr * ld + d] = dVr[rr * ld + d] = 0.f;
  }
  for (int q0 = 0; q0 < S; q0 += FS) {
    __syncthreads();
    for (int e = t; e < FS * D; e += blockDim.x) {
      const int row = q0 + e / D, d = e % D;
      Qt[e] = row < S ? q[base + (size_t)row * C + h * D + d] * scale : 0.f;
      Dt[e] = row < S ? dout[base + (size_t)row * C + h * D + d] : 0.f;
    }
    for (int i = t; i < FS; i += blockDim.x) {
      Lt[i] = q0 + i < S ? lse[stat + q0 + i] : INFINITY;
      Et[i] = q0 + i < S ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < FS; ++i) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s += Qt[i * D + d] * Kr[t * ld + d];
        dp += Dt[i * D + d] * Vr[t * ld + d];
      }
      const float p = expf(s - Lt[i]);
      const float ds = p * (dp - Et[i]);
      for (int d = 0; d < D; ++d) {
        dVr[t * ld + d] += p * Dt[i * D + d];
        dKr[t * ld + d] += ds * Qt[i * D + d];
      }
    }
  }
  __syncthreads();
  for (int e = t; e < FT * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    if (k0 + rr < S) {
      dk[base + (size_t)(k0 + rr) * C + h * D + d] = dKr[rr * ld + d];
      dv[base + (size_t)(k0 + rr) * C + h * D + d] = dVr[rr * ld + d];
    }
  }
}

__global__ void __launch_bounds__(FT)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int H, int D, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = D + 1;
  float* Qr = fsm;             // [FT][ld] q'
  float* Dr = Qr + FT * ld;    // [FT][ld] dO
  float* dQr = Dr + FT * ld;   // [FT][ld]
  float* Kt = dQr + FT * ld;   // [FS][D]
  float* Vt = Kt + FS * D;     // [FS][D]
  const int q0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int t = threadIdx.x;

  for (int e = t; e < FT * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    const int row = q0 + rr;
    Qr[rr * ld + d] = row < S ? q[base + (size_t)row * C + h * D + d] * scale : 0.f;
    Dr[rr * ld + d] = row < S ? dout[base + (size_t)row * C + h * D + d] : 0.f;
    dQr[rr * ld + d] = 0.f;
  }
  const float L = q0 + t < S ? lse[stat + q0 + t] : INFINITY;
  const float E = q0 + t < S ? delta[stat + q0 + t] : 0.f;
  for (int k0 = 0; k0 < S; k0 += FS) {
    __syncthreads();
    for (int e = t; e < FS * D; e += blockDim.x) {
      const int row = k0 + e / D, d = e % D;
      Kt[e] = row < S ? k[base + (size_t)row * C + h * D + d] : 0.f;
      Vt[e] = row < S ? v[base + (size_t)row * C + h * D + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < FS && k0 + j < S; ++j) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s += Qr[t * ld + d] * Kt[j * D + d];
        dp += Dr[t * ld + d] * Vt[j * D + d];
      }
      const float ds = expf(s - L) * (dp - E);
      for (int d = 0; d < D; ++d) dQr[t * ld + d] += ds * Kt[j * D + d];
    }
  }
  __syncthreads();
  for (int e = t; e < FT * D; e += blockDim.x) {
    const int rr = e / D, d = e % D;
    if (q0 + rr < S) dq[base + (size_t)(q0 + rr) * C + h * D + d] = dQr[rr * ld + d] * scale;
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S, int H, int D,
                 cudaStream_t stream) {
  const size_t items = (size_t)B * S * H;
  const int threads = 256;
  flash_bwd_delta<T><<<(unsigned)((items + threads - 1) / threads), threads, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, B, S, H, D);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, void* dk, void* dv, int B, int S, int H, int D,
                float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const dim3 grid(cdiv(S, BT), H, B);
  const size_t smem_kv = (size_t)4 * BT * lds<DP>() * sizeof(bf) + 2 * BT * sizeof(float);
  cudaError_t e = set_smem((const void*)flash_bwd_dkdv<DP>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DP><<<grid, kWarps * 32, smem_kv, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta, (bf*)dk, (bf*)dv,
      S, H, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = (size_t)6 * BT * lds<DP>() * sizeof(bf);
  e = set_smem((const void*)flash_bwd_dq<DP>, smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DP><<<grid, kWarps * 32, smem_q, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta, (bf*)dq, S, H, D,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, S, H*D) contiguous, 16-byte aligned;
// D % 8 == 0, D <= 256.  lse: K1's (B, H, S) fp32 log-sum-exp; delta: an
// fp32 (B, H, S) scratch buffer.
SYNFMC_API int synfmc_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                     const float* lse, const void* dout, float* delta, void* dq,
                                     void* dk, void* dv, int B, int S, int H, int D, float scale,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_delta<__nv_bfloat16>(o, dout, delta, B, S, H, D, st);
  if (err != 0) return err;
  switch (cdiv(D, 16) * 16) {
#define SYNFMC_CASE(DP) \
  case DP:              \
    return launch_bf16<DP>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, D, scale, st);
    SYNFMC_FOR_EACH_DP(SYNFMC_CASE)
#undef SYNFMC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

SYNFMC_API int synfmc_flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                    const float* lse, const void* dout, float* delta, void* dq,
                                    void* dk, void* dv, int B, int S, int H, int D, float scale,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_delta<float>(o, dout, delta, B, S, H, D, st);
  if (err != 0) return err;
  const dim3 grid(cdiv(S, FT), H, B);
  const size_t smem_kv = (size_t)(4 * FT * (D + 1) + 2 * FS * D + 2 * FS) * sizeof(float);
  cudaError_t e = set_smem((const void*)flash_bwd_dkdv_f32, smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_f32<<<grid, FT, smem_kv, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, S, H, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = (size_t)(3 * FT * (D + 1) + 2 * FS * D) * sizeof(float);
  e = set_smem((const void*)flash_bwd_dq_f32, smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_f32<<<grid, FT, smem_q, st>>>((const float*)q, (const float*)k, (const float*)v,
                                             (const float*)dout, lse, delta, (float*)dq, S, H,
                                             D, scale);
  return (int)cudaGetLastError();
}
