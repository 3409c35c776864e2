// Packed temporal self-attention backward on (N, F, C = H*D) tensors.
//
// Replaces synfmc_tpu/ops/temporal_attention.py:_bwd_kernel (called from
// _bwd_call): per row n, per head h, over the F positions of that row,
//   P = softmax(scale * Q K^T) (fp32, normalised),
//   delta = rowsum(dO * (P V)) with P rounded to the operand type,
//   dS = P * (dO V^T - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO,
// with dS and P rounded to the operand type before the three products and
// fp32 accumulation.  Since rowsum(dO * (P V)) = sum_j P_j (dO . V_j), the
// recomputed output is never formed: delta comes from the dP row in hand.
//
// Bound: bytes.  A call reads q, k, v, dO and writes dq, dk, dv once:
// 7*N*F*C*2 bytes against 10*N*H*F*F*D operations (chip_smoke.py's bound),
// 11 FLOP/byte at F = 16, far below the ~295 FLOP/byte where the H100's
// tensor cores would become the limit.  Rows are independent, so nothing
// crosses blocks (the TPU kernel had no cross-step accumulation either).
// At the train step's level 0, 1536 x 16 x (8 x 40), the kernel takes
// 0.0450 ms against that bound's 0.0329 (chip_smoke.py's device time on an
// NVIDIA H100 80GB HBM3 at 700 W; the CUDA-core kernel it replaced, 0.3289).
// The tensor cores take the arithmetic off the critical path; the design
// moves each byte once, with enough blocks in flight to fill the card:
//   - a work unit is one row n and a group of HG consecutive heads.  Its Q,
//     K, V and dO are four F x (HG*D) slabs copied once with 16-byte
//     cp.async into shared rows padded to an odd number of 16-byte chunks
//     (conflict-free ldmatrix).  A block owns one unit; the blocks resident
//     on an SM overlap one another's copies (temporal_fwd.cu measured a
//     persistent ring no faster).  HG is the largest divisor of H whose unit
//     fits 48 KB and still leaves two units per SM, so the mid block's 16
//     rows of 8 heads at D = 160 run as 128 blocks, not 64 half-empty ones;
//     a unit above 48 KB (one head of a large F x D) uses the opt-in shared
//     memory;
//   - phase 1, one warp per (head, 16-query tile): S = Q K^T and
//     dP = dO V^T on mma.sync m16n8k16, k-steps of 16 over D (one m16n8k8
//     step ends a head dim with D % 16 == 8, 40 on level 0, instead of
//     padding it to 48), both accumulators in registers; keys >= F are
//     masked to -inf, and ldmatrix rows >= F read row F - 1 (a masked key's
//     P is 0), so F = 24 or 3 needs no zero rows in the slabs.  Row max,
//     sum and delta take quad shuffles.  The warp stores P and dS, rounded
//     to bf16, in the unit's F x F staging tiles (zero in query rows >= F);
//   - dK = dS^T Q and dV = P^T dO sum over the queries, which for F > 16
//     live in other warps' registers, so P and dS go through shared memory
//     (2*F*F*2 bytes a head, 1 KB at F = 16) rather than through register
//     transposes (movmatrix): a warp per (head, 16-key tile) reads them back
//     with ldmatrix.trans as its A fragments, and the zero query rows need no
//     mask.  dQ = dS K reads the staged dS with a plain ldmatrix;
//   - each product walks D 16 output columns at a time with the B operand
//     (K, dO or Q) through ldmatrix.trans, so the accumulators stay at 8
//     floats a thread whatever D is;
//   - each result overwrites a slab that no later product reads (dQ -> V
//     after phase 1, dV -> K after dQ, dK -> dO after dV), and the block
//     stores the three slabs with 16-byte coalesced stores.
// wgmma is not used: its 64-row tile does not fit F = 16, and the products
// are not the bound.
//
// fp32: the CUDA-core kernel one thread per (row, head, query), used by the
// float32 checks.  TF32 tensor cores would miss their 1e-4 limit.
#include <algorithm>

#include "mma.cuh"

namespace {

using namespace synfmc;
using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 16;
constexpr int kUnitBytes = 48 * 1024;  // target for one unit's shared memory

// out rows [r0, r0 + 16) (those < F) x columns [hoff, hoff + D) of a shared
// slab = A (16 x 16*KT, bf16 A fragments) x B rows [0, 16*KT) x the same
// columns, with B's rows >= F reading row F - 1 (A is zero in those columns).
template <int KT>
__device__ __forceinline__ void product_to_slab(const uint32_t (&a)[KT][4], const bf16* B,
                                                bf16* out, int r0, int F, int LDS, int hoff,
                                                int D) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  int rowB[KT];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) rowB[kk] = min(kk * 16 + (lane & 15), F - 1) * LDS + hoff;
  const bool lo = r0 + g < F, hi = r0 + g + 8 < F;
  bf16* const o_lo = out + (r0 + g) * LDS + hoff + 2 * t;
  bf16* const o_hi = o_lo + 8 * LDS;
  auto put = [&](const float (&acc)[4], int col) {
    if (lo) *reinterpret_cast<__nv_bfloat162*>(o_lo + col) = __floats2bfloat162_rn(acc[0], acc[1]);
    if (hi) *reinterpret_cast<__nv_bfloat162*>(o_hi + col) = __floats2bfloat162_rn(acc[2], acc[3]);
  };
#pragma unroll 2
  for (int dp = 0; dp < D / 16; ++dp) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      ldsm_x4_t(b, B + rowB[kk] + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[0], a[kk], b[0], b[1]);
      mma_bf16(acc[1], a[kk], b[2], b[3]);
    }
    put(acc[0], dp * 16);
    put(acc[1], dp * 16 + 8);
  }
  if (D & 8) {  // the last 8 columns of the head
    float acc[4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[2];
      ldsm_x2_t(b, B + rowB[kk] + D - 8);
      mma_bf16(acc, a[kk], b[0], b[1]);
    }
    put(acc, D - 8);
  }
}

// KT key tiles of 16: F <= 16 * KT.  A block owns one unit; its shared
// memory is [4][F][LDS] (q, k, v, dO) then [2][HG][16*KT][SLD] (rounded P
// and dS, query rows x key columns).
template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    temporal_bwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int F,
                      int H, int D, int HG, float scale) {
  constexpr int FP = 16 * KT, SLD = FP + 8;  // staging rows, and their stride (odd chunks)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int C = H * D, groups = H / HG, seg = HG * D;
  const int LDS = seg_stride(seg), mat = F * LDS;
  const int vpr = seg / 8;  // 16-byte vectors per row segment
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int items = HG * KT;  // (head, 16-row tile) pairs of a unit, queries or keys

  // global offset of this block's unit: row blockIdx.x / groups, head group blockIdx.x % groups
  const size_t base = (size_t)(blockIdx.x / groups) * F * C + (size_t)(blockIdx.x % groups) * seg;
  for (int e = threadIdx.x; e < F * vpr; e += blockDim.x) {
    const int f = e / vpr, j = e - f * vpr;
    const size_t src = base + (size_t)f * C + j * 8;
    bf16* dst = sm + f * LDS + j * 8;
    cp_async16(dst, q + src, true);
    cp_async16(dst + mat, k + src, true);
    cp_async16(dst + 2 * mat, v + src, true);
    cp_async16(dst + 3 * mat, dout + src, true);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  bf16* const Qs = sm;
  bf16* const Ks = sm + mat;
  bf16* const Vs = sm + 2 * mat;
  bf16* const Gs = sm + 3 * mat;  // dO
  bf16* const Ps = sm + 4 * mat;
  bf16* const Ss = Ps + HG * FP * SLD;

  // phase 1: P and dS of each (head, query tile), staged rounded
  for (int it = warp; it < items; it += nwarps) {
    const int h = it % HG, hoff = h * D, q0 = (it / HG) * 16;
    const int rowA = min(q0 + (lane & 15), F - 1) * LDS + hoff + (lane >> 4) * 8;
    float s[2 * KT][4], dp[2 * KT][4];
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
    int rowB[KT];
#pragma unroll
    for (int jp = 0; jp < KT; ++jp)
      rowB[jp] = min(jp * 16 + (lane & 7) + ((lane >> 4) << 3), F - 1) * LDS + hoff +
                 ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ag[4];
      ldsm_x4(a, Qs + rowA + kk * 16);
      ldsm_x4(ag, Gs + rowA + kk * 16);
#pragma unroll
      for (int jp = 0; jp < KT; ++jp) {
        uint32_t b[4], bv[4];
        ldsm_x4(b, Ks + rowB[jp] + kk * 16);
        ldsm_x4(bv, Vs + rowB[jp] + kk * 16);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        mma_bf16(dp[2 * jp], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], ag, bv[2], bv[3]);
      }
    }
    if (D & 8) {  // the last 8 columns of the head: one k = 8 step
      const int rA = min(q0 + (lane & 15), F - 1) * LDS + hoff + D - 8;
      uint32_t a[2], ag[2];
      ldsm_x2(a, Qs + rA);
      ldsm_x2(ag, Gs + rA);
#pragma unroll
      for (int jp = 0; jp < KT; ++jp) {
        const int rB = min(jp * 16 + (lane & 15), F - 1) * LDS + hoff + D - 8;
        uint32_t b[2], bv[2];
        ldsm_x2(b, Ks + rB);
        ldsm_x2(bv, Vs + rB);
        mma_bf16_k8(s[2 * jp], a, b[0]);
        mma_bf16_k8(s[2 * jp + 1], a, b[1]);
        mma_bf16_k8(dp[2 * jp], ag, bv[0]);
        mma_bf16_k8(dp[2 * jp + 1], ag, bv[1]);
      }
    }

    // softmax over the keys; a row's keys live in the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = 8 * j + 2 * t + (c & 1) < F ? s[j][c] * scale : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = __expf(s[j][c] - mx[c >> 1]);
        sum[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = 1.f / sum[r];
    }
    // normalised P in fp32; delta = sum_j round(P_j) dP_j
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] *= sum[c >> 1];
        delta[c >> 1] += __bfloat162float(__float2bfloat16(s[j][c])) * dp[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    // rounded P and dS rows q0 + g and q0 + g + 8; zero past F
    const bool lo = q0 + g < F, hi = q0 + g + 8 < F;
    const int at = h * FP * SLD + (q0 + g) * SLD + 2 * t;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      const int c0 = at + 8 * j, c1 = c0 + 8 * SLD;
      auto ds = [&](int c) { return s[j][c] * (dp[j][c] - delta[c >> 1]) * scale; };
      *reinterpret_cast<uint32_t*>(Ps + c0) = lo ? pack_bf16(s[j][0], s[j][1]) : 0u;
      *reinterpret_cast<uint32_t*>(Ps + c1) = hi ? pack_bf16(s[j][2], s[j][3]) : 0u;
      *reinterpret_cast<uint32_t*>(Ss + c0) = lo ? pack_bf16(ds(0), ds(1)) : 0u;
      *reinterpret_cast<uint32_t*>(Ss + c1) = hi ? pack_bf16(ds(2), ds(3)) : 0u;
    }
  }
  __syncthreads();

  // phase 2: dQ = dS K for each (head, query tile), over V (read only in phase 1)
  for (int it = warp; it < items; it += nwarps) {
    const int h = it % HG, q0 = (it / HG) * 16;
    const bf16* const Sh = Ss + h * FP * SLD + (q0 + (lane & 15)) * SLD + (lane >> 4) * 8;
    uint32_t a[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm_x4(a[kk], Sh + kk * 16);
    product_to_slab<KT>(a, Ks, Vs, q0, F, LDS, h * D, D);
  }
  __syncthreads();

  // phases 3 and 4, one warp per (head, key tile): A = the staged tile
  // transposed, key rows x query columns
  auto staged_t = [&](const bf16* st, int h, int k0, uint32_t (&a)[KT][4]) {
    const bf16* const p = st + h * FP * SLD + ((lane & 7) + ((lane >> 4) << 3)) * SLD + k0 +
                          ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm_x4_t(a[kk], p + kk * 16 * SLD);
  };
  // phase 3: dV = P^T dO, over K (read last in phase 2)
  for (int it = warp; it < items; it += nwarps) {
    const int h = it % HG, k0 = (it / HG) * 16;
    uint32_t a[KT][4];
    staged_t(Ps, h, k0, a);
    product_to_slab<KT>(a, Gs, Ks, k0, F, LDS, h * D, D);
  }
  __syncthreads();
  // phase 4: dK = dS^T Q, over dO (read last in phase 3)
  for (int it = warp; it < items; it += nwarps) {
    const int h = it % HG, k0 = (it / HG) * 16;
    uint32_t a[KT][4];
    staged_t(Ss, h, k0, a);
    product_to_slab<KT>(a, Qs, Gs, k0, F, LDS, h * D, D);
  }
  __syncthreads();

  // the unit's dQ, dV and dK slabs, 16 bytes a thread
  for (int e = threadIdx.x; e < F * vpr; e += blockDim.x) {
    const int f = e / vpr, j = e - f * vpr;
    const size_t dst = base + (size_t)f * C + j * 8;
    const int src = f * LDS + j * 8;
    *reinterpret_cast<uint4*>(dq + dst) = *reinterpret_cast<const uint4*>(Vs + src);
    *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(Ks + src);
    *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(Gs + src);
  }
}

template <int KT>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, int N, int F, int H, int D, float scale,
                cudaStream_t stream) {
  auto kern = temporal_bwd_bf16<KT>;
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  static bool attributes_set[kMaxDevices] = {};  // per instance and device, before its first launch
  if (!attributes_set[info.dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, info.optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attributes_set[info.dev] = true;
  }
  auto unit_bytes = [&](int hg) {
    return (4 * F * seg_stride(hg * D) + 2 * hg * 16 * KT * (16 * KT + 8)) * (int)sizeof(bf16);
  };
  // the largest head group that fits the unit budget and leaves two units per SM
  int hg = H;
  for (; hg > 1; --hg)
    if (H % hg == 0 && unit_bytes(hg) <= kUnitBytes && (long)N * (H / hg) >= 2L * info.sms) break;
  const int smem = unit_bytes(hg);
  if (smem > info.optin) return (int)cudaErrorInvalidValue;
  const int threads = std::min(hg * KT, kMaxWarps) * 32;
  kern<<<N * (H / hg), threads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (const bf16*)dout, (bf16*)dq, (bf16*)dk,
                                                (bf16*)dv, F, H, D, hg, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: one thread per (row, head, query) on the CUDA cores.
// ---------------------------------------------------------------------------

// A block owns `ipb` (row, head) items and reads their Q, K, V and dO head
// slices once into shared memory (rows at an odd 32-bit word stride); one
// thread per (item, query) recomputes its F logits and softmax in registers
// and writes its row of P and dS (rounded) to shared memory; dQ needs only
// the thread's own dS row, while dK and dV sum over queries, so one thread
// per (item, key) reduces a column of dS or P; each result overwrites an
// input matrix no later phase reads (dQ -> V, dV -> K, dK -> dO) and leaves
// with 16-byte stores.
template <typename T, int MAXF>
__global__ void temporal_bwd(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                             int items, int F, int H, int D, int ipb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [ipb][4][F][ld]: Q, K, V, dO
  const int ld = row_stride<T>(D);
  const int per = F * ld;  // one matrix of one item
  const int lp = F + 1;    // odd stride of the P and dS rows
  float* Ps = reinterpret_cast<float*>(sm + (size_t)ipb * 4 * per);  // [ipb][F][lp]
  float* Ss = Ps + (size_t)ipb * F * lp;                             // [ipb][F][lp]
  const int C = H * D;
  const int item0 = blockIdx.x * ipb;
  const int nitems = min(ipb, items - item0);
  constexpr int VE = vec_elems<T>();
  const int dvec = D / VE;
  const int nvec = nitems * F * dvec;

  const T* src[4] = {q, k, v, dout};
  for (int e = threadIdx.x; e < nvec; e += blockDim.x) {
    const int it = e / (F * dvec);
    const int rem = e % (F * dvec);
    const int f = rem / dvec, dv_ = rem % dvec;
    const int item = item0 + it;
    const size_t g = ((size_t)(item / H) * F + f) * C + (size_t)(item % H) * D + dv_ * VE;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 pack = *reinterpret_cast<const uint4*>(src[m] + g);
      const T* el = reinterpret_cast<const T*>(&pack);
      T* dst = sm + ((size_t)it * 4 + m) * per + f * ld + dv_ * VE;
#pragma unroll
      for (int j = 0; j < VE; ++j) dst[j] = el[j];
    }
  }
  __syncthreads();

  const int it = threadIdx.x / F;
  const int i = threadIdx.x % F;  // query row in phases 1-2, key row in 3-4
  const bool active = it < nitems;
  T* Q = sm + (size_t)it * 4 * per;
  T* K = Q + per;
  T* V = Q + 2 * per;
  T* Do = Q + 3 * per;
  float* P = Ps + (size_t)it * F * lp;
  float* dS = Ss + (size_t)it * F * lp;

  // phase 1: the thread's rows of P and dS
  if (active) {
    float s[MAXF], dp[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = to_f(Q[i * ld + d]), gd = to_f(Do[i * ld + d]);
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < F) {
          s[j] += qd * to_f(K[j * ld + d]);
          dp[j] += gd * to_f(V[j * ld + d]);
        }
    }
    float m = -3.0e38f;
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < F) {
        s[j] *= scale;
        m = fmaxf(m, s[j]);
      }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < F) {
        s[j] = __expf(s[j] - m);
        sum += s[j];
      }
    const float inv = 1.f / sum;
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < F) {
        s[j] *= inv;
        delta += round_to<T>(s[j]) * dp[j];
      }
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < F) {
        P[i * lp + j] = round_to<T>(s[j]);
        dS[i * lp + j] = round_to<T>(s[j] * (dp[j] - delta) * scale);
      }
  }
  __syncthreads();
  // phase 2: dQ_i = dS_i K -> V row i (V is read only in phase 1)
  if (active)
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
      for (int j = 0; j < F; ++j) acc += dS[i * lp + j] * to_f(K[j * ld + d]);
      V[i * ld + d] = from_f<T>(acc);
    }
  __syncthreads();
  // phase 3: dV_j = sum_i P_ij dO_i -> K row j (K is read only up to phase 2)
  if (active)
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
      for (int r = 0; r < F; ++r) acc += P[r * lp + i] * to_f(Do[r * ld + d]);
      K[i * ld + d] = from_f<T>(acc);
    }
  __syncthreads();
  // phase 4: dK_j = sum_i dS_ij Q_i -> dO row j (dO is read only up to phase 3)
  if (active)
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
      for (int r = 0; r < F; ++r) acc += dS[r * lp + i] * to_f(Q[r * ld + d]);
      Do[i * ld + d] = from_f<T>(acc);
    }
  __syncthreads();

  T* dst[4] = {nullptr, dv, dq, dk};  // the buffers now holding dV, dQ, dK
  for (int e = threadIdx.x; e < nvec; e += blockDim.x) {
    const int it2 = e / (F * dvec);
    const int rem = e % (F * dvec);
    const int f = rem / dvec, dv_ = rem % dvec;
    const int item = item0 + it2;
    const size_t g = ((size_t)(item / H) * F + f) * C + (size_t)(item % H) * D + dv_ * VE;
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      uint4 pack;
      T* el = reinterpret_cast<T*>(&pack);
      const T* s = sm + ((size_t)it2 * 4 + m) * per + f * ld + dv_ * VE;
#pragma unroll
      for (int j = 0; j < VE; ++j) el[j] = s[j];
      *reinterpret_cast<uint4*>(dst[m] + g) = pack;
    }
  }
}

constexpr int kSmemBudget = 96 * 1024;

template <typename T, int MAXF>
int launch_f(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, int N, int F, int H, int D, float scale, cudaStream_t stream) {
  const int per_item = 4 * F * row_stride<T>(D) * (int)sizeof(T) + 2 * F * (F + 1) * 4;
  int ipb = 256 / F;
  if (ipb * per_item > kSmemBudget) ipb = kSmemBudget / per_item;
  if (ipb < 1) ipb = 1;
  const int smem = ipb * per_item;
  auto kern = temporal_bwd<T, MAXF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int items = N * H;
  kern<<<cdiv(items, ipb), ipb * F, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                    (const T*)dout, (T*)dq, (T*)dk, (T*)dv,
                                                    items, F, H, D, ipb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, int N, int F, int H, int D, float scale, cudaStream_t stream) {
  if (F <= 16) return launch_f<T, 16>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, stream);
  if (F <= 32) return launch_f<T, 32>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, stream);
  return launch_f<T, 64>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, stream);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (N, F, H*D) contiguous, 16-byte aligned;
// F <= 64, D % 8 == 0.
SYNFMC_API int synfmc_temporal_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, void* dq, void* dk, void* dv, int N,
                                        int F, int H, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cdiv(F, 16)) {
    case 1: return launch_bf16<1>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, st);
    case 2: return launch_bf16<2>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, st);
    case 3: return launch_bf16<3>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, st);
    case 4: return launch_bf16<4>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

SYNFMC_API int synfmc_temporal_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv, int N,
                                       int F, int H, int D, float scale, void* stream) {
  return launch<float>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, (cudaStream_t)stream);
}
