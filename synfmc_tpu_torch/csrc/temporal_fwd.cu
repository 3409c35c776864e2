// Packed temporal self-attention forward on (N, F, C = H*D) tensors.
//
// Replaces synfmc_tpu/ops/temporal_attention.py:_fwd_kernel (called from
// _fwd_call): per row n, per head h, softmax(scale * Q K^T) V over the F
// positions of that row, reading and writing the packed layout the QKV Dense
// produces (no head-split transpose).  Logits and softmax in fp32, the scale
// applied to the fp32 logits, P normalised before PV and rounded to the
// operand type, PV accumulated in fp32.
//
// Bound: bytes.  A call reads q, k, v and writes o once: 4*N*F*C*2 bytes
// against 4*N*H*F*F*D operations (chip_smoke.py's bound, the larger of
// bytes / 3.35 TB/s and operations / 989 TFLOP/s on the H100 SXM).  At F = 16
// that is F/2 = 8 FLOP/byte, far below the ~295 FLOP/byte where the tensor
// cores would become the limit.  So the tensor cores only take the
// arithmetic off the critical path, and the design spends its effort on
// moving each byte once with the copies in flight:
//   - a work unit is one row n and a group of HG consecutive heads.  Its Q,
//     K and V are three F x (HG*D) slabs, each row a contiguous segment of
//     the packed row, copied with 16-byte cp.async into shared rows;
//   - a block owns one unit: it loads, computes and stores once.  Copies
//     overlap compute across the blocks resident on an SM, not within a
//     block: a persistent variant that walked the units with a two-stage
//     ring in each block measured equal or slower at every main-path shape
//     (0.0528 against 0.0485 ms at 3072 x 16 x (8 x 40), chip_smoke.py's
//     device time on an NVIDIA H100 80GB HBM3 at 700 W), so it was dropped;
//   - HG is the largest divisor of H whose unit fits 48 KB and that still
//     leaves two units per SM, so that small calls (the mid block's 32 rows
//     of 24 tokens at D = 160) spread over the card; a unit above 48 KB
//     (one head of a large F x D) uses the opt-in shared memory;
//   - one warp per (head, 16-query tile) runs mma.sync: S = Q K^T in k-steps
//     of 16 over D, held as 2*KT n-tiles of fp32 in registers (KT = F / 16
//     rounded up; 32 floats a thread at F = 64); keys >= F are masked to
//     -inf, query rows >= F are never stored, and ldmatrix rows past F read
//     row F - 1 instead (a masked key's P is 0), so shared memory holds only
//     the F real rows and F = 24 or 3 needs no zero rows;
//   - row max and sum take two quad shuffles; P is normalised, rounded to
//     bf16 and packed straight into the A fragments of O = P V, with V
//     through ldmatrix.trans, 16 output columns at a time, so the
//     accumulators stay at 8 floats whatever D is;
//   - a head dim with D % 16 == 8 (40 on level 0) ends with one m16n8k8
//     step instead of padding D with zeros to 48: the slab is the packed
//     row as it is, with no zero columns to write or keep, and 17 % fewer
//     bytes of shared memory at D = 40;
//   - a shared row is padded to an odd multiple of 16 bytes, so the 8 rows
//     an ldmatrix reads fall on distinct banks;
//   - each warp writes its output over its own Q rows, and the block stores
//     the unit's output slab with 16-byte coalesced stores.
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

// KT key tiles of 16: F <= 16 * KT.  A block owns one unit; its shared
// memory is [3][F][LDS] (q, k, v; the output overwrites q).
template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    temporal_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int F, int H, int D,
                      int HG, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int C = H * D, groups = H / HG, seg = HG * D;
  const int LDS = seg_stride(seg), mat = F * LDS;
  const int vpr = seg / 8;  // 16-byte vectors per row segment
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int items = HG * cdiv(F, 16);  // (head, query tile) pairs of a unit

  // global offset of this block's unit: row blockIdx.x / groups, head group blockIdx.x % groups
  const size_t base = (size_t)(blockIdx.x / groups) * F * C + (size_t)(blockIdx.x % groups) * seg;
  for (int e = threadIdx.x; e < F * vpr; e += blockDim.x) {
    const int f = e / vpr, j = e - f * vpr;
    const size_t src = base + (size_t)f * C + j * 8;
    bf16* dst = sm + f * LDS + j * 8;
    cp_async16(dst, q + src, true);
    cp_async16(dst + mat, k + src, true);
    cp_async16(dst + 2 * mat, v + src, true);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  bf16* const Qs = sm;
  const bf16* const Ks = sm + mat;
  const bf16* const Vs = sm + 2 * mat;
  for (int it = warp; it < items; it += nwarps) {
    const int hoff = (it % HG) * D, q0 = (it / HG) * 16;
    const int rowA = min(q0 + (lane & 15), F - 1);

    // S = Q K^T for 16 queries x 16*KT keys, fp32 in registers
    float s[2 * KT][4];
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    int rowB[KT];
#pragma unroll
    for (int jp = 0; jp < KT; ++jp)
      rowB[jp] = min(jp * 16 + (lane & 7) + ((lane >> 4) << 3), F - 1);
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + rowA * LDS + hoff + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < KT; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, Ks + rowB[jp] * LDS + hoff + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    if (D & 8) {  // the last 8 columns of the head: one k = 8 step
      const int c = hoff + D - 8;
      uint32_t a[2];
      ldsm_x2(a, Qs + rowA * LDS + c);
#pragma unroll
      for (int jp = 0; jp < KT; ++jp) {
        uint32_t b[2];
        ldsm_x2(b, Ks + min(jp * 16 + (lane & 15), F - 1) * LDS + c);
        mma_bf16_k8(s[2 * jp], a, b[0]);
        mma_bf16_k8(s[2 * jp + 1], a, b[1]);
      }
    }

    // softmax over the keys; a row's keys live in the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
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
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }
    // normalised P, rounded to bf16, as the A fragments of P V
    uint32_t p[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
      p[kk][1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
    }

    // O = P V, 16 (then 8) columns at a time, written over the warp's Q rows
    __syncwarp();
    int rowV[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) rowV[kk] = min(kk * 16 + (lane & 15), F - 1);
    const bool lo = q0 + g < F, hi = q0 + g + 8 < F;
    bf16* const o_lo = Qs + (q0 + g) * LDS + hoff + 2 * t;
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
        ldsm_x4_t(b, Vs + rowV[kk] * LDS + hoff + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[0], p[kk], b[0], b[1]);
        mma_bf16(acc[1], p[kk], b[2], b[3]);
      }
      put(acc[0], dp * 16);
      put(acc[1], dp * 16 + 8);
    }
    if (D & 8) {
      float acc[4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t b[2];
        ldsm_x2_t(b, Vs + rowV[kk] * LDS + hoff + D - 8);
        mma_bf16(acc, p[kk], b[0], b[1]);
      }
      put(acc, D - 8);
    }
  }
  __syncthreads();

  // the unit's output slab, 16 bytes a thread
  for (int e = threadIdx.x; e < F * vpr; e += blockDim.x) {
    const int f = e / vpr, j = e - f * vpr;
    *reinterpret_cast<uint4*>(o + base + (size_t)f * C + j * 8) =
        *reinterpret_cast<const uint4*>(Qs + f * LDS + j * 8);
  }
}

template <int KT>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int N, int F, int H, int D,
                float scale, cudaStream_t stream) {
  auto kern = temporal_fwd_bf16<KT>;
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
  auto unit_bytes = [&](int hg) { return 3 * F * seg_stride(hg * D) * (int)sizeof(bf16); };
  // the largest head group that fits the unit budget and leaves two units per SM
  int hg = H;
  for (; hg > 1; --hg)
    if (H % hg == 0 && unit_bytes(hg) <= kUnitBytes && (long)N * (H / hg) >= 2L * info.sms) break;
  const int smem = unit_bytes(hg);
  if (smem > info.optin) return (int)cudaErrorInvalidValue;
  const int threads = std::min(hg * cdiv(F, 16), kMaxWarps) * 32;
  kern<<<N * (H / hg), threads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (bf16*)o, F, H, D, hg, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: one thread per (row, head, query) on the CUDA cores.
// ---------------------------------------------------------------------------

// A block owns `ipb` (row, head) items, loads their head slices once into
// shared memory (rows at an odd 32-bit word stride), and each thread keeps
// its query's F logits in registers; the output overwrites the thread's own
// Q row and leaves with 16-byte stores.
template <int MAXF>
__global__ void temporal_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ o, int items,
                                 int F, int H, int D, int ipb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int ld = row_stride<float>(D);
  const int per = F * ld;  // one matrix of one item
  const int C = H * D;
  const int item0 = blockIdx.x * ipb;
  const int nitems = min(ipb, items - item0);
  constexpr int VE = vec_elems<float>();
  const int dvec = D / VE;

  // cooperative load: item it, position f, vector dv of its head slice
  const int nload = nitems * F * dvec;
  for (int e = threadIdx.x; e < nload; e += blockDim.x) {
    const int it = e / (F * dvec);
    const int rem = e % (F * dvec);
    const int f = rem / dvec, dv = rem % dvec;
    const int item = item0 + it;
    const int n = item / H, h = item % H;
    const size_t g = ((size_t)n * F + f) * C + (size_t)h * D + dv * VE;
    const uint4 vq = *reinterpret_cast<const uint4*>(q + g);
    const uint4 vk = *reinterpret_cast<const uint4*>(k + g);
    const uint4 vv = *reinterpret_cast<const uint4*>(v + g);
    const float* eq = reinterpret_cast<const float*>(&vq);
    const float* ek = reinterpret_cast<const float*>(&vk);
    const float* ev = reinterpret_cast<const float*>(&vv);
    float* base = sm + (size_t)it * 3 * per + f * ld + dv * VE;
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      base[j] = eq[j];
      base[per + j] = ek[j];
      base[2 * per + j] = ev[j];
    }
  }
  __syncthreads();

  const int it = threadIdx.x / F;
  const int i = threadIdx.x % F;
  if (it < nitems) {
    float* Q = sm + (size_t)it * 3 * per;
    const float* K = Q + per;
    const float* V = Q + 2 * per;
    float s[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Q[i * ld + d];
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < F) s[j] += qd * K[j * ld + d];
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
#pragma unroll
    for (int j = 0; j < MAXF; ++j)
      if (j < F) s[j] *= inv;
    // Q row i is read only by this thread: overwrite it with the output.
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < F) acc += s[j] * V[j * ld + d];
      Q[i * ld + d] = acc;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nload; e += blockDim.x) {
    const int it2 = e / (F * dvec);
    const int rem = e % (F * dvec);
    const int f = rem / dvec, dv = rem % dvec;
    const int item = item0 + it2;
    const int n = item / H, h = item % H;
    uint4 pack;
    float* ep = reinterpret_cast<float*>(&pack);
    const float* src = sm + (size_t)it2 * 3 * per + f * ld + dv * VE;
#pragma unroll
    for (int j = 0; j < VE; ++j) ep[j] = src[j];  // shared rows are not 16-byte aligned
    *reinterpret_cast<uint4*>(o + ((size_t)n * F + f) * C + (size_t)h * D + dv * VE) = pack;
  }
}

template <int MAXF>
int launch_f32(const void* q, const void* k, const void* v, void* o, int N, int F, int H, int D,
               float scale, cudaStream_t stream) {
  const int per_item = 3 * F * row_stride<float>(D) * (int)sizeof(float);
  int ipb = 256 / F;
  if (ipb * per_item > 64 * 1024) ipb = (64 * 1024) / per_item;
  if (ipb < 1) ipb = 1;
  const int smem = ipb * per_item;
  auto kern = temporal_fwd_f32<MAXF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int items = N * H;
  kern<<<cdiv(items, ipb), ipb * F, smem, stream>>>((const float*)q, (const float*)k,
                                                    (const float*)v, (float*)o, items, F, H, D,
                                                    ipb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (N, F, H*D) contiguous, 16-byte aligned; F <= 64, D % 8 == 0.
SYNFMC_API int synfmc_temporal_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int N, int F, int H, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cdiv(F, 16)) {
    case 1: return launch_bf16<1>(q, k, v, o, N, F, H, D, scale, st);
    case 2: return launch_bf16<2>(q, k, v, o, N, F, H, D, scale, st);
    case 3: return launch_bf16<3>(q, k, v, o, N, F, H, D, scale, st);
    case 4: return launch_bf16<4>(q, k, v, o, N, F, H, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

SYNFMC_API int synfmc_temporal_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int N, int F, int H, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 16) return launch_f32<16>(q, k, v, o, N, F, H, D, scale, st);
  if (F <= 32) return launch_f32<32>(q, k, v, o, N, F, H, D, scale, st);
  return launch_f32<64>(q, k, v, o, N, F, H, D, scale, st);
}
