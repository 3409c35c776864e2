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
// recomputed output is never formed: delta comes from the dP row the thread
// already holds.
//
// Bound: bytes.  At F = 16 a (row, head) pair does ~10*F*F*D = 102 KFLOP on
// 7*F*D*2 = 9 KB (q, k, v, dO in; dq, dk, dv out), 11 FLOP/byte, far below
// the ~295 FLOP/byte where the H100's tensor cores would become the limit.
// Rows are independent, so nothing crosses blocks (the TPU kernel had no
// cross-step accumulation either).  The design moves each byte once:
//   - a block owns `ipb` (row, head) items and reads their Q, K, V and dO
//     head slices once with 16-byte loads into shared memory (rows at an odd
//     32-bit word stride, as in temporal_fwd.cu);
//   - one thread per (item, query) recomputes its F logits and softmax in
//     registers and writes its row of P and dS (rounded) to shared memory;
//   - dQ needs only the thread's own dS row; dK and dV sum over queries, so
//     one thread per (item, key) reduces a column of dS or P;
//   - each result overwrites an input matrix no later phase reads (dQ -> V,
//     dV -> K, dK -> dO) and leaves with 16-byte stores.
#include "common.cuh"

namespace {

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
  return launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale,
                               (cudaStream_t)stream);
}

SYNFMC_API int synfmc_temporal_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv, int N,
                                       int F, int H, int D, float scale, void* stream) {
  return launch<float>(q, k, v, dout, dq, dk, dv, N, F, H, D, scale, (cudaStream_t)stream);
}
