// Packed temporal self-attention forward on (N, F, C = H*D) tensors.
//
// Replaces synfmc_tpu/ops/temporal_attention.py:_fwd_kernel (called from
// _fwd_call): per row n, per head h, softmax(scale * Q K^T) V over the F
// positions of that row, reading and writing the packed layout the QKV Dense
// produces (no head-split transpose).  Logits and softmax in fp32, the scale
// applied to the fp32 logits, P normalised before PV and rounded to the
// operand type, PV accumulated in fp32.
//
// Bound: bytes.  At F = 16 a (row, head) pair does 4*F*F*D = 41 KFLOP on
// 4*F*D*2 = 5 KB, 8 FLOP/byte, far below the ~295 FLOP/byte where the H100's
// tensor cores would become the limit.  So the design spends nothing on
// tensor cores and everything on moving each byte once:
//   - a block owns `ipb` (row, head) items; their Q/K/V head slices are read
//     once from device memory with 16-byte vector loads into shared memory;
//   - one thread per (item, query position) keeps its F logits in registers
//     (F <= 64, templated on a power-of-two bound), so the softmax needs no
//     cross-thread reduction;
//   - K and V rows are broadcast reads; Q rows use an odd 32-bit word stride
//     so the per-thread rows fall on distinct banks;
//   - the output overwrites the thread's own Q row in shared memory and
//     leaves with 16-byte vector stores.
#include "common.cuh"

namespace {

template <typename T, int MAXF>
__global__ void temporal_fwd(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, int items, int F,
                             int H, int D, int ipb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = row_stride<T>(D);
  const int per = F * ld;  // one matrix of one item
  const int C = H * D;
  const int item0 = blockIdx.x * ipb;
  const int nitems = min(ipb, items - item0);
  constexpr int VE = vec_elems<T>();
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
    const T* eq = reinterpret_cast<const T*>(&vq);
    const T* ek = reinterpret_cast<const T*>(&vk);
    const T* ev = reinterpret_cast<const T*>(&vv);
    T* base = sm + (size_t)it * 3 * per + f * ld + dv * VE;
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
    T* Q = sm + (size_t)it * 3 * per;
    const T* K = Q + per;
    const T* V = Q + 2 * per;
    float s[MAXF];
#pragma unroll
    for (int j = 0; j < MAXF; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = to_f(Q[i * ld + d]);
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < F) s[j] += qd * to_f(K[j * ld + d]);
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
      if (j < F) s[j] = round_to<T>(s[j] * inv);
    // Q row i is read only by this thread: overwrite it with the output.
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAXF; ++j)
        if (j < F) acc += s[j] * to_f(V[j * ld + d]);
      Q[i * ld + d] = from_f<T>(acc);
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
    T* ep = reinterpret_cast<T*>(&pack);
    const T* src = sm + (size_t)it2 * 3 * per + f * ld + dv * VE;
#pragma unroll
    for (int j = 0; j < VE; ++j) ep[j] = src[j];
    *reinterpret_cast<uint4*>(o + ((size_t)n * F + f) * C + (size_t)h * D + dv * VE) = pack;
  }
}

template <typename T, int MAXF>
int launch_f(const void* q, const void* k, const void* v, void* o, int N, int F, int H, int D,
             float scale, cudaStream_t stream) {
  const int per_item = 3 * F * row_stride<T>(D) * (int)sizeof(T);
  int ipb = 256 / F;
  if (ipb * per_item > 64 * 1024) ipb = (64 * 1024) / per_item;
  if (ipb < 1) ipb = 1;
  const int smem = ipb * per_item;
  auto kern = temporal_fwd<T, MAXF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int items = N * H;
  kern<<<cdiv(items, ipb), ipb * F, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                    (T*)o, items, F, H, D, ipb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int N, int F, int H, int D,
           float scale, cudaStream_t stream) {
  if (F <= 16) return launch_f<T, 16>(q, k, v, o, N, F, H, D, scale, stream);
  if (F <= 32) return launch_f<T, 32>(q, k, v, o, N, F, H, D, scale, stream);
  return launch_f<T, 64>(q, k, v, o, N, F, H, D, scale, stream);
}

}  // namespace

// q, k, v, o: (N, F, H*D) contiguous, 16-byte aligned; F <= 64, D % 8 == 0.
SYNFMC_API int synfmc_temporal_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int N, int F, int H, int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, N, F, H, D, scale, (cudaStream_t)stream);
}

SYNFMC_API int synfmc_temporal_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int N, int F, int H, int D, float scale, void* stream) {
  return launch<float>(q, k, v, o, N, F, H, D, scale, (cudaStream_t)stream);
}
