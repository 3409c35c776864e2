// Fused GroupNorm (+SiLU/ReLU) forward on (N, S, C) channel-last slabs.
//
// Replaces synfmc_tpu/ops/pallas_groupnorm.py:_gn_kernel (called from
// _fused_group_norm_impl): per-sample group statistics in fp32 with the
// one-pass E[x^2] - E[x]^2 formula of ops/norms.py, the affine folded into
// one per-channel scale/shift, and the activation fused into the write.
//
// Bound: bytes.  It reads x twice (stats, normalise) and writes it once; the
// arithmetic is a few operations per element.  The TPU kernel kept one
// sample's slab resident in VMEM; a Hopper SM has 227 KB, and one VAE sample
// is 12.6 M elements over only 32 groups, so a block per (sample, group)
// would leave most of the 132 SMs idle.  Instead:
//   1. gn_stats:    grid (chunks, N); each block reduces a run of rows of one
//                   sample to per-group partial (sum, sumsq) in fp32, a
//                   thread summing 8 (bf16) or 4 (fp32) channels from 16-byte
//                   loads, a warp reading consecutive addresses of a row;
//   2. gn_finalize: grid N; sums the partials, computes mean/rstd per group
//                   and the folded per-channel (gamma, beta);
//   3. gn_apply:    grid-stride x * gamma + beta (+act) over 16-byte vectors.
// Any C with C % G == 0 is taken: group widths on the UNet path are 10..80
// channels, so groups are reduced from a per-channel shared-memory buffer
// rather than by power-of-two tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ part, int S, int C,
                         int G, int rows_per_chunk, int chunks) {
  extern __shared__ float sh[];  // [2 * C]: per-channel sum, sumsq
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xn = x + (size_t)n * S * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) sh[c] = 0.f;
  __syncthreads();
  // Each thread owns VE consecutive channels (one 16-byte load per row) when
  // C allows, else one channel; `width` channel groups x `lanes` row-lanes,
  // so a warp reads consecutive addresses of a row.
  constexpr int VE = 16 / sizeof(T);
  const int ve = (C % VE == 0) ? VE : 1;
  const int nvec = C / ve;
  const int width = min(nvec, (int)blockDim.x);
  const int lanes = max(1, (int)blockDim.x / width);
  const int l = threadIdx.x / width;
  const int cl = threadIdx.x % width;
  if (l < lanes) {
    for (int v0 = 0; v0 < nvec; v0 += width) {
      const int c = (v0 + cl) * ve;
      if (c >= C) continue;
      float s[VE], q[VE];
#pragma unroll
      for (int j = 0; j < VE; ++j) s[j] = q[j] = 0.f;
      if (ve == VE) {
        for (int r = r0 + l; r < r1; r += lanes) {
          uint4 pack = *reinterpret_cast<const uint4*>(xn + (size_t)r * C + c);
          const T* el = reinterpret_cast<const T*>(&pack);
#pragma unroll
          for (int j = 0; j < VE; ++j) {
            const float v = to_f(el[j]);
            s[j] += v;
            q[j] += v * v;
          }
        }
      } else {
        for (int r = r0 + l; r < r1; r += lanes) {
          const float v = to_f(xn[(size_t)r * C + c]);
          s[0] += v;
          q[0] += v * v;
        }
      }
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        if (j < ve) {
          atomicAdd(&sh[c + j], s[j]);
          atomicAdd(&sh[C + c + j], q[j]);
        }
      }
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += sh[g * cg + j];
      q += sh[C + g * cg + j];
    }
    float* p = part + (((size_t)n * chunks + chunk) * G + g) * 2;
    p[0] = s;
    p[1] = q;
  }
}

template <typename T>
__global__ void gn_finalize(const float* __restrict__ part, const T* __restrict__ scale,
                            const T* __restrict__ bias, float* __restrict__ coef, int S, int C,
                            int G, int chunks, float eps) {
  extern __shared__ float sh[];  // [2 * G]: mean, rstd
  const int n = blockIdx.x;
  const int cg = C / G;
  const float inv_count = 1.f / ((float)S * (float)cg);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float* p = part + (((size_t)n * chunks + k) * G + g) * 2;
      s += p[0];
      q += p[1];
    }
    const float mean = s * inv_count;
    const float var = q * inv_count - mean * mean;
    sh[g] = mean;
    sh[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float gamma = to_f(scale[c]) * sh[G + g];
    float* o = coef + ((size_t)n * C + c) * 2;
    o[0] = gamma;
    o[1] = to_f(bias[c]) - sh[g] * gamma;
  }
}

// grid (blocks, N): 16-byte vectors of one sample; C % (16 / sizeof(T)) == 0
// keeps a vector inside one row, so its channel index is computed once.
template <typename T>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ coef,
                         T* __restrict__ out, int SC, int C, int act) {
  constexpr int VE = 16 / sizeof(T);
  const int n = blockIdx.y;
  const T* xn = x + (size_t)n * SC;
  T* on = out + (size_t)n * SC;
  const float2* kn = reinterpret_cast<const float2*>(coef) + (size_t)n * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < SC / VE; i += gridDim.x * blockDim.x) {
    const int c0 = (i * VE) % C;
    uint4 pack = *reinterpret_cast<const uint4*>(xn + (size_t)i * VE);
    T* el = reinterpret_cast<T*>(&pack);
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      const float2 k = kn[c0 + j];
      float v = to_f(el[j]) * k.x + k.y;
      if (act == 1) v = v / (1.f + __expf(-v));
      else if (act == 2) v = fmaxf(v, 0.f);
      el[j] = from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(on + (size_t)i * VE) = pack;
  }
}

// scalar variant for C not a multiple of the vector width
template <typename T>
__global__ void gn_apply_scalar(const T* __restrict__ x, const float* __restrict__ coef,
                                T* __restrict__ out, int SC, int C, int act) {
  const int n = blockIdx.y;
  const float2* kn = reinterpret_cast<const float2*>(coef) + (size_t)n * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < SC; i += gridDim.x * blockDim.x) {
    const float2 k = kn[i % C];
    float v = to_f(x[(size_t)n * SC + i]) * k.x + k.y;
    if (act == 1) v = v / (1.f + __expf(-v));
    else if (act == 2) v = fmaxf(v, 0.f);
    out[(size_t)n * SC + i] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, float* work,
           int N, int S, int C, int G, float eps, int act, int chunks, cudaStream_t stream) {
  const int rows_per_chunk = cdiv(S, chunks);
  chunks = cdiv(S, rows_per_chunk);
  float* part = work;                                  // [N, chunks, G, 2]
  float* coef = work + (size_t)N * chunks * G * 2;     // [N, C, 2]
  gn_stats<T><<<dim3(chunks, N), kThreads, 2 * C * sizeof(float), stream>>>(
      (const T*)x, part, S, C, G, rows_per_chunk, chunks);
  gn_finalize<T><<<N, kThreads, 2 * G * sizeof(float), stream>>>(
      part, (const T*)scale, (const T*)bias, coef, S, C, G, chunks, eps);
  const bool vec = C % (16 / (int)sizeof(T)) == 0;
  const int items = vec ? S * C / (16 / (int)sizeof(T)) : S * C;
  const int blocks = max(1, min(cdiv(items, kThreads), cdiv(132 * 16, N)));
  if (vec)
    gn_apply<T><<<dim3(blocks, N), kThreads, 0, stream>>>((const T*)x, coef, (T*)out, S * C, C,
                                                          act);
  else
    gn_apply_scalar<T><<<dim3(blocks, N), kThreads, 0, stream>>>((const T*)x, coef, (T*)out,
                                                                 S * C, C, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, S, C) contiguous, 16-byte aligned, S*C < 2^31; scale, bias: (C,)
// of x's type; work: fp32
// scratch of N*chunks*G*2 + N*C*2 elements; act: 0 none, 1 silu, 2 relu.
SYNFMC_API int synfmc_group_norm_bf16(const void* x, const void* scale, const void* bias,
                                      void* out, float* work, int N, int S, int C, int G,
                                      float eps, int act, int chunks, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, out, work, N, S, C, G, eps, act, chunks,
                               (cudaStream_t)stream);
}

SYNFMC_API int synfmc_group_norm_f32(const void* x, const void* scale, const void* bias,
                                     void* out, float* work, int N, int S, int C, int G,
                                     float eps, int act, int chunks, void* stream) {
  return launch<float>(x, scale, bias, out, work, N, S, C, G, eps, act, chunks,
                       (cudaStream_t)stream);
}
