// Fused GroupNorm (+SiLU/ReLU) forward on (N, S, C) channel-last slabs.
//
// Replaces synfmc_tpu/ops/pallas_groupnorm.py:_gn_kernel (called from
// _fused_group_norm_impl): per-sample group statistics in fp32 with the
// one-pass E[x^2] - E[x]^2 formula of ops/norms.py, the affine folded into
// one per-channel scale/shift, and the activation fused into the write.
//
// Bound: bytes.  x is read and the output written; the arithmetic is a few
// operations an element.  The TPU kernel held one sample's slab in VMEM and
// reduced it on the MXU.  A Hopper SM holds 227 KB, so a sample is cut into
// items of whole groups, and an item into the row slices of the blocks of a
// thread-block cluster, whose shared memory together holds the item:
//
//   mode A, gn_cluster (one launch; x crosses HBM once each way): an item is
//     (sample, a run of R groups).  Each of its K blocks copies its rows of
//     the run into shared memory with 16-byte cp.async, all in flight at
//     once; each thread sums the vectors it copied into fp32 (sum, sumsq)
//     of the two groups a vector touches, a warp gathers a group's sums in
//     a fixed order, and the cluster exchanges the per-group partials over
//     distributed shared memory: every block sums the K partials in rank
//     order, so all compute the same mean and rstd.  Each then normalises
//     its rows from shared memory, the per-channel scale and shift in
//     registers, and writes them once.
//   mode B, gn_partials + gn_apply (two launches, two reads): a slab whose
//     narrowest item fits no cluster (the VAE's 25-50 MB levels).  The stats
//     pass reduces row chunks, several 16-byte loads in flight a thread, and
//     each cluster of chunks sums its partials in rank order into one.  The
//     apply pass's blocks combine a sample's partials in their prologue (no
//     finalize launch) and stream x again.
//
// The plan (mode, run, cluster size, rows a block, vector bytes, shared
// bytes) comes from ops/fused_groupnorm.py:_plan; the entry checks it against
// its own layout and the card's cluster occupancy, and refuses what it cannot
// run.  Any C with C % G == 0 is taken: the vector is the widest of 16, 8, 4
// or 2 bytes that divides the run's row and touches at most two groups, so
// C that is not a multiple of 8 runs on narrower copies.
#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "mma.cuh"

namespace cg = cooperative_groups;
using namespace synfmc;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread in mode B
// gn_cluster's blocks an SM: 65,536 registers hold five blocks of 256
// threads at 48 registers a thread (the plan's tiles of at most 32 KB would
// let shared memory hold six).
constexpr int kResidentA = 5;

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

// A block's threads over a slice of `vpr` vectors a row: thread t owns the
// columns t % cols (+ cols, ...) and the rows t / cols (+ lanes, ...), so a
// warp reads consecutive vectors of a row and keeps its scale and shift in
// registers.  _plan mirrors it (ops/fused_groupnorm.py:_lanes).
__host__ __device__ inline int lanes_of(int vpr, int rows) {
  const int lanes = kThreads / (vpr < kThreads ? vpr : kThreads);
  return lanes < rows ? lanes : (rows > 1 ? rows : 1);
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// A vector of VE channels starting at a multiple of VE touches at most two
// groups of cgw channels (the plan narrows the vector until it does), so a
// thread folds its channel sums into two group partials.
inline int groups_spanned(int VE, int cgw) {
  int most = 1;
  for (int v = 0; v < cgw; ++v) {
    const int span = (v * VE + VE - 1) / cgw - v * VE / cgw + 1;
    most = span > most ? span : most;
  }
  return most;
}

// Mode A's shared memory: the tile of rows x W (x's type), then fp32
// [lanes][vpr] float4 group-pair sums, [2][R] partials (read by the
// cluster), [2][R] stats.
inline size_t smem_a(int rows, int W, int R, int esize, int vb) {
  const int vpr = W * esize / vb, lanes = lanes_of(vpr, rows);
  return align16((size_t)rows * W * esize) + 16 * (size_t)lanes * vpr + 4 * 4 * R;
}
// Mode B's stats block: [lanes][vpr] float4 group-pair sums, [2][G]
// partials; its apply block: [2][kThreads] partial sums, [2][G] stats.
inline size_t smem_b(int rows, int C, int G, int esize, int vb) {
  const int vpr = C * esize / vb, lanes = lanes_of(vpr, rows);
  return 16 * (size_t)lanes * vpr + 4 * 2 * G;
}
inline size_t smem_apply(int G) { return 4 * (2 * (size_t)kThreads + 2 * G); }

template <int VB>
__device__ __forceinline__ void copy_in(void* dst, const void* src) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  } else if constexpr (VB >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(VB));
  } else {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}

template <typename T, int VE, typename V>
__device__ __forceinline__ void accumulate(const V& pack, float (&s)[VE], float (&q)[VE]) {
  const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
  for (int j = 0; j < VE; ++j) {
    const float f = to_f(e[j]);
    s[j] += f;
    q[j] = fmaf(f, f, q[j]);
  }
}

// SiLU as v / (1 + 2^(-v log2 e)): ex2.approx and rcp.approx, nothing that
// cancels for negative v (h + h tanh(h), h = v / 2, loses the tail to
// tanh.approx's absolute error near -1).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <typename T, int VE, typename V>
__device__ __forceinline__ V normalise(V pack, const float (&ga)[VE], const float (&be)[VE],
                                       int act) {
  T* e = reinterpret_cast<T*>(&pack);
#pragma unroll
  for (int j = 0; j < VE; ++j) {
    float v = fmaf(to_f(e[j]), ga[j], be[j]);
    if (act == 1) v = silu(v);
    else if (act == 2) v = fmaxf(v, 0.f);
    e[j] = from_f<T>(v);
  }
  return pack;
}

// The folded affine of a vector's VE channels: gamma = scale * rstd and
// beta = bias - mean * gamma, channel c0 + j of groups of cgw channels whose
// stats are stat[g] (mean) and stat[R + g] (rstd).
template <typename T, int VE, typename V>
__device__ __forceinline__ void affine(const V& sc, const V& bi, int c0, int cgw, const float* stat,
                                       int R, float (&ga)[VE], float (&be)[VE]) {
  const T* s = reinterpret_cast<const T*>(&sc);
  const T* b = reinterpret_cast<const T*>(&bi);
#pragma unroll
  for (int j = 0; j < VE; ++j) {
    const int g = (c0 + j) / cgw;
    ga[j] = to_f(s[j]) * stat[R + g];
    be[j] = to_f(b[j]) - stat[g] * ga[j];
  }
}

// Sums the vectors src[r * rs] of rows r = first, first + step, ... < end
// into s and q, kUnroll loads in flight.
template <typename T, int VE, typename V>
__device__ __forceinline__ void sum_column(const V* src, size_t rs, int first, int end, int step,
                                           float (&s)[VE], float (&q)[VE]) {
  int r = first;
  for (; r + (kUnroll - 1) * step < end; r += kUnroll * step) {
    V a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(src + (size_t)(r + u * step) * rs);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<T, VE>(a[u], s, q);
  }
  for (; r < end; r += step) accumulate<T, VE>(__ldg(src + (size_t)r * rs), s, q);
}

// Folds a column's channel sums (its vector's first channel is c) into the
// two groups the vector touches: red[i] = (sum, sumsq) of group c / cgw,
// then of the next.
template <int VE>
__device__ __forceinline__ void store_pair(float4* red, int i, int c, int cgw,
                                           const float (&s)[VE], const float (&q)[VE]) {
  const int g0 = c / cgw;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < VE; ++j) {
    if ((c + j) / cgw == g0) {
      a.x += s[j];
      a.y += q[j];
    } else {
      a.z += s[j];
      a.w += q[j];
    }
  }
  red[i] = a;
}

// Group-pair sums red[lanes][vpr] -> per-group (sum, sumsq) of the R groups
// of cgw channels into part[2][R]: a warp a group gathers the entries of
// the columns that touch it, lanes in a fixed order, and sums them with a
// fixed shuffle tree.  Starts and ends synchronised.
__device__ __forceinline__ void group_sums(const float4* red, float* part, int lanes, int vpr,
                                           int VE, int cgw, int R) {
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < R; g += kThreads / 32) {
    const int vlo = g * cgw / VE, ncol = (g * cgw + cgw - 1) / VE - vlo + 1;
    float s = 0.f, q = 0.f;
    for (int i = lane; i < lanes * ncol; i += 32) {
      const int v = vlo + i % ncol;
      const float4 p = red[(i / ncol) * vpr + v];
      const bool first = v * VE / cgw == g;
      s += first ? p.x : p.z;
      q += first ? p.y : p.w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      part[g] = s;
      part[R + g] = q;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Mode A.  Grid: N * (G / R) items x K blocks, clusters of K along x; block
// rank k holds rows [k * rows, (k + 1) * rows) of its item's W = R * cgw
// channels.  Each thread copies its vectors with cp.async, all in flight at
// once, and sums the same vectors once they land: it reads only what it
// copied, so the sums need no barrier.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, kResidentA) gn_cluster(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    T* __restrict__ out, int S, int C, int cgw, int R, int rows, float eps, int act) {
  constexpr int VE = VB / (int)sizeof(T);
  using V = typename Vec<VB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int W = R * cgw, runs = C / W, item = blockIdx.x / K;
  const int c0 = (item % runs) * W, r0 = rank * rows, nrows = max(0, min(rows, S - r0));
  const int vpr = W / VE, cols = min(vpr, kThreads), lanes = lanes_of(vpr, rows);
  const int l = threadIdx.x / cols, cl = threadIdx.x % cols;
  V* tile = reinterpret_cast<V*>(smem);  // vector (r, v) at tile[r * vpr + v]
  float4* red = reinterpret_cast<float4*>(smem + align16((size_t)rows * W * sizeof(T)));
  float* part = reinterpret_cast<float*>(red + lanes * vpr);
  float* stat = part + 2 * R;
  const size_t rs = (size_t)C / VE, base = ((size_t)(item / runs) * S + r0) * rs + c0 / VE;
  const V* src = reinterpret_cast<const V*>(x) + base;
  const V* scv = reinterpret_cast<const V*>(scale + c0);
  const V* biv = reinterpret_cast<const V*>(bias + c0);
  V sc0 = {}, bi0 = {};  // the first column's scale and bias, read early
  if (l < lanes) {
    for (int v = cl; v < vpr; v += cols)
      for (int r = l; r < nrows; r += lanes) copy_in<VB>(tile + r * vpr + v, src + r * rs + v);
    cp_commit();
    sc0 = __ldg(scv + cl);
    bi0 = __ldg(biv + cl);
    cp_wait<0>();
    for (int v = cl; v < vpr; v += cols) {
      float s[VE] = {}, q[VE] = {};
#pragma unroll 4
      for (int r = l; r < nrows; r += lanes) accumulate<T, VE>(tile[r * vpr + v], s, q);
      store_pair<VE>(red, l * vpr + v, v * VE, cgw, s, q);
    }
  }
  group_sums(red, part, lanes, vpr, VE, cgw, R);

  cluster.sync();  // every block's partials are visible to the cluster
  const float inv_count = 1.f / ((float)S * (float)cgw);
  for (int g = threadIdx.x; g < R; g += kThreads) {
    float sum = 0.f, sq = 0.f;
    for (int k = 0; k < K; ++k) {  // rank order: every block computes the same stats
      const float* p = cluster.map_shared_rank(part, k);
      sum += p[g];
      sq += p[R + g];
    }
    const float mean = sum * inv_count;
    stat[g] = mean;
    stat[R + g] = rsqrtf(sq * inv_count - mean * mean + eps);
  }
  cluster_arrive();  // done reading the other blocks' shared memory (values in hand)
  __syncthreads();

  if (l < lanes) {
    V* dst = reinterpret_cast<V*>(out) + base;
    for (int v = cl; v < vpr; v += cols) {
      float ga[VE], be[VE];
      affine<T, VE>(v == cl ? sc0 : __ldg(scv + v), v == cl ? bi0 : __ldg(biv + v), v * VE, cgw,
                    stat, R, ga, be);
#pragma unroll 4
      for (int r = l; r < nrows; r += lanes)
        dst[r * rs + v] = normalise<T, VE>(tile[r * vpr + v], ga, be, act);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

// Mode B, pass 1.  Grid (P * K, N), clusters of K chunks along x: chunk b
// reduces rows [b * rows, (b + 1) * rows) of sample n over all C channels;
// rank 0 of each cluster writes the sum of its K partials (rank order) to
// work[n][b / K][G] as (sum, sumsq).
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads) gn_partials(const T* __restrict__ x,
                                                        float2* __restrict__ work, int S, int C,
                                                        int G, int rows) {
  constexpr int VE = VB / (int)sizeof(T);
  using V = typename Vec<VB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = blockIdx.y, r0 = blockIdx.x * rows, r1 = min(S, r0 + rows);
  const int vpr = C / VE, cols = min(vpr, kThreads), lanes = lanes_of(vpr, rows);
  const int l = threadIdx.x / cols, cl = threadIdx.x % cols;
  float4* red = reinterpret_cast<float4*>(smem);
  float* part = reinterpret_cast<float*>(red + lanes * vpr);
  const V* xn = reinterpret_cast<const V*>(x + (size_t)n * S * C);
  if (l < lanes) {
    for (int v = cl; v < vpr; v += cols) {
      float s[VE] = {}, q[VE] = {};
      sum_column<T, VE>(xn + v, (size_t)vpr, r0 + l, r1, lanes, s, q);
      store_pair<VE>(red, l * vpr + v, v * VE, C / G, s, q);
    }
  }
  group_sums(red, part, lanes, vpr, VE, C / G, G);

  cluster.sync();
  if (rank == 0) {
    float2* dst = work + ((size_t)n * (gridDim.x / K) + blockIdx.x / K) * G;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float s = 0.f, q = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* p = cluster.map_shared_rank(part, k);
        s += p[g];
        q += p[G + g];
      }
      dst[g] = make_float2(s, q);
    }
  }
  cluster.sync();  // rank 0 has read every block's partials
}

// Mode B, pass 2.  Grid (chunks, N): each block sums its sample's P
// partials (threads split each group's P in a fixed order), then normalises
// its rows.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads) gn_apply(
    const T* __restrict__ x, const float2* __restrict__ work, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ out, int S, int C, int G, int rows, int P,
    float eps, int act) {
  constexpr int VE = VB / (int)sizeof(T);
  using V = typename Vec<VB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [2][kThreads]
  float* stat = acc + 2 * kThreads;             // [2][G]
  const int n = blockIdx.y, r0 = blockIdx.x * rows, r1 = min(S, r0 + rows), cgw = C / G;
  const int vpr = C / VE, cols = min(vpr, kThreads), lanes = lanes_of(vpr, rows);
  const int l = threadIdx.x / cols, cl = threadIdx.x % cols;
  const V* scv = reinterpret_cast<const V*>(scale);
  const V* biv = reinterpret_cast<const V*>(bias);
  V sc0 = {}, bi0 = {};  // the first column's scale and bias, read early
  if (l < lanes) {
    sc0 = __ldg(scv + cl);
    bi0 = __ldg(biv + cl);
  }
  const float inv_count = 1.f / ((float)S * (float)cgw);
  const float2* pn = work + (size_t)n * P * G;
  const int sub = G <= kThreads ? kThreads / G : 1;  // threads a group
  if (G <= kThreads && (int)threadIdx.x < sub * G) {
    const int g = threadIdx.x % G, k0 = threadIdx.x / G;
    float s = 0.f, q = 0.f;
    for (int k = k0; k < P; k += sub) {
      const float2 p = pn[(size_t)k * G + g];
      s += p.x;
      q += p.y;
    }
    acc[k0 * G + g] = s;
    acc[kThreads + k0 * G + g] = q;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f, q = 0.f;
    if (G <= kThreads) {
      for (int k0 = 0; k0 < sub; ++k0) {
        s += acc[k0 * G + g];
        q += acc[kThreads + k0 * G + g];
      }
    } else {
      for (int k = 0; k < P; ++k) {
        const float2 p = pn[(size_t)k * G + g];
        s += p.x;
        q += p.y;
      }
    }
    const float mean = s * inv_count;
    stat[g] = mean;
    stat[G + g] = rsqrtf(q * inv_count - mean * mean + eps);
  }
  __syncthreads();

  if (l >= lanes) return;
  const V* xn = reinterpret_cast<const V*>(x + (size_t)n * S * C);
  V* on = reinterpret_cast<V*>(out + (size_t)n * S * C);
  for (int v = cl; v < vpr; v += cols) {
    float ga[VE], be[VE];
    affine<T, VE>(v == cl ? sc0 : __ldg(scv + v), v == cl ? bi0 : __ldg(biv + v), v * VE, cgw,
                  stat, G, ga, be);
    int r = r0 + l;
    for (; r + (kUnroll - 1) * lanes < r1; r += kUnroll * lanes) {
      V a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(xn + (size_t)(r + u * lanes) * vpr + v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        on[(size_t)(r + u * lanes) * vpr + v] = normalise<T, VE>(a[u], ga, be, act);
    }
    for (; r < r1; r += lanes)
      on[(size_t)r * vpr + v] = normalise<T, VE>(__ldg(xn + (size_t)r * vpr + v), ga, be, act);
  }
}

// cudaFuncAttributeMaxDynamicSharedMemorySize raised to the opt-in once per
// kernel and device, and whether the card can hold one cluster of the
// launch's K blocks at its shared bytes (cudaOccupancyMaxActiveClusters),
// each asked once per key.
struct Known {
  const void* fn;
  int dev, K;
  size_t smem;
  int clusters;  // -1: the attribute was raised
};

template <typename Kernel>
cudaError_t ready(Kernel kern, const cudaLaunchConfig_t& cfg, const DeviceInfo& info) {
  static std::mutex mu;
  static std::vector<Known> known;
  std::lock_guard<std::mutex> lock(mu);
  const void* fn = reinterpret_cast<const void*>(kern);
  const int K = (int)cfg.attrs[0].val.clusterDim.x;
  bool raised = false;
  for (const Known& k : known) {
    if (k.fn != fn || k.dev != info.dev) continue;
    if (k.clusters < 0) raised = true;
    else if (k.K == K && k.smem == cfg.dynamicSmemBytes)
      return k.clusters >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  cudaError_t e = cudaSuccess;
  if (!raised) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, info.optin);
    if (e != cudaSuccess) return e;
    known.push_back({fn, info.dev, 0, 0, -1});
  }
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  known.push_back({fn, info.dev, K, cfg.dynamicSmemBytes, clusters});
  return clusters >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(dim3 grid, size_t smem, int K, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The plan: mode 0 (A) or 1 (B); run = R groups an item (A); cluster = K;
// rows a block; vb = vector bytes; smem = the dynamic shared bytes of the
// plan's cluster kernel, which must equal this file's layout.
template <typename T, int VB>
int launch_vb(const T* x, const T* scale, const T* bias, T* out, float* work, int N, int S, int C,
              int G, float eps, int act, int mode, int run, int K, int rows, size_t smem,
              cudaStream_t stream) {
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  const int esize = (int)sizeof(T), cgw = C / G;
  if (smem > (size_t)info.optin || groups_spanned(VB / esize, cgw) > 2)
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    if (G % run != 0 || (run * cgw * esize) % VB != 0 ||
        smem != smem_a(rows, run * cgw, run, esize, VB))
      return (int)cudaErrorInvalidValue;
    Launch L(dim3((unsigned)((long)N * (G / run) * K)), smem, K, stream);
    e = ready(gn_cluster<T, VB>, L.cfg, info);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&L.cfg, gn_cluster<T, VB>, x, scale, bias, out, S, C, cgw, run, rows,
                           eps, act);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (smem != smem_b(rows, C, G, esize, VB)) return (int)cudaErrorInvalidValue;
  const int chunks = cdiv(S, rows), P = cdiv(chunks, K);
  Launch stats(dim3(P * K, N), smem, K, stream);
  e = ready(gn_partials<T, VB>, stats.cfg, info);
  if (e != cudaSuccess) return (int)e;
  Launch apply(dim3(chunks, N), smem_apply(G), 1, stream);
  e = ready(gn_apply<T, VB>, apply.cfg, info);
  if (e != cudaSuccess) return (int)e;
  float2* part = reinterpret_cast<float2*>(work);
  e = cudaLaunchKernelEx(&stats.cfg, gn_partials<T, VB>, x, part, S, C, G, rows);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&apply.cfg, gn_apply<T, VB>, x, (const float2*)part, scale, bias, out, S,
                         C, G, rows, P, eps, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, float* work, int N,
           int S, int C, int G, float eps, int act, int mode, int run, int K, int rows, int vb,
           int smem, void* stream) {
  if (N < 1 || S < 1 || G < 1 || C % G != 0 || (mode != 0 && mode != 1) || K < 1 ||
      K > kMaxCluster || rows < 1 || smem < 0 || (mode == 0 && (long)rows * K < S) ||
      (C * (int)sizeof(T)) % vb != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
#define SYNFMC_GN_ARGS                                                                            \
  (const T*)x, (const T*)scale, (const T*)bias, (T*)out, work, N, S, C, G, eps, act, mode, run, K, \
      rows, (size_t)smem, (cudaStream_t)stream
  switch (vb) {
    case 16: return launch_vb<T, 16>(SYNFMC_GN_ARGS);
    case 8: return launch_vb<T, 8>(SYNFMC_GN_ARGS);
    case 4: return launch_vb<T, 4>(SYNFMC_GN_ARGS);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_vb<T, 2>(SYNFMC_GN_ARGS);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SYNFMC_GN_ARGS
}

}  // namespace

// x, out: (N, S, C) contiguous, 16-byte aligned, S*C < 2^31; scale, bias: (C,)
// of x's type; work: fp32 scratch of N * ceil(ceil(S / rows) / cluster) * G * 2
// elements in mode B (unused in mode A); act: 0 none, 1 silu, 2 relu; the
// plan's fields as ops/fused_groupnorm.py:_plan gives them (mode 0 is A, 1
// B).  Returns a
// cudaError_t: cudaErrorInvalidValue for a plan this file cannot run,
// cudaErrorInvalidConfiguration for clusters the card cannot hold.
SYNFMC_API int synfmc_group_norm_bf16(const void* x, const void* scale, const void* bias,
                                      void* out, float* work, int N, int S, int C, int G,
                                      float eps, int act, int mode, int run, int cluster,
                                      int rows, int vb, int smem, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, out, work, N, S, C, G, eps, act, mode, run,
                               cluster, rows, vb, smem, stream);
}

SYNFMC_API int synfmc_group_norm_f32(const void* x, const void* scale, const void* bias,
                                     void* out, float* work, int N, int S, int C, int G,
                                     float eps, int act, int mode, int run, int cluster,
                                     int rows, int vb, int smem, void* stream) {
  return launch<float>(x, scale, bias, out, work, N, S, C, G, eps, act, mode, run, cluster, rows,
                       vb, smem, stream);
}
