// Warp-level tensor-core helpers shared by the attention kernels: ldmatrix,
// mma.sync m16n8k16 and m16n8k8 (bf16 in, fp32 accumulate), cp.async, the
// padded shared-memory tile layout both flash directions use, the packed
// row slabs of both temporal directions, and the device's SM count and
// opt-in shared memory.
#pragma once

#include "common.cuh"

namespace synfmc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices from shared memory; lane l supplies the row address
// of matrix l / 8 and receives row l / 4, columns 2*(l % 4) and +1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, transposed: lane l receives rows 2*(l % 4) and +1 of column l / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 b16 matrices: lanes 0-15 supply the row addresses (matrix l / 8),
// lane l receives row l / 4, columns 2*(l % 4) and +1 of each.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The same, transposed.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col).  Fragment
// layout (PTX ISA, mma.m16n8k16): with g = lane / 4, t = lane % 4, a holds
// rows g / g+8 x columns 2t, 2t+1 (+8); b holds rows 2t, 2t+1 (+8) x column g;
// c holds rows g (c0, c1) and g+8 (c2, c3) x columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k = 8 shape, m16n8k8: a holds rows g (a0) and g+8 (a1) x columns 2t,
// 2t+1; b holds rows 2t, 2t+1 x column g; c as above.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4-byte asynchronous copy (through L1); zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared row stride: DP + 8 elements keeps rows 16-byte aligned and puts the
// 8 rows an ldmatrix reads on distinct banks.
template <int DP> __host__ __device__ constexpr int lds() { return DP + 8; }

// rows [row0, row0 + ROWS) of one head slice -> shared [ROWS][lds], zero past
// S and D, with cp.async (the caller commits and waits).
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int row0, int S, int C, int col0,
                                          int D) {
  constexpr int VPR = DP / 8;
  for (int e = threadIdx.x; e < ROWS * VPR; e += blockDim.x) {
    const int r = e / VPR, dv = e % VPR;
    const int row = row0 + r;
    const bool ok = row < S && dv * 8 < D;
    cp_async16(dst + r * lds<DP>() + dv * 8, ok ? src + (size_t)row * C + col0 + dv * 8 : src,
               ok);
  }
}

// The same tile multiplied by `scale` in bf16 (the scaled q of the forward),
// with plain 16-byte loads.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_scaled(const __nv_bfloat16* __restrict__ src,
                                                 __nv_bfloat16* dst, int row0, int S, int C,
                                                 int col0, int D, float scale) {
  for (int e = threadIdx.x; e < ROWS * (DP / 8); e += blockDim.x) {
    const int r = e / (DP / 8), dv = e % (DP / 8);
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < S && dv * 8 < D) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * C + col0 + dv * 8);
      __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) el[j] = __float2bfloat16(__bfloat162float(el[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * lds<DP>() + dv * 8) = val;
  }
}

// Shared row stride (elements) of a packed row segment of `seg` columns: an
// odd number of 16-byte chunks, so the 8 rows an ldmatrix reads fall on
// distinct banks.
__host__ __device__ inline int seg_stride(int seg) { return seg + ((seg / 8) % 2 ? 0 : 8); }

constexpr int kMaxDevices = 16;

// The device's SM count and opt-in shared memory per block, read once per
// process and device.
struct DeviceInfo {
  int dev, sms, optin;
};
inline cudaError_t device_info(DeviceInfo* info) {
  static int sms[kMaxDevices] = {}, optin[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *info = {dev, sms[dev], optin[dev]};
  return cudaSuccess;
}

inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace synfmc

// Every multiple of 16 up to 256: the head dim padded to the mma depth.
#define SYNFMC_FOR_EACH_DP(X)                                                                 \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) X(224) \
  X(240) X(256)
