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
// What the TPU kept in VMEM.  _bwd_packed_single_kernel held a batch row's
// whole q, k, v, dO (all heads) and the per-head S x S logits, P and dS in
// VMEM (up to 80 MB); _bwd_packed_kernel and _bwd_kernel held one q-block
// and a head's whole K/V, and carried fp32 dK/dV accumulators in VMEM
// scratch from one sequential grid step to the next.  A Hopper block has at
// most 227 KB of shared memory, blocks run in no order, and nothing carries
// over between them, so the work splits into three passes:
//   1. flash_bwd_prologue: q' = bf16(q * scale) into a (B, S, H*D) scratch
//      buffer, so both main passes copy q' with 16-byte cp.async like any
//      other tile (the rounding point stays the reference's: q' is rounded
//      before its products), and delta = rowsum(dO * O) in fp32 from K1's
//      saved output.  Each thread takes 16-byte chunks of whole rows;
//      a chunk's partial dot product goes through shared memory and one
//      thread per (row, head) adds its head's partials in a fixed order;
//   2. flash_bwd_dkdv: one block per (key tile, head, batch row).  K and V
//      stay resident, their A fragments in registers, the dK/dV accumulators
//      in registers; tiles of q', dO, lse and delta stream through a ring.
//      It recomputes P^T = exp(K q'^T - lse) from the log-sum-exp K1 saved
//      and runs four products per tile: S^T, dV += P^T dO, dP^T = V dO^T,
//      dK += dS^T q';
//   3. flash_bwd_dq: one block per (query tile, head, batch row).  q' and dO
//      stay resident, their A fragments in registers; K/V tiles stream
//      through a ring; three products per tile: S, dP, dQ += dS K.
//
// Deterministic.  Seven products where five would do: the two passes both
// recompute S and dP.  Folding dQ into pass 2 needs a sum of dQ across key
// blocks, which is either an fp32 atomicAdd (its order changes from run to
// run) or an ordered semaphore between blocks.  Here each output element is
// written by exactly one block, which sums over the other side in a fixed
// loop order, and delta's partials add in a fixed order: dq, dk and dv are
// the same bits on every run, as the JAX package's backward is.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  Passes 2 and 3 are
// bound by operations at the UNet's level 0 (B=16, S=1536, H=8, D=40: 5
// products of 2*S^2*D per (b, h), 121 GFLOP against 110 MB of q, k, v, dO,
// dq, dk, dv: 0.122 ms) and by bytes at level 1 (S=384, D=80); the prologue
// by bytes (q, O, dO read, q' and delta written).  In practice the mma.sync path is held by the tensor
// pipe's instruction rate and by the ldmatrix reads that feed it, not by the
// exponentials: so the A operand of every product stays in registers, a warp
// owns two m16 tiles at DK <= 48 (each B fragment read with ldmatrix feeds
// both), and DK % 16 == 8 (D = 40) ends each product with an m16n8k8 step or
// an n = 8 tile instead of padding to 48.  wgmma with TMA, the Hopper-only
// route with twice the tensor rate and B read from shared memory without
// ldmatrix, is a later step.
//
// The ring.  A block keeps kStages buffers of one streamed tile (32 rows of
// each operand, 16-byte cp.async with zero fill past S and D; lse and delta
// by 4-byte cp.async).  Before tile i's products the block waits for tile
// i's copies (cp.async.wait_group kStages-2), passes one barrier, and starts
// the copies of tile i+kStages-1 into the buffer tile i-1 used, so up to
// kStages-1 tiles are in flight under the products; one barrier per tile.
// Rows past S: a padded query row has q' = dO = 0 and lse = delta = 0, so
// its P is 1 but it adds 0 to dV (dO = 0) and to dK (dS = 1 * (0 - 0));
// padded keys are masked to P = 0 in pass 3 and not stored by pass 2.
//
// Tiles by DK (D rounded up to 8; Tiles<DK> below).  DK <= 48: warps of two
// m-tiles (32 rows), 4 warps a block in both passes (128 resident rows), 4
// stages.  48 < DK <= 128: one m-tile a warp, 4 warps (64 keys) in pass 2
// and 8 (128 queries) in pass 3, 3 stages.  DK > 128: one m-tile a warp, 4
// warps (64 rows), 2 stages.  Streamed tiles are 32 rows; the most shared
// memory a block takes is 136 KB (DK = 256, pass 2).
//
// All products run mma.sync m16n8k16 (bf16 in, fp32 accumulate; m16n8k8 for
// the last 8 columns of D = 40) with ldmatrix, the route of flash_fwd.cu and
// temporal_*.cu: products whose A operand is a probability or dS tile take it
// straight from the accumulator registers, B operands come through ldmatrix
// (.trans where the contraction runs over rows), shared rows are padded by
// 16 bytes.  The launcher sets each instance's shared-memory attribute once
// per device.
//
// fp32: CUDA-core kernels (one thread per key for dK/dV, one per query for
// dQ) on the same three-pass plan, delta in its own pass and q scaled in
// registers, for exact float32 checks.
#include "mma.cuh"

namespace {

using namespace synfmc;
using bf16 = __nv_bfloat16;

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

// Pass 1 (bf16): q' = bf16(q * scale) and delta = rowsum(dO * O).  A block
// owns `rows` whole rows; each thread takes 16-byte chunks (neighbouring
// threads, neighbouring addresses), keeps each chunk's partial dot product
// in shared memory, and after one barrier a thread per (row, head) adds its
// head's D/8 partials in a fixed order.
__global__ void flash_bwd_prologue(const bf16* __restrict__ q, const bf16* __restrict__ o,
                                   const bf16* __restrict__ dout, bf16* __restrict__ qs,
                                   float* __restrict__ delta, int B, int S, int H, int D,
                                   int rows, float scale) {
  extern __shared__ float part[];  // [rows][C / 8]
  const int C = H * D, cpr = C / 8;
  const size_t row0 = (size_t)blockIdx.x * rows;
  const long long left = (long long)B * S - (long long)row0;
  const int nrows = left < rows ? (int)left : rows;
  const size_t base = row0 * C;
  for (int e = threadIdx.x; e < nrows * cpr; e += blockDim.x) {
    const size_t off = base + (size_t)e * 8;
    const uint4 po = *reinterpret_cast<const uint4*>(o + off);
    const uint4 pd = *reinterpret_cast<const uint4*>(dout + off);
    uint4 pq = *reinterpret_cast<const uint4*>(q + off);
    const bf16* eo = reinterpret_cast<const bf16*>(&po);
    const bf16* ed = reinterpret_cast<const bf16*>(&pd);
    bf16* eq = reinterpret_cast<bf16*>(&pq);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc += __bfloat162float(eo[j]) * __bfloat162float(ed[j]);
      eq[j] = __float2bfloat16(__bfloat162float(eq[j]) * scale);
    }
    *reinterpret_cast<uint4*>(qs + off) = pq;
    part[e] = acc;
  }
  __syncthreads();
  const int cph = D / 8;  // chunks a head
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
    const int r = i / H, h = i % H;
    const float* p = part + r * cpr + h * cph;
    float acc = 0.f;
    for (int c = 0; c < cph; ++c) acc += p[c];
    const size_t bs = row0 + r;
    delta[((bs / S) * H + h) * S + bs % S] = acc;
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes by DK, the head dim rounded up to 8 (DP: up to 16).  Pass 2
// takes 4 warps; pass 3 takes 8 at 48 < DK <= 128.  The minimum resident
// blocks cap registers so that 3 pass-3 blocks (DK <= 48) or 2 (DK <= 80)
// share an SM.
template <int DK> struct Tiles {
  static constexpr int kDP = (DK + 15) / 16 * 16;
  static constexpr int kMT = DK <= 48 ? 2 : 1;  // m16 tiles a warp owns
  static constexpr int kWarpsKV = 4;
  static constexpr int kWarpsQ = (DK <= 48 || DK > 128) ? 4 : 8;
  static constexpr int kResKV = 16 * kMT * kWarpsKV;  // keys a pass-2 block owns
  static constexpr int kResQ = 16 * kMT * kWarpsQ;    // queries a pass-3 block owns
  static constexpr int kMinBlocksKV = DK <= 48 ? 2 : 1;  // blocks an SM keeps resident
  static constexpr int kMinBlocksQ = DK <= 48 ? 3 : (DK <= 80 ? 2 : 1);
  static constexpr int kStream = 32;  // streamed rows a stage
  static constexpr int kStages = DK <= 48 ? 4 : (DK <= 128 ? 3 : 2);
  static constexpr int kLds = lds<kDP>();
  static constexpr int kTile = kStream * kLds;  // elements of one streamed operand tile
  // pass 2: K, V resident; a stage holds q', dO, lse and delta
  static constexpr size_t kDkdvSmem =
      2 * (size_t)kResKV * kLds * sizeof(bf16) +
      (size_t)kStages * (2 * kTile * sizeof(bf16) + 2 * kStream * sizeof(float));
  // pass 3: q', dO resident; a stage holds K and V
  static constexpr size_t kDqSmem =
      2 * (size_t)kResQ * kLds * sizeof(bf16) + (size_t)kStages * 2 * kTile * sizeof(bf16);
};

// The A fragments of a warp's 16*MT rows over the head dim, held in
// registers: k-steps of 16, then one of 8 when DK % 16 == 8.
template <int DK, int MT> struct ARows {
  static constexpr int kFull = DK / 16;
  static constexpr bool kTail = DK % 16 != 0;
  uint32_t full[MT][kFull > 0 ? kFull : 1][4];
  uint32_t tail[MT][2];

  // from shared rows [row][d] (the warp's first row at `rows`)
  __device__ __forceinline__ void load(const bf16* rows, int lane) {
    constexpr int LDS = Tiles<DK>::kLds;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* r = rows + (m * 16 + (lane & 15)) * LDS;
#pragma unroll
      for (int kk = 0; kk < kFull; ++kk) ldsm_x4(full[m][kk], r + kk * 16 + (lane >> 4) * 8);
      if (kTail) ldsm_x2(tail[m], r + kFull * 16);
    }
  }
};

// C (MT x 16 rows x N cols) = A B^T over the head dim, A in registers, B's N
// rows in shared at `brow` ([row][d]).
template <int DK, int MT, int N>
__device__ __forceinline__ void warp_abt(float (&c)[MT][N / 8][4], const ARows<DK, MT>& a,
                                         const bf16* brow, int lane) {
  constexpr int LDS = Tiles<DK>::kLds, FULL = DK / 16;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] = c[m][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < FULL; ++kk)
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t bb[4];
      ldsm_x4(bb, brow + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(c[m][2 * jp], a.full[m][kk], bb[0], bb[1]);
        mma_bf16(c[m][2 * jp + 1], a.full[m][kk], bb[2], bb[3]);
      }
    }
  if (DK % 16 != 0) {  // the last 8 columns of the head: one k = 8 step
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t bb[2];
      ldsm_x2(bb, brow + (jp * 16 + (lane & 15)) * LDS + FULL * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16_k8(c[m][2 * jp], a.tail[m], bb[0]);
        mma_bf16_k8(c[m][2 * jp + 1], a.tail[m], bb[1]);
      }
    }
  }
}

// acc (MT x 16 x DK) += X (MT x 16 x N, fp32 fragments rounded to bf16) times
// the N shared rows at `rows` ([row][d]): the contraction runs over rows.
template <int DK, int MT, int N>
__device__ __forceinline__ void warp_xb(float (&acc)[MT][DK / 8][4], const float (&x)[MT][N / 8][4],
                                        const bf16* rows, int lane) {
  constexpr int LDS = Tiles<DK>::kLds, FULL = DK / 16;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][0] = pack_bf16(x[m][2 * kk][0], x[m][2 * kk][1]);
      a[m][1] = pack_bf16(x[m][2 * kk][2], x[m][2 * kk][3]);
      a[m][2] = pack_bf16(x[m][2 * kk + 1][0], x[m][2 * kk + 1][1]);
      a[m][3] = pack_bf16(x[m][2 * kk + 1][2], x[m][2 * kk + 1][3]);
    }
    const bf16* r = rows + (kk * 16 + (lane & 15)) * LDS;
#pragma unroll
    for (int dp = 0; dp < FULL; ++dp) {
      uint32_t bb[4];
      ldsm_x4_t(bb, r + dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * dp], a[m], bb[0], bb[1]);
        mma_bf16(acc[m][2 * dp + 1], a[m], bb[2], bb[3]);
      }
    }
    if (DK % 16 != 0) {  // the last 8 columns: one n = 8 tile
      uint32_t bb[2];
      ldsm_x2_t(bb, r + FULL * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(acc[m][2 * FULL], a[m], bb[0], bb[1]);
    }
  }
}

// Rows g and g + 8 of each 16 x DK warp accumulator tile, times `mul`, to
// bf16 rows [row0 + 16m + g + 8r] of one head slice.
template <int DK, int MT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[MT][DK / 8][4],
                                           int row0, int S, int C, int col0, int D, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * m + g + 8 * r;
      if (row >= S) continue;
      bf16* out = dst + (size_t)row * C + col0;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        const int d = 8 * n + 2 * t;
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(out + d) =
              __floats2bfloat162_rn(acc[m][n][2 * r] * mul, acc[m][n][2 * r + 1] * mul);
      }
    }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&c)[MT][N][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) c[m][n][0] = c[m][n][1] = c[m][n][2] = c[m][n][3] = 0.f;
}

// Pass 2: dK and dV of one (key tile, head, batch row).
template <int DK>
__global__ void __launch_bounds__(Tiles<DK>::kWarpsKV * 32, Tiles<DK>::kMinBlocksKV)
    flash_bwd_dkdv(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int D) {
  using T = Tiles<DK>;
  constexpr int DP = T::kDP, LDS = T::kLds, MT = T::kMT, BM = T::kStream, ST = T::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);            // [kResKV][LDS]
  bf16* Vs = Ks + T::kResKV * LDS;                          // [kResKV][LDS]
  bf16* Qs = Vs + T::kResKV * LDS;                          // [ST][BM][LDS] q'
  bf16* Ds = Qs + ST * T::kTile;                            // [ST][BM][LDS] dO
  float* Ls = reinterpret_cast<float*>(Ds + ST * T::kTile);  // [ST][BM] lse
  float* Es = Ls + ST * BM;                                 // [ST][BM] delta

  const int k0 = blockIdx.x * T::kResKV, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int nq = cdiv(S, BM);

  auto load_stage = [&](int i) {
    const int st = i % ST, q0 = i * BM;
    load_tile<DP, BM>(qs + base, Qs + st * T::kTile, q0, S, C, h * D, D);
    load_tile<DP, BM>(dout + base, Ds + st * T::kTile, q0, S, C, h * D, D);
    for (int r = threadIdx.x; r < BM; r += blockDim.x) {
      const bool ok = q0 + r < S;
      cp_async4(Ls + st * BM + r, lse + stat + (ok ? q0 + r : 0), ok);
      cp_async4(Es + st * BM + r, delta + stat + (ok ? q0 + r : 0), ok);
    }
  };

  load_tile<DP, T::kResKV>(k + base, Ks, k0, S, C, h * D, D);
  load_tile<DP, T::kResKV>(v + base, Vs, k0, S, C, h * D, D);
  cp_commit();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nq) load_stage(i);
    cp_commit();
  }
  cp_wait<ST - 1>();  // K and V have landed
  __syncthreads();
  ARows<DK, MT> ka, va;  // the warp's keys, in registers for the whole loop
  ka.load(Ks + warp * 16 * MT * LDS, lane);
  va.load(Vs + warp * 16 * MT * LDS, lane);
  float dk_acc[MT][DK / 8][4], dv_acc[MT][DK / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int i = 0; i < nq; ++i) {
    cp_wait<ST - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();    // everyone's copies, and tile i-1's buffer is free
    if (i + ST - 1 < nq) load_stage(i + ST - 1);
    cp_commit();  // possibly empty: keeps one group per tile
    const int st = i % ST;
    const bf16* Qt = Qs + st * T::kTile;
    const bf16* Dt = Ds + st * T::kTile;
    const float* Lt = Ls + st * BM;
    const float* Et = Es + st * BM;

    // P^T = exp(K q'^T - lse): the warp's 16*MT keys x BM queries
    float pt[MT][BM / 8][4];
    warp_abt<DK, MT, BM>(pt, ka, Qt, lane);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float l0 = Lt[8 * j + 2 * t] * kLog2e, l1 = Lt[8 * j + 2 * t + 1] * kLog2e;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        pt[m][j][0] = fast_exp2(fmaf(pt[m][j][0], kLog2e, -l0));
        pt[m][j][1] = fast_exp2(fmaf(pt[m][j][1], kLog2e, -l1));
        pt[m][j][2] = fast_exp2(fmaf(pt[m][j][2], kLog2e, -l0));
        pt[m][j][3] = fast_exp2(fmaf(pt[m][j][3], kLog2e, -l1));
      }
    }
    warp_xb<DK, MT, BM>(dv_acc, pt, Dt, lane);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta)
    float dst[MT][BM / 8][4];
    warp_abt<DK, MT, BM>(dst, va, Dt, lane);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float e0 = Et[8 * j + 2 * t], e1 = Et[8 * j + 2 * t + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        dst[m][j][0] = pt[m][j][0] * (dst[m][j][0] - e0);
        dst[m][j][1] = pt[m][j][1] * (dst[m][j][1] - e1);
        dst[m][j][2] = pt[m][j][2] * (dst[m][j][2] - e0);
        dst[m][j][3] = pt[m][j][3] * (dst[m][j][3] - e1);
      }
    }
    warp_xb<DK, MT, BM>(dk_acc, dst, Qt, lane);  // dK += dS^T q'
  }
  cp_wait<0>();  // no copy outlives the block
  const int r0 = k0 + warp * 16 * MT;
  store_rows<DK, MT>(dk + base, dk_acc, r0, S, C, h * D, D, 1.f, lane);
  store_rows<DK, MT>(dv + base, dv_acc, r0, S, C, h * D, D, 1.f, lane);
}

// Pass 3: dQ of one (query tile, head, batch row).
template <int DK>
__global__ void __launch_bounds__(Tiles<DK>::kWarpsQ * 32, Tiles<DK>::kMinBlocksQ)
    flash_bwd_dq(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int H, int D, float scale) {
  using T = Tiles<DK>;
  constexpr int DP = T::kDP, LDS = T::kLds, MT = T::kMT, BN = T::kStream, ST = T::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kResQ][LDS] q'
  bf16* Ds = Qs + T::kResQ * LDS;                // [kResQ][LDS] dO
  bf16* Ks = Ds + T::kResQ * LDS;                // [ST][BN][LDS]
  bf16* Vs = Ks + ST * T::kTile;                 // [ST][BN][LDS]

  const int q0 = blockIdx.x * T::kResQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t base = (size_t)b * S * C;
  const size_t stat = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nk = cdiv(S, BN);
  const int r0 = q0 + warp * 16 * MT;

  auto load_stage = [&](int j) {
    const int st = j % ST;
    load_tile<DP, BN>(k + base, Ks + st * T::kTile, j * BN, S, C, h * D, D);
    load_tile<DP, BN>(v + base, Vs + st * T::kTile, j * BN, S, C, h * D, D);
  };

  load_tile<DP, T::kResQ>(qs + base, Qs, q0, S, C, h * D, D);
  load_tile<DP, T::kResQ>(dout + base, Ds, q0, S, C, h * D, D);
  cp_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < nk) load_stage(j);
    cp_commit();
  }
  float row_lse[MT][2], row_delta[MT][2];  // rows g, g + 8 of each of the warp's m-tiles
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * m + g + 8 * r;
      row_lse[m][r] = row < S ? lse[stat + row] * kLog2e : INFINITY;
      row_delta[m][r] = row < S ? delta[stat + row] : 0.f;
    }
  cp_wait<ST - 1>();  // q' and dO have landed
  __syncthreads();
  ARows<DK, MT> qa, da;  // the warp's queries, in registers for the whole loop
  qa.load(Qs + warp * 16 * MT * LDS, lane);
  da.load(Ds + warp * 16 * MT * LDS, lane);
  float dq_acc[MT][DK / 8][4];
  zero(dq_acc);

  for (int j = 0; j < nk; ++j) {
    cp_wait<ST - 2>();
    __syncthreads();
    if (j + ST - 1 < nk) load_stage(j + ST - 1);
    cp_commit();
    const int st = j % ST;
    const bf16* Kt = Ks + st * T::kTile;
    const bf16* Vt = Vs + st * T::kTile;

    // P = exp(q' K^T - lse), zero past the sequence
    float p[MT][BN / 8][4];
    warp_abt<DK, MT, BN>(p, qa, Kt, lane);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int key = j * BN + 8 * jj + 2 * t;
      const bool ok0 = key < S, ok1 = key + 1 < S;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        p[m][jj][0] = ok0 ? fast_exp2(fmaf(p[m][jj][0], kLog2e, -row_lse[m][0])) : 0.f;
        p[m][jj][1] = ok1 ? fast_exp2(fmaf(p[m][jj][1], kLog2e, -row_lse[m][0])) : 0.f;
        p[m][jj][2] = ok0 ? fast_exp2(fmaf(p[m][jj][2], kLog2e, -row_lse[m][1])) : 0.f;
        p[m][jj][3] = ok1 ? fast_exp2(fmaf(p[m][jj][3], kLog2e, -row_lse[m][1])) : 0.f;
      }
    }
    // dS = P * (dO V^T - delta)
    float ds[MT][BN / 8][4];
    warp_abt<DK, MT, BN>(ds, da, Vt, lane);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ds[m][jj][c] = p[m][jj][c] * (ds[m][jj][c] - row_delta[m][c >> 1]);
    warp_xb<DK, MT, BN>(dq_acc, ds, Kt, lane);  // dQ += dS K
  }
  cp_wait<0>();
  store_rows<DK, MT>(dq + base, dq_acc, r0, S, C, h * D, D, scale, lane);
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

template <int DK>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, float* delta, void* qs, void* dq, void* dk, void* dv, int B,
                int S, int H, int D, float scale, cudaStream_t stream) {
  using T = Tiles<DK>;
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  static bool attributes_set[kMaxDevices] = {};  // per instance and device, before its first launch
  if (!attributes_set[info.dev]) {
    auto set = [](const void* kern, size_t bytes) {
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      return err;
    };
    e = set((const void*)flash_bwd_dkdv<DK>, T::kDkdvSmem);
    if (e == cudaSuccess) e = set((const void*)flash_bwd_dq<DK>, T::kDqSmem);
    if (e != cudaSuccess) return (int)e;
    attributes_set[info.dev] = true;
  }
  const int cpr = H * D / 8;                   // 16-byte chunks a row
  const int rows = cpr >= 2048 ? 1 : 2048 / cpr;  // at most 8 KB of partial sums a block
  flash_bwd_prologue<<<cdiv(B * S, rows), 256, (size_t)rows * cpr * sizeof(float), stream>>>(
      (const bf16*)q, (const bf16*)o, (const bf16*)dout, (bf16*)qs, delta, B, S, H, D, rows,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DK><<<dim3(cdiv(S, T::kResKV), H, B), T::kWarpsKV * 32, T::kDkdvSmem, stream>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dk,
      (bf16*)dv, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DK><<<dim3(cdiv(S, T::kResQ), H, B), T::kWarpsQ * 32, T::kDqSmem, stream>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dq,
      S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, S, H*D) contiguous, 16-byte aligned;
// D % 8 == 0, D <= 256.  lse: K1's (B, H, S) fp32 log-sum-exp; delta: an
// fp32 (B, H, S) scratch buffer; qs: a (B, S, H*D) scratch buffer for q'.
SYNFMC_API int synfmc_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                     const float* lse, const void* dout, float* delta, void* qs,
                                     void* dq, void* dk, void* dv, int B, int S, int H, int D,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cdiv(D, 8) * 8) {
#define SYNFMC_CASE(DK) \
  case DK:              \
    return launch_bf16<DK>(q, k, v, o, lse, dout, delta, qs, dq, dk, dv, B, S, H, D, scale, st);
    SYNFMC_CASE(8) SYNFMC_CASE(24) SYNFMC_CASE(40) SYNFMC_CASE(56) SYNFMC_CASE(72)
    SYNFMC_CASE(88) SYNFMC_CASE(104) SYNFMC_CASE(120) SYNFMC_CASE(136) SYNFMC_CASE(152)
    SYNFMC_CASE(168) SYNFMC_CASE(184) SYNFMC_CASE(200) SYNFMC_CASE(216) SYNFMC_CASE(232)
    SYNFMC_CASE(248)
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
