// Flash attention forward on the packed (B, S, H*D) layout.
//
// Replaces synfmc_tpu/ops/flash_attention.py:_fwd_packed_kernel (:117, called
// from _fwd_packed) and, since the tiles mask any sequence length, the
// padded _fwd_kernel (:69, K4): per (batch row, head), softmax(q*scale K^T) V
// reading q/k/v at column offset h*D of each packed row.  The scale is
// applied to q in the operand type, logits and softmax are fp32, P enters PV
// rounded to the operand type, and the fp32 denominator divides the output.
// When a gradient is wanted the kernel also writes each row's log-sum-exp
// m + log(l) in fp32 to lse (B, H, S), so that the backward (flash_bwd.cu)
// recomputes P = exp(S - lse) without a second softmax pass.
//
// The TPU kernel kept one head's whole K/V resident in VMEM; at S=1536 that
// is 245 KB, more than the 227 KB a Hopper block may hold, so every instance
// here streams K/V tiles through shared memory with an online softmax.
//
// Bound on the H100.  At D=40 (level 0: B=32, S=1536, H=8) the floor is the
// exponentials, one per logit: 604 M at 16 ex2 a clock per SM (132 SMs at
// the top clock of 1.98 GHz) take 0.144 ms, against 0.098 ms for the
// 4*B*H*S^2*D = 96.6 GFLOP at 989 TFLOP/s and 0.038 ms for q, k, v, o's
// bytes.  At D=80 the products cost more than the exponentials (0.0122
// against 0.0090 ms at level 1, S=384), where the 63 MB of q, k, v, o
// (0.0188 ms) set the floor; at longer S the products would.  So the design
// keeps the special-function unit and the tensor cores busy at once, and
// spends no tensor work on padding it can avoid.
//
// Two bf16 instances, chosen by D in synfmc_flash_fwd_bf16 (both written
// here by hand; a shape goes to one or the other, never back):
//
// flash_fwd_wgmma, D <= 128 (every head dim of the flagship UNet: 40, 80).
//   - A persistent block per SM walks items (query tile, head, batch row).
//     It holds one producer warpgroup and consumer warpgroups of 64 query
//     rows each: three (192 rows) when QK^T's depth is <= 48, else two; the
//     producer gives up registers with setmaxnreg so that the consumers get
//     160 or 232 a thread.
//   - S = Q K^T and O += P V run on wgmma.mma_async m64nNk16 with A in
//     registers: Q is loaded with ldmatrix, scaled and kept as A fragments
//     for the item; P goes from the S accumulators straight into PV's A
//     fragments.  B reads shared memory through a descriptor: K tiles as
//     K-major, V tiles as MN-major (the transpose-B bit), both stored
//     [d chunk][key][8] in the no-swizzle core-matrix layout, so any D that
//     is a multiple of 8 works.  Only QK^T's depth is padded (40 -> 48);
//     PV's N is D rounded up to {40, 48, 64, 80, 96, 112, 128}.
//   - The producer copies each item's Q (two buffers) and its K/V tiles of
//     128 keys through a ring of up to 4 stages with 16-byte cp.async (8 rows
//     by 4 chunks a warp instruction: whole 64-byte row pieces in, conflict-
//     free 128-byte core-matrix rows out), zero-filling keys past S and
//     columns past D (QK^T's padded columns included, so no stale bits meet
//     Q's zero columns); cp.async.mbarrier.arrive completes a stage's full
//     mbarrier, the consumers free it through its empty mbarrier.  The ring
//     runs on across items, so the next item's loads overlap this one's
//     last tiles and its output stores.
//   - Each iteration issues S(t) = Q K_t^T and then O += P(t-1) V_(t-1),
//     waits for S(t) only, runs the online softmax of tile t, then waits for
//     PV, rescales O and packs P(t).  The consumer warpgroups take turns
//     issuing their products through named barriers, so that one's
//     exponentials run while another's products do.  Exponentials are
//     ex2.approx of one FFMA, s*log2e - m*log2e; row maxima and sums use four
//     partial chains.
//
// flash_fwd_mma, 128 < D <= 256: a FlashAttention-2 layout on mma.sync m16n8k16, one
//   block per 64 query rows (4 warps of 16), K/V tiles of 64 keys
//   double-buffered with cp.async, the head dim padded to a multiple of 16.
//   At these widths wgmma's 64-row accumulators for S, O and P would not
//   fit a thread's registers beside each other.
//
// fp32: a CUDA-core kernel (one thread per query row, K/V tiles in shared
// memory) with the same online softmax, for exact float32 checks.
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace synfmc;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemOptin = 232448;  // the H100's opt-in shared memory per block

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma instance
// ---------------------------------------------------------------------------

constexpr int kWgKeys = 128;              // keys a K/V tile: the N of S = Q K^T
constexpr int kChunkStep = kWgKeys * 16;  // bytes between 8-column chunks of a tile

// DQK: QK^T's depth (D rounded up to 16); NPV: PV's N (D rounded up to the
// wgmma instances of wgmma.cuh).
template <int DQK, int NPV>
struct WgTiles {
  static constexpr int kWgs = DQK <= 48 ? 3 : 2;     // consumer warpgroups
  static constexpr int kRows = 64 * kWgs;            // query rows an item
  static constexpr int kThreads = 128 * (kWgs + 1);  // + one producer warpgroup
  // registers a thread after setmaxnreg: the block's pool (ptxas gives each
  // thread 65536 / kThreads at entry, in steps of 8) moved from the producer
  // warpgroup to the consumers (232 at two consumer warpgroups, 160 at three)
  static constexpr int kProducerRegs = kWgs == 2 ? 40 : 32;
  static constexpr int kConsumerRegs =
      (65536 / kThreads / 8 * 8 * kThreads - 128 * kProducerRegs) / (128 * kWgs) / 8 * 8;
  static constexpr int kKBytes = kWgKeys * DQK * 2;
  static constexpr int kStageBytes = kKBytes + kWgKeys * NPV * 2;
  static constexpr int kQLds = DQK + 8;  // Q's row stride: an ldmatrix's 8 rows on distinct banks
  static constexpr int kQBytes = 2 * kRows * kQLds * 2;  // two items' Q
  // the stages (4, 3 or 2, as many as fit), the Q buffers, then a full and an
  // empty mbarrier a stage and a full and an empty one a Q buffer
  static constexpr int kStages = 4 * kStageBytes + kQBytes + 8 * 12 <= kSmemOptin   ? 4
                                 : 3 * kStageBytes + kQBytes + 8 * 10 <= kSmemOptin ? 3
                                                                                     : 2;
  static constexpr int kBarOffset = kStages * kStageBytes + kQBytes;
  static constexpr size_t kSmem = (size_t)kBarOffset + 8 * (2 * kStages + 4);
  static_assert(kSmem <= kSmemOptin, "a wgmma forward block above the H100's opt-in");
};

// One K or V tile of kWgKeys rows, W columns stored (W % 8 == 0), into the
// [chunk][key][8] layout by the producer's 128 threads (32 rows a warp).
// Lane l copies row l % 8 of each group of 8 rows, chunks l / 8 + 4j: a warp
// instruction reads 64 contiguous bytes of 8 rows and writes whole 128-byte
// core matrices without bank conflicts.  Chunks past D and rows past S are
// zero-filled.
template <int W>
__device__ __forceinline__ void copy_tile(const bf16* __restrict__ src, unsigned char* dst,
                                          int row0, int S, int C, int D, int tid) {
  static_assert(kWgKeys == 128, "32 rows a producer warp");
  constexpr int CH = W / 8;
  const int rr = tid & 7, cc = (tid >> 3) & 3, pw = tid >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (pw * 4 + k) * 8 + rr, row = row0 + r;
    const bf16* s = src + (size_t)(row < S ? row : 0) * C;
#pragma unroll
    for (int j = 0; j < (CH + 3) / 4; ++j) {
      const int c = cc + 4 * j;
      if (c < CH) {
        const bool ok = row < S && c * 8 < D;
        cp_async16(dst + c * kChunkStep + r * 16, s + (ok ? c * 8 : 0), ok);
      }
    }
  }
}

// Two bf16 multiplied by scale and rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// S (64 x kWgKeys) = Q K^T over DQK / 16 k-steps; K is K-major: LBO steps
// one chunk along d, SBO one 8-key group.
template <int DQK>
__device__ __forceinline__ void issue_qk(float (&s)[kWgKeys / 2],
                                         const uint32_t (&qa)[DQK / 16][4],
                                         const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wg::mma_rs<0>(s, qa[kk], wg::desc(kt + 2 * kk * kChunkStep, kChunkStep, 128), kk > 0);
}

// O (64 x NPV) += P V over kWgKeys / 16 k-steps; V is MN-major: LBO steps
// one 8-key group, SBO one chunk along d, and a k-step starts 16 keys on.
template <int NPV>
__device__ __forceinline__ void issue_pv(float (&o)[NPV / 2],
                                         const uint32_t (&pa)[kWgKeys / 16][4],
                                         const unsigned char* vt) {
#pragma unroll
  for (int j = 0; j < kWgKeys / 16; ++j)
    wg::mma_rs<1>(o, pa[j], wg::desc(vt + j * 256, 128, kChunkStep), 1);
}

// Online softmax of one S tile in place: masks keys >= S when `mask`, updates
// the running max m (rows g, g+8 of the warp) and this thread's partial sum
// l, returns the rescale factors of O, and leaves exp(s - m) in s.
__device__ __forceinline__ void softmax_tile(float (&s)[kWgKeys / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int key0, int S,
                                             bool mask, int t4) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < kWgKeys / 2; ++i)
      if (key0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= S) s[i] = -INFINITY;
  }
  // kPart partial maxima and sums a row, so that the chains are short
  constexpr int kPart = 4;
  float px[2][kPart], ps[2][kPart];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kPart; ++c) px[r][c] = -INFINITY, ps[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < kWgKeys / 2; ++i)
    px[(i >> 1) & 1][(i >> 2) % kPart] = fmaxf(px[(i >> 1) & 1][(i >> 2) % kPart], s[i]);
  float mx[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = px[r][0];
#pragma unroll
    for (int c = 1; c < kPart; ++c) mx[r] = fmaxf(mx[r], px[r][c]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    ml[r] = m_new * kLog2e;
    alpha[r] = fast_exp2(fmaf(m[r], kLog2e, -ml[r]));  // 0 on the first tile (m = -inf)
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < kWgKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], kLog2e, -ml[r]));
    ps[r][(i >> 2) % kPart] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = ps[r][0];
#pragma unroll
    for (int c = 1; c < kPart; ++c) sum += ps[r][c];
    l[r] = fmaf(l[r], alpha[r], sum);
  }
}

// PV's A fragments from the S accumulators: k-step j covers keys 16j..16j+15,
// the S column groups 2j and 2j+1.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kWgKeys / 16][4],
                                       const float (&s)[kWgKeys / 2]) {
#pragma unroll
  for (int j = 0; j < kWgKeys / 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pa[j][c] = pack_bf16(s[8 * j + 2 * c], s[8 * j + 2 * c + 1]);
}

// Turns of the consumer warpgroups at issuing their products: warpgroup w
// waits on named barrier 1 + w and, once it has issued, lets w + 1 go.
__device__ __forceinline__ void turn_wait(int w) { wg::bar_sync(1 + w, 256); }
template <int W>
__device__ __forceinline__ void turn_pass(int w) {
  wg::bar_arrive(1 + (w + 1) % W, 256);
}

template <int DQK, int NPV>
__global__ void __launch_bounds__(WgTiles<DQK, NPV>::kThreads, 1)
    flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int B, int S, int H, int D, float scale) {
  using T = WgTiles<DQK, NPV>;
  constexpr int ST = T::kStages, W = T::kWgs;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ST * T::kStageBytes);  // [2][kRows][kQLds]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + T::kBarOffset);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;  // [2]
  uint64_t* qempty = qfull + 2;  // [2]
  const int C = H * D;
  const int nk = cdiv(S, kWgKeys), nq = cdiv(S, T::kRows), items = nq * H * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(full + s, 128);     // the producer's threads, as their copies land
      wg::mbar_init(empty + s, 4 * W);  // one lane of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(qfull + s, 128);
      wg::mbar_init(qempty + s, 4 * W);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  auto slot = [&](int g) { return smem_raw + (g % ST) * T::kStageBytes; };

  // The block walks items (query tile, head, batch row) blockIdx.x,
  // blockIdx.x + gridDim.x, ...; g counts K/V tiles across them, so the ring
  // runs on from one item into the next.
  if (warp >= 4 * W) {  // producer: Q of each item, then its K/V tiles
    wg::set_max_regs_dec<T::kProducerRegs>();
    const int tid = threadIdx.x - 128 * W;
    int g = 0;
    for (int item = blockIdx.x, j = 0; item < items; item += gridDim.x, ++j) {
      const int x = item % nq, h = (item / nq) % H, b = item / (nq * H);
      const size_t base = (size_t)b * S * C + (size_t)h * D;
      // Q into buffer j % 2 once the consumers have read the item before last;
      // chunks past D and rows past S zero-filled, rows mapped as copy_tile's
      if (j >= 2) wg::mbar_wait(qempty + (j & 1), ((j >> 1) - 1) & 1);
      bf16* qs = Qs + (j & 1) * T::kRows * T::kQLds;
      for (int r = (tid >> 5) * 8 + (tid & 7); r < T::kRows; r += 32) {
        const int row = x * T::kRows + r;
        const bf16* src = q + base + (size_t)(row < S ? row : 0) * C;
#pragma unroll
        for (int jj = 0; jj < (DQK / 8 + 3) / 4; ++jj) {
          const int c = ((tid >> 3) & 3) + 4 * jj;
          const bool ok = row < S && c * 8 < D;
          if (c < DQK / 8) cp_async16(qs + r * T::kQLds + c * 8, src + (ok ? c * 8 : 0), ok);
        }
      }
      wg::mbar_arrive_cp_async(qfull + (j & 1));
      for (int t = 0; t < nk; ++t, ++g) {  // tile t into stage g % ST once it is free
        const int st = g % ST;
        if (g >= ST) wg::mbar_wait(empty + st, (g / ST - 1) & 1);
        copy_tile<DQK>(k + base, slot(g), t * kWgKeys, S, C, D, tid);
        copy_tile<NPV>(v + base, slot(g) + T::kKBytes, t * kWgKeys, S, C, D, tid);
        wg::mbar_arrive_cp_async(full + st);
      }
    }
    cp_commit();
    cp_wait<0>();
    return;
  }
  wg::set_max_regs_inc<T::kConsumerRegs>();

  const int wgi = warp / 4, gr = lane >> 2, t4 = lane & 3;
  const int wrow = wgi * 64 + (warp % 4) * 16;  // the warp's first row in the item
  const bool ragged = S % kWgKeys != 0;
  float sacc[kWgKeys / 2], oacc[NPV / 2];
  uint32_t qa[DQK / 16][4], pa[kWgKeys / 16][4];

  if (wgi == W - 1) wg::bar_arrive(1, 256);  // warpgroup 0 goes first

  int g = 0;
  for (int item = blockIdx.x, j = 0; item < items; item += gridDim.x, ++j, g += nk) {
    const int x = item % nq, h = (item / nq) % H, b = item / (nq * H);
    const size_t base = (size_t)b * S * C + (size_t)h * D;

    // Q's A fragments, scaled in bf16 as the TPU kernel does (zero past S and D)
    wg::mbar_wait(qfull + (j & 1), (j >> 1) & 1);
    const bf16* qs = Qs + (j & 1) * T::kRows * T::kQLds;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      ldsm_x4(qa[kk], qs + (wrow + (lane & 15)) * T::kQLds + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int c = 0; c < 4; ++c) qa[kk][c] = scale_pair(qa[kk][c], scale);
    }
    if (lane == 0) wg::mbar_arrive(qempty + (j & 1));

#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];

    // tile t: S(t), and PV(t - 1) from the second tile on; the last tile
    // masks keys past S.  One copy of the body: a tile-0 prologue and a
    // peeled last tile would triple the code.
    for (int t = 0; t < nk; ++t) {
      // free the stage of tile t - 2 (its PV completed last iteration)
      if (t >= 2 && lane == 0) wg::mbar_arrive(empty + (g + t - 2) % ST);
      wg::mbar_wait(full + (g + t) % ST, ((g + t) / ST) & 1);
      wg::fence_async_shared();
      turn_wait(wgi);
      wg::fence();
      issue_qk<DQK>(sacc, qa, slot(g + t));
      wg::commit();
      if (t > 0) issue_pv<NPV>(oacc, pa, slot(g + t - 1) + T::kKBytes);
      wg::commit();
      turn_pass<W>(wgi);
      wg::wait<1>();  // S(t) is in; PV(t-1) may still run under the exponentials
      wg::hold(sacc);
      softmax_tile(sacc, m_run, l_run, alpha, t * kWgKeys, S, ragged && t == nk - 1, t4);
      wg::wait<0>();
      wg::hold(oacc);
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];  // 0 on tile 0
      pack_p(pa, sacc);
    }

    // the last PV, then free the item's last two stages
    turn_wait(wgi);
    wg::fence();
    issue_pv<NPV>(oacc, pa, slot(g + nk - 1) + T::kKBytes);
    wg::commit();
    turn_pass<W>(wgi);
    wg::wait<0>();
    wg::hold(oacc);
    if (lane == 0) {
      if (nk >= 2) wg::mbar_arrive(empty + (g + nk - 2) % ST);
      wg::mbar_arrive(empty + (g + nk - 1) % ST);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = x * T::kRows + wrow + gr + 8 * r;
      if (row >= S) continue;
      if (lse != nullptr && t4 == 0) lse[((size_t)b * H + h) * S + row] = m_run[r] + logf(l);
      const float inv = 1.f / l;
      bf16* orow = o + base + (size_t)row * C;
#pragma unroll
      for (int jj = 0; jj < NPV / 8; ++jj) {
        const int d = 8 * jj + 2 * t4;
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(oacc[4 * jj + 2 * r] * inv, oacc[4 * jj + 2 * r + 1] * inv);
      }
    }
  }
  if (wgi == 0) turn_wait(0);  // take the last warpgroup's final pass
}

// ---------------------------------------------------------------------------
// mma.sync instance, 128 < D <= 256
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // keys per K/V tile
constexpr int kWarps = BQ / 16;

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
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

// The kernel's dynamic shared-memory limit, raised once per instance and
// device before its first launch.
template <typename Kernel>
cudaError_t smem_once(Kernel kern, size_t bytes, bool (&done)[kMaxDevices], int dev) {
  if (done[dev]) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <int DQK, int NPV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                 int H, int D, float scale, cudaStream_t stream) {
  using T = WgTiles<DQK, NPV>;
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  if (T::kSmem > (size_t)info.optin) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  e = smem_once(flash_fwd_wgmma<DQK, NPV>, T::kSmem, done, info.dev);
  if (e != cudaSuccess) return (int)e;
  const long items = (long)cdiv(S, T::kRows) * H * B;  // one block an SM walks them
  const int grid = (int)(items < info.sms ? items : info.sms);
  flash_fwd_wgmma<DQK, NPV><<<grid, T::kThreads, T::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, B, S, H, D, scale);
  return (int)cudaGetLastError();
}

// The mma.sync instance's block: a q tile and two double-buffered K/V tiles.
template <int DP>
constexpr size_t mma_smem() {
  return (size_t)(BQ + 4 * BK) * lds<DP>() * sizeof(bf16);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               int H, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem<DP>();
  static_assert(smem <= kSmemOptin, "an mma.sync forward block above the H100's opt-in");
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)info.optin) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  e = smem_once(flash_fwd_mma<DP>, smem, done, info.dev);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(S, BQ), H, B);
  flash_fwd_mma<DP><<<grid, kWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, H, D, scale);
  return (int)cudaGetLastError();
}

// The bf16 instances by head dim D (a multiple of 8 up to 256): D <= 128 runs
// the wgmma one as (D, QK^T depth, PV's N), 128 < D <= 256 the mma.sync one
// at D rounded up to 16 (ops/flash_attention.py:fwd_instance mirrors this).
#define SYNFMC_FWD_WGMMA(X)                                                                \
  X(8, 16, 40) X(16, 16, 40) X(24, 32, 40) X(32, 32, 40) X(40, 48, 40) X(48, 48, 48)    \
  X(56, 64, 64) X(64, 64, 64) X(72, 80, 80) X(80, 80, 80) X(88, 96, 96) X(96, 96, 96)   \
  X(104, 112, 112) X(112, 112, 112) X(120, 128, 128) X(128, 128, 128)
#define SYNFMC_FWD_MMA(X) \
  X(144) X(160) X(176) X(192) X(208) X(224) X(240) X(256)

// q, k, v, o: (B, S, H*D) contiguous, 16-byte aligned; D % 8 == 0, D <= 256.
// lse: (B, H, S) fp32, or null when no gradient is wanted.  A block above
// the device's opt-in shared memory returns cudaErrorInvalidValue before any
// launch (synfmc_flash_fwd_bf16_smem names its bytes).
SYNFMC_API int synfmc_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int S, int H, int D, float scale,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WG(DK, DQK, NPV) \
  case DK:               \
    return launch_wgmma<DQK, NPV>(q, k, v, o, lse, B, S, H, D, scale, st);
#define MMA(DP) \
  case DP:      \
    return launch_mma<DP>(q, k, v, o, lse, B, S, H, D, scale, st);
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 128) {
    switch (D) { SYNFMC_FWD_WGMMA(WG) }
  } else {
    switch (cdiv(D, 16) * 16) { SYNFMC_FWD_MMA(MMA) }
  }
#undef WG
#undef MMA
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of one block of the bf16 instance that
// synfmc_flash_fwd_bf16 runs at head dim D; 0 for a D it does not take.
SYNFMC_API int synfmc_flash_fwd_bf16_smem(int D) {
#define WG(DK, DQK, NPV) \
  case DK:               \
    return (int)WgTiles<DQK, NPV>::kSmem;
#define MMA(DP) \
  case DP:      \
    return (int)mma_smem<DP>();
  if (D <= 0 || D % 8 || D > 256) return 0;
  if (D <= 128) {
    switch (D) { SYNFMC_FWD_WGMMA(WG) }
  } else {
    switch (cdiv(D, 16) * 16) { SYNFMC_FWD_MMA(MMA) }
  }
#undef WG
#undef MMA
  return 0;
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
