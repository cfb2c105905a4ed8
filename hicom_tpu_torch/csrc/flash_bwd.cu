// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/out/dO in, fp32 sums, bf16 grads out (fp32
// operands take flash_bwd_f32.cu; the split path's sum pass is flash_part_sum.cuh, in both).
//
// Replaces two Pallas TPU kernels of hicom_tpu/ops/flash_attention.py:
//   * _bwd_dq_kernel (K5): dQ = scale * sum_k dS K, with P = exp(S - lse) recomputed from the
//     forward's lse and dS = P * (dP - delta), dP = dO V^T, delta = rowsum(dO * O);
//   * _bwd_dkv_kernel (K6): dV = sum_q P^T dO and dK = scale * sum_q dS^T Q, summed over every
//     query head of the kv head's group (the TPU kernel's folded GQA rows).
// Both keep the forward's semantics (csrc/flash_fwd.cu): a bottom-right causal rule
// k <= q + Lk - Lq, keys at or past kv_lengths[b] masked (p = 0), query rows past kv_lengths not
// masked (their dO is what the loss gives them), P rounded to bf16 before the dV product, dS
// rounded to bf16 before the dQ and dK products, every sum in fp32.
//
// What bounds it on the H100: at the decoder prefill and tower shapes, operations (3 products of
// 2 * d flops per unmasked (q, k) pair for dQ, 4 for dK/dV, against reading q/k/v/dO once); at the
// global compressor's 32 queries over 23,328 keys, bytes (K and V read and dK and dV written: 430 MB
// at b = 2, 128 us for K6; the products there are 14 GFLOP, 14 us at the bf16 peak). S, P, dP and
// dS live only in registers, so no Lq x Lk matrix ever reaches device memory.
//
// Design against the TPU original:
//   * K5: one block = BQ query rows of one (batch, q head), 16 per warp: BQ = 32 (2 warps) when
//     Lq <= 32, as at the global compressor, so no half-empty 64-row tile is paid for, else 64.
//     Q and dO stay in registers as mma.sync A fragments. K and V stream in 32-key tiles through a
//     4-stage cp.async ring in dynamic shared memory (rows padded by 16 bytes), so three tiles are
//     in flight while one is computed, and the B fragments are read with ldmatrix (S = Q K^T and
//     dP = dO V^T) and ldmatrix.trans (dQ += dS K). The block walks the key tiles up to the causal
//     diagonal and the row's kv_lengths limit (the TPU grid's sequential kv axis).
//   * K5 split-KV: when ceil(Lq / BQ) * B * H blocks cannot fill the card, the wrapper picks
//     n_split chunks of those key tiles (grid z; ops/flash_attention.py dq_splits: 14 at the
//     global compressor's b 2, 252 blocks instead of 18). Each block writes its chunk's fp32 dQ sum
//     to a workspace of n_split x B * H * Lq * d floats, and part_sum_kernel (flash_part_sum.cuh) adds
//     the chunks in split order, applies scale and rounds to bf16: no atomics, the same result on every run.
//   * K6: one block = one warpgroup and 64 keys of one (batch, kv head). Its K and V tiles arrive
//     once by TMA and stay in shared memory; the (query head, 64-row query tile) units that can see
//     its keys stream their Q, dO, lse and delta through a 2-3 slot ring (Q and dO by TMA into the
//     forward's tile layout, hopper.cuh, one mbarrier per slot; lse and delta copied by the threads
//     one unit ahead). All four products are warpgroup MMAs: S^T = K Q^T and dP^T = V dO^T with both
//     operands K-major in shared memory, issued together, P^T formed while dP^T is in flight; then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T, the accumulators of S^T and dP^T rounded to
//     bf16, as register A operands and dO and Q as MN-major B operands (the forward's P V). Every
//     wgmma and its wait lie on warpgroup-uniform paths and nothing is in flight from one unit to
//     the next, so ptxas keeps them asynchronous. dK and dV (64 x d fp32 each) stay in registers
//     until the end, and leave through shared memory: staged as whole rows, then written in
//     coalesced 16-byte stores (the tile's rows are one contiguous run of device memory). Written
//     straight from the accumulator layout, 4 bytes a thread, the stores took most of the kernel's
//     time at the global compressor's shape, where every block walks one unit.
//   * K6 split: one block per (key tile, batch, kv head) gives 96 blocks at the decoder shape, under
//     one wave. When those blocks cannot fill the card, the wrapper cuts each block's walk over its
//     units, head-major, into n_split near-equal ranges (grid z; dkv_splits: at least two blocks per
//     SM, rounded up because a causal mask makes the first key tiles' blocks the longest: 3 at the
//     decoder, 288 blocks of which two fit an SM at a time); each block writes fp32 partials of dK
//     and dV to workspaces of n_split x B * KVH * Lk * d floats, and part_sum_kernel adds them in
//     split order, applies scale to dK and rounds both to bf16. The global compressor and the tower
//     keep one split.
//   * dS and P are formed in the accumulator layout of S^T/dP (K6) or S/dP (K5) and reused directly
//     as the A operand of the next product, as the forward does with P.
//   * d is padded inside shared memory to DP (hopper.cuh padded_dim: a multiple of 16 up to 128, then 192 or
//     256): every padded head dim 16, 32, ..., 128, 192, 256 has an instance of each kernel. K5 takes DP / 16
//     k-steps of mma.sync; K6's tiles are the forward's (hopper.cuh Tile<DP>), the columns past the last whole
//     64-column box (all of them at d <= 48) arriving as 8-column chunks, and its dV/dK products over them one
//     wgmma of N = 16 or 32, or 32 then 16 (a 48-column tail: d 48, d 112); past 128 the last box reaches past
//     d and TMA fills it with zeros. Rows past Lq / Lk load as zeros, and a query row past Lq reads
//     lse = +inf, so its p is 0.
//   * Past padded d 128 the registers run out, and both kernels change shape, not semantics:
//       - K5: Q and dO (64 + 64 registers a thread at 256, beside dQ's 128) leave the registers for shared
//         memory, copied once with the first K/V tile, and each k-step reads its A fragments with ldmatrix
//         (202,752 bytes of shared memory at 256: one block per SM). Its tiles, rows per block and split
//         chunks stay as they are, so split_dq_reference describes every width.
//       - K6: dK and dV (2 x 128 registers at 256) no longer fit one warpgroup, so a block has two over its
//         64 keys: warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1 computes
//         dP^T = V dO^T, takes P^T in fp32 from warpgroup 0 through shared memory (a named barrier), forms
//         dS^T and dK += dS^T Q. Each issues its products through one code path with its operands chosen by
//         warpgroup, so ptxas keeps them asynchronous. Units, splits and the sum pass stay as they are
//         (214,040 bytes of shared memory at 256, one block per SM).
//   * kv_lengths is a runtime argument of both kernels (the masks test every key against the row's limit
//     either way), and so is causal in K5 (one uniform test beside its mask of every key): K5 has one instance
//     per padded head dim and block height, K6 one per padded head dim and mask kind, 40 in all, where the
//     wide instances made the build the smoke's longest wait. K6 keeps causal a template argument: at run
//     time it cost K6 10-12% at the decoder and tower shapes on the H100 (PERF.md §6).
//   * delta = rowsum(dO * O) is one fp32 reduction in the wrapper, as the JAX package computes it
//     outside its kernels.
#include <math.h>

#include "flash_part_sum.cuh"
#include "hopper.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BK_DQ = 32;     // K5: keys per tile
constexpr int DQ_STAGES = 4;  // K5: K/V tiles in its ring

// The accumulators of n-tiles 2j and 2j + 1 (16 x 16 in all) as the A operand of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

constexpr int DKV_BK = 64;  // K6: keys per block, one warpgroup (16 per warp)
constexpr int DKV_BQ = 64;  // K6: query rows per unit of its ring
// K6's ring slots: 3 where the block is small (d <= 80), else 2; two blocks share an SM up to 128
__host__ __device__ constexpr int dkv_stages(int dp) { return dp <= 80 ? 3 : 2; }
// K6's warpgroups: one up to padded d 128; past it dK and dV (64 x DP fp32 each, 2 x 96 or 2 x 128 registers
// a thread) cannot share one, so warpgroup 0 holds dV and warpgroup 1 dK (one block per SM)
__host__ __device__ constexpr int dkv_warpgroups(int dp) { return dp <= 128 ? 1 : 2; }
static_assert(WG_THREADS == 2 * DKV_BQ, "K6 copies lse (first half of the threads) and delta (second half)");

// TMA maps of q and dO (d columns, Lq rows, B * H heads), k and v (d columns, Lk rows, B * KVH heads):
// boxes of 64 rows, 64 columns in the 128-byte swizzle, or 8 for the columns past them.
struct DkvParams {
  CUtensorMap tq, tdo, tk, tv;
  CUtensorMap tq8, tdo8, tk8, tv8;
  const int* kv_lengths;     // (B,) or null
  const float *lse, *delta;  // (B, H, Lq)
  bf16 *dk, *dv;             // (B, KVH, Lk, d), n_split == 1
  float *dk_part, *dv_part;  // (n_split, B * KVH, Lk, d), n_split > 1
  int B, H, KVH, Lq, Lk, d, n_split;
  float scale, bias;
};

// K, V, the ring of Q and dO, each slot's lse and delta, past 128 the fp32 P^T that warpgroup 0 hands
// warpgroup 1, then the mbarriers
template <int DP>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 2 * DKV_BK * DP * 2 + dkv_stages(DP) * (2 * DKV_BQ * DP * 2 + 2 * DKV_BQ * 4) +
         (dkv_warpgroups(DP) > 1 ? DKV_BK * DKV_BQ * 4 : 0) + (dkv_stages(DP) + 1) * 8;
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K6. grid (ceil(Lk / 64), B * KVH, n_split), dkv_warpgroups(DP) warpgroups, dkv_smem_bytes<DP>() of
// dynamic shared memory. Writes scale * dK and dV in bf16 (n_split == 1) or the split's unscaled fp32
// partials.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS * dkv_warpgroups(DP), DP <= 128 ? 2 : 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  constexpr int BK = DKV_BK, BQ = DKV_BQ;
  constexpr int KC = DP / 16;   // k16 steps of S^T and dP^T over d
  constexpr int NT_S = BQ / 8;  // 8-query tiles of S^T and dP^T
  constexpr int NACC = DP / 2;  // accumulator registers of dK, and of dV (64 x DP per warpgroup)
  constexpr int STAGES = dkv_stages(DP);
  constexpr bool WIDE = dkv_warpgroups(DP) > 1;
  constexpr int NTHREADS = WG_THREADS * dkv_warpgroups(DP);
  constexpr int TILE_K = BK * DP * 2, TILE_Q = BQ * DP * 2;  // bytes of a K or V tile, of a Q or dO tile
  typedef Tile<DP> T;
  static_assert(2 * BK * (DP * 4 + 16) <= dkv_smem_bytes<DP>(), "the epilogue stages dK and dV in fp32 rows");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sk = smem_u32(smem), sv = sk + TILE_K;
  const uint32_t ring = sv + TILE_K;  // slot s: Q at ring + 2 s TILE_Q, dO TILE_Q bytes later
  float* s_lse = reinterpret_cast<float*>(smem + 2 * TILE_K + STAGES * 2 * TILE_Q);  // slot s at s * BQ
  float* s_delta = s_lse + STAGES * BQ;
  float* xchg = s_delta + STAGES * BQ;  // WIDE: P^T, each thread's 32 values as 8 float4s WG_THREADS apart
  const uint32_t bars = smem_u32(xchg + (WIDE ? BK * BQ : 0));  // slot s's barrier at bars + 8 s, then K/V's
  const uint32_t kvbar = bars + STAGES * 8;

  const int bkv = blockIdx.y;  // b * KVH + kvh
  const int b = bkv / p.KVH;
  const int G = p.H / p.KVH;
  const int split = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int wg = WIDE ? __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0) : 0;  // warp-uniform for ptxas
  const int tid = threadIdx.x % WG_THREADS;  // within the warpgroup
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = __shfl_sync(0xffffffffu, max(0, min(p.Lk, p.kv_lengths[b])), 0);
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  // The units of work: (query head of the group, query tile) pairs, head-major, over the tiles that
  // can see the block's keys (the first query that sees key k0 is k0 - diag); none for a tile wholly
  // past kv_lengths, whose gradients are zero. This split walks units u_begin .. u_begin + n - 1.
  const int qt_begin = CAUSAL ? max(0, k0 - diag) / BQ : 0;
  const int nq = k0 < kv_limit ? max(0, (p.Lq + BQ - 1) / BQ - qt_begin) : 0;
  const int u_begin = G * nq * split / p.n_split;
  const int n = G * nq * (split + 1) / p.n_split - u_begin;

  const int tail_loaded = max(0, p.d / 8 - T::NB * 8);  // tail chunks that hold columns below d
  auto unit_head = [&](int i) { return b * p.H + (bkv % p.KVH) * G + (u_begin + i) / nq; };
  auto unit_q0 = [&](int i) { return (qt_begin + (u_begin + i) % nq) * BQ; };
  auto slot_q = [&](int i) { return ring + (i % STAGES) * 2 * TILE_Q; };
  auto bar = [&](int i) { return bars + (i % STAGES) * 8; };
  auto issue = [&](int i) {  // one thread: Q and dO of unit i into its slot
    mbar_expect_tx(bar(i), 2 * T::bytes(BQ, tail_loaded));
    T::load(slot_q(i), &p.tq, &p.tq8, BQ, unit_q0(i), unit_head(i), bar(i), tail_loaded);
    T::load(slot_q(i) + TILE_Q, &p.tdo, &p.tdo8, BQ, unit_q0(i), unit_head(i), bar(i), tail_loaded);
  };
  // lse and delta of unit i, row threadIdx.x % BQ, by the first warpgroup: its first BQ threads take
  // lse, less the bias and in the log2 domain, the others delta; rows past Lq get +inf and 0, so their p is 0
  auto stat = [&](int i) {
    const int q = unit_q0(i) + threadIdx.x % BQ;
    const size_t at = (size_t)unit_head(i) * p.Lq + q;
    if (threadIdx.x < BQ) return q < p.Lq ? (p.lse[at] - p.bias) * LOG2E : INFINITY;
    return q < p.Lq ? p.delta[at] : 0.f;
  };
  auto put_stat = [&](int i, float x) { (threadIdx.x < BQ ? s_lse : s_delta)[(i % STAGES) * BQ + threadIdx.x % BQ] = x; };
  const bool stats = threadIdx.x < WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tail chunks past d (columns 72-79 at d 72) are zero in K, V and every slot, once
  T::zero_pad(sk, BK, tail_loaded, threadIdx.x, NTHREADS);
  T::zero_pad(sv, BK, tail_loaded, threadIdx.x, NTHREADS);
  for (int i = 0; i < 2 * STAGES; ++i) T::zero_pad(ring + i * TILE_Q, BQ, tail_loaded, threadIdx.x, NTHREADS);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(kvbar, 2 * T::bytes(BK, tail_loaded));
    T::load(sk, &p.tk, &p.tk8, BK, k0, bkv, kvbar, tail_loaded);
    T::load(sv, &p.tv, &p.tv8, BK, k0, bkv, kvbar, tail_loaded);
    for (int s = 0; s < STAGES && s < n; ++s) issue(s);
  }
  if (stats)
    for (int s = 0; s < STAGES && s < n; ++s) put_stat(s, stat(s));
  __syncthreads();  // the first slots' lse and delta
  if (n > 0) mbar_wait(kvbar, 0);

  // dK and dV; WIDE: acc_a is this warpgroup's one accumulator, dV (warpgroup 0) or dK (warpgroup 1)
  float acc_a[NACC], acc_b[WIDE ? 1 : NACC], s[NT_S * 4], dp[WIDE ? 1 : NT_S * 4];
  float* dv = acc_a;
  float* dk = WIDE ? acc_a : acc_b;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc_a[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : NACC); ++i) acc_b[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : NT_S * 4); ++i) dp[i] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    const bool refill = i + STAGES < n;
    const float next = refill && stats ? stat(i + STAGES) : 0.f;  // its load is in flight through this unit
    mbar_wait(bar(i), (i / STAGES) & 1);
    const uint32_t sq = slot_q(i), sdo = sq + TILE_Q;
    const int q0 = unit_q0(i);
    bool need_mask = k0 + BK > kv_limit;
    if (CAUSAL) need_mask = need_mask || k0 + BK - 1 > q0 + diag;
    const float* lse2 = s_lse + (i % STAGES) * BQ;
    const float* dl = s_delta + (i % STAGES) * BQ;
    // P^T = exp(S^T scale + bias - lse) over S^T, masked
    auto probabilities = [&]() {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + t * 2 + (e & 1);
          float x = exp2_approx(s[nt * 4 + e] * scale2 - lse2[col]);
          if (need_mask) {
            bool ok = key[e >> 1] < kv_limit;
            if (CAUSAL) ok = ok && key[e >> 1] <= q0 + col + diag;
            x = ok ? x : 0.f;
          }
          s[nt * 4 + e] = x;
        }
      }
    };
    uint32_t pa[BQ / 16][4];
    auto pack = [&](uint32_t (*a)[4], const float* x) {
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[kc][j] = pack_bf16(x[8 * kc + 2 * j], x[8 * kc + 2 * j + 1]);
    };

    if constexpr (!WIDE) {
      // S^T = K Q^T and dP^T = V dO^T: rows are the block's 64 keys, columns the unit's 64 queries
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(s, T::kmajor(sk, BK, 0, kc), T::kmajor(sq, BQ, 0, kc), kc > 0);
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(dp, T::kmajor(sv, BK, 0, kc), T::kmajor(sdo, BQ, 0, kc), kc > 0);
      wgmma_commit();
      wgmma_wait<1>();  // P^T over S^T while dP^T is in flight
      fence_regs<NT_S * 4>(s);
      probabilities();
      // dS^T = P^T (dP^T - delta) over dP^T; both in bf16 as the A operands of dV and dK
      wgmma_wait<0>();
      fence_regs<NT_S * 4>(dp);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt * 4 + e] = s[nt * 4 + e] * (dp[nt * 4 + e] - dl[nt * 8 + t * 2 + (e & 1)]);
      uint32_t da[BQ / 16][4];
      pack(pa, s);
      pack(da, dp);

      // dV += P^T dO and dK += dS^T Q: the k-dimension is the unit's 64 queries
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        T::rs_mn(dv, pa[kc], sdo, BQ, kc);
        T::rs_mn(dk, da[kc], sq, BQ, kc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NACC>(dk);
      fence_regs<NACC>(dv);
    } else {
      // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T. One code path with the operands chosen by
      // warpgroup, so that every wgmma lies on a path ptxas finds warpgroup-uniform.
      const uint32_t rows_tile = wg == 0 ? sk : sv, cols_tile = wg == 0 ? sq : sdo;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        wgmma_ss_n64(s, T::kmajor(rows_tile, BK, 0, kc), T::kmajor(cols_tile, BQ, 0, kc), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT_S * 4>(s);
      float4* x = reinterpret_cast<float4*>(xchg) + tid;
      if (wg == 0) {  // P^T to warpgroup 1 through shared memory, fp32 (its thread tid holds the same elements)
        probabilities();
#pragma unroll
        for (int j = 0; j < NT_S; ++j) x[j * WG_THREADS] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        named_bar_arrive(1, NTHREADS);
      } else {  // dS^T = P^T (dP^T - delta) over dP^T
        named_bar_sync(1, NTHREADS);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          const float4 pt = x[j * WG_THREADS];
          const float d0 = dl[j * 8 + t * 2], d1 = dl[j * 8 + t * 2 + 1];
          s[4 * j] = pt.x * (s[4 * j] - d0);
          s[4 * j + 1] = pt.y * (s[4 * j + 1] - d1);
          s[4 * j + 2] = pt.z * (s[4 * j + 2] - d0);
          s[4 * j + 3] = pt.w * (s[4 * j + 3] - d1);
        }
      }
      pack(pa, s);
      // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
      const uint32_t mn = wg == 0 ? sdo : sq;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) T::rs_mn(acc_a, pa[kc], mn, BQ, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NACC>(acc_a);
    }
    __syncthreads();  // every warp is done with the slot (and the P^T exchange): refill it
    if (refill) {
      if (stats) put_stat(i + STAGES, next);
      if (threadIdx.x == 0) issue(i + STAGES);
    }
  }

  // The epilogue through shared memory, which the walk no longer needs: this thread's rows key[r] of dK
  // and dV (accumulator nt * 4 + 2 r (+1) holds columns nt * 8 + 2 t (+1)) go to whole rows there, scaled
  // and in bf16 (n_split == 1) or as fp32 partials, and the tile's rows, one contiguous run of device
  // memory each for dK and dV, leave in coalesced 16-byte stores. WIDE: warpgroup 0 stages dV, 1 dK.
  const bool direct = p.n_split == 1;
  const int row_bytes = DP * (direct ? 2 : 4) + 16;  // a 16-byte pad spreads the rows over the banks
  unsigned char* st_k = smem;
  unsigned char* st_v = smem + BK * row_bytes;
  const bool put_k = !WIDE || wg == 1, put_v = !WIDE || wg == 0;
  __syncthreads();  // every warp is done with K, V and the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int c = nt * 8 + t * 2;
      const float* kk = dk + nt * 4 + 2 * r;
      const float* vv = dv + nt * 4 + 2 * r;
      if (direct) {
        if (put_k)
          *reinterpret_cast<__nv_bfloat162*>(st_k + row * row_bytes + c * 2) = __floats2bfloat162_rn(kk[0] * p.scale, kk[1] * p.scale);
        if (put_v) *reinterpret_cast<__nv_bfloat162*>(st_v + row * row_bytes + c * 2) = __floats2bfloat162_rn(vv[0], vv[1]);
      } else {
        if (put_k) *reinterpret_cast<float2*>(st_k + row * row_bytes + c * 4) = make_float2(kk[0], kk[1]);
        if (put_v) *reinterpret_cast<float2*>(st_v + row * row_bytes + c * 4) = make_float2(vv[0], vv[1]);
      }
    }
  }
  __syncthreads();
  const size_t first = ((direct ? 0 : (size_t)split * gridDim.y * p.Lk) + (size_t)bkv * p.Lk + k0) * p.d;
  char* gk = direct ? reinterpret_cast<char*>(p.dk + first) : reinterpret_cast<char*>(p.dk_part + first);
  char* gv = direct ? reinterpret_cast<char*>(p.dv + first) : reinterpret_cast<char*>(p.dv_part + first);
  const int chunks = p.d * (direct ? 2 : 4) / 16;  // 16-byte chunks of a row in device memory
  for (int i = threadIdx.x; i < min(BK, p.Lk - k0) * chunks; i += NTHREADS) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(gk + (size_t)i * 16) = *reinterpret_cast<const uint4*>(st_k + r * row_bytes + c * 16);
    *reinterpret_cast<uint4*>(gv + (size_t)i * 16) = *reinterpret_cast<const uint4*>(st_v + r * row_bytes + c * 16);
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch_dkv(const DkvParams& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_kernel<DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lk + DKV_BK - 1) / DKV_BK, p.B * p.KVH, p.n_split);
  kernel<<<grid, WG_THREADS * dkv_warpgroups(DP), smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum<bf16>{{p.dk_part, p.dv_part}, {p.dk, p.dv}, {p.scale, 1.f}}, 2, p.n_split,
                  (size_t)p.B * p.KVH * p.Lk * p.d, stream);
}


// K6 at padded head dim DP, causal or not.
template <int DP>
cudaError_t dispatch_dkv(const DkvParams& p, bool causal, cudaStream_t stream) {
  return causal ? launch_dkv<DP, true>(p, stream) : launch_dkv<DP, false>(p, stream);
}

struct DqParams {
  const bf16 *q, *k, *v, *dout;      // (B, H, Lq, d), (B, KVH, Lk, d) x 2, (B, H, Lq, d)
  const int* kv_lengths;            // (B,) or null
  const float *lse, *delta;         // (B, H, Lq)
  bf16* dq;                         // (B, H, Lq, d), n_split == 1
  float* dq_part;                   // (n_split, B * H, Lq, d), n_split > 1
  int B, H, KVH, Lq, Lk, d, n_split, causal;
  float scale, bias;
};

// K5 keeps Q and dO in registers up to padded d 128; past it (16 x DP fp32 of dQ a warp is 128
// registers a thread at 256) they wait in shared memory and each k-step reads its A fragments there.
__host__ __device__ constexpr bool dq_qa_in_smem(int dp) { return dp > 128; }

template <int DP, int NW>
constexpr int dq_smem_bytes() {  // the K/V ring, then Q and dO of the block's 16 NW rows past 128
  return DQ_STAGES * 2 * BK_DQ * (DP + 8) * 2 + (dq_qa_in_smem(DP) ? 2 * 16 * NW * (DP + 8) * 2 : 0);
}

// K5. grid (ceil(Lq / (16 NW)), B * H, n_split), 32 NW threads, dq_smem_bytes<DP, NW>() of dynamic
// shared memory. Writes scale * dQ in bf16 (n_split == 1) or the chunk's unscaled fp32 sum.
template <int DP, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dq_kernel(const DqParams p) {
  constexpr int BQ = 16 * NW;        // query rows per block
  constexpr int LDS = DP + 8;        // 16-byte row pad: conflict-free ldmatrix rows
  constexpr int KC = DP / 16;        // k-steps over d
  constexpr int NT_O = DP / 8;       // n-tiles of dQ
  constexpr int NT_S = BK_DQ / 8;    // n-tiles of S and dP
  constexpr int CH = DP / 8;         // 16-byte chunks of a padded row
  constexpr int TILE = BK_DQ * LDS;  // elements of one K or V tile
  constexpr bool QA_SMEM = dq_qa_in_smem(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // slot s: K at 2 s TILE, V TILE later
  bf16* sqa = ring + DQ_STAGES * 2 * TILE;           // QA_SMEM: Q (BQ rows of LDS), then dO

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int kvh = (bh % p.H) / (p.H / p.KVH);
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK_DQ - 1) / BK_DQ;
  if (p.causal) {
    const int max_key = min(q0 + BQ - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK_DQ + 1);
  }
  const int t_begin = n_tiles * split / p.n_split;
  const int t_end = n_tiles * (split + 1) / p.n_split;

  const size_t kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  const bf16* kb = p.k + kv_off;
  const bf16* vb = p.v + kv_off;
  auto issue = [&](int kt) {
    bf16* slot = ring + ((kt - t_begin) % DQ_STAGES) * 2 * TILE;
    const int k0 = kt * BK_DQ;
    for (int idx = threadIdx.x; idx < BK_DQ * CH; idx += NW * 32) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool in = k0 + r < p.Lk && c < p.d;
      const size_t off = (size_t)(k0 + r) * p.d + c;
      cp_async16(smem_u32(slot + r * LDS + c), in ? kb + off : kb, in);
      cp_async16(smem_u32(slot + TILE + r * LDS + c), in ? vb + off : vb, in);
    }
  };
  const size_t qoff = (size_t)bh * p.Lq * p.d;
  if constexpr (QA_SMEM) {  // Q and dO of the block's rows join the first tile's copies; zeros past Lq and d
    for (int idx = threadIdx.x; idx < BQ * CH; idx += NW * 32) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool in = q0 + r < p.Lq && c < p.d;
      const size_t off = qoff + (size_t)(q0 + r) * p.d + c;
      cp_async16(smem_u32(sqa + r * LDS + c), in ? p.q + off : p.q, in);
      cp_async16(smem_u32(sqa + BQ * LDS + r * LDS + c), in ? p.dout + off : p.dout, in);
    }
  }
#pragma unroll
  for (int s = 0; s < DQ_STAGES - 1; ++s) {
    if (t_begin + s < t_end) issue(t_begin + s);
    cp_async_commit();
  }

  // Q and dO as A operands, straight from device memory: rows row[j & 1], columns kc * 16 + 2t
  // (+1), + 8 for j >= 2; zero past Lq and d. Past 128 they are read from shared memory per k-step.
  uint32_t qa[QA_SMEM ? 1 : KC][4], da[QA_SMEM ? 1 : KC][4];
  if constexpr (!QA_SMEM) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row[j & 1];
        const int c = kc * 16 + t * 2 + (j >> 1) * 8;
        const bool in = r < p.Lq && c < p.d;
        qa[kc][j] = in ? ld32(p.q + qoff + (size_t)r * p.d + c) : 0u;
        da[kc][j] = in ? ld32(p.dout + qoff + (size_t)r * p.d + c) : 0u;
      }
  }
  // ldmatrix lanes for an A fragment: rows warp * 16 + lane % 16, columns kc * 16 + 8 (lane / 16), so
  // r[0..3] are the fragment's rows g / g + 8 at columns 2t and 2t + 8, as the registers above hold them
  const uint32_t a_off = ((warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8) * 2;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Lq;
    row_lse[r] = in ? p.lse[(size_t)bh * p.Lq + row[r]] : INFINITY;
    row_delta[r] = in ? p.delta[(size_t)bh * p.Lq + row[r]] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = t_begin; kt < t_end; ++kt) {
    if (kt + DQ_STAGES - 1 < t_end) issue(kt + DQ_STAGES - 1);
    cp_async_commit();
    cp_async_wait<DQ_STAGES - 1>();  // this thread's copies of tile kt have landed
    __syncthreads();                 // ... and every thread's
    const uint32_t sk = smem_u32(ring + ((kt - t_begin) % DQ_STAGES) * 2 * TILE);
    const uint32_t sv = sk + TILE * 2;

    // S = Q K^T and dP = dO V^T; ldmatrix lanes: keys (nt + lane / 16) * 8 + lane % 8, columns
    // kc * 16 + 8 (lane / 8 % 2), so r[0], r[1] are n-tile nt's B fragment and r[2], r[3] nt + 1's
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t* qfr = qa[QA_SMEM ? 0 : kc];
      const uint32_t* dfr = da[QA_SMEM ? 0 : kc];
      if constexpr (QA_SMEM) {
        ldmatrix_x4(qa[0], smem_u32(sqa) + a_off + kc * 32);
        ldmatrix_x4(da[0], smem_u32(sqa + BQ * LDS) + a_off + kc * 32);
      }
#pragma unroll
      for (int nt = 0; nt < NT_S; nt += 2) {
        const uint32_t off = (((nt + (lane >> 4)) * 8 + (lane & 7)) * LDS + kc * 16 + ((lane >> 3) & 1) * 8) * 2;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, sk + off);
        ldmatrix_x4(vf, sv + off);
        mma_bf16(s[nt], qfr, kf[0], kf[1]);
        mma_bf16(s[nt + 1], qfr, kf[2], kf[3]);
        mma_bf16(dp[nt], dfr, vf[0], vf[1]);
        mma_bf16(dp[nt + 1], dfr, vf[2], vf[3]);
      }
    }

    // P from the lse, then dS = P * (dP - delta), stored over S
    const int k0 = kt * BK_DQ;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const bool ok = key < kv_limit && (!p.causal || key <= row[e >> 1] + diag);
        const float pr = ok ? __expf(s[nt][e] * p.scale + p.bias - row_lse[e >> 1]) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - row_delta[e >> 1]);
      }
    }

    // dQ += dS K: the k-dimension is this tile's keys. ldmatrix.trans lanes: keys kc * 16 +
    // 8 (lane / 8 % 2) + lane % 8, columns (nt + lane / 16) * 8
#pragma unroll
    for (int kc = 0; kc < BK_DQ / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nt = 0; nt < NT_O; nt += 2) {
        const uint32_t off = ((kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (nt + (lane >> 4)) * 8) * 2;
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, sk + off);
        mma_bf16(acc[nt], a, kf[0], kf[1]);
        mma_bf16(acc[nt + 1], a, kf[2], kf[3]);
      }
    }
    __syncthreads();  // the slot is free before the next iteration copies into it
  }
  cp_async_wait<0>();  // Q's and dO's copies, when the chunk walked no tile

  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c >= p.d) continue;
      if (p.n_split == 1)
        *reinterpret_cast<__nv_bfloat162*>(p.dq + ((size_t)bh * p.Lq + row[r]) * p.d + c) =
            __floats2bfloat162_rn(acc[nt][2 * r] * p.scale, acc[nt][2 * r + 1] * p.scale);
      else
        *reinterpret_cast<float2*>(p.dq_part + (prow + row[r]) * p.d + c) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

template <int DP, int NW>
cudaError_t launch_dq_nw(const DqParams& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP, NW>();
  auto kernel = flash_bwd_dq_kernel<DP, NW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + 16 * NW - 1) / (16 * NW), p.B * p.H, p.n_split);
  kernel<<<grid, NW * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum<bf16>{{p.dq_part, nullptr}, {p.dq, nullptr}, {p.scale, 0.f}}, 1, p.n_split,
                  (size_t)p.B * p.H * p.Lq * p.d, stream);
}

// K5 at padded head dim DP: 32-row query tiles (2 warps) when Lq <= 32, else 64 (4 warps).
template <int DP>
cudaError_t dispatch_dq(const DqParams& p, cudaStream_t stream) {
  return p.Lq <= 32 ? launch_dq_nw<DP, 2>(p, stream) : launch_dq_nw<DP, 4>(p, stream);
}

bool bad_shape(int d, int H, int KVH, int Lq, int Lk) {
  return d % 8 != 0 || d > 256 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0;
}

}  // namespace

// q/dout (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null;
// lse/delta (B, H, Lq) fp32; dq (B, H, Lq, d) bf16. n_split >= 1 chunks of the key axis; for
// n_split > 1, an fp32 workspace dq_part (n_split, B * H, Lq, d). d % 8 == 0, d <= 256, H % KVH == 0.
extern "C" int hicom_flash_bwd_dq(const void* q, const void* k, const void* v, const int* kv_lengths,
                                  const void* dout, const float* lse, const float* delta, void* dq, float* dq_part,
                                  int B, int H, int KVH, int Lq, int Lk, int d, int n_split, float scale, float bias,
                                  int causal, void* stream) {
  if (bad_shape(d, H, KVH, Lq, Lk) || B <= 0 || dq == nullptr || n_split < 1 || (n_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  DqParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
             static_cast<const bf16*>(dout), kv_lengths, lse, delta, static_cast<bf16*>(dq), dq_part,
             B, H, KVH, Lq, Lk, d, n_split, causal != 0, scale, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)dispatch_dq<16>(p, s);
    case 32: return (int)dispatch_dq<32>(p, s);
    case 48: return (int)dispatch_dq<48>(p, s);
    case 64: return (int)dispatch_dq<64>(p, s);
    case 80: return (int)dispatch_dq<80>(p, s);
    case 96: return (int)dispatch_dq<96>(p, s);
    case 112: return (int)dispatch_dq<112>(p, s);
    case 128: return (int)dispatch_dq<128>(p, s);
    case 192: return (int)dispatch_dq<192>(p, s);
    case 256: return (int)dispatch_dq<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split path's reduction alone: out (n) = scale * sum over n_split of part (n_split, n) fp32, written
// in bf16, or in fp32 with out_fp32 (K5's dQ sum), and with a second pair part2/out2 (scale2) in the same
// launch (K6's dK and dV sums); n % 4 == 0.
extern "C" int hicom_flash_part_sum(const float* part, void* out, float scale, const float* part2, void* out2,
                                    float scale2, int n_split, long long n, int out_fp32, void* stream) {
  if (n <= 0 || n % 4 != 0 || n_split < 1 || (part2 == nullptr) != (out2 == nullptr)) return (int)cudaErrorInvalidValue;
  const int outputs = part2 == nullptr ? 1 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_fp32)
    return (int)part_sum(PartSum<float>{{part, part2}, {static_cast<float*>(out), static_cast<float*>(out2)},
                                        {scale, scale2}}, outputs, n_split, (size_t)n, s);
  return (int)part_sum(PartSum<bf16>{{part, part2}, {static_cast<bf16*>(out), static_cast<bf16*>(out2)},
                                     {scale, scale2}}, outputs, n_split, (size_t)n, s);
}

// K6, as hicom_flash_bwd_dq; dk/dv (B, KVH, Lk, d) bf16. n_split >= 1 ranges of each block's units;
// for n_split > 1, fp32 workspaces dk_part and dv_part (n_split, B * KVH, Lk, d).
extern "C" int hicom_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* kv_lengths,
                                   const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                                   float* dk_part, float* dv_part, int B, int H, int KVH, int Lq, int Lk, int d,
                                   int n_split, float scale, float bias, int causal, void* stream) {
  if (bad_shape(d, H, KVH, Lq, Lk) || B <= 0 || dk == nullptr || dv == nullptr || n_split < 1 ||
      (n_split > 1 && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  DkvParams p;
  p.kv_lengths = kv_lengths;
  p.lse = lse, p.delta = delta;
  p.dk = static_cast<bf16*>(dk), p.dv = static_cast<bf16*>(dv);
  p.dk_part = dk_part, p.dv_part = dv_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split;
  p.scale = scale, p.bias = bias;
  cudaError_t err = tile_maps(&p.tq, &p.tq8, q, d, Lq, B * H, DKV_BQ);
  if (err == cudaSuccess) err = tile_maps(&p.tdo, &p.tdo8, dout, d, Lq, B * H, DKV_BQ);
  if (err == cudaSuccess) err = tile_maps(&p.tk, &p.tk8, k, d, Lk, B * KVH, DKV_BK);
  if (err == cudaSuccess) err = tile_maps(&p.tv, &p.tv8, v, d, Lk, B * KVH, DKV_BK);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)dispatch_dkv<16>(p, causal != 0, s);
    case 32: return (int)dispatch_dkv<32>(p, causal != 0, s);
    case 48: return (int)dispatch_dkv<48>(p, causal != 0, s);
    case 64: return (int)dispatch_dkv<64>(p, causal != 0, s);
    case 80: return (int)dispatch_dkv<80>(p, causal != 0, s);
    case 96: return (int)dispatch_dkv<96>(p, causal != 0, s);
    case 112: return (int)dispatch_dkv<112>(p, causal != 0, s);
    case 128: return (int)dispatch_dkv<128>(p, causal != 0, s);
    case 192: return (int)dispatch_dkv<192>(p, causal != 0, s);
    case 256: return (int)dispatch_dkv<256>(p, causal != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
