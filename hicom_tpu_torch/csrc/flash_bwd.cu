// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/out/dO in, fp32 sums, bf16 grads out.
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
//     to a workspace of n_split x B * H * Lq * d floats, and part_sum_kernel adds the chunks in
//     split order, applies scale and rounds to bf16: no atomics, the same result on every run.
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
//   * d is padded inside shared memory to DP (a multiple of 16); rows past Lq / Lk load as zeros,
//     and a query row past Lq reads lse = +inf, so its p is 0.
//   * delta = rowsum(dO * O) is one fp32 reduction in the wrapper, as the JAX package computes it
//     outside its kernels.
#include <math.h>

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

// The split path's second pass: out[y] (n) bf16 = scale[y] * sum over the chunks of part[y]
// (n_split, n) fp32, in split order, for the y = blockIdx.y outputs (K5: dQ; K6: dK and dV). One
// thread per 4 elements; n % 4 == 0.
struct PartSum {
  const float* part[2];
  bf16* out[2];
  float scale[2];
};

__global__ void part_sum_kernel(const PartSum a, int n_split, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* part = a.part[blockIdx.y];
  const float scale = a.scale[blockIdx.y];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(a.out[blockIdx.y] + i);
  out[0] = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
  out[1] = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
}

cudaError_t part_sum(const PartSum& a, int outputs, int n_split, size_t n, cudaStream_t stream) {
  const size_t threads = n / 4;
  part_sum_kernel<<<dim3((unsigned)((threads + 127) / 128), outputs), 128, 0, stream>>>(a, n_split, n);
  return cudaGetLastError();
}

constexpr int DKV_BK = 64;  // K6: keys per block, one warpgroup (16 per warp)
constexpr int DKV_BQ = 64;  // K6: query rows per unit of its ring
// K6's ring slots: 3 where the block is small (d <= 80), else 2; two blocks share an SM either way
__host__ __device__ constexpr int dkv_stages(int dp) { return dp <= 80 ? 3 : 2; }
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

template <int DP>
__host__ __device__ constexpr int dkv_smem_bytes() {  // K, V, the ring of Q and dO, each slot's lse and delta, the mbarriers
  return 2 * DKV_BK * DP * 2 + dkv_stages(DP) * (2 * DKV_BQ * DP * 2 + 2 * DKV_BQ * 4 + 8) + 8;
}

// K6. grid (ceil(Lk / 64), B * KVH, n_split), one warpgroup, dkv_smem_bytes<DP>() of dynamic shared
// memory. Writes scale * dK and dV in bf16 (n_split == 1) or the split's unscaled fp32 partials.
template <int DP, bool CAUSAL, bool HAS_LEN>
__global__ void __launch_bounds__(WG_THREADS, 2) flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  constexpr int BK = DKV_BK, BQ = DKV_BQ;
  constexpr int KC = DP / 16;   // k16 steps of S^T and dP^T over d
  constexpr int NT_S = BQ / 8;  // 8-query tiles of S^T and dP^T
  constexpr int NACC = DP / 2;  // accumulator registers of dK, and of dV (64 x DP per warpgroup)
  constexpr int STAGES = dkv_stages(DP);
  constexpr int TILE_K = BK * DP * 2, TILE_Q = BQ * DP * 2;  // bytes of a K or V tile, of a Q or dO tile
  typedef Tile<DP> T;
  static_assert(2 * BK * (DP * 4 + 16) <= dkv_smem_bytes<DP>(), "the epilogue stages dK and dV in fp32 rows");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sk = smem_u32(smem), sv = sk + TILE_K;
  const uint32_t ring = sv + TILE_K;  // slot s: Q at ring + 2 s TILE_Q, dO TILE_Q bytes later
  float* s_lse = reinterpret_cast<float*>(smem + 2 * TILE_K + STAGES * 2 * TILE_Q);  // slot s at s * BQ
  float* s_delta = s_lse + STAGES * BQ;
  const uint32_t bars = smem_u32(s_delta + STAGES * BQ);  // slot s's barrier at bars + 8 s, then K/V's
  const uint32_t kvbar = bars + STAGES * 8;

  const int bkv = blockIdx.y;  // b * KVH + kvh
  const int b = bkv / p.KVH;
  const int G = p.H / p.KVH;
  const int split = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (HAS_LEN) kv_limit = __shfl_sync(0xffffffffu, max(0, min(p.Lk, p.kv_lengths[b])), 0);
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
  // lse and delta of unit i, row threadIdx.x % BQ: the first BQ threads take lse, less the bias and in
  // the log2 domain, the others delta; rows past Lq get +inf and 0, so their p is 0
  auto stat = [&](int i) {
    const int q = unit_q0(i) + threadIdx.x % BQ;
    const size_t at = (size_t)unit_head(i) * p.Lq + q;
    if (threadIdx.x < BQ) return q < p.Lq ? (p.lse[at] - p.bias) * LOG2E : INFINITY;
    return q < p.Lq ? p.delta[at] : 0.f;
  };
  auto put_stat = [&](int i, float x) { (threadIdx.x < BQ ? s_lse : s_delta)[(i % STAGES) * BQ + threadIdx.x % BQ] = x; };

  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tail chunks past d (columns 72-79 at d 72) are zero in K, V and every slot, once
  T::zero_pad(sk, BK, tail_loaded, threadIdx.x, WG_THREADS);
  T::zero_pad(sv, BK, tail_loaded, threadIdx.x, WG_THREADS);
  for (int i = 0; i < 2 * STAGES; ++i) T::zero_pad(ring + i * TILE_Q, BQ, tail_loaded, threadIdx.x, WG_THREADS);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(kvbar, 2 * T::bytes(BK, tail_loaded));
    T::load(sk, &p.tk, &p.tk8, BK, k0, bkv, kvbar, tail_loaded);
    T::load(sv, &p.tv, &p.tv8, BK, k0, bkv, kvbar, tail_loaded);
    for (int s = 0; s < STAGES && s < n; ++s) issue(s);
  }
  for (int s = 0; s < STAGES && s < n; ++s) put_stat(s, stat(s));
  __syncthreads();  // the first slots' lse and delta
  if (n > 0) mbar_wait(kvbar, 0);

  float dk[NACC], dv[NACC], s[NT_S * 4], dp[NT_S * 4];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) s[i] = dp[i] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    const bool refill = i + STAGES < n;
    const float next = refill ? stat(i + STAGES) : 0.f;  // its load is in flight through this unit
    mbar_wait(bar(i), (i / STAGES) & 1);
    const uint32_t sq = slot_q(i), sdo = sq + TILE_Q;
    // S^T = K Q^T and dP^T = V dO^T: rows are the block's 64 keys, columns the unit's 64 queries
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(s, T::kmajor(sk, BK, 0, kc), T::kmajor(sq, BQ, 0, kc), kc > 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(dp, T::kmajor(sv, BK, 0, kc), T::kmajor(sdo, BQ, 0, kc), kc > 0);
    wgmma_commit();
    const int q0 = unit_q0(i);
    bool need_mask = k0 + BK > kv_limit;
    if (CAUSAL) need_mask = need_mask || k0 + BK - 1 > q0 + diag;
    const float* lse2 = s_lse + (i % STAGES) * BQ;
    const float* dl = s_delta + (i % STAGES) * BQ;

    // P^T = exp(S^T scale + bias - lse) over S^T while dP^T is in flight
    wgmma_wait<1>();
    fence_regs<NT_S * 4>(s);
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
    // dS^T = P^T (dP^T - delta) over dP^T; both in bf16 as the A operands of dV and dK
    wgmma_wait<0>();
    fence_regs<NT_S * 4>(dp);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt * 4 + e] = s[nt * 4 + e] * (dp[nt * 4 + e] - dl[nt * 8 + t * 2 + (e & 1)]);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kc][j] = pack_bf16(s[8 * kc + 2 * j], s[8 * kc + 2 * j + 1]);
        da[kc][j] = pack_bf16(dp[8 * kc + 2 * j], dp[8 * kc + 2 * j + 1]);
      }

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
    __syncthreads();  // every warp is done with the slot: refill it
    if (refill) {
      put_stat(i + STAGES, next);
      if (threadIdx.x == 0) issue(i + STAGES);
    }
  }

  // The epilogue through shared memory, which the walk no longer needs: this thread's rows key[r] of dK
  // and dV (accumulator nt * 4 + 2 r (+1) holds columns nt * 8 + 2 t (+1)) go to whole rows there, scaled
  // and in bf16 (n_split == 1) or as fp32 partials, and the tile's rows, one contiguous run of device
  // memory each for dK and dV, leave in coalesced 16-byte stores.
  const bool direct = p.n_split == 1;
  const int row_bytes = DP * (direct ? 2 : 4) + 16;  // a 16-byte pad spreads the rows over the banks
  unsigned char* st_k = smem;
  unsigned char* st_v = smem + BK * row_bytes;
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
        *reinterpret_cast<__nv_bfloat162*>(st_k + row * row_bytes + c * 2) = __floats2bfloat162_rn(kk[0] * p.scale, kk[1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(st_v + row * row_bytes + c * 2) = __floats2bfloat162_rn(vv[0], vv[1]);
      } else {
        *reinterpret_cast<float2*>(st_k + row * row_bytes + c * 4) = make_float2(kk[0], kk[1]);
        *reinterpret_cast<float2*>(st_v + row * row_bytes + c * 4) = make_float2(vv[0], vv[1]);
      }
    }
  }
  __syncthreads();
  const size_t first = ((direct ? 0 : (size_t)split * gridDim.y * p.Lk) + (size_t)bkv * p.Lk + k0) * p.d;
  char* gk = direct ? reinterpret_cast<char*>(p.dk + first) : reinterpret_cast<char*>(p.dk_part + first);
  char* gv = direct ? reinterpret_cast<char*>(p.dv + first) : reinterpret_cast<char*>(p.dv_part + first);
  const int chunks = p.d * (direct ? 2 : 4) / 16;  // 16-byte chunks of a row in device memory
  for (int i = threadIdx.x; i < min(BK, p.Lk - k0) * chunks; i += WG_THREADS) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(gk + (size_t)i * 16) = *reinterpret_cast<const uint4*>(st_k + r * row_bytes + c * 16);
    *reinterpret_cast<uint4*>(gv + (size_t)i * 16) = *reinterpret_cast<const uint4*>(st_v + r * row_bytes + c * 16);
  }
}

template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch_dkv(const DkvParams& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_kernel<DP, CAUSAL, HAS_LEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lk + DKV_BK - 1) / DKV_BK, p.B * p.KVH, p.n_split);
  kernel<<<grid, WG_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum{{p.dk_part, p.dv_part}, {p.dk, p.dv}, {p.scale, 1.f}}, 2, p.n_split,
                  (size_t)p.B * p.KVH * p.Lk * p.d, stream);
}

// One of the four mask variants of K6 at padded head dim DP.
template <int DP>
cudaError_t dispatch_dkv(const DkvParams& p, bool causal, cudaStream_t stream) {
  const bool has_len = p.kv_lengths != nullptr;
  if (causal && has_len) return launch_dkv<DP, true, true>(p, stream);
  if (causal) return launch_dkv<DP, true, false>(p, stream);
  if (has_len) return launch_dkv<DP, false, true>(p, stream);
  return launch_dkv<DP, false, false>(p, stream);
}

struct DqParams {
  const bf16 *q, *k, *v, *dout;      // (B, H, Lq, d), (B, KVH, Lk, d) x 2, (B, H, Lq, d)
  const int* kv_lengths;            // (B,) or null
  const float *lse, *delta;         // (B, H, Lq)
  bf16* dq;                         // (B, H, Lq, d), n_split == 1
  float* dq_part;                   // (n_split, B * H, Lq, d), n_split > 1
  int B, H, KVH, Lq, Lk, d, n_split;
  float scale, bias;
};

template <int DP>
constexpr int dq_smem_bytes() {
  return DQ_STAGES * 2 * BK_DQ * (DP + 8) * 2;
}

// K5. grid (ceil(Lq / (16 NW)), B * H, n_split), 32 NW threads, dq_smem_bytes<DP>() of dynamic
// shared memory. Writes scale * dQ in bf16 (n_split == 1) or the chunk's unscaled fp32 sum.
template <int DP, bool CAUSAL, bool HAS_LEN, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dq_kernel(const DqParams p) {
  constexpr int BQ = 16 * NW;        // query rows per block
  constexpr int LDS = DP + 8;        // 16-byte row pad: conflict-free ldmatrix rows
  constexpr int KC = DP / 16;        // k-steps over d
  constexpr int NT_O = DP / 8;       // n-tiles of dQ
  constexpr int NT_S = BK_DQ / 8;    // n-tiles of S and dP
  constexpr int CH = DP / 8;         // 16-byte chunks of a padded row
  constexpr int TILE = BK_DQ * LDS;  // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // slot s: K at 2 s TILE, V TILE later

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
  if (HAS_LEN) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK_DQ - 1) / BK_DQ;
  if (CAUSAL) {
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
#pragma unroll
  for (int s = 0; s < DQ_STAGES - 1; ++s) {
    if (t_begin + s < t_end) issue(t_begin + s);
    cp_async_commit();
  }

  // Q and dO as A operands, straight from device memory: rows row[j & 1], columns kc * 16 + 2t
  // (+1), + 8 for j >= 2; zero past Lq and d
  uint32_t qa[KC][4], da[KC][4];
  const size_t qoff = (size_t)bh * p.Lq * p.d;
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
#pragma unroll
      for (int nt = 0; nt < NT_S; nt += 2) {
        const uint32_t off = (((nt + (lane >> 4)) * 8 + (lane & 7)) * LDS + kc * 16 + ((lane >> 3) & 1) * 8) * 2;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, sk + off);
        ldmatrix_x4(vf, sv + off);
        mma_bf16(s[nt], qa[kc], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qa[kc], kf[2], kf[3]);
        mma_bf16(dp[nt], da[kc], vf[0], vf[1]);
        mma_bf16(dp[nt + 1], da[kc], vf[2], vf[3]);
      }
    }

    // P from the lse, then dS = P * (dP - delta), stored over S
    const int k0 = kt * BK_DQ;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        bool ok = key < kv_limit;
        if (CAUSAL) ok = ok && key <= row[e >> 1] + diag;
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

template <int DP, bool CAUSAL, bool HAS_LEN, int NW>
cudaError_t launch_dq_nw(const DqParams& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP>();
  auto kernel = flash_bwd_dq_kernel<DP, CAUSAL, HAS_LEN, NW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + 16 * NW - 1) / (16 * NW), p.B * p.H, p.n_split);
  kernel<<<grid, NW * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum{{p.dq_part, nullptr}, {p.dq, nullptr}, {p.scale, 0.f}}, 1, p.n_split,
                  (size_t)p.B * p.H * p.Lq * p.d, stream);
}

// 32-row query tiles (2 warps) when Lq <= 32, else 64 (4 warps).
template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch_dq(const DqParams& p, cudaStream_t stream) {
  if (p.Lq <= 32) return launch_dq_nw<DP, CAUSAL, HAS_LEN, 2>(p, stream);
  return launch_dq_nw<DP, CAUSAL, HAS_LEN, 4>(p, stream);
}

// One of the four mask variants of K5 at padded head dim DP.
template <int DP>
cudaError_t dispatch_dq(const DqParams& p, bool causal, cudaStream_t stream) {
  const bool has_len = p.kv_lengths != nullptr;
  if (causal && has_len) return launch_dq<DP, true, true>(p, stream);
  if (causal) return launch_dq<DP, true, false>(p, stream);
  if (has_len) return launch_dq<DP, false, true>(p, stream);
  return launch_dq<DP, false, false>(p, stream);
}

bool bad_shape(int d, int H, int KVH, int Lq, int Lk) {
  return d % 8 != 0 || d > 128 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0;
}

}  // namespace

// q/dout (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null;
// lse/delta (B, H, Lq) fp32; dq (B, H, Lq, d) bf16. n_split >= 1 chunks of the key axis; for
// n_split > 1, an fp32 workspace dq_part (n_split, B * H, Lq, d). d % 8 == 0, d <= 128, H % KVH == 0.
extern "C" int hicom_flash_bwd_dq(const void* q, const void* k, const void* v, const int* kv_lengths,
                                  const void* dout, const float* lse, const float* delta, void* dq, float* dq_part,
                                  int B, int H, int KVH, int Lq, int Lk, int d, int n_split, float scale, float bias,
                                  int causal, void* stream) {
  if (bad_shape(d, H, KVH, Lq, Lk) || B <= 0 || dq == nullptr || n_split < 1 || (n_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  DqParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
             static_cast<const bf16*>(dout), kv_lengths, lse, delta, static_cast<bf16*>(dq), dq_part,
             B, H, KVH, Lq, Lk, d, n_split, scale, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 32: return (int)dispatch_dq<32>(p, causal != 0, s);
    case 64: return (int)dispatch_dq<64>(p, causal != 0, s);
    case 80: return (int)dispatch_dq<80>(p, causal != 0, s);
    case 128: return (int)dispatch_dq<128>(p, causal != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split path's reduction alone: out (n) bf16 = scale * sum over n_split of part (n_split, n) fp32
// (K5's dQ sum), and with a second pair part2/out2 (scale2) in the same launch (K6's dK and dV sums);
// n % 4 == 0.
extern "C" int hicom_flash_part_sum(const float* part, void* out, float scale, const float* part2, void* out2,
                                    float scale2, int n_split, long long n, void* stream) {
  if (n <= 0 || n % 4 != 0 || n_split < 1 || (part2 == nullptr) != (out2 == nullptr)) return (int)cudaErrorInvalidValue;
  const PartSum a{{part, part2}, {static_cast<bf16*>(out), static_cast<bf16*>(out2)}, {scale, scale2}};
  return (int)part_sum(a, part2 == nullptr ? 1 : 2, n_split, (size_t)n, static_cast<cudaStream_t>(stream));
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
  switch ((d + 15) / 16 * 16) {
    case 32: return (int)dispatch_dkv<32>(p, causal != 0, s);
    case 64: return (int)dispatch_dkv<64>(p, causal != 0, s);
    case 80: return (int)dispatch_dkv<80>(p, causal != 0, s);
    case 128: return (int)dispatch_dkv<128>(p, causal != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
