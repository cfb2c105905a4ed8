// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v in, fp32 softmax, bf16 out + fp32 lse (fp32
// operands take flash_fwd_f32.cu; the split path's merge pass is flash_merge.cuh).
//
// Replaces two Pallas TPU kernels of hicom_tpu/ops/flash_attention.py:
//   * _fullblock_kernel (K1): unmasked softmax(q k^T * scale + bias) v over whole rows, the SigLIP
//     tower (rows of L = 729, d = 72). Instantiated with CAUSAL = false, and no kv_lengths.
//   * _flash_kernel (K2): blocked online softmax with per-row kv_lengths, a bottom-right causal mask
//     (k <= q + Lk - Lq) and GQA (kv head h / (H / KVH)): the decoder prefill (b 2, 28 q / 4 kv
//     heads, 743 tokens, d = 128) and the global compressor (9 heads, 32 queries over 23,328 keys).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   * tower and prefill: operations, 4 Lq Lk d flops per head against 2 (Lq + Lk) d bf16 bytes.
//     The tower's 512 rows take 79 us at the bf16 peak, the prefill 8 us: both products belong on
//     the warpgroup MMA, fed from shared memory without stalls.
//   * global compressor: bytes. 32 queries read 23,328 keys and values once, 107 MB per batch row,
//     32 us; but one block per 128 query rows gives only B * H = 9 (b 1) or 18 (b 2) blocks there,
//     a tenth of the 132 SMs, each walking 365 key tiles alone.
//
// The design:
//   * A block holds two warpgroups of 64 query rows each (128 rows of one batch row and head).
//   * S = Q K^T and O += P V are warpgroup MMAs (wgmma m64nNk16, bf16 operands, fp32 accumulators):
//     S with Q and K both read from shared memory, P V with P, S's accumulator layout rounded to
//     bf16, as the register A operand and V as an MN-major (transposed) B, so V needs no transpose.
//   * Q and the K/V tiles of 64 keys come by TMA into shared memory (up to 128: a ring of 4 tiles at d <= 80,
//     where two blocks share an SM, else 5), one thread issuing the copies and an mbarrier per slot
//     signalling their arrival. A tile's columns 0-63 (0-127 at d 128) arrive as boxes of 64
//     columns, rows of 128 B in the 128-byte swizzle that wgmma reads; d 72's columns 64-71 (a
//     144-byte row has no swizzle of its width) arrive as a 16-byte box without swizzle, read with
//     a second descriptor and a 16-column P V product, and columns 72-79 are zeros written once.
//     Every padded head dim 16, 32, ..., 128, 192, 256 (d % 8 == 0) has an instance: the columns past the last
//     whole box (all of them at d <= 48) arrive so, in chunks of 8 columns, and P V over them is one
//     product of 16 or 32 columns, or 32 and then 16 (a 48-column tail: d 48, d 112).
//     Past 128 the head dim pads to 192 or 256 (hopper.cuh padded_dim): 3 or 4 boxes of 64 columns,
//     the last reaching past d where d is not 192 or 256 (d 136: TMA fills columns 136-191 with
//     zeros), and P V is one product of N = 192 or 256 per k-step, V's boxes the descriptor's
//     64-column atoms (hopper.cuh wgmma_rs_mn_row). O's accumulator is then 96 or 128
//     registers a thread beside S's 32 and P's 16. 256 is the ceiling of this layout: wgmma's N stops
//     at 256, and O past it would not fit the 255 registers a thread may hold.
//     Rows past Lq or Lk arrive as zeros. Device memory is never padded.
//   * Per key tile, S of the tile and P V of the previous one are in flight together, and the
//     softmax of the tile runs while P V of the previous one does; nothing is in flight from one
//     tile to the next. All wgmma and their waits lie on paths that are uniform across the
//     warpgroup (ptxas serialises wgmma it finds on divergent paths): a warpgroup whose rows all
//     lie past Lq computes anyway and writes nothing.
//   * Up to 128 a K tile and its V tile share a ring slot, and thread 0 requests a slot's next tile
//     after a block-wide barrier that waits for P V of the tile it held. At the padded widths 192 and
//     256 (flash_fwd_ws_kernel) that left a tile's copy requested in the very iteration that waits for
//     it (2 slots of 64 KB at 256), so every tile exposed the whole TMA latency. There a producer
//     warpgroup (setmaxnreg down to 24 registers; the consumers up to 240, room for O's 128 beside S
//     and P) issues every copy, and K and V have rings of their own (2 slots each: Q and the rings
//     take 196,680 bytes at both widths), each slot with a full and an empty mbarrier: each consumer
//     warp arrives on a K slot's empty barrier once it has waited for S of the slot's tile, and on a V
//     slot's once P V of it is done, so K(i + 1) is in flight from S(i - 1) on and V(i + 1) from
//     P V(i - 1) on, a whole tile ahead, and no block-wide barrier remains in the walk. The two
//     consumer warpgroups take turns to issue their products (ping-pong on named barriers), so one's
//     softmax runs under the other's products; 192 walks tiles of 96 keys (S as m64n96k16). Measured
//     on the H100 (PERF.md, PR 22): each warpgroup's products run at about half the tensor cores'
//     rate (an m64n64k16 of S took about 110 cycles of the 32 its arithmetic needs), which is what
//     holds these instances back; Q in registers, S over independent accumulators, and a deeper walk
//     without ping-pong measured no faster or slower.
//   * The online softmax runs in registers in the log2 domain (ex2.approx); no Lq x Lk matrix
//     reaches device memory.
//   * Split-KV for small grids: the wrapper picks n_split chunks of the key axis (grid z) when
//     ceil(Lq / 128) * B * H blocks cannot fill the card (ops/flash_attention.py forward_splits:
//     29 chunks at the global compressor's b 1, 14 at b 2; one at the tower and prefill). Each block
//     writes its chunk's unnormalised fp32 output, running max and denominator to a workspace, and
//     flash_merge_kernel (flash_merge.cuh) combines the chunks in a fixed order (the same result on
//     every run) into the bf16 output and the fp32 lse.
//   * Partials alone (o null): the blocks write their chunks' fp32 partials, even at one chunk, and
//     no merge runs, so that partials over keys held elsewhere (other ranks, other ring blocks) are
//     merged with these by one merge pass, all in fp32 (ops/flash_attention.py
//     flash_forward_partials).
//
// kv_lengths is a runtime argument (one instance per head dim and mask kind, causal or not: the masks test a
// tile's keys against the row's limit either way), which halves the instances the build compiles.
//
// Masking follows the Pallas kernel: masked logits are -1e30, so a row with no valid key yet carries
// p = 1 until a real maximum arrives and wipes it (alpha = 0); keys past Lk are -inf (p = 0). Tiles
// wholly above the causal diagonal or past kv_lengths are skipped, except in a block that holds a
// row with no valid key at all: it walks every tile, so that the row ends as the mean of all Lk
// values, flash_reference's answer. A chunk with no tile writes max -inf and denominator 0 and gets
// weight 0 in the merge; a chunk whose tiles are all masked for a row writes max -1e30 and weighs
// exp(-1e30 - M) = 0 against any chunk with a real maximum M. The final divide uses max(l, 1e-30).
#include <math.h>

#include "flash_merge.cuh"
#include "hopper.cuh"

namespace {

constexpr int NWG = 2;                    // warpgroups per block
constexpr int NTHREADS = NWG * WG_THREADS;
constexpr int BQ = 64 * NWG;              // query rows per block
constexpr int BK = 64;                    // keys per tile
// K/V tiles in the ring up to 128: 4 where two blocks share an SM (d <= 80), else 5
__host__ __device__ constexpr int stages_for(int dp) { return dp <= 80 ? 4 : 5; }
constexpr float NEG = -1e30f;
constexpr float NEG2 = NEG * LOG2E;       // the -1e30 mask in the log2 domain (NEG2 * LN2 == NEG)

// TMA maps of q (d columns, Lq rows, B * H heads), k and v (d columns, Lk rows, B * KVH heads): boxes of
// 64 columns with the 128-byte swizzle, and boxes of 8 columns without, for the tail past them.
struct Params {
  CUtensorMap tq, tk, tv;         // 64-column boxes of BQ / BK rows, 128-byte swizzle
  CUtensorMap tq8, tk8, tv8;      // 8-column boxes of BQ / BK rows
  const int* kv_lengths;          // (B,) or null
  bf16* o;                        // (B, H, Lq, d), or null for the partials alone
  float* lse;                     // (B, H, Lq)
  float *o_part, *m_part, *l_part;  // n_split > 1 or o null: (n_split, B * H, Lq, d), (n_split, B * H, Lq) x 2
  int B, H, KVH, Lq, Lk, d, n_split;
  float scale, bias;
};

template <int DP>
constexpr int fwd_smem_bytes() {  // Q, the ring, then one mbarrier per slot and one for Q
  return BQ * DP * 2 + stages_for(DP) * (2 * BK * DP * 2 + 8) + 8;
}

// grid (ceil(Lq / BQ), B * H, n_split), NTHREADS threads, fwd_smem_bytes<DP>() of dynamic shared
// memory.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, DP <= 80 ? 2 : 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  constexpr int KC = DP / 16;        // k16 steps of Q K^T
  constexpr int NT_O = DP / 8;       // 8-column tiles of O
  constexpr int NT_S = BK / 8;       // 8-key tiles of S
  constexpr int TILE = BK * DP * 2;  // bytes of one K or V tile
  constexpr int STAGES = stages_for(DP);
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);  // Q, BQ rows in the ring's core-matrix layout
  const uint32_t ring = sq + BQ * DP * 2;  // slot s: K at ring + 2 s TILE, V TILE bytes later
  const uint32_t bars = ring + STAGES * 2 * TILE;  // slot s's "tile landed" barrier at bars + 8 s
  const uint32_t qbar = bars + STAGES * 8;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int kvh = (bh % p.H) / (p.H / p.KVH);
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);  // warp-uniform for ptxas
  const int warp = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq0 = q0 + wg * 64;  // this warpgroup's first row
  const int row[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = __shfl_sync(0xffffffffu, max(0, min(p.Lk, p.kv_lengths[b])), 0);
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK - 1) / BK;
  if (CAUSAL) {
    const int max_key = min(q0 + BQ - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK + 1);
  }
  if (kv_limit == 0 || (CAUSAL && q0 + diag < 0)) n_tiles = (p.Lk + BK - 1) / BK;  // a row with no valid key
  const int t_begin = n_tiles * split / p.n_split;
  const int t_end = n_tiles * (split + 1) / p.n_split;

  // Q (BQ rows) and each K and V tile (BK rows) in hopper.cuh's tile layout
  typedef Tile<DP> T;
  const int tail_loaded = max(0, p.d / 8 - T::NB * 8);  // tail chunks that hold columns below d

  const int head = b * p.KVH + kvh;
  auto slot = [&](int kt) { return ring + ((kt - t_begin) % STAGES) * 2 * TILE; };
  auto bar = [&](int kt) { return bars + ((kt - t_begin) % STAGES) * 8; };
  auto wait_tile = [&](int kt) { mbar_wait(bar(kt), ((kt - t_begin) / STAGES) & 1); };
  auto issue = [&](int kt) {  // one thread: tile kt of K and V
    mbar_expect_tx(bar(kt), 2 * T::bytes(BK, tail_loaded));
    T::load(slot(kt), &p.tk, &p.tk8, BK, kt * BK, head, bar(kt), tail_loaded);
    T::load(slot(kt) + TILE, &p.tv, &p.tv8, BK, kt * BK, head, bar(kt), tail_loaded);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tail chunks past d (columns 72-79 at d 72) are zero in Q and every slot, once
  T::zero_pad(sq, BQ, tail_loaded, threadIdx.x, NTHREADS);
  for (int i = 0; i < 2 * STAGES; ++i) T::zero_pad(ring + i * TILE, BK, tail_loaded, threadIdx.x, NTHREADS);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, T::bytes(BQ, tail_loaded));
    T::load(sq, &p.tq, &p.tq8, BQ, q0, bh, qbar, tail_loaded);
    // tiles t_begin .. t_begin + STAGES - 1 in flight
    for (int s = 0; s < STAGES; ++s)
      if (t_begin + s < t_end) issue(t_begin + s);
  }
  mbar_wait(qbar, 0);

  // S = Q K^T of tile kt into s, issued and committed but not waited for: this warpgroup's 64 rows of
  // Q and the tile's keys, both K-major in shared memory.
  auto issue_qk = [&](float* s, int kt) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(s, T::kmajor(sq, BQ, wg * 64, kc), T::kmajor(slot(kt), BK, 0, kc), kc > 0);
    wgmma_commit();
  };

  // running max (log2 domain) and denominator of rows row[0] and row[1]; the output accumulator
  float m[2] = {NEG2, NEG2};
  float l[2] = {0.f, 0.f};
  float acc[NT_O * 4];
#pragma unroll
  for (int i = 0; i < NT_O * 4; ++i) acc[i] = 0.f;
  const float scale2 = p.scale * LOG2E, bias2 = p.bias * LOG2E;

  // The softmax of tile kt, in place on its logits s: masks, the running max and denominator, and
  // alpha, the factor by which the output accumulated so far must shrink.
  float s[NT_S * 4];
  float alpha[2];
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    bool need_mask = k0 + BK > kv_limit;
    if (CAUSAL) need_mask = need_mask || k0 + BK - 1 > q0 + diag;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt * 4 + e] * scale2 + bias2;
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          bool ok = key < kv_limit;
          if (CAUSAL) ok = ok && key <= row[e >> 1] + diag;
          x = key >= p.Lk ? -INFINITY : (ok ? x : NEG2);
        }
        s[nt * 4 + e] = x;
      }
    }
    // in the log2 domain; this thread holds rows row[0] (e = 0, 1) and row[1] (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_approx(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        s[nt * 4 + 2 * r] = exp2_approx(s[nt * 4 + 2 * r] - mx);
        s[nt * 4 + 2 * r + 1] = exp2_approx(s[nt * 4 + 2 * r + 1] - mx);
        sum += s[nt * 4 + 2 * r] + s[nt * 4 + 2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = mx;
    }
  };
  // P of the last softmax in bf16, S's accumulator layout as the A operand of P V
  uint32_t pa[BK / 16][4];
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
  };
  // O = alpha O + P V of tile kt, issued and committed; V is the MN-major B (Tile::rs_mn).
  auto issue_pv = [&](int kt) {
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt * 4 + 0] *= alpha[0];
      acc[nt * 4 + 1] *= alpha[0];
      acc[nt * 4 + 2] *= alpha[1];
      acc[nt * 4 + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) T::rs_mn(acc, pa[kc], slot(kt) + TILE, BK, kc);
    wgmma_commit();
  };

  // Tile t_begin: S, softmax, P. Then per tile kt: S of tile kt and P V of tile kt - 1 in flight
  // together, the softmax of tile kt while P V of tile kt - 1 runs, and nothing in flight from one
  // tile to the next. Every wgmma and wait is on the uniform path, where ptxas keeps them
  // asynchronous: a warpgroup with no row below Lq computes anyway (its rows are not written), and
  // a chunk with no tile computes on a slot no copy writes and writes the empty partial.
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) s[i] = 0.f;
  if (t_begin < t_end) wait_tile(t_begin);
  issue_qk(s, t_begin);
  wgmma_wait<0>();
  fence_regs<NT_S * 4>(s);
  softmax(t_begin);
  pack();
  for (int kt = t_begin + 1; kt < t_end; ++kt) {
    __syncthreads();  // every warpgroup has finished P V of tile kt - 2: its slot is free
    if (threadIdx.x == 0 && kt - 2 >= t_begin && kt - 2 + STAGES < t_end) issue(kt - 2 + STAGES);
    wait_tile(kt);
    issue_qk(s, kt);
    issue_pv(kt - 1);
    wgmma_wait<1>();  // S of tile kt
    fence_regs<NT_S * 4>(s);
    softmax(kt);
    wgmma_wait<0>();  // P V of tile kt - 1
    fence_regs<NT_O * 4>(acc);
    pack();
  }
  issue_pv(max(t_begin, t_end - 1));  // (an empty chunk reads its first slot)
  wgmma_wait<0>();
  fence_regs<NT_O * 4>(acc);
  if (t_begin == t_end) {  // an empty chunk: nothing walked
#pragma unroll
    for (int i = 0; i < NT_O * 4; ++i) acc[i] = 0.f;
    l[0] = l[1] = 0.f;
  }

  if (p.n_split == 1 && p.o != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.Lq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / denom;
      bf16* orow = p.o + ((size_t)bh * p.Lq + row[r]) * p.d;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int c = nt * 8 + t * 2;
        if (c < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[nt * 4 + 2 * r] * inv, acc[nt * 4 + 2 * r + 1] * inv);
      }
      if (t == 0) p.lse[(size_t)bh * p.Lq + row[r]] = m[r] * LN2 + logf(denom);
    }
    return;
  }
  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    float* orow = p.o_part + (prow + row[r]) * p.d;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c < p.d) *reinterpret_cast<float2*>(orow + c) = make_float2(acc[nt * 4 + 2 * r], acc[nt * 4 + 2 * r + 1]);
    }
    if (t == 0) {
      p.m_part[prow + row[r]] = t_end > t_begin ? m[r] * LN2 : -INFINITY;
      p.l_part[prow + row[r]] = l[r];
    }
  }
}

// ------------------------------------------------------------------------------------------------------------
// The 192 and 256 instances: a producer warpgroup (its first thread issues every copy) beside the two consumer
// warpgroups, K and V in rings of their own, and every slot's hand-over on mbarriers. K tile i is requested once
// the consumers have waited for S of the tile its slot held (i - STAGES), V tile i once they have waited for P V
// of its slot's last tile; the producer asks for K(i + 1) before V(i), the order the consumers take them in.
constexpr int WS_THREADS = (NWG + 1) * WG_THREADS;
// keys per tile: 96 at 192 (S as m64n96k16: an m64n64k16 product took about 110 cycles, 32 of them its
// arithmetic), 64 at 256 (and up to 128, flash_fwd_kernel's BK), where no wider tile fits beside Q
__host__ __device__ constexpr int keys_per_tile(int dp) { return dp == 192 ? 96 : 64; }
constexpr int WS_STAGES = 2;  // slots of each ring (192: Q 48 KB + 4 x 36 KB; 256: Q 64 KB + 4 x 32 KB)
template <int DP>
constexpr int ws_smem_bytes() {  // Q, the K ring, the V ring, then each slot's full and empty barriers, then Q's
  return BQ * DP * 2 + 2 * WS_STAGES * keys_per_tile(DP) * DP * 2 + (4 * WS_STAGES + 1) * 8;
}
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(WS_THREADS, 1) flash_fwd_ws_kernel(const __grid_constant__ Params p) {
  static_assert(DP % 64 == 0, "the warp-specialised instances have no tail columns");
  constexpr int BKW = keys_per_tile(DP);
  constexpr int KC = DP / 16, NT_O = DP / 8, NT_S = BKW / 8;
  constexpr int TILE = BKW * DP * 2, STAGES = WS_STAGES;
  typedef Tile<DP> T;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t kring = sq + BQ * DP * 2, vring = kring + STAGES * TILE;
  const uint32_t kfull = vring + STAGES * TILE, kempty = kfull + 8 * STAGES;
  const uint32_t vfull = kempty + 8 * STAGES, vempty = vfull + 8 * STAGES, qbar = vempty + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int kvh = (bh % p.H) / (p.H / p.KVH);
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);  // warp-uniform for ptxas

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = __shfl_sync(0xffffffffu, max(0, min(p.Lk, p.kv_lengths[b])), 0);
  const int diag = p.Lk - p.Lq;
  int n_tiles = (kv_limit + BKW - 1) / BKW;
  if (CAUSAL) {
    const int max_key = min(q0 + BQ - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BKW + 1);
  }
  if (kv_limit == 0 || (CAUSAL && q0 + diag < 0)) n_tiles = (p.Lk + BKW - 1) / BKW;  // a row with no valid key
  const int t_begin = n_tiles * split / p.n_split;
  const int n = n_tiles * (split + 1) / p.n_split - t_begin;  // tiles of this chunk, i = 0 .. n - 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, NWG * 4);  // one arrival from each consumer warp
      mbar_init(vempty + 8 * s, NWG * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the producer's warps leave early

  if (wg == NWG) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * WG_THREADS) {
      const int head = b * p.KVH + kvh;
      mbar_expect_tx(qbar, T::bytes(BQ, 0));
      T::load(sq, &p.tq, &p.tq8, BQ, q0, bh, qbar, 0);
      // tile i of K or V into slot i % STAGES, once the consumers have freed it of tile i - STAGES
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, T::bytes(BKW, 0));
        T::load(ring + s * TILE, map, map, BKW, (t_begin + i) * BKW, head, full + 8 * s, 0);
      };
      if (n > 0) load(&p.tk, kring, kfull, kempty, 0);
      for (int i = 0; i < n; ++i) {
        if (i + 1 < n) load(&p.tk, kring, kfull, kempty, i + 1);
        load(&p.tv, vring, vfull, vempty, i);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int warp = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq0 = q0 + wg * 64;  // this warpgroup's first row
  const int row[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
  auto wait_full = [&](uint32_t full, int i) { mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1); };
  auto release = [&](uint32_t empty, int i) {  // after the wgmma that read slot i % STAGES was waited for
    if (lane == 0) mbar_arrive(empty + 8 * (i % STAGES));
  };

  float m[2] = {NEG2, NEG2};
  float l[2] = {0.f, 0.f};
  float acc[NT_O * 4];
#pragma unroll
  for (int i = 0; i < NT_O * 4; ++i) acc[i] = 0.f;
  const float scale2 = p.scale * LOG2E, bias2 = p.bias * LOG2E;
  float s[NT_S * 4];
  float alpha[2];
  uint32_t pa[BKW / 16][4];

  auto issue_qk = [&](int i) {  // S = Q K^T of tile i into s, committed, not waited for
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      if constexpr (BKW == 64)
        wgmma_ss_n64(s, T::kmajor(sq, BQ, wg * 64, kc), T::kmajor(kring + (i % STAGES) * TILE, BKW, 0, kc), kc > 0);
      else
        wgmma_ss_wide<BKW>(s, T::kmajor(sq, BQ, wg * 64, kc), T::kmajor(kring + (i % STAGES) * TILE, BKW, 0, kc),
                           kc > 0);
    wgmma_commit();
  };
  auto softmax = [&](int kt) {  // flash_fwd_kernel's
    const int k0 = kt * BKW;
    bool need_mask = k0 + BKW > kv_limit;
    if (CAUSAL) need_mask = need_mask || k0 + BKW - 1 > q0 + diag;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt * 4 + e] * scale2 + bias2;
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          bool ok = key < kv_limit;
          if (CAUSAL) ok = ok && key <= row[e >> 1] + diag;
          x = key >= p.Lk ? -INFINITY : (ok ? x : NEG2);
        }
        s[nt * 4 + e] = x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_approx(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        s[nt * 4 + 2 * r] = exp2_approx(s[nt * 4 + 2 * r] - mx);
        s[nt * 4 + 2 * r + 1] = exp2_approx(s[nt * 4 + 2 * r + 1] - mx);
        sum += s[nt * 4 + 2 * r] + s[nt * 4 + 2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = mx;
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < BKW / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
  };
  auto issue_pv = [&](int i) {  // O = alpha O + P V of tile i, committed, not waited for
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt * 4 + 0] *= alpha[0];
      acc[nt * 4 + 1] *= alpha[0];
      acc[nt * 4 + 2] *= alpha[1];
      acc[nt * 4 + 3] *= alpha[1];
    }
    wgmma_fence();
    // one product a k-step over the whole row: V's boxes of 64 columns are the descriptor's MN atoms
#pragma unroll
    for (int kc = 0; kc < BKW / 16; ++kc)
      wgmma_rs_mn_row<DP>(acc, pa[kc], make_desc(vring + (i % STAGES) * TILE + kc * 2048, BKW * 128, 1024) | SW128);
    wgmma_commit();
  };
  // ping-pong: the warpgroups take turns to issue their products (named barriers 1 and 2, each warpgroup's
  // turn arriving from the other), so one's softmax runs while the other's products do
  auto my_turn = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(2 * WG_THREADS) : "memory"); };
  auto their_turn = [&]() { asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(2 * WG_THREADS) : "memory"); };
  if (wg == 1) their_turn();  // the first turn is warpgroup 0's

  // As flash_fwd_kernel: S of tile i and P V of tile i - 1 in flight together, the softmax of tile i while P V
  // runs; every wgmma and wait on the uniform path (an empty chunk computes on slots no copy writes, and no
  // barrier is waited for or arrived at).
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) s[i] = 0.f;
  mbar_wait(qbar, 0);
  if (n > 0) wait_full(kfull, 0);
  my_turn();
  issue_qk(0);
  their_turn();
  wgmma_wait<0>();
  fence_regs<NT_S * 4>(s);
  if (n > 0) release(kempty, 0);
  softmax(t_begin);
  pack();
  for (int i = 1; i < n; ++i) {
    wait_full(kfull, i);
    wait_full(vfull, i - 1);
    my_turn();
    issue_qk(i);
    issue_pv(i - 1);
    their_turn();
    wgmma_wait<1>();  // S of tile i: its K slot is free
    fence_regs<NT_S * 4>(s);
    release(kempty, i);
    softmax(t_begin + i);
    wgmma_wait<0>();  // P V of tile i - 1: its V slot is free
    fence_regs<NT_O * 4>(acc);
    release(vempty, i - 1);
    pack();
  }
  if (n > 0) wait_full(vfull, n - 1);
  my_turn();
  issue_pv(max(0, n - 1));
  if (wg == 0) their_turn();  // warpgroup 1 takes no turn after this one
  wgmma_wait<0>();
  fence_regs<NT_O * 4>(acc);
  if (n == 0) {  // an empty chunk: nothing walked
#pragma unroll
    for (int i = 0; i < NT_O * 4; ++i) acc[i] = 0.f;
    l[0] = l[1] = 0.f;
  }

  if (p.n_split == 1 && p.o != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.Lq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / denom;
      bf16* orow = p.o + ((size_t)bh * p.Lq + row[r]) * p.d;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int c = nt * 8 + t * 2;
        if (c < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[nt * 4 + 2 * r] * inv, acc[nt * 4 + 2 * r + 1] * inv);
      }
      if (t == 0) p.lse[(size_t)bh * p.Lq + row[r]] = m[r] * LN2 + logf(denom);
    }
    return;
  }
  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    float* orow = p.o_part + (prow + row[r]) * p.d;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c < p.d) *reinterpret_cast<float2*>(orow + c) = make_float2(acc[nt * 4 + 2 * r], acc[nt * 4 + 2 * r + 1]);
    }
    if (t == 0) {
      p.m_part[prow + row[r]] = n > 0 ? m[r] * LN2 : -INFINITY;
      p.l_part[prow + row[r]] = l[r];
    }
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr bool ws = DP >= 192;  // the warp-specialised instances
  int smem = 0;
  void (*kernel)(const Params) = nullptr;
  if constexpr (ws) {
    smem = ws_smem_bytes<DP>(), kernel = flash_fwd_ws_kernel<DP, CAUSAL>;
  } else {
    smem = fwd_smem_bytes<DP>(), kernel = flash_fwd_kernel<DP, CAUSAL>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + BQ - 1) / BQ, p.B * p.H, p.n_split);
  kernel<<<grid, ws ? WS_THREADS : NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1 || p.o == nullptr) return err;
  return merge<bf16>(p.o_part, p.m_part, p.l_part, p.o, p.lse, p.n_split, p.B * p.H * p.Lq, p.d, stream);
}

template <int DP>
cudaError_t dispatch(const Params& p, bool causal, cudaStream_t stream) {
  return causal ? launch<DP, true>(p, stream) : launch<DP, false>(p, stream);
}

}  // namespace

// q (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null; o (B, H, Lq, d)
// bf16; lse (B, H, Lq) fp32. n_split >= 1 chunks of the key axis; for n_split > 1, fp32 workspaces
// o_part (n_split, B * H, Lq, d), m_part and l_part (n_split, B * H, Lq). With o null the kernel
// writes those partials (needed then at any n_split) and no merge runs; lse is unused. d % 8 == 0,
// d <= 256, H % KVH == 0. Returns a CUDA error code (0 when both launches were accepted).
extern "C" int hicom_flash_fwd(const void* q, const void* k, const void* v, const int* kv_lengths, void* o,
                               float* lse, float* o_part, float* m_part, float* l_part, int B, int H, int KVH,
                               int Lq, int Lk, int d, int n_split, float scale, float bias, int causal,
                               void* stream) {
  if (d % 8 != 0 || d > 256 || KVH <= 0 || H % KVH != 0 || B <= 0 || Lq <= 0 || Lk <= 0 || n_split < 1 ||
      ((n_split > 1 || o == nullptr) && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.kv_lengths = kv_lengths;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split;
  p.scale = scale, p.bias = bias;
  // the swizzled maps serve the kernel's 64-column boxes, the narrow ones the columns past them
  cudaError_t err = tile_maps(&p.tq, &p.tq8, q, d, Lq, B * H, BQ);
  const int bk = keys_per_tile(padded_dim(d));
  if (err == cudaSuccess) err = tile_maps(&p.tk, &p.tk8, k, d, Lk, B * KVH, bk);
  if (err == cudaSuccess) err = tile_maps(&p.tv, &p.tv8, v, d, Lk, B * KVH, bk);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)dispatch<16>(p, causal != 0, s);
    case 32: return (int)dispatch<32>(p, causal != 0, s);
    case 48: return (int)dispatch<48>(p, causal != 0, s);
    case 64: return (int)dispatch<64>(p, causal != 0, s);
    case 80: return (int)dispatch<80>(p, causal != 0, s);
    case 96: return (int)dispatch<96>(p, causal != 0, s);
    case 112: return (int)dispatch<112>(p, causal != 0, s);
    case 128: return (int)dispatch<128>(p, causal != 0, s);
    case 192: return (int)dispatch<192>(p, causal != 0, s);
    case 256: return (int)dispatch<256>(p, causal != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The merge pass alone: o_part (n_split, rows, d), m_part and l_part (n_split, rows) fp32 to o (rows, d)
// and lse (rows,) fp32; o is fp32 when out_fp32, else bf16. d % 4 == 0.
extern "C" int hicom_flash_merge(const float* o_part, const float* m_part, const float* l_part, void* o, float* lse,
                                 int n_split, int rows, int d, int out_fp32, void* stream) {
  if (d % 4 != 0 || n_split < 1 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_fp32) return (int)merge<float>(o_part, m_part, l_part, static_cast<float*>(o), lse, n_split, rows, d, s);
  return (int)merge<bf16>(o_part, m_part, l_part, static_cast<bf16*>(o), lse, n_split, rows, d, s);
}
