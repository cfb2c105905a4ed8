// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v in, fp32 softmax, bf16 out + fp32 lse.
//
// Replaces two Pallas TPU kernels of hicom_tpu/ops/flash_attention.py:
//   * _fullblock_kernel (K1): unmasked softmax(q k^T * scale + bias) v over whole rows, the SigLIP
//     tower (rows of L = 729, d = 72). Instantiated with CAUSAL = false, HAS_LEN = false.
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
//   * Q and the K/V tiles of 64 keys come by TMA into shared memory (a ring of 4 tiles at d <= 80,
//     where two blocks share an SM, else 5), one thread issuing the copies and an mbarrier per slot
//     signalling their arrival. A tile's columns 0-63 (0-127 at d 128) arrive as boxes of 64
//     columns, rows of 128 B in the 128-byte swizzle that wgmma reads; d 72's columns 64-71 (a
//     144-byte row has no swizzle of its width) arrive as a 16-byte box without swizzle, read with
//     a second descriptor and a 16-column P V product, and columns 72-79 are zeros written once.
//     Rows past Lq or Lk arrive as zeros. Device memory is never padded.
//   * Per key tile, S of the tile and P V of the previous one are in flight together, and the
//     softmax of the tile runs while P V of the previous one does; nothing is in flight from one
//     tile to the next. All wgmma and their waits lie on paths that are uniform across the
//     warpgroup (ptxas serialises wgmma it finds on divergent paths): a warpgroup whose rows all
//     lie past Lq computes anyway and writes nothing.
//   * The online softmax runs in registers in the log2 domain (ex2.approx); no Lq x Lk matrix
//     reaches device memory.
//   * Split-KV for small grids: the wrapper picks n_split chunks of the key axis (grid z) when
//     ceil(Lq / 128) * B * H blocks cannot fill the card (ops/flash_attention.py forward_splits:
//     29 chunks at the global compressor's b 1, 14 at b 2; one at the tower and prefill). Each block
//     writes its chunk's unnormalised fp32 output, running max and denominator to a workspace, and
//     flash_merge_kernel combines the chunks in a fixed order (the same result on every run) into
//     the bf16 output and the fp32 lse.
//
// Masking follows the Pallas kernel: masked logits are -1e30, so a row with no valid key yet carries
// p = 1 until a real maximum arrives and wipes it (alpha = 0); keys past Lk are -inf (p = 0). Tiles
// wholly above the causal diagonal or past kv_lengths are skipped, except in a block that holds a
// row with no valid key at all: it walks every tile, so that the row ends as the mean of all Lk
// values, flash_reference's answer. A chunk with no tile writes max -inf and denominator 0 and gets
// weight 0 in the merge; a chunk whose tiles are all masked for a row writes max -1e30 and weighs
// exp(-1e30 - M) = 0 against any chunk with a real maximum M. The final divide uses max(l, 1e-30).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through cudaGetDriverEntryPointByVersion
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;           // one warpgroup
constexpr int NWG = 2;                    // warpgroups per block
constexpr int NTHREADS = NWG * WG_THREADS;
constexpr int BQ = 64 * NWG;              // query rows per block
constexpr int BK = 64;                    // keys per tile
// K/V tiles in the ring: 4 where two blocks share an SM (d <= 80), else 5
__host__ __device__ constexpr int stages_for(int dp) { return dp <= 80 ? 4 : 5; }
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;       // the -1e30 mask in the log2 domain (NEG2 * LN2 == NEG)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of TMA transactions before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@!done bra WAIT;\n}\n" ::"r"(
          bar),
      "r"(parity)
      : "memory");
}
// A TMA box of a 3-D tensor map (columns, rows, heads) to shared memory at dst, completing on the
// barrier. Rows and columns past the map's extent arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// This thread's finished generic-proxy writes to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from reading or writing accumulators between a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: the start address, and the byte offsets between 8-row core matrices
// along K (leading) and along M or N (stride), each in 16-byte units; SW128 marks the 128-byte
// swizzle (rows of 128 B, 8-row atoms of 1 KB), else no swizzle (8 x 16-byte core matrices).
constexpr uint64_t SW128 = 1ull << 62;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N fp32, the warpgroup's accumulator) = a (64 x 16 bf16, registers) * b (16 x N bf16,
// shared memory; K-major when TRANS_B = 0, MN-major when 1) + (scale_d ? d : 0).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N not instantiated");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
}

// d (64 x 64 fp32) = a (64 x 16 bf16, K-major in shared memory) * b (16 x 64 bf16, K-major in shared
// memory) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// TMA maps of q (d columns, Lq rows, B * H heads), k and v (d columns, Lk rows, B * KVH heads): boxes of
// 64 columns with the 128-byte swizzle, and boxes of 8 columns without, for the tail past them.
struct Params {
  CUtensorMap tq, tk, tv;         // 64-column boxes of BQ / BK rows, 128-byte swizzle
  CUtensorMap tq8, tk8, tv8;      // 8-column boxes of BQ / BK rows
  const int* kv_lengths;          // (B,) or null
  bf16* o;                        // (B, H, Lq, d)
  float* lse;                     // (B, H, Lq)
  float *o_part, *m_part, *l_part;  // n_split > 1: (n_split, B * H, Lq, d), (n_split, B * H, Lq) x 2
  int B, H, KVH, Lq, Lk, d, n_split;
  float scale, bias;
};

template <int DP>
constexpr int fwd_smem_bytes() {  // Q, the ring, then one mbarrier per slot and one for Q
  return BQ * DP * 2 + stages_for(DP) * (2 * BK * DP * 2 + 8) + 8;
}

// grid (ceil(Lq / BQ), B * H, n_split), NTHREADS threads, fwd_smem_bytes<DP>() of dynamic shared
// memory.
template <int DP, bool CAUSAL, bool HAS_LEN>
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
  if (HAS_LEN) kv_limit = __shfl_sync(0xffffffffu, max(0, min(p.Lk, p.kv_lengths[b])), 0);
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK - 1) / BK;
  if (CAUSAL) {
    const int max_key = min(q0 + BQ - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK + 1);
  }
  if (kv_limit == 0 || (CAUSAL && q0 + diag < 0)) n_tiles = (p.Lk + BK - 1) / BK;  // a row with no valid key
  const int t_begin = n_tiles * split / p.n_split;
  const int t_end = n_tiles * (split + 1) / p.n_split;

  // A tile of R rows (Q: BQ, K and V: BK) holds NB boxes of 64 columns, R rows of 128 B each with the
  // 128-byte swizzle, then the TAIL columns past them as 16-byte chunks of R rows without swizzle (d 72:
  // one box and the chunks of columns 64-71 and 72-79, the last zero). TMA writes both forms.
  constexpr int NB = DP / 64;
  constexpr int TAIL = DP % 64;
  const int tail_loaded = max(0, p.d / 8 - NB * 8);  // tail chunks that hold columns below d
  auto load_tile = [&](uint32_t dst, const CUtensorMap* sw, const CUtensorMap* narrow, int R, int r0, int hd,
                       uint32_t barrier) {
    for (int bx = 0; bx < NB; ++bx) tma_load(dst + bx * R * 128, sw, bx * 64, r0, hd, barrier);
    for (int c = 0; c < tail_loaded; ++c) tma_load(dst + NB * R * 128 + c * R * 16, narrow, NB * 64 + c * 8, r0, hd, barrier);
  };
  auto tile_bytes = [&](int R) { return NB * R * 128 + tail_loaded * R * 16; };
  // K-major operand descriptor for columns kc * 16 .. + 15 of rows row0 .. of a tile of R rows
  auto kmajor = [&](uint32_t base, int R, int row0, int kc) -> uint64_t {
    if (kc < NB * 4) return make_desc(base + (kc / 4) * R * 128 + row0 * 128 + (kc % 4) * 32, 16, 1024) | SW128;
    return make_desc(base + NB * R * 128 + (kc * 2 - NB * 8) * R * 16 + row0 * 16, R * 16, 128);
  };

  const int head = b * p.KVH + kvh;
  auto slot = [&](int kt) { return ring + ((kt - t_begin) % STAGES) * 2 * TILE; };
  auto bar = [&](int kt) { return bars + ((kt - t_begin) % STAGES) * 8; };
  auto wait_tile = [&](int kt) { mbar_wait(bar(kt), ((kt - t_begin) / STAGES) & 1); };
  auto issue = [&](int kt) {  // one thread: tile kt of K and V
    mbar_expect_tx(bar(kt), 2 * tile_bytes(BK));
    load_tile(slot(kt), &p.tk, &p.tk8, BK, kt * BK, head, bar(kt));
    load_tile(slot(kt) + TILE, &p.tv, &p.tv8, BK, kt * BK, head, bar(kt));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tail chunks past d (columns 72-79 at d 72) are zero in Q and every slot, once
  const int npad = TAIL / 8 - tail_loaded;
  for (int idx = threadIdx.x; idx < npad * (BQ + STAGES * 2 * BK); idx += NTHREADS) {
    const int c = tail_loaded + idx % npad;
    const int r = idx / npad;  // rows of Q, then the rows of each K and V tile
    const uint32_t at = r < BQ ? sq + NB * BQ * 128 + c * BQ * 16 + r * 16
                               : ring + ((r - BQ) / BK) * TILE + NB * BK * 128 + c * BK * 16 + ((r - BQ) % BK) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0u) : "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, tile_bytes(BQ));
    load_tile(sq, &p.tq, &p.tq8, BQ, q0, bh, qbar);
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
    for (int kc = 0; kc < KC; ++kc) wgmma_ss_n64(s, kmajor(sq, BQ, wg * 64, kc), kmajor(slot(kt), BK, 0, kc), kc > 0);
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
  // O = alpha O + P V of tile kt, issued and committed. MN-major B: 8-column chunks BK * 16 B apart,
  // 8-key groups 128 B apart.
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
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int bx = 0; bx < NB; ++bx)  // 64 columns of a box: keys 128 B apart, 8-key atoms 1 KB
        wgmma_rs<64, 1>(acc + bx * 32, pa[kc], make_desc(slot(kt) + TILE + bx * BK * 128 + kc * 2048, BK * 128, 1024) | SW128, 1);
      if constexpr (TAIL > 0)  // the tail: 8-key groups 128 B apart, 8-column chunks BK * 16 B apart
        wgmma_rs<TAIL, 1>(acc + NB * 32, pa[kc], make_desc(slot(kt) + TILE + NB * BK * 128 + kc * 256, 128, BK * 16), 1);
    }
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

  if (p.n_split == 1) {
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

// The split path's second pass, one warp per row: the chunks' largest max M and denominator sum
// L = sum_s w_s l_s with w_s = exp(m_s - M) (a chunk with max -inf weighs 0), then each lane sums 4
// columns, out = sum_s w_s o_s / max(L, 1e-30) in split order, in bf16; lse = M + log max(L, 1e-30).
__global__ void flash_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                                   const float* __restrict__ l_part, bf16* __restrict__ o, float* __restrict__ lse,
                                   int n_split, int rows, int d) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  auto weight = [&](int s, float M) {
    const float ms = m_part[(size_t)s * rows + r];
    return ms == -INFINITY ? 0.f : __expf(ms - M);
  };
  float M = -INFINITY;
  for (int s = lane; s < n_split; s += 32) M = fmaxf(M, m_part[(size_t)s * rows + r]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
  float L = 0.f;
  for (int s = lane; s < n_split; s += 32) L += weight(s, M) * l_part[(size_t)s * rows + r];
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) L += __shfl_xor_sync(0xffffffffu, L, x);
  const float denom = fmaxf(L, 1e-30f);
  const float inv = 1.f / denom;
  for (int c = lane * 4; c < d; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = weight(s, M);
      const float4 x = *reinterpret_cast<const float4*>(o_part + ((size_t)s * rows + r) * d + c);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * d + c);
    out[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    out[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  if (lane == 0) lse[r] = M + logf(denom);
}

cudaError_t merge(const float* o_part, const float* m_part, const float* l_part, bf16* o, float* lse, int n_split,
                  int rows, int d, cudaStream_t stream) {
  flash_merge_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(o_part, m_part, l_part, o, lse, n_split, rows, d);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<DP>();
  auto kernel = flash_fwd_kernel<DP, CAUSAL, HAS_LEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + BQ - 1) / BQ, p.B * p.H, p.n_split);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return merge(p.o_part, p.m_part, p.l_part, p.o, p.lse, p.n_split, p.B * p.H * p.Lq, p.d, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// (heads, rows, d) bf16 at base as a 3-D TMA map: columns, rows, heads; boxes of box_cols columns x
// box_rows rows, with the 128-byte swizzle when box_cols is 64. Rows past the extent arrive as zeros.
cudaError_t tile_map(CUtensorMap* map, const void* base, int d, int rows, int heads, int box_cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t dispatch(const Params& p, bool causal, cudaStream_t stream) {
  const bool has_len = p.kv_lengths != nullptr;
  if (causal && has_len) return launch<DP, true, true>(p, stream);
  if (causal) return launch<DP, true, false>(p, stream);
  if (has_len) return launch<DP, false, true>(p, stream);
  return launch<DP, false, false>(p, stream);
}

}  // namespace

// q (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null; o (B, H, Lq, d)
// bf16; lse (B, H, Lq) fp32. n_split >= 1 chunks of the key axis; for n_split > 1, fp32 workspaces
// o_part (n_split, B * H, Lq, d), m_part and l_part (n_split, B * H, Lq). d % 8 == 0, d <= 128,
// H % KVH == 0. Returns a CUDA error code (0 when both launches were accepted).
extern "C" int hicom_flash_fwd(const void* q, const void* k, const void* v, const int* kv_lengths, void* o,
                               float* lse, float* o_part, float* m_part, float* l_part, int B, int H, int KVH,
                               int Lq, int Lk, int d, int n_split, float scale, float bias, int causal,
                               void* stream) {
  if (d % 8 != 0 || d > 128 || KVH <= 0 || H % KVH != 0 || B <= 0 || Lq <= 0 || Lk <= 0 || n_split < 1 ||
      (n_split > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
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
  const int boxes = (d + 15) / 16 * 16 / 64;
  cudaError_t err = cudaSuccess;
  if (boxes > 0) {
    err = tile_map(&p.tq, q, d, Lq, B * H, 64, BQ);
    if (err == cudaSuccess) err = tile_map(&p.tk, k, d, Lk, B * KVH, 64, BK);
    if (err == cudaSuccess) err = tile_map(&p.tv, v, d, Lk, B * KVH, 64, BK);
  }
  if (err == cudaSuccess && d > boxes * 64) {
    err = tile_map(&p.tq8, q, d, Lq, B * H, 8, BQ);
    if (err == cudaSuccess) err = tile_map(&p.tk8, k, d, Lk, B * KVH, 8, BK);
    if (err == cudaSuccess) err = tile_map(&p.tv8, v, d, Lk, B * KVH, 8, BK);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 32: return (int)dispatch<32>(p, causal != 0, s);
    case 64: return (int)dispatch<64>(p, causal != 0, s);
    case 80: return (int)dispatch<80>(p, causal != 0, s);
    case 128: return (int)dispatch<128>(p, causal != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The merge pass alone: o_part (n_split, rows, d), m_part and l_part (n_split, rows) fp32 to o (rows, d)
// bf16 and lse (rows,) fp32. d % 4 == 0.
extern "C" int hicom_flash_merge(const float* o_part, const float* m_part, const float* l_part, void* o, float* lse,
                                 int n_split, int rows, int d, void* stream) {
  if (d % 4 != 0 || n_split < 1 || rows <= 0) return (int)cudaErrorInvalidValue;
  return (int)merge(o_part, m_part, l_part, static_cast<bf16*>(o), lse, n_split, rows, d,
                    static_cast<cudaStream_t>(stream));
}
