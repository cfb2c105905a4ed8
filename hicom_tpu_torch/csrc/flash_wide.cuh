// Flash attention past head dim 256 for Hopper (sm_90a): the forward (K1, K2) and the backward (K5, K6) of
// csrc/flash_fwd.cu and csrc/flash_bwd.cu (bf16) and their fp32 instances (flash_fwd_f32.cu,
// flash_bwd_f32.cu), for every head dim d % 8 == 0 past 256, with d a runtime argument and no upper limit.
// flash_wide.cu instantiates these templates in bf16 (mma.sync m16n8k16, fp32 accumulators), flash_wide_f32.cu
// in fp32 (every product as 3xTF32 m16n8k8 products; no operand below fp32 precision).
//
// Replaces, past head dim 256, four Pallas TPU kernels of hicom_tpu/ops/flash_attention.py: _fullblock_kernel
// (K1), _flash_kernel (K2), _bwd_dq_kernel (K5) and _bwd_dkv_kernel (K6). The TPU kernels have no width limit:
// JAX's auto rule sends them every head dim that is a multiple of 64 at any length, and every multiple of 8 in
// one block of at most 1,024 rows. Same contract, semantics and split paths as the kernels up to 256: a
// bottom-right causal rule k <= q + Lk - Lq, kv_lengths, GQA with the kv head h / (H / KVH), logit_bias,
// masked logits at -1e30 (keys past Lk -inf), the forward's lse, P rounded to v's type before P V and dV, dS
// rounded to k's type before dQ and dK, every sum in fp32; the forward's merge (flash_merge.cuh) and the
// backward's sum pass (flash_part_sum.cuh) over the same chunks, so that split_forward_reference,
// split_dq_reference and split_dkv_reference describe these kernels too.
//
// Why the kernels up to 256 stop there: their output accumulators (O; dQ; dK and dV) hold a whole row of d
// columns in registers (d / 2 fp32 registers a thread in a 64-row warpgroup: 128 at 256, beside S and P), wgmma's
// N stops at 256, and Q beside a ring of K/V tiles already fills the 232,448 bytes of shared memory at 256.
//
// What bounds them on the H100 (989 TFLOP/s bf16 and 495 TF32 on the tensor cores, 67 fp32 FFMA, 3.35 TB/s):
// operations at every shape the main paths give (the [hd512] prefill, K1 over the d-288 tower). An output row
// of d columns must still be cut into blocks that fit a thread's registers (at most 256 columns for O and dQ,
// 128 for K6's dK and dV), but the contraction over d that gives S = Q K^T (and dP = dO V^T) should be done
// once, not once per block, and fp32 products should reach the tensor cores. The design:
//   * Clusters (every kernel). The output's column blocks of one (row or key block, split) are one thread-block
//     cluster of C CTAs along grid z (z = (split * passes + pass) * C + rank, launched with cudaLaunchKernelEx
//     and a cluster dimension, refused with an error when cudaOccupancyMaxActiveClusters finds no room). The
//     padded d's chunks of 64 columns are cut into C near-equal shares (d 288: 2 and 3 of 5): CTA r loads only
//     its share of Q and K (K5: Q, K, dO and V; K6: K, V, Q and dO), computes a partial S (K5: S and dP; K6: S^T
//     and dP^T) over it, and the partials meet in distributed shared memory (cluster_sum: mapa,
//     ld.shared::cluster, barrier.cluster), summed in rank order, so m, l and the lse (K5 and K6: P and dS) are
//     the same bits in every CTA and rank 0 alone writes the row statistics. Each CTA then computes its own
//     output columns, the same share (the forward's O += P V; K5's dQ += dS K; K6's dV += P^T dO and dK += dS^T
//     Q). The bf16 forward keeps Q's share in shared memory for the whole walk; fp32 streams it with K, and K5
//     streams Q and dO in both types, so that two CTAs fit an SM.
//   * Past the largest cluster (max_cluster, 8: the portable size) the blocks go in passes: the grid holds
//     `passes` clusters of C CTAs per (row block, split); cluster `pass` writes its C blocks of the output, and
//     every pass computes S again over shares of the whole d. K6 takes passes past d 1,024 (16 chunks of 128
//     columns), the forward and K5 past 2,048.
//   * fp32: 3xTF32 (mma.sync m16n8k8): each operand x splits into hi, x rounded to TF32 as cvt.rna.tf32.f32
//     rounds, and lo = x - hi (split_tf32), as its fragment is read, and the product is lo hi + hi lo + hi hi
//     (lo lo, below 2^-21 of the product, is dropped): within the fp32 gate where one TF32 product is not
//     (tests/test_torch_wide_tf32.py). Each chunk's products go to a fresh accumulator, added with one rounded
//     add (the tensor cores' fp32 accumulation truncates). The accumulator layout is bf16 m16n8k16's, so the
//     masks, the online softmax, the splits and the epilogues are one body for both types. On the H100 three
//     TF32 products on mma.sync cost about what one FFMA product did, so the fp32 gain is the recomputation
//     removed (PERF.md, PR 21); wgmma wants both TF32 operands K-major, which V (P V) and Q and dO (dK, dV) are
//     not.
//   * P and dS stay in registers: bf16 packs two 8-column accumulator tiles into m16n8k16's A fragment; fp32
//     reads the k of each step of 8 in the order 2t, 2t + 1 for the fragment's columns t, t + 4, so that the
//     accumulator is m16n8k8's A fragment as it is and B's [k][n] rows fall in distinct banks at LD 68.
//   * A block is 4 warps of 16 rows (query rows for the forward and K5, keys for K6). Inputs stream as chunks of
//     64 columns (rows of 64 + 16 / sizeof(T) elements in shared memory: 144 or 272 bytes, so 8 consecutive rows'
//     16-byte reads fall in distinct banks) through a ring of slots filled by cp.async (zeros past d and past the
//     rows' extent), the next steps' copies in flight while one is computed.
//   * Tiles as the kernels up to 256 walk them, so the split twins hold: the forward walks 64-key tiles over
//     its 128-row group (blocks of 64 rows, as flash_fwd_f32.cu), K5 32-key tiles from 64-row blocks, K6 64-key
//     blocks over (query head, 64-row query tile) units.
//
// Shared memory, registers and spill (ptxas, sm_90a; PERF.md, PRs 21-22): forward 106,496 B in bf16 (Q's share,
// 2 slots of two chunks, two exchange buffers: two CTAs an SM; 255 registers, 20 B spill) and 102,400 in fp32 (2
// slots, two CTAs an SM; 255, 408 B); K5 88,064 in bf16 (3 slots of two chunks, two exchange buffers: two CTAs an
// SM; 255, 72 B) and 102,400 in fp32 (2 slots; 255, 28 B); K6 103,424 in bf16 (2 slots of two chunks, two
// buffers of S^T and dP^T, two units' lse and delta: two CTAs an SM; 255, none) and 171,008 in fp32 (3 slots;
// 255, 500 B).
#pragma once

#include <math.h>

#include "flash_merge.cuh"
#include "flash_part_sum.cuh"
#include "hopper.cuh"

namespace {
namespace wide {

constexpr int NTHREADS = 128;  // 4 warps of 16 rows
constexpr int CW = 64;         // columns of a chunk
constexpr float NEG2 = -1e30f * LOG2E;  // the -1e30 mask in the log2 domain

// Shared rows of a chunk: 64 columns plus 16 bytes.
template <typename T>
struct Layout {
  static constexpr int LD = CW + 16 / (int)sizeof(T);  // elements per row: 72 (bf16), 68 (fp32)
  static constexpr int CH = 64 * LD;                    // elements of a 64-row chunk
  static constexpr int BYTES = CH * (int)sizeof(T);     // 9,216 or 17,408
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Rows r0 .. r0 + R - 1 and columns c0 .. c0 + 63 of a (limit, d) row-major matrix at src into R shared rows of
// Layout<T>::LD at dst, zeros past limit or d (d % 8 == 0, so a 16-byte copy lies wholly below d or past it).
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int r0, int R, int limit, int c0, int d) {
  constexpr int PER = 16 / (int)sizeof(T), PIECES = CW / PER;
  for (int i = threadIdx.x; i < R * PIECES; i += NTHREADS) {
    const int r = i / PIECES, c = (i % PIECES) * PER;
    const bool in = r0 + r < limit && c0 + c < d;
    cp_async16(smem_u32(dst + r * Layout<T>::LD + c), in ? src + (size_t)(r0 + r) * d + c0 + c : src, in);
  }
}

__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put2(float* p, float x, float y) { *reinterpret_cast<float2*>(p) = make_float2(x, y); }

// The warp's bf16 product: acc[nt] is this thread's part of an 8-column tile of a 16-row accumulator (rows g
// and g + 8, columns 2t and 2t + 1; c[0], c[1] on row g); acc (16 x 8 NT) += A (16 x KK, the warp's 16 rows at
// a, [m][k], LD apart) B^T, B's 8 NT rows at b ([n][k]).
template <int NT, int KK>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const bf16* a, const bf16* b) {
  constexpr int LD = Layout<bf16>::LD;
  const int lane = threadIdx.x % 32;
  // ldmatrix lanes: A rows lane % 16, columns 8 (lane / 16); B rows (lane / 16) * 8 + lane % 8 of an n-tile
  // pair, columns 8 (lane / 8 % 2)
  const uint32_t a0 = smem_u32(a) + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const uint32_t b0 = smem_u32(b) + (((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int kc = 0; kc < KK / 16; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, a0 + kc * 32);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b0 + (nt * 8 * LD + kc * 16) * 2);
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// A ring of STAGES slots of SLOT elements fed by a schedule of steps: issue(s) starts step s's copies into
// slot s % STAGES. advance() waits for the current step's copies (with the next STAGES - 1 in flight) and
// returns its slot; release() after its products frees the slot for the copies the next advance() issues.
template <typename T, int STAGES, int SLOT, typename Issue>
struct Ring {
  T* base;
  int n_steps, step;
  Issue& issue;
  __device__ __forceinline__ Ring(T* b, int n, Issue& f) : base(b), n_steps(n), step(0), issue(f) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_steps) issue(s, base + s * SLOT);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ const T* advance() {
    const int next = step + STAGES - 1;
    if (next < n_steps) issue(next, base + (next % STAGES) * SLOT);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    return base + (step % STAGES) * SLOT;
  }
  __device__ __forceinline__ void release() {
    __syncthreads();
    ++step;
  }
};

// ---- 3xTF32 products (the fp32 forward and K6) ---------------------------------------------------------------
// x = hi + lo + a rest below 2^-21 |x|: hi is x rounded to TF32 (10-bit mantissa, to nearest, ties away:
// cvt.rna.tf32.f32's rounding, as integer operations on the bits: a half unit of the 13 dropped bits added to the
// magnitude, then those bits cleared; cvt.rna itself compiles to about four instructions with its checks for
// infinities and NaN, which these finite operands do not need), lo = x - hi (exact) with the same half unit
// added. The tensor cores read a TF32 operand's top 19 bits, so lo's low bits need no clearing.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc[j] += a b[j] for four 8-column tiles j in 3xTF32 (lo hi, hi lo, hi hi: the small terms first), the four
// tiles' products interleaved so that no product waits on the one before it
__device__ __forceinline__ void mma3x4(float (*acc)[4], const uint32_t* ah, const uint32_t* al, uint32_t (*bh)[2],
                                       uint32_t (*bl)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
}

// acc += tmp, then tmp = 0. The fp32 products of each half chunk go to a fresh accumulator, added to the running
// one with one rounded add: the tensor cores' fp32 accumulation does not round to nearest, and its error grows
// with the chain (K6's dK over a walk of 35 units, 840 products into one register, missed the fp32 gate by
// 1.46x; with a chain of a chunk, 24 products, K6 at d 320 read 0.957 of it, as dS = P (dP - delta) cancels;
// half a chunk, 12 products, keeps a margin). NT 8-column tiles.
template <int NT>
__device__ __forceinline__ void add_fresh(float (*acc)[4], float (*tmp)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e], tmp[nt][e] = 0.f;
}

// S-type products: acc (16 x 8 NT) += A (the warp's 16 rows at a, [m][k]) B^T (8 NT rows at b, [n][k]) over one
// chunk of 64 columns: the forward's and K6's 64 keys (NT 8), K5's 32 (NT 4). bf16: ldmatrix and m16n8k16
// (mma_nt). fp32: 3xTF32 m16n8k8, each thread reading its rows g and g + 8 at columns t and t + 4 of each step of
// 8 (banks 4g + t at LD 68: distinct).
template <int NT = 8>
__device__ __forceinline__ void s_product(float (*acc)[4], const bf16* a, const bf16* b) { mma_nt<NT, CW>(acc, a, b); }
template <int NT = 8>
__device__ __forceinline__ void s_product(float (*acc)[4], const float* a, const float* b) {
  constexpr int LD = Layout<float>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * LD + t;
  const float* b0 = b + g * LD + t;
  float tmp[NT][4] = {};
#pragma unroll 2
  for (int k = 0; k < CW; k += 8) {
    if (k == CW / 2) add_fresh<NT>(acc, tmp);
    uint32_t ah[4], al[4];
    split_tf32(a0[k], ah[0], al[0]);
    split_tf32(a0[8 * LD + k], ah[1], al[1]);
    split_tf32(a0[k + 4], ah[2], al[2]);
    split_tf32(a0[8 * LD + k + 4], ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(b0[(n0 + j) * 8 * LD + k], bh[j][0], bl[j][0]);
        split_tf32(b0[(n0 + j) * 8 * LD + k + 4], bh[j][1], bl[j][1]);
      }
      mma3x4(tmp + n0, ah, al, bh, bl);
    }
  }
  add_fresh<NT>(acc, tmp);
}

// P V-type products: acc (16 x 64 of one output chunk) += P (16 x KK: this thread's accumulator fragments p, as
// an S-type product leaves them; the forward's and K6's 64 keys or queries, K5's dS over 32 keys) B (KK x 64 at
// b, [k][n]); P never goes through shared memory. bf16 packs two
// 8-column tiles into m16n8k16's A fragment (rounding p to bf16, as the plain twins round it to v's dtype) and
// reads B with ldmatrix.trans. fp32 takes the k order 2t, 2t + 1 for the fragment's columns t, t + 4 of each step
// of 8: the accumulator's c[0], c[2], c[1], c[3] are then m16n8k8's A fragment, and B's rows 2t and 2t + 1 at
// column g fall in banks 8t + g and 8t + 4 + g at LD 68 (distinct; k order t, t + 4 would give 4t + g, which
// is not).
template <int KK = CW>
__device__ __forceinline__ void pv_product(float (*acc)[4], const float (*p)[4], const bf16* b) {
  constexpr int LD = Layout<bf16>::LD;
  const int lane = threadIdx.x % 32;
  const uint32_t b0 = smem_u32(b) + ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kc = 0; kc < KK / 16; ++kc) {
    const uint32_t af[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]), pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b0 + (kc * 16 * LD + nt * 8) * 2);
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}
template <int KK = CW>
__device__ __forceinline__ void pv_product(float (*acc)[4], const float (*p)[4], const float* b) {
  constexpr int LD = Layout<float>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* b0 = b + 2 * t * LD + g;
  float tmp[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < KK / 8; ++kk) {
    if (kk > 0 && kk % 4 == 0) add_fresh<8>(acc, tmp);  // a fresh accumulator every 32 keys
    uint32_t ah[4], al[4];
    split_tf32(p[kk][0], ah[0], al[0]);
    split_tf32(p[kk][2], ah[1], al[1]);
    split_tf32(p[kk][1], ah[2], al[2]);
    split_tf32(p[kk][3], ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(b0[kk * 8 * LD + (n0 + j) * 8], bh[j][0], bl[j][0]);
        split_tf32(b0[(kk * 8 + 1) * LD + (n0 + j) * 8], bh[j][1], bl[j][1]);
      }
      mma3x4(tmp + n0, ah, al, bh, bl);
    }
  }
  add_fresh<8>(acc, tmp);
}

// ---- the thread-block cluster ---------------------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// Every thread of every CTA of the cluster; shared-memory writes before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr int XF = 64 * 64;  // floats of one exchanged partial (64 x 64)

__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {  // rank's shared-memory address of local
  uint32_t at;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(at) : "r"(local), "r"(rank));
  return at;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t at) {
  float4 y;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(y.x), "=f"(y.y), "=f"(y.z), "=f"(y.w)
               : "r"(at)
               : "memory");
  return y;
}

// The cluster's sum of NP partial products, each 16 x 64 a warp (x[i]: this thread's fragments), in round
// `round` of a walk; xb: two buffers of NP partials. Each CTA writes its own partial (thread-major float4s),
// one cluster barrier, then every element is the sum of the C partials in rank order from 0.0, so every CTA
// holds the same bits.
//   * Gathered (SLICE_FROM 0, or C below it): every CTA adds all C partials itself. The rounds take the two
//     buffers in turn, so one barrier a round suffices: a CTA reaches round i + 2's writes only after every
//     CTA has arrived at round i + 1's barrier, that is, after it has read round i's partials.
//   * Sliced (C from SLICE_FROM on; K6, whose two partials a unit take C x 32 KB of reads from the others'
//     shared memory when gathered: 256 KB at d 1,024): CTA r adds the r-th of C slices of the partials from
//     every CTA into the second buffer, a second barrier, and every CTA gathers each element from the CTA that
//     added it, 2 (C - 1) / C of one partial's bytes. The two barriers also order the rounds, so the first
//     buffer takes every round's partials. Measured on the H100 (PERF.md, PR 21): bf16 K6 (two CTAs an SM)
//     gains from 3 CTAs on (d 512: 0.53 -> 0.38 ms, d 1,024: 1.53 -> 0.63), fp32 K6 (one CTA an SM, the
//     second barrier not hidden) at 8 (d 1,024: 1.92 -> 1.81) but not at 3 or 4 (d 320 and 512: 3-9% slower),
//     so it slices from 5; the forward (one partial of 16 KB a CTA) gathers: sliced it ran no faster.
template <int NP, int SLICE_FROM>
__device__ __forceinline__ void cluster_sum(float (*x)[8][4], float* xb, int round, int C) {
  constexpr int F = NP * 8 * NTHREADS;  // float4s of a partial
  const bool sliced = SLICE_FROM > 0 && C >= SLICE_FROM;
  float4* mine = reinterpret_cast<float4*>(xb + (sliced ? 0 : (round & 1) * NP * XF)) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < NP * 8; ++i) {
    const float* v = x[i / 8][i % 8];
    mine[i * NTHREADS] = make_float4(v[0], v[1], v[2], v[3]);
  }
  cluster_sync();
  if (!sliced) {
#pragma unroll
    for (int i = 0; i < NP * 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i / 8][i % 8][e] = 0.f;
    const uint32_t local = smem_u32(mine);
    for (int r = 0; r < C; ++r) {
      const uint32_t at = map_rank(local, r);
#pragma unroll
      for (int i = 0; i < NP * 8; ++i) {
        const float4 y = ld_cluster(at + i * NTHREADS * 16);
        float* v = x[i / 8][i % 8];
        v[0] += y.x, v[1] += y.y, v[2] += y.z, v[3] += y.w;
      }
    }
    return;
  }
  const uint32_t part = smem_u32(xb);
  float4* sum = reinterpret_cast<float4*>(xb + NP * XF);  // this CTA's slice of the sums
  const int rank = cluster_rank(), first = F * rank / C, last = F * (rank + 1) / C;
  for (int f = first + threadIdx.x; f < last; f += NTHREADS) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float4 y = ld_cluster(map_rank(part + f * 16, r));
      v.x += y.x, v.y += y.y, v.z += y.z, v.w += y.w;
    }
    sum[f - first] = v;
  }
  cluster_sync();
  const uint32_t sums = smem_u32(sum);
#pragma unroll
  for (int i = 0; i < NP * 8; ++i) {
    const int f = i * NTHREADS + threadIdx.x, owner = ((f + 1) * C - 1) / F;
    const float4 y = ld_cluster(map_rank(sums + (f - F * owner / C) * 16, owner));
    float* v = x[i / 8][i % 8];
    v[0] = y.x, v[1] = y.y, v[2] = y.z, v[3] = y.w;
  }
}

struct Params {
  const void *q, *k, *v, *dout;  // (B, H, Lq, d), (B, KVH, Lk, d) x 2, (B, H, Lq, d)
  const int* kv_lengths;         // (B,) or null
  const float *lse, *delta;      // the backward's (B, H, Lq)
  void* o;                       // the forward's (B, H, Lq, d), or null for the partials alone
  float* lse_out;                // the forward's (B, H, Lq)
  float *o_part, *m_part, *l_part;  // the forward's split partials: (n_split, B * H, Lq, d), (n_split, B * H, Lq)
  void *dq, *dk, *dv;               // the backward's outputs, n_split == 1
  float *dq_part, *dk_part, *dv_part;  // (n_split, B * H, Lq, d), (n_split, B * KVH, Lk, d) x 2
  int B, H, KVH, Lq, Lk, d, n_split, causal;
  int passes;  // clusters per (block, split)
  float scale, bias;
};

// A clustered CTA's columns: its share of the contraction over d (chunks [cs, cs + nc)) and its output block
// ([os, os + nvc)), both from the cluster's rank and size and the grid's z = (split * passes + pass) * C + rank.
struct Shares {
  int C, rank, split, pass, ndc, cs, nc, os, nvc;
  __device__ __forceinline__ explicit Shares(const Params& p) {
    C = cluster_ctas(), rank = cluster_rank();
    const int zc = blockIdx.z / C, nb = p.passes * C, j = (zc % p.passes) * C + rank;
    split = zc / p.passes, pass = zc % p.passes;
    ndc = padded_dim(p.d) / CW;
    cs = ndc * rank / C, nc = ndc * (rank + 1) / C - cs;
    os = ndc * j / nb, nvc = ndc * (j + 1) / nb - os;
  }
};

// ------------------------------------------------------------------------------------------------------------
// The forward (K1, K2). grid (ceil(Lq / 64), B * H, n_split * passes * C), clusters of C along z. Shared memory:
// in bf16, Q's share (at most FWD_NCH chunks); the ring (a slot holds two chunks: two of K's share where Q's is
// resident, else Q's and K's at one chunk, or two of V's in the output block); the two exchange buffers of S.
// fp32 streams Q too, so that two CTAs fit an SM (102,400 B each).
constexpr int FWD_BQ = 64, FWD_GROUP = 128, FWD_BK = 64, FWD_NCH = 4;  // FWD_NCH: output chunks a CTA holds
template <typename T>
__host__ __device__ constexpr int fwd_resident() { return sizeof(T) == 2 ? FWD_NCH : 0; }  // Q's chunks
template <typename T>
__host__ __device__ constexpr int fwd_smem() {
  return (fwd_resident<T>() + 2 * 2) * Layout<T>::BYTES + 2 * XF * 4;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qres = reinterpret_cast<T*>(smem_raw);
  T* ring = qres + fwd_resident<T>() * CH;
  float* xbuf = reinterpret_cast<float*>(ring + 2 * 2 * CH);

  const Shares sh(p);
  const int bh = blockIdx.y, b = bh / p.H, kvh = (bh % p.H) / (p.H / p.KVH);
  const int q0 = blockIdx.x * FWD_BQ, g0 = q0 / FWD_GROUP * FWD_GROUP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + FWD_BK - 1) / FWD_BK;  // the tiles of the block's 128-row group, as flash_fwd.cu
  if (p.causal) {
    const int max_key = min(g0 + FWD_GROUP - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / FWD_BK + 1);
  }
  if (kv_limit == 0 || (p.causal && g0 + diag < 0)) n_tiles = (p.Lk + FWD_BK - 1) / FWD_BK;  // a row with no key
  const int t_begin = n_tiles * sh.split / p.n_split, t_end = n_tiles * (sh.split + 1) / p.n_split;

  // bf16 in one pass: the share is the output block, at most FWD_NCH chunks, and stays in shared memory
  const bool resident = fwd_resident<T>() > 0 && p.passes == 1;
  const int n_s = resident ? (sh.nc + 1) / 2 : sh.nc;  // S steps per key tile
  const int spt = n_s + (sh.nvc + 1) / 2;               // steps per key tile
  const T* qg = static_cast<const T*>(p.q) + (size_t)bh * p.Lq * p.d;
  const size_t kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;
  if (resident)  // with the ring's first group
    for (int c = 0; c < sh.nc; ++c) load_chunk(qres + c * CH, qg, q0, 64, p.Lq, (sh.cs + c) * CW, p.d);
  auto issue = [&](int s, T* slot) {
    const int k0 = (t_begin + s / spt) * FWD_BK, j = s % spt;
    if (j < n_s && resident) {
      load_chunk(slot, kg, k0, 64, p.Lk, (sh.cs + 2 * j) * CW, p.d);
      if (2 * j + 1 < sh.nc) load_chunk(slot + CH, kg, k0, 64, p.Lk, (sh.cs + 2 * j + 1) * CW, p.d);
    } else if (j < n_s) {
      load_chunk(slot, qg, q0, 64, p.Lq, (sh.cs + j) * CW, p.d);
      load_chunk(slot + CH, kg, k0, 64, p.Lk, (sh.cs + j) * CW, p.d);
    } else {
      const int c = 2 * (j - n_s);
      load_chunk(slot, vg, k0, 64, p.Lk, (sh.os + c) * CW, p.d);
      if (c + 1 < sh.nvc) load_chunk(slot + CH, vg, k0, 64, p.Lk, (sh.os + c + 1) * CW, p.d);
    }
  };
  Ring<T, 2, 2 * CH, decltype(issue)> ring_(ring, (t_end - t_begin) * spt, issue);

  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
  float acc[FWD_NCH][8][4];
#pragma unroll
  for (int c = 0; c < FWD_NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
  const float scale2 = p.scale * LOG2E, bias2 = p.bias * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    float s[8][4] = {};
    for (int j = 0; j < n_s; ++j) {  // the partial S = Q K^T over the share
      const T* slot = ring_.advance();
      if (resident) {
        s_product(s, qres + 2 * j * CH + warp * 16 * LD, slot);
        if (2 * j + 1 < sh.nc) s_product(s, qres + (2 * j + 1) * CH + warp * 16 * LD, slot + CH);
      } else {
        s_product(s, slot + warp * 16 * LD, slot + CH);
      }
      ring_.release();
    }
    if (sh.C > 1) cluster_sum<1, 0>(&s, xbuf, kt - t_begin, sh.C);
    // masks and the online softmax in the log2 domain (flash_fwd.cu's): rows row[0] (e = 0, 1), row[1] (e = 2, 3)
    const int k0 = kt * FWD_BK;
    const bool need_mask = k0 + FWD_BK > kv_limit || (p.causal && k0 + FWD_BK - 1 > q0 + diag);
    float alpha[2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2 + bias2;
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          const bool ok = key < kv_limit && (!p.causal || key <= row[e >> 1] + diag);
          x = key >= p.Lk ? -INFINITY : (ok ? x : NEG2);
        }
        s[nt][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_approx(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * r] = exp2_approx(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = exp2_approx(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = mx;
    }
#pragma unroll
    for (int c = 0; c < FWD_NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[c][nt][0] *= alpha[0];
        acc[c][nt][1] *= alpha[0];
        acc[c][nt][2] *= alpha[1];
        acc[c][nt][3] *= alpha[1];
      }
#pragma unroll
    for (int c = 0; c < FWD_NCH; c += 2) {  // O += P V over the output block's chunks, two a step
      if (c < sh.nvc) {
        const T* slot = ring_.advance();
        pv_product(acc[c], s, slot);
        if (c + 1 < sh.nvc) pv_product(acc[c + 1], s, slot + CH);
        ring_.release();
      }
    }
  }
  cp_async_wait<0>();

  const bool direct = p.n_split == 1 && p.o != nullptr;
  const size_t prow = ((size_t)sh.split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = direct ? 1.f / denom : 1.f;
#pragma unroll
    for (int c = 0; c < FWD_NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (sh.os + c) * CW + nt * 8 + 2 * t;
        if (c >= sh.nvc || col >= p.d) continue;
        const float x = acc[c][nt][2 * r] * inv, y = acc[c][nt][2 * r + 1] * inv;
        if (direct)
          put2(static_cast<T*>(p.o) + ((size_t)bh * p.Lq + row[r]) * p.d + col, x, y);
        else
          put2(p.o_part + (prow + row[r]) * p.d + col, x, y);
      }
    if (sh.rank != 0 || sh.pass != 0 || t != 0) continue;
    if (direct)
      p.lse_out[(size_t)bh * p.Lq + row[r]] = m[r] * LN2 + logf(denom);
    else {
      p.m_part[prow + row[r]] = t_end > t_begin ? m[r] * LN2 : -INFINITY;
      p.l_part[prow + row[r]] = l[r];
    }
  }
  if (sh.C > 1) cluster_sync();  // no CTA leaves while the others may still read its last partial
}

// ------------------------------------------------------------------------------------------------------------
// K5. grid (ceil(Lq / 64), B * H, n_split * passes * C), clusters of C along z. Per 32-key tile: the partial S = Q
// K^T and dP = dO V^T over the CTA's share of d, the cluster's sum of both (one 16 x 64 partial a warp: S's 32
// keys, then dP's), P and dS = P (dP - delta) in registers, then dQ += dS K over the CTA's output block. A slot
// holds two chunks: Q's (64 rows) and K's (32) at one chunk of the share (an S step), dO's and V's (a dP step), or
// the output block's chunks of K (32 rows each: the dQ step); beside the ring, the two exchange buffers.
constexpr int DQ_BQ = 64, DQ_BK = 32, DQ_NCH = 4;  // DQ_NCH: output chunks a CTA holds
template <typename T>
__host__ __device__ constexpr int dq_stages() { return sizeof(T) == 2 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr int dq_smem() { return dq_stages<T>() * 2 * Layout<T>::BYTES + 2 * XF * 4; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* xbuf = reinterpret_cast<float*>(ring + dq_stages<T>() * 2 * CH);

  const Shares sh(p);
  const int bh = blockIdx.y, b = bh / p.H, kvh = (bh % p.H) / (p.H / p.KVH);
  const int q0 = blockIdx.x * DQ_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;
  int n_tiles = (kv_limit + DQ_BK - 1) / DQ_BK;
  if (p.causal) {
    const int max_key = min(q0 + DQ_BQ - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / DQ_BK + 1);
  }
  const int t_begin = n_tiles * sh.split / p.n_split, t_end = n_tiles * (sh.split + 1) / p.n_split;

  const int spt = 2 * sh.nc + 1;  // steps per key tile: S and dP at each chunk of the share, then dQ
  const size_t qoff = (size_t)bh * p.Lq * p.d, kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  const T* qg = static_cast<const T*>(p.q) + qoff;
  const T* dog = static_cast<const T*>(p.dout) + qoff;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;
  auto issue = [&](int s, T* slot) {
    const int k0 = (t_begin + s / spt) * DQ_BK, j = s % spt;
    if (j < 2 * sh.nc) {
      const int c = (sh.cs + j / 2) * CW;
      load_chunk(slot, j % 2 == 0 ? qg : dog, q0, 64, p.Lq, c, p.d);
      load_chunk(slot + CH, j % 2 == 0 ? kg : vg, k0, DQ_BK, p.Lk, c, p.d);
    } else {
      for (int c = 0; c < sh.nvc; ++c) load_chunk(slot + c * DQ_BK * LD, kg, k0, DQ_BK, p.Lk, (sh.os + c) * CW, p.d);
    }
  };
  Ring<T, dq_stages<T>(), 2 * CH, decltype(issue)> ring_(ring, (t_end - t_begin) * spt, issue);

  // per row: the log2-domain offset (bias - lse) log2 e (-inf past Lq: p = 0) and delta
  float off[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Lq;
    off[r] = in ? (p.bias - p.lse[(size_t)bh * p.Lq + row[r]]) * LOG2E : -INFINITY;
    dl[r] = in ? p.delta[(size_t)bh * p.Lq + row[r]] : 0.f;
  }
  float acc[DQ_NCH][8][4];
#pragma unroll
  for (int c = 0; c < DQ_NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    float sd[8][4] = {};  // S (tiles 0-3: the key tile's 32 keys), then dP (4-7)
    for (int j = 0; j < sh.nc; ++j) {  // the partial S and dP over the share
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const T* slot = ring_.advance();
        s_product<4>(sd + 4 * x, slot + warp * 16 * LD, slot + CH);
        ring_.release();
      }
    }
    if (sh.C > 1) cluster_sum<1, 0>(&sd, xbuf, kt - t_begin, sh.C);
    // P = exp(S scale + bias - lse), masked; dS = P (dP - delta) in S's tiles, rounded to T by the dQ product
    const int k0 = kt * DQ_BK;
    const bool need_mask = k0 + DQ_BK > kv_limit || (p.causal && k0 + DQ_BK - 1 > q0 + diag);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2_approx(fmaf(sd[nt][e], scale2, off[e >> 1]));
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          const bool ok = key < kv_limit && (!p.causal || key <= row[e >> 1] + diag);
          pr = ok ? pr : 0.f;
        }
        sd[nt][e] = pr * (sd[nt + 4][e] - dl[e >> 1]);
      }
    const T* slot = ring_.advance();  // dQ += dS K over the output block: k over the tile's 32 keys
#pragma unroll
    for (int c = 0; c < DQ_NCH; ++c)
      if (c < sh.nvc) pv_product<DQ_BK>(acc[c], sd, slot + c * DQ_BK * LD);
    ring_.release();
  }
  cp_async_wait<0>();

  const size_t prow = ((size_t)sh.split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < DQ_NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (sh.os + c) * CW + nt * 8 + 2 * t;
        if (c >= sh.nvc || col >= p.d) continue;
        if (p.n_split == 1)
          put2(static_cast<T*>(p.dq) + ((size_t)bh * p.Lq + row[r]) * p.d + col, acc[c][nt][2 * r] * p.scale,
               acc[c][nt][2 * r + 1] * p.scale);
        else
          put2(p.dq_part + (prow + row[r]) * p.d + col, acc[c][nt][2 * r], acc[c][nt][2 * r + 1]);
      }
  }
  if (sh.C > 1) cluster_sync();  // no CTA leaves while the others may still read its last partial
}

// ------------------------------------------------------------------------------------------------------------
// K6. grid (ceil(Lk / 64), B * KVH, n_split * passes * C), clusters of C along z. A slot holds two chunks: K's
// and Q's (an S^T step) or V's and dO's (a dP^T step) at one chunk of the share, or Q's and dO's at one chunk of
// the output block (a dK / dV step); beside the ring, the two exchange buffers (S^T and dP^T partials) and each
// unit's lse and delta (two slots). bf16 fits two CTAs an SM (103,424 B).
constexpr int DKV_BK = 64, DKV_BQ = 64, DKV_NCH = 2;  // DKV_NCH: output chunks of dK and of dV
template <typename T>
__host__ __device__ constexpr int dkv_stages() { return sizeof(T) == 2 ? 2 : 3; }
template <typename T>
__host__ __device__ constexpr int dkv_smem() {
  return dkv_stages<T>() * 2 * Layout<T>::BYTES + 2 * 2 * XF * 4 + 2 * 2 * DKV_BQ * 4;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* xbuf = reinterpret_cast<float*>(ring + dkv_stages<T>() * 2 * CH);
  float* stats = xbuf + 2 * 2 * XF;  // unit i's lse (64 floats) then delta (64) at (i % 2) * 128

  const Shares sh(p);
  const int bkv = blockIdx.y, b = bkv / p.KVH, G = p.H / p.KVH;
  const int k0 = blockIdx.x * DKV_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;
  // the units of flash_bwd.cu's K6 (ops/flash_attention.py dkv_unit_range)
  const int qt_begin = p.causal ? max(0, k0 - diag) / DKV_BQ : 0;
  const int nq = k0 < kv_limit ? max(0, (p.Lq + DKV_BQ - 1) / DKV_BQ - qt_begin) : 0;
  const int u_begin = G * nq * sh.split / p.n_split;
  const int n = G * nq * (sh.split + 1) / p.n_split - u_begin;

  const int spt = 2 * sh.nc + sh.nvc;
  const size_t kv_off = (size_t)bkv * p.Lk * p.d;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;
  auto unit_head = [&](int i) { return b * p.H + (bkv % p.KVH) * G + (u_begin + i) / nq; };
  auto unit_q0 = [&](int i) { return (qt_begin + (u_begin + i) % nq) * DKV_BQ; };
  auto issue = [&](int s, T* slot) {
    const int i = s / spt, j = s % spt, hd = unit_head(i), qq0 = unit_q0(i);
    const T* qg = static_cast<const T*>(p.q) + (size_t)hd * p.Lq * p.d;
    const T* dog = static_cast<const T*>(p.dout) + (size_t)hd * p.Lq * p.d;
    if (j == 0) {  // the unit's lse (first 64 threads) and delta (the others); rows past Lq are not read
      const int x = threadIdx.x % DKV_BQ, q = qq0 + x;
      const float* src = (threadIdx.x < DKV_BQ ? p.lse : p.delta) + (size_t)hd * p.Lq + (q < p.Lq ? q : 0);
      cp_async4(smem_u32(stats + (i % 2) * 2 * DKV_BQ + threadIdx.x), src, q < p.Lq);
    }
    if (j < 2 * sh.nc) {
      const int c = (sh.cs + j / 2) * CW;
      load_chunk(slot, j % 2 == 0 ? kg : vg, k0, 64, p.Lk, c, p.d);
      load_chunk(slot + CH, j % 2 == 0 ? qg : dog, qq0, 64, p.Lq, c, p.d);
    } else {
      const int c = (sh.os + j - 2 * sh.nc) * CW;
      load_chunk(slot, qg, qq0, 64, p.Lq, c, p.d);
      load_chunk(slot + CH, dog, qq0, 64, p.Lq, c, p.d);
    }
  };
  Ring<T, dkv_stages<T>(), 2 * CH, decltype(issue)> ring_(ring, n * spt, issue);

  float dk[DKV_NCH][8][4], dv[DKV_NCH][8][4];
#pragma unroll
  for (int c = 0; c < DKV_NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][nt][e] = dv[c][nt][e] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    float sd[2][8][4] = {};  // S^T, then P^T; dP^T, then dS^T: rows the block's keys, columns the unit's queries
    for (int j = 0; j < sh.nc; ++j) {  // the partial S^T = K Q^T and dP^T = V dO^T over the share
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const T* slot = ring_.advance();
        s_product(sd[x], slot + warp * 16 * LD, slot + CH);
        ring_.release();
      }
    }
    if (sh.C > 1) cluster_sum<2, sizeof(T) == 2 ? 3 : 5>(sd, xbuf, i, sh.C);
    // P^T = exp(S^T scale + bias - lse), masked, and dS^T = P^T (dP^T - delta)
    const int qq0 = unit_q0(i);
    const float* lse = stats + (i % 2) * 2 * DKV_BQ;
    const bool need_mask = k0 + DKV_BK > kv_limit || (p.causal && k0 + DKV_BK - 1 > qq0 + diag);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1), q = qq0 + col;
        float pr = q < p.Lq ? exp2_approx(sd[0][nt][e] * scale2 + (p.bias - lse[col]) * LOG2E) : 0.f;
        if (need_mask) {
          const int kk = key[e >> 1];
          const bool ok = kk < kv_limit && (!p.causal || kk <= q + diag);
          pr = ok ? pr : 0.f;
        }
        sd[0][nt][e] = pr;
        sd[1][nt][e] = pr * (sd[1][nt][e] - (q < p.Lq ? lse[DKV_BQ + col] : 0.f));
      }
    }
#pragma unroll
    for (int c = 0; c < DKV_NCH; ++c)  // dV += P^T dO and dK += dS^T Q over the output block: k over the queries
      if (c < sh.nvc) {
        const T* slot = ring_.advance();
        pv_product(dv[c], sd[0], slot + CH);
        pv_product(dk[c], sd[1], slot);
        ring_.release();
      }
  }
  cp_async_wait<0>();

  const bool direct = p.n_split == 1;
  const size_t first = (direct ? 0 : (size_t)sh.split * gridDim.y * p.Lk) + (size_t)bkv * p.Lk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Lk) continue;
#pragma unroll
    for (int c = 0; c < DKV_NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (sh.os + c) * CW + nt * 8 + 2 * t;
        if (c >= sh.nvc || col >= p.d) continue;
        const size_t at = (first + key[r]) * p.d + col;
        if (direct) {
          put2(static_cast<T*>(p.dk) + at, dk[c][nt][2 * r] * p.scale, dk[c][nt][2 * r + 1] * p.scale);
          put2(static_cast<T*>(p.dv) + at, dv[c][nt][2 * r], dv[c][nt][2 * r + 1]);
        } else {
          put2(p.dk_part + at, dk[c][nt][2 * r], dk[c][nt][2 * r + 1]);
          put2(p.dv_part + at, dv[c][nt][2 * r], dv[c][nt][2 * r + 1]);
        }
      }
  }
  if (sh.C > 1) cluster_sync();  // no CTA leaves while the others may still read its last partials
}

// ------------------------------------------------------------------------------------------------------------
// Launches: each returns a CUDA error code (0 when every launch was accepted).
inline int blocks_of(int d, int dc) { return (padded_dim(d) + dc - 1) / dc; }

// The largest cluster the kernels launch (8, the portable size: past it a launch needs
// cudaFuncAttributeNonPortableClusterSizeAllowed, which these launches do not set). Tests lower it to take the
// passes at small widths, or raise it to see a refused cluster raise.
int max_cluster = 8;

// (CTAs in a cluster, passes) for nch output chunks a CTA: blocks of nch chunks, in passes of at most
// max_cluster CTAs, the CTAs of a pass balanced
struct Clusters {
  int size, passes;
};
inline Clusters clusters_of(int d, int nch) {
  const int blocks = (padded_dim(d) / CW + nch - 1) / nch, passes = (blocks + max_cluster - 1) / max_cluster;
  return {(blocks + passes - 1) / passes, passes};
}

// A launch in clusters of `cluster` CTAs along z, refused (an error, no launch) when the card cannot hold one
// such cluster (cudaOccupancyMaxActiveClusters, asked once per kernel and cluster size that it accepts).
template <typename K>
cudaError_t start_cluster(K kernel, dim3 grid, int cluster, int smem, const Params& p, cudaStream_t stream,
                          unsigned long long& accepted) {  // bit c: the kernel's clusters of c CTAs fit the card
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster < 1 || cluster > 63) return cudaErrorInvalidValue;
  if (!(accepted >> cluster & 1)) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    accepted |= 1ull << cluster;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad(const Params& p) {
  return p.d % 8 != 0 || p.d <= 256 || p.KVH <= 0 || p.H % p.KVH != 0 || p.B <= 0 || p.Lq <= 0 || p.Lk <= 0 ||
         p.n_split < 1 || (size_t)p.n_split * blocks_of(p.d, CW) > 65535 ||
         (reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) | reinterpret_cast<uintptr_t>(p.v)) %
                 16 != 0;
}

template <typename T>
int forward(const void* q, const void* k, const void* v, const int* kv_lengths, void* o, float* lse, float* o_part,
            float* m_part, float* l_part, int B, int H, int KVH, int Lq, int Lk, int d, int n_split, float scale,
            float bias, int causal, void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.kv_lengths = kv_lengths, p.o = o, p.lse_out = lse;
  p.o_part = o_part, p.m_part = m_part, p.l_part = l_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split, p.causal = causal != 0;
  p.scale = scale, p.bias = bias;
  if (bad(p) || ((n_split > 1 || o == nullptr) && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  static unsigned long long accepted = 0;
  const Clusters cl = clusters_of(d, FWD_NCH);
  p.passes = cl.passes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start_cluster(fwd_kernel<T>, dim3((Lq + FWD_BQ - 1) / FWD_BQ, B * H, n_split * cl.passes * cl.size),
                                  cl.size, fwd_smem<T>(), p, s, accepted);
  if (err != cudaSuccess || n_split == 1 || o == nullptr) return (int)err;
  return (int)merge<T>(o_part, m_part, l_part, static_cast<T*>(o), lse, n_split, B * H * Lq, d, s);
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, const int* kv_lengths, const void* dout,
                const float* lse, const float* delta, void* dq, float* dq_part, int B, int H, int KVH, int Lq, int Lk,
                int d, int n_split, float scale, float bias, int causal, void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.kv_lengths = kv_lengths, p.lse = lse, p.delta = delta;
  p.dq = dq, p.dq_part = dq_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split, p.causal = causal != 0;
  p.scale = scale, p.bias = bias;
  if (bad(p) || dq == nullptr || reinterpret_cast<uintptr_t>(dout) % 16 != 0 || (n_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  static unsigned long long accepted = 0;
  const Clusters cl = clusters_of(d, DQ_NCH);
  p.passes = cl.passes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start_cluster(dq_kernel<T>, dim3((Lq + DQ_BQ - 1) / DQ_BQ, B * H, n_split * cl.passes * cl.size),
                                  cl.size, dq_smem<T>(), p, s, accepted);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return (int)part_sum(PartSum<T>{{dq_part, nullptr}, {static_cast<T*>(dq), nullptr}, {scale, 0.f}}, 1, n_split,
                       (size_t)B * H * Lq * d, s);
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v, const int* kv_lengths, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, float* dk_part, float* dv_part, int B,
                 int H, int KVH, int Lq, int Lk, int d, int n_split, float scale, float bias, int causal,
                 void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.kv_lengths = kv_lengths, p.lse = lse, p.delta = delta;
  p.dk = dk, p.dv = dv, p.dk_part = dk_part, p.dv_part = dv_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split, p.causal = causal != 0;
  p.scale = scale, p.bias = bias;
  if (bad(p) || dk == nullptr || dv == nullptr || reinterpret_cast<uintptr_t>(dout) % 16 != 0 ||
      (n_split > 1 && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  static unsigned long long accepted = 0;
  const Clusters cl = clusters_of(d, DKV_NCH);
  p.passes = cl.passes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start_cluster(dkv_kernel<T>,
                                  dim3((Lk + DKV_BK - 1) / DKV_BK, B * KVH, n_split * cl.passes * cl.size), cl.size,
                                  dkv_smem<T>(), p, s, accepted);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return (int)part_sum(PartSum<T>{{dk_part, dv_part}, {static_cast<T*>(dk), static_cast<T*>(dv)}, {scale, 1.f}}, 2,
                       n_split, (size_t)B * KVH * Lk * d, s);
}

}  // namespace wide
}  // namespace
