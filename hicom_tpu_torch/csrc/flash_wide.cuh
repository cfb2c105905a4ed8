// Flash attention past head dim 256 for Hopper (sm_90a): the forward (K1, K2) and the backward (K5, K6) of
// csrc/flash_fwd.cu and csrc/flash_bwd.cu (bf16) and their fp32 instances (flash_fwd_f32.cu,
// flash_bwd_f32.cu), for every head dim d % 8 == 0 past 256, with d a runtime argument and no upper limit.
// flash_wide.cu instantiates these templates in bf16 (products on the tensor cores, mma.sync m16n8k16),
// flash_wide_f32.cu in fp32 (FFMA, no operand below fp32).
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
// The design, one for every width past 256:
//   * Column blocks. The output's columns are cut into blocks of DC (256 for the forward and K5, whose one
//     accumulator is 16 x DC fp32 a warp: 128 registers a thread; 128 for K6, which holds dK and dV) on a grid
//     axis (z = column block * n_split + split), so an accumulator never outgrows the registers whatever d is.
//   * S = Q K^T (and dP = dO V^T in the backward) is recomputed in every column block, accumulated over the
//     whole d in chunks of 64 columns that stream through shared memory; Q is not resident (it does not fit
//     beside the ring past 256). Every column block computes the same S in the same order, so m, l and the
//     lse are the same in each and are written by block 0 alone. At d 512 the forward does 1.5 times the
//     flops of one pass (S twice, P V once), K5 1.67 times, K6 2.5 times (S^T and dP^T in 4 blocks).
//   * A block is 4 warps of 16 rows (query rows for the forward and K5, keys for K6), with the mma.sync
//     accumulator layout (a thread holds rows g and g + 8, columns 2t and 2t + 1 of each 8-column tile) in both
//     types, so the masks, the online softmax and the epilogues are one code. Its inputs stream as chunks of 64
//     columns (rows of 64 + 16 / sizeof(T) elements in shared memory: 144 or 272 bytes, so 8 consecutive rows'
//     16-byte reads fall in distinct banks) through a ring of slots filled by cp.async (zeros past d and past
//     the rows' extent), one step of a fixed schedule per slot, the next steps' copies in flight while one is
//     computed. P (K6: P^T and dS^T; K5: dS) is rounded to the operand type and goes through the warp's own
//     16 rows of shared memory to its next product, so both products read their operands from shared memory.
//   * bf16: ldmatrix fragments and mma.sync m16n8k16 with fp32 accumulators (A row-major, B from rows of
//     [n][k] with ldmatrix or [k][n] with ldmatrix.trans). fp32: the same warp tiles as FFMA, each thread
//     reading its rows g, g + 8 and its columns 2t, 2t + 1 from shared memory (16-byte reads along k).
//   * Tiles as the kernels up to 256 walk them, so the split twins hold: the forward walks 64-key tiles over
//     its 128-row group (blocks of 64 rows, as flash_fwd_f32.cu), K5 32-key tiles from 64-row blocks (the same
//     walk as dq_block_q's 32 rows at Lq <= 32), K6 64-key blocks over (query head, 64-row query tile) units.
//   * One instance per kernel and type: d, causal and kv_lengths are runtime arguments; the column block's
//     chunks past the padded d (hopper.cuh padded_dim: past 128, a multiple of 64) are neither loaded nor
//     multiplied.
//
// What bounds them on the H100 (bf16 989 TFLOP/s on the tensor cores, fp32 67 TFLOP/s FFMA, 3.35 TB/s):
// operations at every shape the main paths give (the [hd512] prefill, K1 over the d-288 tower), as for the
// kernels up to 256. This first design pays for the recomputation above and gives up wgmma and TMA (mma.sync
// reaches a part of the tensor cores' rate). Shared memory: forward 82,944 B (bf16, 4 slots) / 87,040 (fp32,
// 2), K5 92,160 / 121,856 (3 / 2 slots), K6 93,184 / 175,104 (2 slots); ptxas gives the bf16 kernels 250-255
// registers with no spill, the fp32 ones 255 with 24-84 bytes of spill. PERF.md has their times beside the
// bound.
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

// The warp's products. acc[nt] is this thread's part of an 8-column tile of a 16-row accumulator (rows g and
// g + 8, columns 2t and 2t + 1; c[0], c[1] on row g). a: the warp's 16 rows of A ([m][k], LD apart).
//   mma_nt: acc (16 x 8 NT) += A (16 x KK) B^T, B's 8 NT rows at b ([n][k]);
//   mma_nn: acc (16 x 8 NT) += A (16 x KK) B, B's KK rows at b ([k][n]).
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

template <int NT, int KK>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const bf16* a, const bf16* b) {
  constexpr int LD = Layout<bf16>::LD;
  const int lane = threadIdx.x % 32;
  // ldmatrix.trans lanes: B rows (k) 8 (lane / 8 % 2) + lane % 8, columns (lane / 16) * 8 of an n-tile pair
  const uint32_t a0 = smem_u32(a) + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const uint32_t b0 = smem_u32(b) + ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kc = 0; kc < KK / 16; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, a0 + kc * 32);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b0 + (kc * 16 * LD + nt * 8) * 2);
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

template <int NT, int KK>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const float* a, const float* b) {
  constexpr int LD = Layout<float>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * LD;
  const float* b0 = b + 2 * t * LD;
#pragma unroll 2
  for (int k = 0; k < KK; k += 4) {
    const float4 x0 = ld4(a0 + k), x1 = ld4(a0 + 8 * LD + k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 y0 = ld4(b0 + nt * 8 * LD + k), y1 = ld4(b0 + (nt * 8 + 1) * LD + k);
      acc[nt][0] = dot4(x0, y0, acc[nt][0]);
      acc[nt][1] = dot4(x0, y1, acc[nt][1]);
      acc[nt][2] = dot4(x1, y0, acc[nt][2]);
      acc[nt][3] = dot4(x1, y1, acc[nt][3]);
    }
  }
}

template <int NT, int KK>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const float* a, const float* b) {
  constexpr int LD = Layout<float>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * LD;
  const float* b0 = b + 2 * t;
#pragma unroll 2
  for (int k = 0; k < KK; k += 4) {
    const float4 x0 = ld4(a0 + k), x1 = ld4(a0 + 8 * LD + k);
    const float u0[4] = {x0.x, x0.y, x0.z, x0.w}, u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 y = *reinterpret_cast<const float2*>(b0 + (k + kk) * LD + nt * 8);
        acc[nt][0] = fmaf(u0[kk], y.x, acc[nt][0]);
        acc[nt][1] = fmaf(u0[kk], y.y, acc[nt][1]);
        acc[nt][2] = fmaf(u1[kk], y.x, acc[nt][2]);
        acc[nt][3] = fmaf(u1[kk], y.y, acc[nt][3]);
      }
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
  float scale, bias;
};

// ------------------------------------------------------------------------------------------------------------
// The forward (K1, K2). grid (ceil(Lq / 64), B * H, n_split * ceil(DP / 256)); a slot holds two chunks: Q and K
// over 64 columns of d (S steps), or two 64-column chunks of V in the column block (P V steps); then P.
constexpr int FWD_BQ = 64, FWD_GROUP = 128, FWD_BK = 64, FWD_DC = 256;
template <typename T>
__host__ __device__ constexpr int fwd_stages() { return sizeof(T) == 2 ? 4 : 2; }
template <typename T>
__host__ __device__ constexpr int fwd_smem() { return (fwd_stages<T>() * 2 + 1) * Layout<T>::BYTES; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH, NCH = FWD_DC / CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* pw = ring + fwd_stages<T>() * 2 * CH + (threadIdx.x / 32) * 16 * LD;  // this warp's 16 rows of P

  const int split = blockIdx.z % p.n_split, cb = blockIdx.z / p.n_split;
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
  const int t_begin = n_tiles * split / p.n_split, t_end = n_tiles * (split + 1) / p.n_split;

  const int ndc = padded_dim(p.d) / CW;               // chunks of d in S
  const int c_first = cb * NCH;                       // the column block's first chunk
  const int nvc = min(NCH, ndc - c_first);            // its chunks below the padded d
  const int spt = ndc + (nvc + 1) / 2;                // steps per key tile
  const T* qg = static_cast<const T*>(p.q) + (size_t)bh * p.Lq * p.d;
  const size_t kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;
  auto issue = [&](int s, T* slot) {
    const int k0 = (t_begin + s / spt) * FWD_BK, j = s % spt;
    if (j < ndc) {
      load_chunk(slot, qg, q0, 64, p.Lq, j * CW, p.d);
      load_chunk(slot + CH, kg, k0, 64, p.Lk, j * CW, p.d);
    } else {
      const int c = 2 * (j - ndc);
      load_chunk(slot, vg, k0, 64, p.Lk, (c_first + c) * CW, p.d);
      if (c + 1 < nvc) load_chunk(slot + CH, vg, k0, 64, p.Lk, (c_first + c + 1) * CW, p.d);
    }
  };
  Ring<T, fwd_stages<T>(), 2 * CH, decltype(issue)> ring_(ring, (t_end - t_begin) * spt, issue);

  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
  float acc[NCH][8][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
  const float scale2 = p.scale * LOG2E, bias2 = p.bias * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int j = 0; j < ndc; ++j) {  // S = Q K^T over d
      const T* slot = ring_.advance();
      mma_nt<8, CW>(s, slot + warp * 16 * LD, slot + CH);
      ring_.release();
    }
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
    // P in T (bf16: rounded, as the plain twin rounds it to v's dtype) to the warp's rows
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      put2(pw + g * LD + nt * 8 + 2 * t, s[nt][0], s[nt][1]);
      put2(pw + (g + 8) * LD + nt * 8 + 2 * t, s[nt][2], s[nt][3]);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[c][nt][0] *= alpha[0];
        acc[c][nt][1] *= alpha[0];
        acc[c][nt][2] *= alpha[1];
        acc[c][nt][3] *= alpha[1];
      }
#pragma unroll
    for (int c = 0; c < NCH; c += 2) {  // O += P V over the column block's chunks, two a step
      if (c < nvc) {
        const T* slot = ring_.advance();
        mma_nn<8, FWD_BK>(acc[c], pw, slot);
        if (c + 1 < nvc) mma_nn<8, FWD_BK>(acc[c + 1], pw, slot + CH);
        ring_.release();
      }
    }
  }
  cp_async_wait<0>();

  const bool direct = p.n_split == 1 && p.o != nullptr;
  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = direct ? 1.f / denom : 1.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (c_first + c) * CW + nt * 8 + 2 * t;
        if (col >= p.d) continue;
        const float x = acc[c][nt][2 * r] * inv, y = acc[c][nt][2 * r + 1] * inv;
        if (direct)
          put2(static_cast<T*>(p.o) + ((size_t)bh * p.Lq + row[r]) * p.d + col, x, y);
        else
          put2(p.o_part + (prow + row[r]) * p.d + col, x, y);
      }
    if (cb != 0 || t != 0) continue;
    if (direct)
      p.lse_out[(size_t)bh * p.Lq + row[r]] = m[r] * LN2 + logf(denom);
    else {
      p.m_part[prow + row[r]] = t_end > t_begin ? m[r] * LN2 : -INFINITY;
      p.l_part[prow + row[r]] = l[r];
    }
  }
}

// ------------------------------------------------------------------------------------------------------------
// K5. grid (ceil(Lq / 64), B * H, n_split * ceil(DP / 256)); a slot holds Q and dO (64 rows each) and K and V
// (32 rows each) over 64 columns of d (S and dP steps), or four 32-row chunks of K in the column block (the
// dQ step); then dS.
constexpr int DQ_BQ = 64, DQ_BK = 32, DQ_DC = 256;
template <typename T>
__host__ __device__ constexpr int dq_stages() { return sizeof(T) == 2 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr int dq_smem() { return (dq_stages<T>() * 3 + 1) * Layout<T>::BYTES; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH, NCH = DQ_DC / CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* dsw = ring + dq_stages<T>() * 3 * CH + (threadIdx.x / 32) * 16 * LD;  // this warp's 16 rows of dS

  const int split = blockIdx.z % p.n_split, cb = blockIdx.z / p.n_split;
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
  const int t_begin = n_tiles * split / p.n_split, t_end = n_tiles * (split + 1) / p.n_split;

  const int ndc = padded_dim(p.d) / CW, c_first = cb * NCH, nvc = min(NCH, ndc - c_first);
  const int spt = ndc + 1;
  const size_t qoff = (size_t)bh * p.Lq * p.d, kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  const T* qg = static_cast<const T*>(p.q) + qoff;
  const T* dog = static_cast<const T*>(p.dout) + qoff;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;
  auto issue = [&](int s, T* slot) {
    const int k0 = (t_begin + s / spt) * DQ_BK, j = s % spt;
    if (j < ndc) {
      load_chunk(slot, qg, q0, 64, p.Lq, j * CW, p.d);
      load_chunk(slot + CH, dog, q0, 64, p.Lq, j * CW, p.d);
      load_chunk(slot + 2 * CH, kg, k0, DQ_BK, p.Lk, j * CW, p.d);
      load_chunk(slot + 2 * CH + DQ_BK * LD, vg, k0, DQ_BK, p.Lk, j * CW, p.d);
    } else {
      for (int c = 0; c < nvc; ++c) load_chunk(slot + c * DQ_BK * LD, kg, k0, DQ_BK, p.Lk, (c_first + c) * CW, p.d);
    }
  };
  Ring<T, dq_stages<T>(), 3 * CH, decltype(issue)> ring_(ring, (t_end - t_begin) * spt, issue);

  // per row: the log2-domain offset (bias - lse) log2 e (-inf past Lq: p = 0) and delta
  float off[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Lq;
    off[r] = in ? (p.bias - p.lse[(size_t)bh * p.Lq + row[r]]) * LOG2E : -INFINITY;
    dl[r] = in ? p.delta[(size_t)bh * p.Lq + row[r]] : 0.f;
  }
  float acc[NCH][8][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int j = 0; j < ndc; ++j) {  // S = Q K^T and dP = dO V^T over d
      const T* slot = ring_.advance();
      mma_nt<4, CW>(s, slot + warp * 16 * LD, slot + 2 * CH);
      mma_nt<4, CW>(dp, slot + CH + warp * 16 * LD, slot + 2 * CH + DQ_BK * LD);
      ring_.release();
    }
    // P = exp(S scale + bias - lse), masked; dS = P (dP - delta) in T to the warp's rows
    const int k0 = kt * DQ_BK;
    const bool need_mask = k0 + DQ_BK > kv_limit || (p.causal && k0 + DQ_BK - 1 > q0 + diag);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2_approx(fmaf(s[nt][e], scale2, off[e >> 1]));
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          const bool ok = key < kv_limit && (!p.causal || key <= row[e >> 1] + diag);
          pr = ok ? pr : 0.f;
        }
        s[nt][e] = pr * (dp[nt][e] - dl[e >> 1]);
      }
      put2(dsw + g * LD + nt * 8 + 2 * t, s[nt][0], s[nt][1]);
      put2(dsw + (g + 8) * LD + nt * 8 + 2 * t, s[nt][2], s[nt][3]);
    }
    __syncwarp();
    const T* slot = ring_.advance();  // dQ += dS K over the column block: k over the tile's 32 keys
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c < nvc) mma_nn<8, DQ_BK>(acc[c], dsw, slot + c * DQ_BK * LD);
    ring_.release();
  }
  cp_async_wait<0>();

  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (c_first + c) * CW + nt * 8 + 2 * t;
        if (col >= p.d) continue;
        if (p.n_split == 1)
          put2(static_cast<T*>(p.dq) + ((size_t)bh * p.Lq + row[r]) * p.d + col, acc[c][nt][2 * r] * p.scale,
               acc[c][nt][2 * r + 1] * p.scale);
        else
          put2(p.dq_part + (prow + row[r]) * p.d + col, acc[c][nt][2 * r], acc[c][nt][2 * r + 1]);
      }
  }
}

// ------------------------------------------------------------------------------------------------------------
// K6. grid (ceil(Lk / 64), B * KVH, n_split * ceil(DP / 128)); a slot holds K, V, Q and dO over 64 columns of d
// (S^T and dP^T steps), or Q and dO's chunks in the column block (the dK / dV step); beside the ring, each
// unit's lse and delta (two slots) and P^T and dS^T.
constexpr int DKV_BK = 64, DKV_BQ = 64, DKV_DC = 128, DKV_STAGES = 2;
template <typename T>
__host__ __device__ constexpr int dkv_smem() { return (DKV_STAGES * 4 + 2) * Layout<T>::BYTES + 2 * 2 * DKV_BQ * 4; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(const Params p) {
  constexpr int LD = Layout<T>::LD, CH = Layout<T>::CH, NCH = DKV_DC / CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* ptw = ring + DKV_STAGES * 4 * CH + (threadIdx.x / 32) * 16 * LD;  // this warp's 16 key rows of P^T
  T* dsw = ptw + CH;                                                   // ... and of dS^T
  // unit i's lse (64 floats) then delta (64) at (i % 2) * 128
  float* stats = reinterpret_cast<float*>(ring + (DKV_STAGES * 4 + 2) * CH);

  const int split = blockIdx.z % p.n_split, cb = blockIdx.z / p.n_split;
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
  const int u_begin = G * nq * split / p.n_split;
  const int n = G * nq * (split + 1) / p.n_split - u_begin;

  const int ndc = padded_dim(p.d) / CW, c_first = cb * NCH, nvc = min(NCH, ndc - c_first);
  const int spt = ndc + 1;
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
    if (j < ndc) {
      load_chunk(slot, kg, k0, 64, p.Lk, j * CW, p.d);
      load_chunk(slot + CH, vg, k0, 64, p.Lk, j * CW, p.d);
      load_chunk(slot + 2 * CH, qg, qq0, 64, p.Lq, j * CW, p.d);
      load_chunk(slot + 3 * CH, dog, qq0, 64, p.Lq, j * CW, p.d);
    } else {
      for (int c = 0; c < nvc; ++c) {
        load_chunk(slot + c * CH, qg, qq0, 64, p.Lq, (c_first + c) * CW, p.d);
        load_chunk(slot + (2 + c) * CH, dog, qq0, 64, p.Lq, (c_first + c) * CW, p.d);
      }
    }
  };
  Ring<T, DKV_STAGES, 4 * CH, decltype(issue)> ring_(ring, n * spt, issue);

  float dk[NCH][8][4], dv[NCH][8][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][nt][e] = dv[c][nt][e] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int j = 0; j < ndc; ++j) {  // S^T = K Q^T and dP^T = V dO^T over d: rows the block's keys
      const T* slot = ring_.advance();
      mma_nt<8, CW>(s, slot + warp * 16 * LD, slot + 2 * CH);
      mma_nt<8, CW>(dp, slot + CH + warp * 16 * LD, slot + 3 * CH);
      ring_.release();
    }
    // P^T = exp(S^T scale + bias - lse), masked, and dS^T = P^T (dP^T - delta), each in T to the warp's rows
    const int qq0 = unit_q0(i);
    const float* lse = stats + (i % 2) * 2 * DKV_BQ;
    const bool need_mask = k0 + DKV_BK > kv_limit || (p.causal && k0 + DKV_BK - 1 > qq0 + diag);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1), q = qq0 + col;
        float pr = q < p.Lq ? exp2_approx(s[nt][e] * scale2 + (p.bias - lse[col]) * LOG2E) : 0.f;
        if (need_mask) {
          const int kk = key[e >> 1];
          const bool ok = kk < kv_limit && (!p.causal || kk <= q + diag);
          pr = ok ? pr : 0.f;
        }
        s[nt][e] = pr;
        dp[nt][e] = pr * (dp[nt][e] - (q < p.Lq ? lse[DKV_BQ + col] : 0.f));
      }
      put2(ptw + g * LD + nt * 8 + 2 * t, s[nt][0], s[nt][1]);
      put2(ptw + (g + 8) * LD + nt * 8 + 2 * t, s[nt][2], s[nt][3]);
      put2(dsw + g * LD + nt * 8 + 2 * t, dp[nt][0], dp[nt][1]);
      put2(dsw + (g + 8) * LD + nt * 8 + 2 * t, dp[nt][2], dp[nt][3]);
    }
    __syncwarp();
    const T* slot = ring_.advance();  // dV += P^T dO and dK += dS^T Q over the column block: k over the queries
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c < nvc) {
        mma_nn<8, DKV_BQ>(dv[c], ptw, slot + (2 + c) * CH);
        mma_nn<8, DKV_BQ>(dk[c], dsw, slot + c * CH);
      }
    ring_.release();
  }
  cp_async_wait<0>();

  const bool direct = p.n_split == 1;
  const size_t first = (direct ? 0 : (size_t)split * gridDim.y * p.Lk) + (size_t)bkv * p.Lk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Lk) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (c_first + c) * CW + nt * 8 + 2 * t;
        if (col >= p.d) continue;
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
}

// ------------------------------------------------------------------------------------------------------------
// Launches: each returns a CUDA error code (0 when every launch was accepted).
inline int blocks_of(int d, int dc) { return (padded_dim(d) + dc - 1) / dc; }

template <typename K>
cudaError_t start(K kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad(const Params& p) {
  return p.d % 8 != 0 || p.d <= 256 || p.KVH <= 0 || p.H % p.KVH != 0 || p.B <= 0 || p.Lq <= 0 || p.Lk <= 0 ||
         p.n_split < 1 || (size_t)p.n_split * blocks_of(p.d, 128) > 65535 ||
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start(fwd_kernel<T>, dim3((Lq + FWD_BQ - 1) / FWD_BQ, B * H, n_split * blocks_of(d, FWD_DC)),
                          fwd_smem<T>(), p, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start(dq_kernel<T>, dim3((Lq + DQ_BQ - 1) / DQ_BQ, B * H, n_split * blocks_of(d, DQ_DC)),
                          dq_smem<T>(), p, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = start(dkv_kernel<T>, dim3((Lk + DKV_BK - 1) / DKV_BK, B * KVH, n_split * blocks_of(d, DKV_DC)),
                          dkv_smem<T>(), p, s);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return (int)part_sum(PartSum<T>{{dk_part, dv_part}, {static_cast<T*>(dk), static_cast<T*>(dv)}, {scale, 1.f}}, 2,
                       n_split, (size_t)B * KVH * Lk * d, s);
}

}  // namespace wide
}  // namespace
