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
// global compressor's 32 queries over 23,328 keys, bytes (K and V read: 215 MB at b = 2, 64 us; the
// dQ products there are 10 GFLOP, 10 us at the bf16 peak). S, P, dP and dS live only in registers,
// so no Lq x Lk matrix ever reaches device memory. Both kernels issue mma.sync m16n8k16 bf16 tiles
// with fp32 accumulation; the warpgroup MMA of the forward (csrc/flash_fwd.cu) is left for a
// redesign of K6, whose products dominate the backward at the decoder shape.
//
// Design against the TPU original:
//   * K5: one block = BQ query rows of one (batch, q head), 16 per warp: BQ = 32 (2 warps) when
//     Lq <= 32, as at the global compressor, so no half-empty 64-row tile is paid for, else 64.
//     Q and dO stay in registers as mma A fragments. K and V stream in 32-key tiles through a
//     4-stage cp.async ring in dynamic shared memory (rows padded by 16 bytes), so three tiles are
//     in flight while one is computed, and the B fragments are read with ldmatrix (S = Q K^T and
//     dP = dO V^T) and ldmatrix.trans (dQ += dS K). The block walks the key tiles up to the causal
//     diagonal and the row's kv_lengths limit (the TPU grid's sequential kv axis).
//   * K5 split-KV: when ceil(Lq / BQ) * B * H blocks cannot fill the card, the wrapper picks
//     n_split chunks of those key tiles (grid z; ops/flash_attention.py dq_splits: 14 at the
//     global compressor's b 2, 252 blocks instead of 18). Each block writes its chunk's fp32 dQ sum
//     to a workspace of n_split x B * H * Lq * d floats, and dq_sum_kernel adds the chunks in split
//     order, applies scale and rounds to bf16: no atomics, the same result on every run.
//   * K6: one block = 64 keys of one (batch, kv head), 4 warps of 16 keys, K and V tiles kept in
//     shared memory. The block walks every query head of its group and every 32-row query tile
//     that can see its keys, so the reduction over the group stays inside the block: no atomics,
//     and the result is the same on every run.
//   * dS and P are formed in the accumulator layout of S^T/dP and reused directly as the A
//     operand of the next product, as the forward does with P.
//   * d is padded inside shared memory to DP (a multiple of 16); rows past Lq / Lk load as zeros,
//     and a query row past Lq reads lse = +inf, so its p is 0.
//   * delta = rowsum(dO * O) is one fp32 reduction in the wrapper, as the JAX package computes it
//     outside its kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BK_DQ = 32;   // K5: keys per tile
constexpr int DQ_STAGES = 4;  // K5: K/V tiles in its ring
constexpr int BKV = 64;     // K6: keys per block (16 per warp)
constexpr int BQ_DKV = 32;  // K6: query rows per step of its loop

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !in (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Four 8 x 8 bf16 matrices from shared memory; lanes 8j..8j+7 give the row addresses of matrix j,
// and r[j] is this lane's mma fragment of it (transposed with ldmatrix_x4_trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two bf16 values of one column (rows r and r + 1) of a row-major shared tile, as one B register.
template <int LDS>
__device__ __forceinline__ uint32_t col_pair(const bf16* s, int r, int c) {
  __nv_bfloat162 v;
  v.x = s[r * LDS + c];
  v.y = s[(r + 1) * LDS + c];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, rows r0 and r0 + 8 of this lane, columns c..c+1 and c+8..c+9).
template <int LDS>
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* s, int r0, int c) {
  a[0] = ld32(&s[r0 * LDS + c]);
  a[1] = ld32(&s[(r0 + 8) * LDS + c]);
  a[2] = ld32(&s[r0 * LDS + c + 8]);
  a[3] = ld32(&s[(r0 + 8) * LDS + c + 8]);
}

// The accumulators of n-tiles 2j and 2j + 1 (16 x 16 in all) as the A operand of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy a (rows x d) bf16 tile with row stride d into shared memory of row stride LDS,
// zero-filling rows >= nrows and columns >= d (d % 8 == 0, 16-byte vectors).
template <int DP, int LDS, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int nrows, int d) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
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

// K5's second pass with n_split > 1: dq = scale * sum_s dq_part[s] in split order, in bf16. One
// thread per 4 elements; n % 4 == 0.
__global__ void dq_sum_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq, int n_split, size_t n,
                              float scale) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(dq_part + (size_t)s * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dq + i);
  out[0] = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
  out[1] = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
}

cudaError_t dq_sum(const float* dq_part, bf16* dq, int n_split, size_t n, float scale, cudaStream_t stream) {
  const size_t threads = n / 4;
  dq_sum_kernel<<<(unsigned)((threads + 63) / 64), 64, 0, stream>>>(dq_part, dq, n_split, n, scale);
  return cudaGetLastError();
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (2 * BKV + 2 * BQ_DKV) * (DP + 8) * 2 + 2 * BQ_DKV * 4;
}

// K6. grid (ceil(Lk / BKV), B * KVH); dynamic shared memory dkv_smem_bytes<DP>().
template <int DP, bool CAUSAL, bool HAS_LEN>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ kv_lengths, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int KVH, int Lq, int Lk, int d, float scale, float bias) {
  constexpr int LDS = DP + 8;
  constexpr int KC = DP / 16;
  constexpr int NT_O = DP / 8;  // n-tiles of dK and dV
  constexpr int NT_S = BQ_DKV / 8;  // n-tiles of S^T and dP^T (over the query rows)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * LDS;
  bf16* sQ = sV + BKV * LDS;
  bf16* sD = sQ + BQ_DKV * LDS;  // dO
  float* sL = reinterpret_cast<float*>(sD + BQ_DKV * LDS);
  float* sDelta = sL + BQ_DKV;

  const int bkv = blockIdx.y;  // b * KVH + kvh
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int G = H / KVH;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int key[2] = {k0 + r0, k0 + r0 + 8};

  int kv_limit = Lk;
  if (HAS_LEN) kv_limit = min(Lk, kv_lengths[b]);
  const int diag = Lk - Lq;

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  if (k0 < kv_limit) {  // a tile wholly past kv_lengths has zero gradients
    const size_t kv_off = ((size_t)bkv * Lk + k0) * d;
    load_rows<DP, LDS, BKV>(sK, k + kv_off, min(BKV, Lk - k0), d);
    load_rows<DP, LDS, BKV>(sV, v + kv_off, min(BKV, Lk - k0), d);
    // the first query that sees key k0 is k0 - diag: earlier query tiles are skipped
    const int qt_begin = CAUSAL ? max(0, k0 - diag) / BQ_DKV : 0;
    const int n_qt = (Lq + BQ_DKV - 1) / BQ_DKV;

    for (int hh = 0; hh < G; ++hh) {
      const int bh = b * H + kvh * G + hh;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        const int q0 = qt * BQ_DKV;
        const int nq = min(BQ_DKV, Lq - q0);
        __syncthreads();
        load_rows<DP, LDS, BQ_DKV>(sQ, q + ((size_t)bh * Lq + q0) * d, nq, d);
        load_rows<DP, LDS, BQ_DKV>(sD, dout + ((size_t)bh * Lq + q0) * d, nq, d);
        if (threadIdx.x < BQ_DKV) {
          const int qi = q0 + threadIdx.x;
          sL[threadIdx.x] = qi < Lq ? lse[(size_t)bh * Lq + qi] : INFINITY;
          sDelta[threadIdx.x] = qi < Lq ? delta[(size_t)bh * Lq + qi] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys, columns the 32 queries
        float s[NT_S][4], dp[NT_S][4];
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ka[4], va[4];
          a_frag<LDS>(ka, sK, r0, kc * 16 + t * 2);
          a_frag<LDS>(va, sV, r0, kc * 16 + t * 2);
#pragma unroll
          for (int nt = 0; nt < NT_S; ++nt) {
            const int off = (nt * 8 + g) * LDS + kc * 16 + t * 2;
            mma_bf16(s[nt], ka, ld32(&sQ[off]), ld32(&sQ[off + 8]));
            mma_bf16(dp[nt], va, ld32(&sD[off]), ld32(&sD[off + 8]));
          }
        }

        // P^T over S^T, dS^T = P^T * (dP^T - delta) over dP^T
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + t * 2 + (e & 1);
            const int kk = key[e >> 1];
            bool ok = kk < kv_limit;
            if (CAUSAL) ok = ok && kk <= q0 + col + diag;
            const float p = ok ? __expf(s[nt][e] * scale + bias - sL[col]) : 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - sDelta[col]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: the k-dimension is this step's query rows
#pragma unroll
        for (int kc = 0; kc < BQ_DKV / 16; ++kc) {
          uint32_t pa[4], dsa[4];
          acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
          acc_to_a(dsa, dp[2 * kc], dp[2 * kc + 1]);
          const int qr = kc * 16 + t * 2;
#pragma unroll
          for (int nt = 0; nt < NT_O; ++nt) {
            const int c = nt * 8 + g;
            mma_bf16(dv_acc[nt], pa, col_pair<LDS>(sD, qr, c), col_pair<LDS>(sD, qr + 8, c));
            mma_bf16(dk_acc[nt], dsa, col_pair<LDS>(sQ, qr, c), col_pair<LDS>(sQ, qr + 8, c));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Lk) continue;
    const size_t off = ((size_t)bkv * Lk + key[r]) * d;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
            __floats2bfloat162_rn(dk_acc[nt][2 * r] * scale, dk_acc[nt][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
            __floats2bfloat162_rn(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const int* kv_lengths;
  const float *lse, *delta;
  int B, H, KVH, Lq, Lk, d;
  float scale, bias;
  int causal;
  cudaStream_t stream;
};

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
  return dq_sum(p.dq_part, p.dq, p.n_split, (size_t)p.B * p.H * p.Lq * p.d, p.scale, stream);
}

// 32-row query tiles (2 warps) when Lq <= 32, else 64 (4 warps).
template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch_dq(const DqParams& p, cudaStream_t stream) {
  if (p.Lq <= 32) return launch_dq_nw<DP, CAUSAL, HAS_LEN, 2>(p, stream);
  return launch_dq_nw<DP, CAUSAL, HAS_LEN, 4>(p, stream);
}

template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  constexpr int smem = dkv_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_kernel<DP, CAUSAL, HAS_LEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lk + BKV - 1) / BKV, a.B * a.KVH);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(a.q, a.k, a.v, a.kv_lengths, a.dout, a.lse, a.delta, dk, dv, a.H,
                                             a.KVH, a.Lq, a.Lk, a.d, a.scale, a.bias);
  return cudaGetLastError();
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

// One of the four mask variants of K6 at padded head dim DP.
template <int DP>
cudaError_t dispatch_dkv(const Args& a, bf16* dk, bf16* dv) {
  const bool has_len = a.kv_lengths != nullptr;
  if (a.causal && has_len) return launch_dkv<DP, true, true>(a, dk, dv);
  if (a.causal) return launch_dkv<DP, true, false>(a, dk, dv);
  if (has_len) return launch_dkv<DP, false, true>(a, dk, dv);
  return launch_dkv<DP, false, false>(a, dk, dv);
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

// K5's reduction alone: dq (n) bf16 = scale * sum over n_split of dq_part (n_split, n) fp32; n % 4 == 0.
extern "C" int hicom_flash_dq_sum(const float* dq_part, void* dq, int n_split, long long n, float scale,
                                  void* stream) {
  if (n <= 0 || n % 4 != 0 || n_split < 1) return (int)cudaErrorInvalidValue;
  return (int)dq_sum(dq_part, static_cast<bf16*>(dq), n_split, (size_t)n, scale, static_cast<cudaStream_t>(stream));
}

// As hicom_flash_bwd_dq without the split; dk/dv (B, KVH, Lk, d) bf16.
extern "C" int hicom_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* kv_lengths,
                                   const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                                   int B, int H, int KVH, int Lq, int Lk, int d, float scale, float bias,
                                   int causal, void* stream) {
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
         static_cast<const bf16*>(dout), kv_lengths, lse, delta, B, H, KVH, Lq, Lk, d, scale, bias, causal,
         static_cast<cudaStream_t>(stream)};
  if (bad_shape(d, H, KVH, Lq, Lk) || dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  bf16 *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  switch ((d + 15) / 16 * 16) {
    case 32: return (int)dispatch_dkv<32>(a, dkp, dvp);
    case 64: return (int)dispatch_dkv<64>(a, dkp, dvp);
    case 80: return (int)dispatch_dkv<80>(a, dkp, dvp);
    case 128: return (int)dispatch_dkv<128>(a, dkp, dvp);
    default: return (int)cudaErrorInvalidValue;
  }
}
