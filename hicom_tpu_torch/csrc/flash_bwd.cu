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
// global compressor's 32 queries over 23,328 keys, bytes (K and V read, dK and dV written).
// This first version issues mma.sync m16n8k16 bf16 tiles with fp32 accumulation (not wgmma) and
// plain shared-memory tiles (no cp.async/TMA pipeline); S, P, dP and dS live only in registers,
// so no Lq x Lk matrix ever reaches device memory.
//
// Design against the TPU original:
//   * K5: one block = 64 query rows of one (batch, q head), 4 warps of 16 rows. Q and dO stay
//     in registers as mma A fragments; the block walks 32-key tiles of K and V up to the causal
//     diagonal and the row's kv_lengths limit (the TPU grid's sequential kv axis).
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
constexpr int BQ = 64;      // K5: query rows per block (16 per warp)
constexpr int BK_DQ = 32;   // K5: keys per step of its loop
constexpr int BKV = 64;     // K6: keys per block (16 per warp)
constexpr int BQ_DKV = 32;  // K6: query rows per step of its loop

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

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

// K5. grid (ceil(Lq / BQ), B * H).
template <int DP, bool CAUSAL, bool HAS_LEN>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const int* __restrict__ kv_lengths, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int KVH, int Lq, int Lk, int d, float scale, float bias) {
  constexpr int LDS = DP + 8;  // 16-byte row pad: conflict-free fragment loads
  constexpr int KC = DP / 16;  // k-steps over d
  constexpr int NT_O = DP / 8;  // n-tiles of dQ
  constexpr int NT_S = BK_DQ / 8;  // n-tiles of S and dP
  __shared__ __align__(16) bf16 smem[2 * BK_DQ * LDS];  // K and V tiles; Q and dO staged first
  bf16* sK = smem;
  bf16* sV = smem + BK_DQ * LDS;
  static_assert(2 * BK_DQ == BQ, "the staging of Q and dO uses both tiles");

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int nq = min(BQ, Lq - q0);

  const bf16* kb = k + (size_t)(b * KVH + kvh) * Lk * d;
  const bf16* vb = v + (size_t)(b * KVH + kvh) * Lk * d;

  uint32_t qa[KC][4], da[KC][4];
  load_rows<DP, LDS, BQ>(smem, q + ((size_t)bh * Lq + q0) * d, nq, d);
  __syncthreads();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) a_frag<LDS>(qa[kc], smem, r0, kc * 16 + t * 2);
  __syncthreads();
  load_rows<DP, LDS, BQ>(smem, dout + ((size_t)bh * Lq + q0) * d, nq, d);
  __syncthreads();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) a_frag<LDS>(da[kc], smem, r0, kc * 16 + t * 2);

  const int row[2] = {q0 + r0, q0 + r0 + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < Lq;
    row_lse[r] = in ? lse[(size_t)bh * Lq + row[r]] : INFINITY;
    row_delta[r] = in ? delta[(size_t)bh * Lq + row[r]] : 0.f;
  }

  int kv_limit = Lk;
  if (HAS_LEN) kv_limit = min(Lk, kv_lengths[b]);
  const int diag = Lk - Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK_DQ - 1) / BK_DQ;
  if (CAUSAL) {
    const int max_key = min(q0 + BQ - 1, Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK_DQ + 1);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK_DQ;
    __syncthreads();
    load_rows<DP, LDS, BK_DQ>(sK, kb + (size_t)k0 * d, min(BK_DQ, Lk - k0), d);
    load_rows<DP, LDS, BK_DQ>(sV, vb + (size_t)k0 * d, min(BK_DQ, Lk - k0), d);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int off = (nt * 8 + g) * LDS + kc * 16 + t * 2;
        mma_bf16(s[nt], qa[kc], ld32(&sK[off]), ld32(&sK[off + 8]));
        mma_bf16(dp[nt], da[kc], ld32(&sV[off]), ld32(&sV[off + 8]));
      }
    }

    // P from the lse, then dS = P * (dP - delta), stored over S
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        bool ok = key < kv_limit;
        if (CAUSAL) ok = ok && key <= row[e >> 1] + diag;
        const float p = ok ? __expf(s[nt][e] * scale + bias - row_lse[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]);
      }
    }

    // dQ += dS K: the k-dimension is this tile's keys
#pragma unroll
    for (int kc = 0; kc < BK_DQ / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
      const int kr = kc * 16 + t * 2;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int c = nt * 8 + g;
        mma_bf16(acc[nt], a, col_pair<LDS>(sK, kr, c), col_pair<LDS>(sK, kr + 8, c));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Lq) continue;
    bf16* orow = dq + ((size_t)bh * Lq + row[r]) * d;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
    }
  }
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

template <int DP, bool CAUSAL, bool HAS_LEN>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<DP, CAUSAL, HAS_LEN><<<grid, NTHREADS, 0, a.stream>>>(
      a.q, a.k, a.v, a.kv_lengths, a.dout, a.lse, a.delta, dq, a.H, a.KVH, a.Lq, a.Lk, a.d, a.scale, a.bias);
  return cudaGetLastError();
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

// One of the four mask variants of K5 (dq != null) or K6 (dk, dv) at padded head dim DP.
template <int DP>
cudaError_t dispatch(const Args& a, bf16* dq, bf16* dk, bf16* dv) {
  const bool has_len = a.kv_lengths != nullptr;
  if (dq != nullptr) {
    if (a.causal && has_len) return launch_dq<DP, true, true>(a, dq);
    if (a.causal) return launch_dq<DP, true, false>(a, dq);
    if (has_len) return launch_dq<DP, false, true>(a, dq);
    return launch_dq<DP, false, false>(a, dq);
  }
  if (a.causal && has_len) return launch_dkv<DP, true, true>(a, dk, dv);
  if (a.causal) return launch_dkv<DP, true, false>(a, dk, dv);
  if (has_len) return launch_dkv<DP, false, true>(a, dk, dv);
  return launch_dkv<DP, false, false>(a, dk, dv);
}

int run(const Args& a, bf16* dq, bf16* dk, bf16* dv) {
  if (a.d % 8 != 0 || a.d > 128 || a.KVH <= 0 || a.H % a.KVH != 0 || a.Lq <= 0 || a.Lk <= 0)
    return (int)cudaErrorInvalidValue;
  switch ((a.d + 15) / 16 * 16) {
    case 32: return (int)dispatch<32>(a, dq, dk, dv);
    case 64: return (int)dispatch<64>(a, dq, dk, dv);
    case 80: return (int)dispatch<80>(a, dq, dk, dv);
    case 128: return (int)dispatch<128>(a, dq, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null;
// lse/delta (B, H, Lq) fp32; dq (B, H, Lq, d) bf16. d % 8 == 0, d <= 128, H % KVH == 0.
extern "C" int hicom_flash_bwd_dq(const void* q, const void* k, const void* v, const int* kv_lengths,
                                  const void* dout, const float* lse, const float* delta, void* dq, int B,
                                  int H, int KVH, int Lq, int Lk, int d, float scale, float bias, int causal,
                                  void* stream) {
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
         static_cast<const bf16*>(dout), kv_lengths, lse, delta, B, H, KVH, Lq, Lk, d, scale, bias, causal,
         static_cast<cudaStream_t>(stream)};
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return run(a, static_cast<bf16*>(dq), nullptr, nullptr);
}

// As hicom_flash_bwd_dq; dk/dv (B, KVH, Lk, d) bf16.
extern "C" int hicom_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* kv_lengths,
                                   const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                                   int B, int H, int KVH, int Lq, int Lk, int d, float scale, float bias,
                                   int causal, void* stream) {
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
         static_cast<const bf16*>(dout), kv_lengths, lse, delta, B, H, KVH, Lq, Lk, d, scale, bias, causal,
         static_cast<cudaStream_t>(stream)};
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return run(a, nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
}
