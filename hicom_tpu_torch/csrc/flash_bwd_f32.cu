// Flash-attention backward for Hopper (sm_90a) in fp32: fp32 q/k/v/out/dO in, fp32 dQ, dK and dV out, and no
// operand rounded below fp32 anywhere (no TF32, no bf16 staging).
//
// The fp32 instances of the two Pallas TPU kernels that flash_bwd.cu replaces in bf16
// (hicom_tpu/ops/flash_attention.py): _bwd_dq_kernel (K5: dQ = scale * sum_k dS K) and _bwd_dkv_kernel (K6:
// dV = sum_q P^T dO and dK = scale * sum_q dS^T Q over every query head of the kv head's group), with
// P = exp(S * scale + bias - lse) recomputed from the forward's lse, dP = dO V^T, dS = P (dP - delta) and
// delta = rowsum(dO * O) from the wrapper. JAX's kernels are dtype-generic: in fp32 their roundings of P and
// dS (p.astype(do.dtype), ds.astype(k.dtype)) are no-ops, and here nothing is rounded either. Same contract,
// masks and split paths as flash_bwd.cu: a bottom-right causal rule k <= q + Lk - Lq, keys at or past
// kv_lengths[b] masked (p = 0), query rows past kv_lengths not masked; every head dim that is a multiple of 8
// up to 256, padded to 16, 32, ..., 128 and then to 192 or 256 (hopper.cuh padded_dim).
//
// What bounds it on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s): at the decoder prefill,
// operations (3 products of 2 d flops per unmasked (q, k) pair for dQ, 4 for dK and dV); at the global
// compressor's 32 queries over 23,328 keys, bytes (K and V read and dK and dV written, 860 MB at b 2 in
// fp32). The tensor cores offer fp32 only as TF32 (10-bit mantissa), so every product is an FFMA.
//
// The design, the fp32 forward's (flash_fwd_f32.cu) on the CUDA cores:
//   * 256 threads, thread (ty, tx) = (tid / 16, tid % 16); shared rows of DP + 4 floats (16-byte reads of 8
//     consecutive rows fall in distinct banks at every DP); columns past d and rows past Lq or Lk arrive by
//     cp.async as zeros. Products over d read float4 along d; products over keys or queries read a float4 of
//     P or dS and float2 pairs of columns tx + 16 c. Two blocks share an SM up to d 128 (99 KB of shared
//     memory at d 128 for K5, 108 KB for K6), so one block's loads run under the other's arithmetic; at
//     192 and 256 one block holds an SM (K5 147 and 195 KB, K6 156 and 204 KB) with up to 255 registers a
//     thread for K6's 2 x 64 accumulators of dK and dV at 256.
//   * K5: one block = BQ = 16 R query rows of one (batch, q head) (R = 2 when Lq <= 32, as at the global
//     compressor, else 4: dq_block_q's 32 or 64 rows), thread rows ty + 16 i; the key tiles of 32 keys
//     (the bf16 kernel's tiles, so dq_splits, tile_range and split_dq_reference hold for both types) come
//     into shared memory one at a time, thread keys tx + 16 j (j < 2). S and dP in registers, then P and
//     dS; dS goes to shared memory over the V tile (read out by then) and dQ += dS K accumulates R x DP / 16
//     values a thread.
//   * K6: one block = 64 keys of one (batch, kv head), resident in shared memory with their V rows; it
//     walks the (query head, 64-row query tile) units of dkv_unit_range, each as two halves of 32 query
//     rows (Q and dO of a half in shared memory), thread keys ty + 16 i (i < 4) and queries tx + 16 j
//     (j < 2) for S^T and dP^T; P^T, then dS^T, go through one shared buffer for dV += P^T dO and
//     dK += dS^T Q, 4 x DP / 16 values a thread of each, in registers until the end.
//   * Split paths as flash_bwd.cu: K5's chunks of key tiles and K6's ranges of units (grid z) write fp32
//     partials, which part_sum_kernel (flash_part_sum.cuh) adds in split order into fp32 dQ, dK and dV.
//   * Causal and kv_lengths are runtime arguments (one instance per head dim, and per R for K5): the masks
//     test a tile's keys only where the tile reaches past a limit.
#include <math.h>

#include "flash_part_sum.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int PAD = 4;        // floats past DP in each shared row
constexpr int BK_DQ = 32;     // K5: keys per tile (flash_bwd.cu's, ops/flash_attention.py DQ_BLOCK_K)
constexpr int DKV_BK = 64;    // K6: keys per block (DKV_BLOCK_K)
constexpr int DKV_BQ = 64;    // K6: query rows per unit (DKV_BLOCK_Q)
constexpr int HALF = 32;      // K6: query rows per half unit
constexpr int PS = 32 + PAD;  // row stride of dS (K5) and of P^T / dS^T (K6)

struct Params {
  const float *q, *k, *v, *dout;     // (B, H, Lq, d), (B, KVH, Lk, d) x 2, (B, H, Lq, d)
  const int* kv_lengths;             // (B,) or null
  const float *lse, *delta;          // (B, H, Lq)
  float *dq, *dk, *dv;               // n_split == 1: (B, H, Lq, d), (B, KVH, Lk, d) x 2
  float *dq_part, *dk_part, *dv_part;  // n_split > 1: (n_split, B * H, Lq, d), (n_split, B * KVH, Lk, d) x 2
  int B, H, KVH, Lq, Lk, d, n_split, causal;
  float scale, bias;
};

// rows r0 .. r0 + R - 1 of a (limit, d) fp32 matrix into R shared rows of DS floats, zeros past limit or d
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int R, int limit, int d) {
  constexpr int DS = DP + PAD, C4 = DP / 4;
  for (int i = threadIdx.x; i < R * C4; i += NTHREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool in = r0 + r < limit && c < d;
    cp_async16(smem_u32(dst + r * DS + c), in ? src + (size_t)(r0 + r) * d + c : src, in);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc[i][2c, 2c + 1] += sum over the J = 32 columns j of w[row ty + 16 i][j] * m[j][col pair 2 (tx + 16 c)]:
// w (rows of PS floats) is P, P^T, dS or dS^T; m (rows of DS floats) is K, dO or Q.
template <int DP, int R>
__device__ __forceinline__ void accumulate(float (*acc)[2 * ((DP / 2 + 15) / 16)], const float* w, const float* m,
                                           int d) {
  constexpr int DS = DP + PAD, NC = (DP / 2 + 15) / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int j0 = 0; j0 < 32; j0 += 4) {
    float4 pr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pr[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * PS + j0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 2 * (tx + 16 * c);
      if (col < d) {
        const float* mr = m + j0 * DS + col;
        const float2 m0 = *reinterpret_cast<const float2*>(mr);
        const float2 m1 = *reinterpret_cast<const float2*>(mr + DS);
        const float2 m2 = *reinterpret_cast<const float2*>(mr + 2 * DS);
        const float2 m3 = *reinterpret_cast<const float2*>(mr + 3 * DS);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float a0 = acc[i][2 * c], a1 = acc[i][2 * c + 1];
          a0 = fmaf(pr[i].x, m0.x, a0);
          a1 = fmaf(pr[i].x, m0.y, a1);
          a0 = fmaf(pr[i].y, m1.x, a0);
          a1 = fmaf(pr[i].y, m1.y, a1);
          a0 = fmaf(pr[i].z, m2.x, a0);
          a1 = fmaf(pr[i].z, m2.y, a1);
          a0 = fmaf(pr[i].w, m3.x, a0);
          a1 = fmaf(pr[i].w, m3.y, a1);
          acc[i][2 * c] = a0;
          acc[i][2 * c + 1] = a1;
        }
      }
    }
  }
}

template <int DP, int R>
constexpr int dq_smem_bytes() {  // Q, dO, K, then V (or dS over it)
  return (2 * 16 * R * (DP + PAD) + BK_DQ * (DP + PAD) +
          (BK_DQ * (DP + PAD) > 16 * R * PS ? BK_DQ * (DP + PAD) : 16 * R * PS)) * 4;
}

// K5. grid (ceil(Lq / (16 R)), B * H, n_split), NTHREADS threads, dq_smem_bytes<DP, R>() of dynamic shared
// memory. Writes scale * dQ (n_split == 1) or the chunk's unscaled partial.
template <int DP, int R>
__global__ void __launch_bounds__(NTHREADS, DP <= 128 ? 2 : 1) flash_bwd_dq_f32_kernel(const __grid_constant__ Params p) {
  constexpr int BQ = 16 * R;
  constexpr int DS = DP + PAD;
  constexpr int NC = (DP / 2 + 15) / 16;  // column pairs per thread: pairs tx + 16 c
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * DS;
  float* sk = sdo + BQ * DS;
  float* sv = sk + BK_DQ * DS;  // dS (BQ rows of PS) over it once dP is formed

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int kvh = (bh % p.H) / (p.H / p.KVH);
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;

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

  const size_t qoff = (size_t)bh * p.Lq * p.d;
  const size_t kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  load_rows<DP>(sq, p.q + qoff, q0, BQ, p.Lq, p.d);
  load_rows<DP>(sdo, p.dout + qoff, q0, BQ, p.Lq, p.d);
  cp_async_commit();

  // per row: log2-domain offset (bias - lse) log2 e (-inf past Lq: p = 0) and delta
  int row[R];
  float off[R], dl[R], acc[R][2 * NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = q0 + ty + 16 * i;
    const bool in = row[i] < p.Lq;
    off[i] = in ? (p.bias - p.lse[(size_t)bh * p.Lq + row[i]]) * LOG2E : -INFINITY;
    dl[i] = in ? p.delta[(size_t)bh * p.Lq + row[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) acc[i][c] = 0.f;
  }
  const float scale2 = p.scale * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    __syncthreads();  // dS and K of the last tile are read out
    load_rows<DP>(sk, p.k + kv_off, kt * BK_DQ, BK_DQ, p.Lk, p.d);
    load_rows<DP>(sv, p.v + kv_off, kt * BK_DQ, BK_DQ, p.Lk, p.d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: the thread's R x 2 of each, keys tx + 16 j
    float s[R][2], dp[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 kb[2], vb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * DS + c);
        vb[j] = *reinterpret_cast<const float4*>(sv + (tx + 16 * j) * DS + c);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * DS + c);
        const float4 da = *reinterpret_cast<const float4*>(sdo + (ty + 16 * i) * DS + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = dot4(qa, kb[j], s[i][j]);
          dp[i][j] = dot4(da, vb[j], dp[i][j]);
        }
      }
    }

    // P from the lse, then dS = P (dP - delta)
    const int k0 = kt * BK_DQ;
    bool need_mask = k0 + BK_DQ > kv_limit;
    if (p.causal) need_mask = need_mask || k0 + BK_DQ - 1 > q0 + diag;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float pr = exp2_approx(fmaf(s[i][j], scale2, off[i]));
        if (need_mask) {
          const int key = k0 + tx + 16 * j;
          const bool ok = key < kv_limit && (!p.causal || key <= row[i] + diag);
          pr = ok ? pr : 0.f;
        }
        s[i][j] = pr * (dp[i][j] - dl[i]);
      }
    __syncthreads();  // V is read out: dS goes over it
    float* sds = sv;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) sds[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();

    accumulate<DP, R>(acc, sds, sk, p.d);  // dQ += dS K
  }
  cp_async_wait<0>();  // Q's and dO's copies, when the chunk walked no tile

  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (row[i] >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 2 * (tx + 16 * c);
      if (col >= p.d) continue;
      if (p.n_split == 1)
        *reinterpret_cast<float2*>(p.dq + ((size_t)bh * p.Lq + row[i]) * p.d + col) =
            make_float2(acc[i][2 * c] * p.scale, acc[i][2 * c + 1] * p.scale);
      else
        *reinterpret_cast<float2*>(p.dq_part + (prow + row[i]) * p.d + col) =
            make_float2(acc[i][2 * c], acc[i][2 * c + 1]);
    }
  }
}

template <int DP, int R>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP, R>();
  auto kernel = flash_bwd_dq_f32_kernel<DP, R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + 16 * R - 1) / (16 * R), p.B * p.H, p.n_split);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum<float>{{p.dq_part, nullptr}, {p.dq, nullptr}, {p.scale, 0.f}}, 1, p.n_split,
                  (size_t)p.B * p.H * p.Lq * p.d, stream);
}

// 32-row query blocks when Lq <= 32, else 64 (dq_block_q).
template <int DP>
cudaError_t dispatch_dq(const Params& p, cudaStream_t stream) {
  return p.Lq <= 32 ? launch_dq<DP, 2>(p, stream) : launch_dq<DP, 4>(p, stream);
}

template <int DP>
constexpr int dkv_smem_bytes() {  // K, V, then Q and dO of a half unit, then P^T or dS^T
  return (2 * DKV_BK * (DP + PAD) + 2 * HALF * (DP + PAD) + DKV_BK * PS) * 4;
}

// K6. grid (ceil(Lk / 64), B * KVH, n_split), NTHREADS threads, dkv_smem_bytes<DP>() of dynamic shared memory.
// Writes scale * dK and dV (n_split == 1) or the range's unscaled partials.
template <int DP>
__global__ void __launch_bounds__(NTHREADS, DP <= 128 ? 2 : 1) flash_bwd_dkv_f32_kernel(const __grid_constant__ Params p) {
  constexpr int DS = DP + PAD;
  constexpr int NC = (DP / 2 + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + DKV_BK * DS;
  float* sq = sv + DKV_BK * DS;
  float* sdo = sq + HALF * DS;
  float* sw = sdo + HALF * DS;  // P^T, then dS^T: 64 key rows of PS

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.y;  // b * KVH + kvh
  const int b = bkv / p.KVH;
  const int G = p.H / p.KVH;
  const int split = blockIdx.z;
  const int k0 = blockIdx.x * DKV_BK;

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;
  // the units as in flash_bwd.cu's K6 (ops/flash_attention.py dkv_unit_range)
  const int qt_begin = p.causal ? max(0, k0 - diag) / DKV_BQ : 0;
  const int nq = k0 < kv_limit ? max(0, (p.Lq + DKV_BQ - 1) / DKV_BQ - qt_begin) : 0;
  const int u_begin = G * nq * split / p.n_split;
  const int n = G * nq * (split + 1) / p.n_split - u_begin;

  const size_t kv_off = (size_t)bkv * p.Lk * p.d;
  load_rows<DP>(sk, p.k + kv_off, k0, DKV_BK, p.Lk, p.d);
  load_rows<DP>(sv, p.v + kv_off, k0, DKV_BK, p.Lk, p.d);
  cp_async_commit();

  float dk[4][2 * NC], dv[4][2 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float scale2 = p.scale * LOG2E;
  const bool key_mask = k0 + DKV_BK > kv_limit;  // some of the block's keys are past kv_lengths

  for (int u = 0; u < n; ++u) {
    const int head = b * p.H + (bkv % p.KVH) * G + (u_begin + u) / nq;
    const int qbase = (qt_begin + (u_begin + u) % nq) * DKV_BQ;
    for (int h = 0; h < DKV_BQ / HALF; ++h) {
      const int q0 = qbase + h * HALF;
      if (q0 >= p.Lq || (p.causal && k0 > q0 + HALF - 1 + diag)) continue;  // no row, or every key above them
      const size_t qoff = (size_t)head * p.Lq * p.d;
      __syncthreads();  // the last half's Q, dO and P^T / dS^T are read out
      load_rows<DP>(sq, p.q + qoff, q0, HALF, p.Lq, p.d);
      load_rows<DP>(sdo, p.dout + qoff, q0, HALF, p.Lq, p.d);
      cp_async_commit();
      float off[2], dl[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + tx + 16 * j;
        const bool in = q < p.Lq;
        off[j] = in ? (p.bias - p.lse[(size_t)head * p.Lq + q]) * LOG2E : -INFINITY;
        dl[j] = in ? p.delta[(size_t)head * p.Lq + q] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the thread's keys ty + 16 i, queries tx + 16 j
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 2
      for (int c = 0; c < DP; c += 4) {
        float4 qa[2], da[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qa[j] = *reinterpret_cast<const float4*>(sq + (tx + 16 * j) * DS + c);
          da[j] = *reinterpret_cast<const float4*>(sdo + (tx + 16 * j) * DS + c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kb = *reinterpret_cast<const float4*>(sk + (ty + 16 * i) * DS + c);
          const float4 vb = *reinterpret_cast<const float4*>(sv + (ty + 16 * i) * DS + c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = dot4(kb, qa[j], s[i][j]);
            dp[i][j] = dot4(vb, da[j], dp[i][j]);
          }
        }
      }

      // P^T, masked, and dS^T = P^T (dP^T - delta)
      const bool need_mask = key_mask || (p.causal && k0 + DKV_BK - 1 > q0 + diag);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pr = exp2_approx(fmaf(s[i][j], scale2, off[j]));
          if (need_mask) {
            const int key = k0 + ty + 16 * i;
            const bool ok = key < kv_limit && (!p.causal || key <= q0 + tx + 16 * j + diag);
            pr = ok ? pr : 0.f;
          }
          s[i][j] = pr;
          dp[i][j] = pr * (dp[i][j] - dl[j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sw[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
      __syncthreads();
      accumulate<DP, 4>(dv, sw, sdo, p.d);  // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sw[(ty + 16 * i) * PS + tx + 16 * j] = dp[i][j];
      __syncthreads();
      accumulate<DP, 4>(dk, sw, sq, p.d);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();  // K's and V's copies, when the block walked no unit

  const bool direct = p.n_split == 1;
  const size_t first = (direct ? 0 : (size_t)split * gridDim.y * p.Lk) + (size_t)bkv * p.Lk;
  float* gk = direct ? p.dk : p.dk_part;
  float* gv = direct ? p.dv : p.dv_part;
  const float ks = direct ? p.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 2 * (tx + 16 * c);
      if (col >= p.d) continue;
      const size_t at = (first + key) * p.d + col;
      *reinterpret_cast<float2*>(gk + at) = make_float2(dk[i][2 * c] * ks, dk[i][2 * c + 1] * ks);
      *reinterpret_cast<float2*>(gv + at) = make_float2(dv[i][2 * c], dv[i][2 * c + 1]);
    }
  }
}

template <int DP>
cudaError_t dispatch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lk + DKV_BK - 1) / DKV_BK, p.B * p.KVH, p.n_split);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return part_sum(PartSum<float>{{p.dk_part, p.dv_part}, {p.dk, p.dv}, {p.scale, 1.f}}, 2, p.n_split,
                  (size_t)p.B * p.KVH * p.Lk * p.d, stream);
}

bool bad_args(const void* q, const void* k, const void* v, const void* dout, int B, int H, int KVH, int Lq, int Lk,
              int d, int n_split) {
  return d % 8 != 0 || d <= 0 || d > 256 || KVH <= 0 || H % KVH != 0 || B <= 0 || Lq <= 0 || Lk <= 0 ||
         n_split < 1 ||
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
          reinterpret_cast<uintptr_t>(dout)) % 16 != 0;
}

#define HICOM_F32_WIDTHS(CALL)                  \
  switch (padded_dim(p.d)) {                    \
    case 16: return (int)CALL<16>(p, s);        \
    case 32: return (int)CALL<32>(p, s);        \
    case 48: return (int)CALL<48>(p, s);        \
    case 64: return (int)CALL<64>(p, s);        \
    case 80: return (int)CALL<80>(p, s);        \
    case 96: return (int)CALL<96>(p, s);        \
    case 112: return (int)CALL<112>(p, s);      \
    case 128: return (int)CALL<128>(p, s);      \
    case 192: return (int)CALL<192>(p, s);      \
    case 256: return (int)CALL<256>(p, s);      \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// As hicom_flash_bwd_dq (flash_bwd.cu), in fp32: q/dout (B, H, Lq, d), k/v (B, KVH, Lk, d) fp32 contiguous and
// 16-byte aligned; kv_lengths (B,) int32 or null; lse/delta (B, H, Lq) fp32; dq (B, H, Lq, d) fp32. n_split >= 1
// chunks of the key axis; for n_split > 1, an fp32 workspace dq_part (n_split, B * H, Lq, d). d % 8 == 0,
// d <= 256, H % KVH == 0. Returns a CUDA error code (0 when every launch was accepted).
extern "C" int hicom_flash_bwd_dq_f32(const float* q, const float* k, const float* v, const int* kv_lengths,
                                      const float* dout, const float* lse, const float* delta, float* dq,
                                      float* dq_part, int B, int H, int KVH, int Lq, int Lk, int d, int n_split,
                                      float scale, float bias, int causal, void* stream) {
  if (bad_args(q, k, v, dout, B, H, KVH, Lq, Lk, d, n_split) || dq == nullptr || (n_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.kv_lengths = kv_lengths, p.lse = lse, p.delta = delta;
  p.dq = dq, p.dq_part = dq_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split, p.causal = causal != 0;
  p.scale = scale, p.bias = bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HICOM_F32_WIDTHS(dispatch_dq)
}

// As hicom_flash_bwd_dkv (flash_bwd.cu), in fp32: dk/dv (B, KVH, Lk, d) fp32. n_split >= 1 ranges of each block's
// units; for n_split > 1, fp32 workspaces dk_part and dv_part (n_split, B * KVH, Lk, d).
extern "C" int hicom_flash_bwd_dkv_f32(const float* q, const float* k, const float* v, const int* kv_lengths,
                                       const float* dout, const float* lse, const float* delta, float* dk, float* dv,
                                       float* dk_part, float* dv_part, int B, int H, int KVH, int Lq, int Lk, int d,
                                       int n_split, float scale, float bias, int causal, void* stream) {
  if (bad_args(q, k, v, dout, B, H, KVH, Lq, Lk, d, n_split) || dk == nullptr || dv == nullptr ||
      (n_split > 1 && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.kv_lengths = kv_lengths, p.lse = lse, p.delta = delta;
  p.dk = dk, p.dv = dv, p.dk_part = dk_part, p.dv_part = dv_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split, p.causal = causal != 0;
  p.scale = scale, p.bias = bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HICOM_F32_WIDTHS(dispatch_dkv)
}
