// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax, bf16 out + fp32 lse.
//
// Replaces two Pallas TPU kernels of hicom_tpu/ops/flash_attention.py:
//   * _fullblock_kernel (K1): unmasked softmax(q k^T * scale + bias) v, the SigLIP tower
//     (L = 729, d = 72). Instantiated here with CAUSAL = false, HAS_LEN = false.
//   * _flash_kernel (K2): blocked online softmax with per-row kv_lengths, a bottom-right
//     causal mask (k_pos <= q_pos + Lk - Lq) and GQA; the decoder prefill (28q/4kv heads,
//     d = 128) and the global compressor (9 heads, 32 queries over 23,328 keys).
//
// What bounds it on the H100: at the tower shape the work is compute-bound
// (4 * L^2 * d flops per head against 4 * L * d * 2 bytes), so the tensor cores matter.
// This first version issues mma.sync m16n8k16 bf16 tiles with fp32 accumulation (not wgmma),
// streams K/V tiles of 64 keys through shared memory (no cp.async double buffering), and keeps
// the logits, the running max/denominator and the output accumulator in registers, so no
// L x L logits ever reach device memory.
//
// Design against the TPU original:
//   * One block = 64 query rows of one (batch, head); 4 warps of 16 rows each. The TPU grid's
//     sequential kv axis becomes the loop inside the block.
//   * GQA indexes the kv head as h / (H / KVH) instead of folding query rows.
//   * d is padded inside shared memory to DP (a multiple of 16, the mma k-step); device memory
//     is never padded. Rows past Lq / Lk load as zeros; only tiles that cross the kv limit or
//     the causal diagonal build a mask (729 = 11 * 64 + 25: one ragged tile per row block).
//   * Tiles entirely above the causal diagonal or past kv_lengths are skipped.
//   * Masked logits are -1e30 as in the Pallas kernel; the final divide uses max(l, 1e-30) so a
//     row with no work writes zeros, not NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr float NEG = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a (rows x d) bf16 tile with row stride d into shared memory of row stride LDS,
// zero-filling rows >= nrows and columns >= d (d % 8 == 0, 16-byte vectors).
template <int DP, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int nrows, int d) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += NWARPS * 32) {
    int r = idx / CHUNKS;
    int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int DP, bool CAUSAL, bool HAS_LEN>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lengths,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int KVH, int Lq, int Lk, int d, float scale, float bias) {
  constexpr int LDS = DP + 8;  // 16-byte row pad: conflict-free fragment loads
  constexpr int KC = DP / 16;  // k-steps of q k^T
  constexpr int NT_O = DP / 8;  // n-tiles of the output
  constexpr int NT_S = BK / 8;  // n-tiles of the logits
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LDS];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* qb = q + ((size_t)bh * Lq + q0) * d;
  const __nv_bfloat16* kb = k + (size_t)(b * KVH + kvh) * Lk * d;
  const __nv_bfloat16* vb = v + (size_t)(b * KVH + kvh) * Lk * d;

  // Q fragments stay in registers for the whole kv loop (staged through sK).
  load_tile<DP, LDS>(sK, qb, min(BQ, Lq - q0), d);
  __syncthreads();
  uint32_t qa[KC][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + t * 2;
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(&sK[r0 * LDS + c]);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(&sK[(r0 + 8) * LDS + c]);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(&sK[r0 * LDS + c + 8]);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(&sK[(r0 + 8) * LDS + c + 8]);
  }

  int kv_limit = Lk;
  if (HAS_LEN) kv_limit = min(Lk, kv_lengths[b]);
  const int diag = Lk - Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK - 1) / BK;
  if (CAUSAL) {
    const int max_key = min(q0 + BQ - 1, Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK + 1);
  }

  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<DP, LDS>(sK, kb + (size_t)k0 * d, min(BK, Lk - k0), d);
    load_tile<DP, LDS>(sV, vb + (size_t)k0 * d, min(BK, Lk - k0), d);
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kr = &sK[(nt * 8 + g) * LDS + kc * 16 + t * 2];
        mma_bf16(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    bool need_mask = k0 + BK > kv_limit;
    if (CAUSAL) need_mask = need_mask || (k0 + BK - 1 > q0 + diag);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale + bias;
        if (need_mask) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          bool ok = key < kv_limit;
          if (CAUSAL) ok = ok && key <= row[e >> 1] + diag;
          x = ok ? x : NEG;
        }
        s[nt][e] = x;
      }
    }

    // online softmax: this thread owns rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = __expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        s[nt][2 * r] = __expf(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = __expf(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = mx;
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // P (bf16, the logits' accumulator layout reused as the A operand) times V
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + t * 2;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int c = nt * 8 + g;
        __nv_bfloat162 b0, b1;
        b0.x = sV[kr * LDS + c];
        b0.y = sV[(kr + 1) * LDS + c];
        b1.x = sV[(kr + 8) * LDS + c];
        b1.y = sV[(kr + 9) * LDS + c];
        mma_bf16(acc[nt], pa, *reinterpret_cast<uint32_t*>(&b0), *reinterpret_cast<uint32_t*>(&b1));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* orow = o + ((size_t)bh * Lq + row[r]) * d;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int c = nt * 8 + t * 2;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    }
    if (t == 0) lse[(size_t)bh * Lq + row[r]] = m[r] + logf(denom);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_lengths, void* o,
                   float* lse, int B, int H, int KVH, int Lq, int Lk, int d, float scale,
                   float bias, int causal, cudaStream_t stream) {
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  dim3 block(NWARPS * 32);
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k);
  auto vp = static_cast<const __nv_bfloat16*>(v);
  auto op = static_cast<__nv_bfloat16*>(o);
  const bool has_len = kv_lengths != nullptr;
  if (causal && has_len)
    flash_fwd_kernel<DP, true, true><<<grid, block, 0, stream>>>(qp, kp, vp, kv_lengths, op, lse, H, KVH, Lq, Lk, d, scale, bias);
  else if (causal)
    flash_fwd_kernel<DP, true, false><<<grid, block, 0, stream>>>(qp, kp, vp, kv_lengths, op, lse, H, KVH, Lq, Lk, d, scale, bias);
  else if (has_len)
    flash_fwd_kernel<DP, false, true><<<grid, block, 0, stream>>>(qp, kp, vp, kv_lengths, op, lse, H, KVH, Lq, Lk, d, scale, bias);
  else
    flash_fwd_kernel<DP, false, false><<<grid, block, 0, stream>>>(qp, kp, vp, kv_lengths, op, lse, H, KVH, Lq, Lk, d, scale, bias);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Lq, d), k/v (B, KVH, Lk, d) bf16 contiguous; kv_lengths (B,) int32 or null;
// o (B, H, Lq, d) bf16; lse (B, H, Lq) fp32. d % 8 == 0, d <= 128, H % KVH == 0.
extern "C" int hicom_flash_fwd(const void* q, const void* k, const void* v, const int* kv_lengths,
                               void* o, float* lse, int B, int H, int KVH, int Lq, int Lk, int d,
                               float scale, float bias, int causal, void* stream) {
  if (d % 8 != 0 || d > 128 || H % KVH != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
  switch (dp) {
    case 32: return (int)launch<32>(q, k, v, kv_lengths, o, lse, B, H, KVH, Lq, Lk, d, scale, bias, causal, s);
    case 64: return (int)launch<64>(q, k, v, kv_lengths, o, lse, B, H, KVH, Lq, Lk, d, scale, bias, causal, s);
    case 80: return (int)launch<80>(q, k, v, kv_lengths, o, lse, B, H, KVH, Lq, Lk, d, scale, bias, causal, s);
    case 128: return (int)launch<128>(q, k, v, kv_lengths, o, lse, B, H, KVH, Lq, Lk, d, scale, bias, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
