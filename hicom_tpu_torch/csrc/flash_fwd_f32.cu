// Flash-attention forward for Hopper (sm_90a) in fp32: fp32 q/k/v in, fp32 out and lse, and no operand
// rounded below fp32 anywhere (no TF32, no bf16 staging).
//
// The fp32 instances of the two Pallas TPU kernels that flash_fwd.cu replaces in bf16
// (hicom_tpu/ops/flash_attention.py): _fullblock_kernel (K1, the SigLIP tower: rows of 729, d 72) and
// _flash_kernel (K2: causal aligned bottom-right, kv_lengths, GQA; the decoder prefill at d 128 and the
// global compressor's 32 queries over 23,328 keys). JAX's kernels are dtype-generic: in fp32 they keep
// every operand in fp32, and so does this one. Same contract, masks and split path as flash_fwd.cu; every
// head dim that is a multiple of 8 up to 256, padded to 16, 32, ..., 128 and then to 192 or 256
// (hopper.cuh padded_dim).
//
// What bounds it on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s): the tower and the prefill are
// operations (4 Lq Lk d flops per head against 4 (Lq + Lk) d bytes); the global compressor is bytes (its keys
// and values, 215 MB a batch row in fp32, read once). The tensor cores offer fp32 only as TF32 (10-bit
// mantissa), so every product here is an FFMA.
//
// The design, a plain tiled flash forward on the CUDA cores:
//   * A block of 256 threads holds 64 query rows of one (batch row, head); thread (ty, tx) = (tid / 16,
//     tid % 16) owns rows ty + 16 i (i < 4). Q, then per tile the 64 keys of K and V, come by cp.async into
//     shared memory as rows of DP + 4 floats (the 4 extra floats keep the 16-byte reads of 8 consecutive
//     rows in distinct banks); columns past d and rows past Lq or Lk arrive as zeros.
//   * S = Q K^T: the thread's 4 x 4 logits (keys tx + 16 j), 16-byte reads of Q and K along d, 64 FFMA per
//     8 reads. The online softmax runs in registers in the log2 domain, the row's max and sum reduced over
//     the 16 threads that hold it (lanes of one warp, shuffles 8, 4, 2, 1).
//   * P goes to shared memory over the K tile (read out by then); O += P V with the thread's 4 rows and
//     column pairs tx + 16 c, 16-byte reads of P and 8-byte reads of V.
//   * Two blocks share an SM up to d 128 (101 KB of shared memory there), so one block's loads run under
//     the other's arithmetic; at 192 and 256 (147 and 195 KB) one block holds an SM, and its 255
//     registers a thread keep O's 48 or 64 accumulators with no spill.
//   * The key tiles a block walks are those of its 128-row group, the bf16 kernel's query block, 64 keys
//     each (bf16 at padded 192 walks 96-key tiles: ops/flash_attention.py fwd_block_k), so the split
//     path's chunks (forward_splits, tile_range) follow the kernel of each type and split_forward_reference
//     describes both. Each chunk writes its fp32 partials; the merge pass
//     (flash_merge.cuh) writes fp32 rows.
//
// kv_lengths is a runtime argument, as in flash_fwd.cu.
//
// Masking as flash_fwd.cu: masked logits -1e30, keys past Lk -inf, a group holding a row with no valid key
// walks every tile (the row ends as the mean of all Lk values), an empty chunk writes max -inf and
// denominator 0, the final divide uses max(l, 1e-30).
#include <math.h>

#include "flash_merge.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int BQ = 64;        // query rows per block
constexpr int GROUP_Q = 128;  // query rows that share one walk of key tiles (flash_fwd.cu's block)
constexpr int BK = 64;        // keys per tile
constexpr int PAD = 4;        // floats past DP in each shared row
constexpr float NEG2 = -1e30f * LOG2E;  // the -1e30 mask in the log2 domain

struct Params {
  const float *q, *k, *v;           // (B, H, Lq, d), (B, KVH, Lk, d) x 2
  const int* kv_lengths;            // (B,) or null
  float* o;                         // (B, H, Lq, d), or null for the partials alone
  float* lse;                       // (B, H, Lq)
  float *o_part, *m_part, *l_part;  // n_split > 1 or o null: (n_split, B * H, Lq, d), (n_split, B * H, Lq) x 2
  int B, H, KVH, Lq, Lk, d, n_split;
  float scale, bias;
};

template <int DP>
constexpr int smem_bytes() {  // Q, then K (or P over it), then V
  return (BQ * (DP + PAD) + (BK * (DP + PAD) > BQ * (BK + PAD) ? BK * (DP + PAD) : BQ * (BK + PAD)) +
          BK * (DP + PAD)) * 4;
}

// grid (ceil(Lq / BQ), B * H, n_split), NTHREADS threads, smem_bytes<DP>() of dynamic shared memory.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, DP <= 128 ? 2 : 1) flash_fwd_f32_kernel(const __grid_constant__ Params p) {
  constexpr int DS = DP + PAD;  // row stride of Q, K and V in shared memory, in floats
  constexpr int PS = BK + PAD;  // row stride of P
  constexpr int NC = (DP / 2 + 15) / 16;  // column pairs per thread: pairs tx + 16 c
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + BQ * DS;
  float* sv = sk + (BK * DS > BQ * PS ? BK * DS : BQ * PS);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int kvh = (bh % p.H) / (p.H / p.KVH);
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int g0 = q0 / GROUP_Q * GROUP_Q;

  int kv_limit = p.Lk;
  if (p.kv_lengths != nullptr) kv_limit = max(0, min(p.Lk, p.kv_lengths[b]));
  const int diag = p.Lk - p.Lq;  // bottom-right causal offset
  int n_tiles = (kv_limit + BK - 1) / BK;
  if (CAUSAL) {
    const int max_key = min(g0 + GROUP_Q - 1, p.Lq - 1) + diag;
    n_tiles = max_key < 0 ? 0 : min(n_tiles, max_key / BK + 1);
  }
  if (kv_limit == 0 || (CAUSAL && g0 + diag < 0)) n_tiles = (p.Lk + BK - 1) / BK;  // a row with no valid key
  const int t_begin = n_tiles * split / p.n_split;
  const int t_end = n_tiles * (split + 1) / p.n_split;

  const float* qg = p.q + (size_t)bh * p.Lq * p.d;
  const size_t kv_off = (size_t)(b * p.KVH + kvh) * p.Lk * p.d;
  // rows r0 .. r0 + R - 1 of a (limit, d) matrix into R rows of DS floats, zeros past limit or d
  auto load = [&](float* dst, const float* src, int r0, int R, int limit) {
    constexpr int C4 = DP / 4;
    for (int i = tid; i < R * C4; i += NTHREADS) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool in = r0 + r < limit && c < p.d;
      cp_async16(smem_u32(dst + r * DS + c), in ? src + (size_t)(r0 + r) * p.d + c : src, in);
    }
  };
  load(sq, qg, q0, BQ, p.Lq);
  cp_async_commit();

  int row[4];
  float m[4], l[4], acc[4][2 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    m[i] = NEG2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) acc[i][c] = 0.f;
  }
  const float scale2 = p.scale * LOG2E, bias2 = p.bias * LOG2E;

  for (int kt = t_begin; kt < t_end; ++kt) {
    __syncthreads();  // P and V of the last tile are read out
    load(sk, p.k + kv_off, kt * BK, BK, p.Lk);
    load(sv, p.v + kv_off, kt * BK, BK, p.Lk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * DS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * DS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // masks, then the online softmax of the thread's rows in the log2 domain
    const int k0 = kt * BK;
    bool need_mask = k0 + BK > kv_limit;
    if (CAUSAL) need_mask = need_mask || k0 + BK - 1 > q0 + diag;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale2 + bias2;
        if (need_mask) {
          const int key = k0 + tx + 16 * j;
          bool ok = key < kv_limit;
          if (CAUSAL) ok = ok && key <= row[i] + diag;
          x = key >= p.Lk ? -INFINITY : (ok ? x : NEG2);
        }
        s[i][j] = x;
      }
      float mx = fmaxf(m[i], fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
#pragma unroll
      for (int x = 8; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float alpha = exp2_approx(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2_approx(s[i][j] - mx);
        sum += s[i][j];
      }
#pragma unroll
      for (int x = 8; x > 0; x >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K is read out: P goes over it
    float* sp = sk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * PS + j0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 2 * (tx + 16 * c);
        if (col < p.d) {
          const float* vr = sv + j0 * DS + col;
          const float2 v0 = *reinterpret_cast<const float2*>(vr);
          const float2 v1 = *reinterpret_cast<const float2*>(vr + DS);
          const float2 v2 = *reinterpret_cast<const float2*>(vr + 2 * DS);
          const float2 v3 = *reinterpret_cast<const float2*>(vr + 3 * DS);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a0 = acc[i][2 * c], a1 = acc[i][2 * c + 1];
            a0 = fmaf(pr[i].x, v0.x, a0);
            a1 = fmaf(pr[i].x, v0.y, a1);
            a0 = fmaf(pr[i].y, v1.x, a0);
            a1 = fmaf(pr[i].y, v1.y, a1);
            a0 = fmaf(pr[i].z, v2.x, a0);
            a1 = fmaf(pr[i].z, v2.y, a1);
            a0 = fmaf(pr[i].w, v3.x, a0);
            a1 = fmaf(pr[i].w, v3.y, a1);
            acc[i][2 * c] = a0;
            acc[i][2 * c + 1] = a1;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // Q's copy, when the chunk walked no tile

  if (p.n_split == 1 && p.o != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row[i] >= p.Lq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / denom;
      float* orow = p.o + ((size_t)bh * p.Lq + row[i]) * p.d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 2 * (tx + 16 * c);
        if (col < p.d)
          *reinterpret_cast<float2*>(orow + col) = make_float2(acc[i][2 * c] * inv, acc[i][2 * c + 1] * inv);
      }
      if (tx == 0) p.lse[(size_t)bh * p.Lq + row[i]] = m[i] * LN2 + logf(denom);
    }
    return;
  }
  const size_t prow = ((size_t)split * gridDim.y + bh) * p.Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= p.Lq) continue;
    float* orow = p.o_part + (prow + row[i]) * p.d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 2 * (tx + 16 * c);
      if (col < p.d) *reinterpret_cast<float2*>(orow + col) = make_float2(acc[i][2 * c], acc[i][2 * c + 1]);
    }
    if (tx == 0) {
      p.m_part[prow + row[i]] = t_end > t_begin ? m[i] * LN2 : -INFINITY;
      p.l_part[prow + row[i]] = l[i];
    }
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  auto kernel = flash_fwd_f32_kernel<DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + BQ - 1) / BQ, p.B * p.H, p.n_split);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1 || p.o == nullptr) return err;
  return merge<float>(p.o_part, p.m_part, p.l_part, p.o, p.lse, p.n_split, p.B * p.H * p.Lq, p.d, stream);
}

template <int DP>
cudaError_t dispatch(const Params& p, bool causal, cudaStream_t stream) {
  return causal ? launch<DP, true>(p, stream) : launch<DP, false>(p, stream);
}

}  // namespace

// As hicom_flash_fwd (flash_fwd.cu), in fp32: q (B, H, Lq, d), k/v (B, KVH, Lk, d) fp32 contiguous and 16-byte
// aligned; kv_lengths (B,) int32 or null; o (B, H, Lq, d) fp32; lse (B, H, Lq) fp32. n_split >= 1 chunks of the
// key axis; for n_split > 1, fp32 workspaces o_part (n_split, B * H, Lq, d), m_part and l_part (n_split, B * H,
// Lq). With o null the kernel writes those partials (needed then at any n_split) and no merge runs. d % 8 == 0,
// d <= 256, H % KVH == 0. Returns a CUDA error code (0 when every launch was accepted).
extern "C" int hicom_flash_fwd_f32(const float* q, const float* k, const float* v, const int* kv_lengths, float* o,
                                   float* lse, float* o_part, float* m_part, float* l_part, int B, int H, int KVH,
                                   int Lq, int Lk, int d, int n_split, float scale, float bias, int causal,
                                   void* stream) {
  if (d % 8 != 0 || d <= 0 || d > 256 || KVH <= 0 || H % KVH != 0 || B <= 0 || Lq <= 0 || Lk <= 0 || n_split < 1 ||
      ((n_split > 1 || o == nullptr) && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v;
  p.kv_lengths = kv_lengths;
  p.o = o, p.lse = lse;
  p.o_part = o_part, p.m_part = m_part, p.l_part = l_part;
  p.B = B, p.H = H, p.KVH = KVH, p.Lq = Lq, p.Lk = Lk, p.d = d, p.n_split = n_split;
  p.scale = scale, p.bias = bias;
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
