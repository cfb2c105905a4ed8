// One-token decode attention over a bf16 or int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hicom_tpu/ops/flash_decode.py:_decode_kernel (K3): each of
// the g = H / KVH query heads sharing a kv head attends over the cache slots its bitmap allows.
// With an int8 cache the per-slot scales multiply the logits (k_scale) and multiply p for the
// accumulator only (v_scale), not the denominator, exactly as the TPU kernel does; p times the v
// scale is rounded to bf16 before the P V product, as the TPU kernel rounds it to q's type.
//
// What bounds it on the H100: bytes. One decode step reads each valid cache slot once
// (2 * d * 2 bytes in bf16, 2 * d bytes + 8 bytes of scales in int8) and does 4 * g * d flops per
// slot, far below the card's 295 flops per byte: at the served shape (b 2, 4 kv heads, about 1,500
// valid slots) that is 3 MB, under a microsecond. So the limit is latency: how many bytes are in
// flight, and how few dependent steps each block takes.
//
// The design (flash-decoding over small chunks):
//   * One block = one warp = 32 slots of one (batch, kv head); 32-slot chunks put about 24 busy
//     blocks on each kv head of a cache filled to 760 slots (96 at b 1, 192 at b 2).
//   * The warp reads its chunk's bitmap with one coalesced load and a ballot. An empty chunk writes
//     its (max -inf, denominator 0) partial and returns without touching K or V, so the unwritten
//     part of the cache costs one byte per slot.
//   * A chunk with a valid slot copies its valid K and V rows into shared memory with 16-byte
//     cp.async (16 KB in bf16), all issued before any compute, while the query and the slots'
//     scales load; rows whose bit is clear are zero-filled and never read. int8 codes are copied as
//     they are and converted to bf16 in shared memory (exact: |x| <= 127).
//   * Both products are mma.sync m16n8k16 tiles: S = Q K^T with the group's heads as the 16 rows
//     of A (rows past g are zero) and 8-slot column tiles of K by ldmatrix, and O = P V with P, S's
//     accumulator layout, as the A operand and V by ldmatrix.trans. The softmax of each head runs
//     along its row in registers, with the masked logits at -1e30 as on the TPU.
//   * Each chunk's partial (max, fp32 denominator, unnormalised fp32 accumulator per head) goes to a
//     workspace; the combine kernel loads every chunk's max into shared memory in parallel, reduces
//     them to the row's maximum and the weights exp(m_i - M), lists the chunks with a nonzero
//     weight, and sums their weighted accumulators in chunk order, the loads issued back to back.
//     A row with no valid slot at all has every logit at -1e30 on the TPU, hence the uniform
//     average of its values: the combine computes that average for such a row.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 128;
constexpr int CHUNK = 32;   // slots per block, one per lane
constexpr int LDS = D + 8;  // bf16 row stride of the K and V tiles: a 16-byte pad, conflict-free ldmatrix
constexpr float NEG = -1e30f;

// A chunk's int8 codes (CHUNK rows of D, packed) to bf16 rows of stride LDS; 16 codes per lane step.
__device__ __forceinline__ void codes_to_bf16(bf16* dst, const int8_t* src, int lane) {
  for (int i = lane; i < CHUNK * D / 16; i += 32) {
    const int r = i / (D / 16), c = (i % (D / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * D + c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = pack_bf16((float)x[2 * j], (float)x[2 * j + 1]);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + r * LDS + c + 8) = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// grid (n_chunks, B * KVH), one warp; partial outputs pm/pl (rows, n_chunks, G), pacc (rows, n_chunks, G, D)
template <int G, bool QUANT>
__global__ void __launch_bounds__(32)
decode_partial_kernel(const bf16* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
                      const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                      const uint8_t* __restrict__ slot_mask, float* __restrict__ pm, float* __restrict__ pl,
                      float* __restrict__ pacc, int KVH, int S, float scale) {
  constexpr int ROW = QUANT ? D : 2 * D;      // bytes of a cache row
  constexpr int STAGED = QUANT ? D : 2 * LDS;  // bytes of a row as copied into shared memory
  __shared__ __align__(16) bf16 sk[CHUNK * LDS];
  __shared__ __align__(16) bf16 sv[CHUNK * LDS];
  __shared__ __align__(16) int8_t codes[QUANT ? 2 * CHUNK * D : 16];  // K's then V's, as they are

  const int chunk = blockIdx.x;
  const int rowi = blockIdx.y;  // b * KVH + kvh
  const int b = rowi / KVH;
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int s0 = chunk * CHUNK;
  const int slot = s0 + lane;
  const bool valid = slot < S && slot_mask[(size_t)b * S + slot] != 0;
  const uint32_t bits = __ballot_sync(0xffffffffu, valid);
  const size_t part = (size_t)rowi * gridDim.x + chunk;
  if (bits == 0) {  // an empty chunk: max -inf, denominator 0; the combine gives it no weight
    if (lane < G) {
      pm[part * G + lane] = -INFINITY;
      pl[part * G + lane] = 0.f;
    }
    return;
  }

  // the valid slots' K and V rows, every copy issued before any compute; clear slots' rows are zeros
  const char* kb = static_cast<const char*>(k) + ((size_t)rowi * S + s0) * ROW;
  const char* vb = static_cast<const char*>(v) + ((size_t)rowi * S + s0) * ROW;
  const uint32_t dk = smem_u32(QUANT ? (void*)codes : (void*)sk);
  const uint32_t dv = smem_u32(QUANT ? (void*)(codes + CHUNK * D) : (void*)sv);
  for (int i = lane; i < CHUNK * ROW / 16; i += 32) {
    const int r = i / (ROW / 16), c = (i % (ROW / 16)) * 16;
    const bool in = (bits >> r) & 1;
    cp_async16(dk + r * STAGED + c, kb + (in ? r * ROW + c : 0), in);
    cp_async16(dv + r * STAGED + c, vb + (in ? r * ROW + c : 0), in);
  }
  cp_async_commit();

  // meanwhile Q as the A operand: row g is head g (rows past G and 8-15 are zero), columns
  // kc * 16 + 2t (+1) and + 8; and this lane's slot's scales
  uint32_t qa[D / 16][2];
  const bf16* qrow = q + ((size_t)rowi * G + min(g, G - 1)) * D + 2 * t;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = g < G ? ld32(qrow + kc * 16) : 0u;
    qa[kc][1] = g < G ? ld32(qrow + kc * 16 + 8) : 0u;
  }
  float ks = 1.f, vs = 1.f;
  if (QUANT && valid) {
    ks = k_scale[(size_t)rowi * S + slot];
    vs = v_scale[(size_t)rowi * S + slot];
  }
  cp_async_wait<0>();
  __syncwarp();
  if (QUANT) {
    codes_to_bf16(sk, codes, lane);
    codes_to_bf16(sv, codes + CHUNK * D, lane);
    __syncwarp();
  }

  // S = Q K^T: ldmatrix lanes give keys (nt + lane / 16) * 8 + lane % 8, columns kc * 16 + 8 (lane / 8 % 2)
  const uint32_t ak = smem_u32(sk), av = smem_u32(sv);
  float sc[CHUNK / 8][4];
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t a[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
#pragma unroll
    for (int nt = 0; nt < CHUNK / 8; nt += 2) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ak + (((nt + (lane >> 4)) * 8 + (lane & 7)) * LDS + kc * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(sc[nt], a, kf[0], kf[1]);
      mma_bf16(sc[nt + 1], a, kf[2], kf[3]);
    }
  }

  // head g's softmax over slots nt * 8 + 2t + e: the k scale, -1e30 where the bit is clear, the max,
  // p and its fp32 sum; then p times the v scale in bf16 as the A operand of P V (rows 8-15 zero)
  float x[CHUNK / 8][2];
  float m = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sl = nt * 8 + 2 * t + e;
      float logit = sc[nt][e];
      if (QUANT) logit *= __shfl_sync(0xffffffffu, ks, sl);
      x[nt][e] = (bits >> sl) & 1 ? logit * scale : NEG;
      m = fmaxf(m, x[nt][e]);
    }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float l = 0.f;
  uint32_t pa[CHUNK / 16][4];
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    float pr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pr[e] = __expf(x[nt][e] - m);
      l += pr[e];
      if (QUANT) pr[e] *= __shfl_sync(0xffffffffu, vs, nt * 8 + 2 * t + e);
    }
    pa[nt / 2][(nt & 1) * 2] = pack_bf16(pr[0], pr[1]);
    pa[nt / 2][(nt & 1) * 2 + 1] = 0u;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // O = P V: ldmatrix.trans lanes give slots kc * 16 + 8 (lane / 8 % 2) + lane % 8, columns (nt + lane / 16) * 8
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < CHUNK / 16; ++kc)
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, av + ((kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (nt + (lane >> 4)) * 8) * 2);
      mma_bf16(o[nt], pa[kc], vf[0], vf[1]);
      mma_bf16(o[nt + 1], pa[kc], vf[2], vf[3]);
    }

  if (g < G) {
    if (t == 0) {
      pm[part * G + g] = m;
      pl[part * G + g] = l;
    }
    float* acc = pacc + (part * G + g) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) *reinterpret_cast<float2*>(acc + nt * 8) = make_float2(o[nt][0], o[nt][1]);
  }
}

// The block's max (IS_MAX) or sum of x, in a fixed order; red holds D / 32 floats.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = IS_MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) x = IS_MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red may be written again
  return x;
}

// grid (B * KVH * G), D threads, 2 n_chunks words of dynamic shared memory: merge the chunks' partials
// into o (B, KVH * G, 1, D) bf16. A row with no valid slot at all gets what the TPU kernel gives it:
// every logit is -1e30, so every p is 1 and the output is the plain average of all S value rows
// (times their v scales).
template <bool QUANT>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ pacc,
                      const void* __restrict__ v, const float* __restrict__ v_scale, bf16* __restrict__ o, int G,
                      int n_chunks, int S) {
  extern __shared__ float w[];  // chunk i's max, then its weight exp(m_i - M) (0 for an empty chunk)
  int* busy = reinterpret_cast<int*>(w + n_chunks);  // the chunks with a valid slot, in order
  __shared__ float red[D / 32];
  __shared__ int counts[D / 32];
  const int rh = blockIdx.x;  // (b * KVH + kvh) * G + h
  const int rowi = rh / G;
  const int h = rh % G;
  const int c = threadIdx.x;
  const int warp = c / 32, lane = c % 32;
  auto at = [&](int i) { return ((size_t)rowi * n_chunks + i) * G + h; };
  // every chunk's max at once (-inf for an empty one), the row's largest M, the weights and L
  float M = -INFINITY;
  for (int i = c; i < n_chunks; i += D) {
    w[i] = pl[at(i)] > 0.f ? pm[at(i)] : -INFINITY;
    M = fmaxf(M, w[i]);
  }
  M = block_reduce<true>(M, red);
  float L = 0.f;
  for (int i = c; i < n_chunks; i += D) {
    w[i] = w[i] == -INFINITY ? 0.f : __expf(w[i] - M);
    L += w[i] * pl[at(i)];
  }
  L = block_reduce<false>(L, red);  // its barriers also publish w
  // the busy chunks' indices in order (a ballot per warp and D chunks per round), so that the sum
  // below issues its loads back to back instead of one behind each branch
  int n_busy = 0;
  for (int base = 0; base < n_chunks; base += D) {
    const bool on = base + c < n_chunks && w[base + c] > 0.f;
    const uint32_t ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int offset = n_busy;
    for (int x = 0; x < warp; ++x) offset += counts[x];
    if (on) busy[offset + __popc(ballot & ((1u << lane) - 1))] = base + c;
    for (int x = 0; x < D / 32; ++x) n_busy += counts[x];
    __syncthreads();
  }
  float A = 0.f;
  if (M != -INFINITY) {
#pragma unroll 8
    for (int j = 0; j < n_busy; ++j) A += w[busy[j]] * pacc[at(busy[j]) * D + c];
  } else {  // all-clear bitmap: the uniform average (rare; one pass over the row's values)
    for (int s = 0; s < S; ++s) {
      const size_t off = (size_t)rowi * S + s;
      if constexpr (QUANT) {
        A += (float)static_cast<const int8_t*>(v)[off * D + c] * v_scale[off];
      } else {
        A += __bfloat162float(static_cast<const bf16*>(v)[off * D + c]);
      }
    }
    L = (float)S;
  }
  o[(size_t)rh * D + c] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}

template <int G>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const uint8_t* mask, float* ws, void* o, int B, int KVH, int S, int quant,
                   float scale, cudaStream_t stream) {
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  const size_t combine_smem = (size_t)n_chunks * 2 * sizeof(float);
  if (combine_smem > 48 * 1024) return cudaErrorInvalidValue;
  const int rows = B * KVH;
  float* pm = ws;
  float* pl = pm + (size_t)rows * n_chunks * G;
  float* pacc = pl + (size_t)rows * n_chunks * G;
  const dim3 grid(n_chunks, rows);
  auto qp = static_cast<const bf16*>(q);
  auto op = static_cast<bf16*>(o);
  if (quant) {
    decode_partial_kernel<G, true><<<grid, 32, 0, stream>>>(qp, k, v, ks, vs, mask, pm, pl, pacc, KVH, S, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<true><<<rows * G, D, combine_smem, stream>>>(pm, pl, pacc, v, vs, op, G, n_chunks, S);
  } else {
    decode_partial_kernel<G, false><<<grid, 32, 0, stream>>>(qp, k, v, ks, vs, mask, pm, pl, pacc, KVH, S, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<false><<<rows * G, D, combine_smem, stream>>>(pm, pl, pacc, v, vs, op, G, n_chunks, S);
  }
  return cudaGetLastError();
}

}  // namespace

// Workspace floats needed by hicom_flash_decode.
extern "C" long long hicom_decode_workspace(int B, int KVH, int G, int S) {
  const long long n_chunks = (S + CHUNK - 1) / CHUNK;
  return (long long)B * KVH * n_chunks * G * (2 + D);
}

// q (B, KVH * G, 1, D) bf16; k/v (B, KVH, S, D) bf16 (quant = 0) or int8 (quant = 1);
// k_scale/v_scale (B, KVH, S) fp32 (int8 only, else null); slot_mask (B, S) uint8;
// ws fp32 workspace of hicom_decode_workspace floats; o (B, KVH * G, 1, D) bf16.
extern "C" int hicom_flash_decode(const void* q, const void* k, const void* v, const float* k_scale,
                                  const float* v_scale, const uint8_t* slot_mask, float* ws, void* o,
                                  int B, int KVH, int G, int S, int d, int quant, float scale,
                                  void* stream) {
  if (d != D || S <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return (int)launch<1>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    case 2: return (int)launch<2>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    case 4: return (int)launch<4>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    case 6: return (int)launch<6>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    case 7: return (int)launch<7>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    case 8: return (int)launch<8>(q, k, v, k_scale, v_scale, slot_mask, ws, o, B, KVH, S, quant, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
