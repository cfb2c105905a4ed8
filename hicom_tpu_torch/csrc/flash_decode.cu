// One-token decode attention over a bf16 or int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hicom_tpu/ops/flash_decode.py:_decode_kernel (K3): each of
// the g = H / KVH query heads sharing a kv head attends over the cache slots its bitmap allows.
// With an int8 cache the per-slot scales multiply the logits (k_scale) and multiply p for the
// accumulator only (v_scale), not the denominator, exactly as the TPU kernel does.
//
// What bounds it on the H100: bytes. One decode step reads each valid cache slot once
// (2 * d * 2 bytes in bf16, 2 * d bytes + 8 bytes of scales in int8) and does 4 * g * d flops per
// slot, far below the card's 295 flops per byte. At b = 1 there are only KVH = 4 (batch, kv head)
// rows, so one block per row would leave 128 of 132 SMs idle. The design splits the slot axis
// (flash-decoding): blocks of 128 slots each produce a partial (max, denominator, accumulator)
// per head in fp32, and a second small kernel merges the partials. Slots whose bit is clear are
// skipped without reading K/V; a masked slot contributes exp(-1e30 - m) = 0 in the TPU kernel too.
// A row with no valid slot at all has every logit at -1e30 there, hence the uniform average of
// its values: the merge kernel computes that average for such a row. Inside a block each warp
// walks its own slots with lanes split over d and keeps an online softmax in registers; the four
// warps merge through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int NWARPS = 4;
constexpr int CHUNK = 128;  // slots per block
constexpr int PER_LANE = D / 32;

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* x) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

__device__ __forceinline__ void load_row(const int8_t* p, float* x) {
  char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = (float)c.x;
  x[1] = (float)c.y;
  x[2] = (float)c.z;
  x[3] = (float)c.w;
}

// grid (B * KVH, n_chunks); partial outputs pm/pl (rows, n_chunks, G), pacc (rows, n_chunks, G, D)
template <int G, typename KV, bool QUANT>
__global__ void __launch_bounds__(NWARPS * 32)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const uint8_t* __restrict__ slot_mask,
                      float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
                      int KVH, int S, float scale) {
  __shared__ float sm[NWARPS][G];
  __shared__ float sl[NWARPS][G];
  __shared__ float sacc[NWARPS][G][D];

  const int rowi = blockIdx.x;  // b * KVH + kvh
  const int b = rowi / KVH;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = lane * PER_LANE;

  float qf[G][PER_LANE];
#pragma unroll
  for (int h = 0; h < G; ++h) load_row(q + ((size_t)rowi * G + h) * D + c0, qf[h]);

  float m[G], l[G], acc[G][PER_LANE];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) acc[h][e] = 0.f;
  }

  const uint8_t* mrow = slot_mask + (size_t)b * S;
  const int s_end = min(S, (chunk + 1) * CHUNK);
  for (int s = chunk * CHUNK + warp; s < s_end; s += NWARPS) {
    if (mrow[s] == 0) continue;  // warp-uniform branch
    const size_t off = ((size_t)rowi * S + s) * D + c0;
    float kf[PER_LANE], vf[PER_LANE];
    load_row(k + off, kf);
    load_row(v + off, vf);
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      ks = k_scale[(size_t)rowi * S + s];
      vs = v_scale[(size_t)rowi * S + s];
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) dot += qf[h][e] * kf[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float logit = dot * ks * scale;
      const float m_new = fmaxf(m[h], logit);
      const float alpha = __expf(m[h] - m_new);
      const float p = __expf(logit - m_new);
      l[h] = l[h] * alpha + p;
      const float pv = p * vs;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) acc[h][e] = acc[h][e] * alpha + pv * vf[e];
      m[h] = m_new;
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      sm[warp][h] = m[h];
      sl[warp][h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) sacc[warp][h][c0 + e] = acc[h][e];
  }
  __syncthreads();

  const size_t base = (size_t)rowi * n_chunks + chunk;
  for (int i = threadIdx.x; i < G * D; i += NWARPS * 32) {
    const int h = i / D;
    const int c = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm[w][h]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float f = sm[w][h] == -INFINITY ? 0.f : __expf(sm[w][h] - M);
        L += sl[w][h] * f;
        A += sacc[w][h][c] * f;
      }
    }
    if (M != -INFINITY) pacc[(base * G + h) * D + c] = A;  // an empty chunk is skipped by the merge
    if (c == 0) {
      pm[base * G + h] = M;
      pl[base * G + h] = L;
    }
  }
}

// grid (B * KVH * G), block D: merge the chunks' partials into o (B, KVH * G, 1, D) bf16.
// A row with no valid slot at all gets what the TPU kernel gives it: every logit is -1e30, so
// every p is 1 and the output is the plain average of all S value rows (times their v scales).
template <typename KV, bool QUANT>
__global__ void decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                      const float* __restrict__ pacc, const KV* __restrict__ v,
                                      const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ o,
                                      int G, int n_chunks, int S) {
  const int rh = blockIdx.x;  // (b * KVH + kvh) * G + h
  const int rowi = rh / G;
  const int h = rh % G;
  const int c = threadIdx.x;
  float M = -INFINITY;
  for (int i = 0; i < n_chunks; ++i) {
    const size_t idx = ((size_t)rowi * n_chunks + i) * G + h;
    if (pl[idx] > 0.f) M = fmaxf(M, pm[idx]);
  }
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int i = 0; i < n_chunks; ++i) {
      const size_t idx = ((size_t)rowi * n_chunks + i) * G + h;
      if (pl[idx] > 0.f) {
        const float f = __expf(pm[idx] - M);
        L += pl[idx] * f;
        A += pacc[idx * D + c] * f;
      }
    }
  } else {  // all-clear bitmap: the uniform average (rare; one pass over the row's values)
    for (int s = 0; s < S; ++s) {
      const size_t off = (size_t)rowi * S + s;
      float x;
      if constexpr (QUANT) {
        x = (float)v[off * D + c] * v_scale[off];
      } else {
        x = __bfloat162float(v[off * D + c]);
      }
      A += x;
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
  const int rows = B * KVH;
  float* pm = ws;
  float* pl = pm + (size_t)rows * n_chunks * G;
  float* pacc = pl + (size_t)rows * n_chunks * G;
  dim3 grid(rows, n_chunks);
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto op = static_cast<__nv_bfloat16*>(o);
  if (quant) {
    auto vp = static_cast<const int8_t*>(v);
    decode_partial_kernel<G, int8_t, true><<<grid, NWARPS * 32, 0, stream>>>(
        qp, static_cast<const int8_t*>(k), vp, ks, vs, mask, pm, pl, pacc, KVH, S, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<int8_t, true><<<rows * G, D, 0, stream>>>(pm, pl, pacc, vp, vs, op, G, n_chunks, S);
  } else {
    auto vp = static_cast<const __nv_bfloat16*>(v);
    decode_partial_kernel<G, __nv_bfloat16, false><<<grid, NWARPS * 32, 0, stream>>>(
        qp, static_cast<const __nv_bfloat16*>(k), vp, ks, vs, mask, pm, pl, pacc, KVH, S, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<__nv_bfloat16, false><<<rows * G, D, 0, stream>>>(pm, pl, pacc, vp, vs, op, G,
                                                                           n_chunks, S);
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
