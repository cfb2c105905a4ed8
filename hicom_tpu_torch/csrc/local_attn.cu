// Tile attention of the local compressor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hicom_tpu/ops/local_attn.py:_tile_attn_kernel (K4): one query
// per (kt, kh, kw) tile of a (t, h, w, d) volume attends over the K = kt * kh * kw keys of its
// tile: fp32 logits, fp32 softmax, p rounded to the value dtype, fp32 weighted sum.
//
// What bounds it on the H100: bytes. Each key and value row is read once (the tiles partition
// the volume), and the arithmetic is K dot products plus one K-wide weighted sum per tile, about
// 2 flops per byte. The design reads the tiles straight from the (t, h, w, d) volumes, with no
// retiled copy in device memory: one block per tile, 8 warps; each warp takes whole keys and
// reduces its dot product with shuffles, the K logits and probabilities live in shared memory, and
// the weighted sum walks the value rows with neighbouring threads on neighbouring columns.
// scale and bias are read from device memory, so the clip-scale path (exp(logit_scale) computed
// on the card) needs no host sync.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_K = 64;

__global__ void __launch_bounds__(NTHREADS)
tile_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ key,
                 const __nv_bfloat16* __restrict__ value, const float* __restrict__ scale_p,
                 const float* __restrict__ bias_p, __nv_bfloat16* __restrict__ out,
                 int h, int w, int qk, int dv, int kt, int kh, int kw) {
  __shared__ float sp[MAX_K];
  __shared__ float sprob[MAX_K];
  const int h1 = h / kh;
  const int w1 = w / kw;
  const int tile = blockIdx.x;  // (a, bb, c) over (t1, h1, w1)
  const int c = tile % w1;
  const int bb = (tile / w1) % h1;
  const int a = tile / (w1 * h1);
  const int K = kt * kh * kw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale = *scale_p;
  const float bias = *bias_p;

  const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(q + (size_t)tile * qk);
  for (int j = warp; j < K; j += NTHREADS / 32) {
    // key j of the tile, ordered (t2, h2, w2) as tile_thw orders them
    const int it = j / (kh * kw);
    const int ih = (j / kw) % kh;
    const int iw = j % kw;
    const size_t pos = ((size_t)(a * kt + it) * h + (bb * kh + ih)) * w + (c * kw + iw);
    const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(key + pos * qk);
    float dot = 0.f;
    for (int e = lane; e < qk / 2; e += 32) {
      const float2 kf = __bfloat1622float2(krow[e]);
      const float2 qf = __bfloat1622float2(qrow[e]);
      dot += kf.x * qf.x + kf.y * qf.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) sp[j] = dot * scale + bias;
  }
  __syncthreads();

  // softmax over the K logits (K <= 64), probabilities rounded to bf16 as the TPU kernel does
  if (threadIdx.x < K) {
    float mx = -INFINITY;
    for (int j = 0; j < K; ++j) mx = fmaxf(mx, sp[j]);
    float sum = 0.f;
    for (int j = 0; j < K; ++j) sum += __expf(sp[j] - mx);
    sprob[threadIdx.x] = __bfloat162float(__float2bfloat16(__expf(sp[threadIdx.x] - mx) / sum));
  }
  __syncthreads();

  for (int e = threadIdx.x; e < dv / 2; e += NTHREADS) {
    float2 acc = make_float2(0.f, 0.f);
    for (int j = 0; j < K; ++j) {
      const int it = j / (kh * kw);
      const int ih = (j / kw) % kh;
      const int iw = j % kw;
      const size_t pos = ((size_t)(a * kt + it) * h + (bb * kh + ih)) * w + (c * kw + iw);
      const float p = sprob[j];
      const float2 vf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(value + pos * dv)[e]);
      acc.x += p * vf.x;
      acc.y += p * vf.y;
    }
    reinterpret_cast<__nv_bfloat162*>(out + (size_t)tile * dv)[e] = __float22bfloat162_rn(acc);
  }
}

}  // namespace

// q (t1, h1, w1, qk), key (t, h, w, qk), value (t, h, w, dv) bf16 contiguous; scale/bias one
// fp32 each in device memory; out (t1, h1, w1, dv) bf16. Divisible tiles, K <= 64, qk and dv even.
extern "C" int hicom_tile_attention(const void* q, const void* key, const void* value,
                                    const float* scale, const float* bias, void* out, int t, int h,
                                    int w, int qk, int dv, int kt, int kh, int kw, void* stream) {
  if (t % kt || h % kh || w % kw || kt * kh * kw > MAX_K || qk % 2 || dv % 2)
    return (int)cudaErrorInvalidValue;
  const int tiles = (t / kt) * (h / kh) * (w / kw);
  tile_attn_kernel<<<tiles, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(key),
      static_cast<const __nv_bfloat16*>(value), scale, bias, static_cast<__nv_bfloat16*>(out), h, w,
      qk, dv, kt, kh, kw);
  return (int)cudaGetLastError();
}
