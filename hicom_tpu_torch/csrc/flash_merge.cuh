// The split path's second pass of the flash forward (flash_fwd.cu, flash_fwd_f32.cu): the fp32 partials
// of n_split key chunks merged into the output in the caller's type (bf16 or fp32) and the fp32 lse.
#pragma once

#include "hopper.cuh"

namespace {

// One warp per row: the chunks' largest max M and denominator sum L = sum_s w_s l_s with w_s = exp(m_s - M)
// (a chunk with max -inf weighs 0), then each lane sums 4 columns, out = sum_s w_s o_s / max(L, 1e-30) in
// split order, stored as OutT with no other rounding; lse = M + log max(L, 1e-30).
template <typename OutT>
__global__ void flash_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                                   const float* __restrict__ l_part, OutT* __restrict__ o, float* __restrict__ lse,
                                   int n_split, int rows, int d) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  auto weight = [&](int s, float M) {
    const float ms = m_part[(size_t)s * rows + r];
    return ms == -INFINITY ? 0.f : __expf(ms - M);
  };
  float M = -INFINITY;
  for (int s = lane; s < n_split; s += 32) M = fmaxf(M, m_part[(size_t)s * rows + r]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
  float L = 0.f;
  for (int s = lane; s < n_split; s += 32) L += weight(s, M) * l_part[(size_t)s * rows + r];
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) L += __shfl_xor_sync(0xffffffffu, L, x);
  const float denom = fmaxf(L, 1e-30f);
  const float inv = 1.f / denom;
  for (int c = lane * 4; c < d; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = weight(s, M);
      const float4 x = *reinterpret_cast<const float4*>(o_part + ((size_t)s * rows + r) * d + c);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    store4(o + (size_t)r * d + c, make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  if (lane == 0) lse[r] = M + logf(denom);
}

template <typename OutT>
cudaError_t merge(const float* o_part, const float* m_part, const float* l_part, OutT* o, float* lse, int n_split,
                  int rows, int d, cudaStream_t stream) {
  flash_merge_kernel<OutT><<<(rows + 3) / 4, 128, 0, stream>>>(o_part, m_part, l_part, o, lse, n_split, rows, d);
  return cudaGetLastError();
}

}  // namespace
