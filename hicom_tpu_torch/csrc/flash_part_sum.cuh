// The split path's second pass of the flash backward (flash_bwd.cu, flash_bwd_f32.cu): the fp32 partials of
// n_split chunks (K5's dQ over key chunks, K6's dK and dV over ranges of its units) summed in split order,
// scaled, and written in the caller's type (bf16 or fp32) with no other rounding.
#pragma once

#include "hopper.cuh"

namespace {

// out[y] (n) = scale[y] * sum over the chunks of part[y] (n_split, n), for the y = blockIdx.y outputs.
template <typename OutT>
struct PartSum {
  const float* part[2];
  OutT* out[2];
  float scale[2];
};

// One thread per 4 elements; n % 4 == 0. The chunks are added in split order: the same result on every run.
template <typename OutT>
__global__ void part_sum_kernel(const PartSum<OutT> a, int n_split, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float* part = a.part[blockIdx.y];
  const float scale = a.scale[blockIdx.y];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(a.out[blockIdx.y] + i, make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale));
}

template <typename OutT>
cudaError_t part_sum(const PartSum<OutT>& a, int outputs, int n_split, size_t n, cudaStream_t stream) {
  const size_t threads = n / 4;
  part_sum_kernel<OutT><<<dim3((unsigned)((threads + 127) / 128), outputs), 128, 0, stream>>>(a, n_split, n);
  return cudaGetLastError();
}

}  // namespace
