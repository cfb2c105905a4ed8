// Flash attention past head dim 256 in bf16 (K1/K2 forward, K5 and K6 backward): flash_wide.cuh's kernels with
// their products on the tensor cores (mma.sync m16n8k16, fp32 accumulators), each in clusters. The entry points take the
// arguments of hicom_flash_fwd, hicom_flash_bwd_dq and hicom_flash_bwd_dkv (flash_fwd.cu, flash_bwd.cu), for
// d % 8 == 0 past 256.
#include "flash_wide.cuh"

extern "C" int hicom_flash_fwd_wide(const void* q, const void* k, const void* v, const int* kv_lengths, void* o,
                                    float* lse, float* o_part, float* m_part, float* l_part, int B, int H, int KVH,
                                    int Lq, int Lk, int d, int n_split, float scale, float bias, int causal,
                                    void* stream) {
  return wide::forward<bf16>(q, k, v, kv_lengths, o, lse, o_part, m_part, l_part, B, H, KVH, Lq, Lk, d, n_split,
                             scale, bias, causal, stream);
}

extern "C" int hicom_flash_bwd_dq_wide(const void* q, const void* k, const void* v, const int* kv_lengths,
                                       const void* dout, const float* lse, const float* delta, void* dq,
                                       float* dq_part, int B, int H, int KVH, int Lq, int Lk, int d, int n_split,
                                       float scale, float bias, int causal, void* stream) {
  return wide::backward_dq<bf16>(q, k, v, kv_lengths, dout, lse, delta, dq, dq_part, B, H, KVH, Lq, Lk, d, n_split,
                                 scale, bias, causal, stream);
}

extern "C" int hicom_flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const int* kv_lengths,
                                        const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                                        float* dk_part, float* dv_part, int B, int H, int KVH, int Lq, int Lk, int d,
                                        int n_split, float scale, float bias, int causal, void* stream) {
  return wide::backward_dkv<bf16>(q, k, v, kv_lengths, dout, lse, delta, dk, dv, dk_part, dv_part, B, H, KVH, Lq,
                                  Lk, d, n_split, scale, bias, causal, stream);
}

// The largest cluster that this library's kernels launch (wide::max_cluster): sets it to n when n > 0 and
// returns the value before. Tests only.
extern "C" int hicom_flash_wide_max_cluster(int n) {
  const int before = wide::max_cluster;
  if (n > 0) wide::max_cluster = n;
  return before;
}
