// Tile attention of the local compressor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hicom_tpu/ops/local_attn.py:_tile_attn_kernel (K4): one query per
// (kt, kh, kw) tile of a (t, h, w, d) volume attends over the K = kt * kh * kw keys of its tile: fp32
// logits times scale plus bias, fp32 softmax, p rounded to bf16, fp32 weighted sum, output rounded to bf16.
// The fp32 instance (JAX's kernel is dtype-generic) reads and writes fp32 rows and rounds nothing: the same
// code on the element type T, a 16-byte chunk holding 8 bf16 or 4 floats.
//
// What bounds it on the H100: bytes. The tiles partition the volumes, so each key and value row is read
// once, and the arithmetic is about 2 flops per byte: tensor cores cannot help. What the kernel has to do
// is keep enough bytes in flight (at 3.35 TB/s and about a microsecond of latency, some 25 KB per SM),
// read nothing twice, and keep its compute off the loads' critical path.
//
// Design. For each (it, ih) of a tile, its kw keys (and values) are one contiguous segment of kw * d
// elements, so a tile is its query row, kt * kh key segments and kt * kh value segments: 1-D bulk copies
// (cp.async.bulk) with no tensor map, straight from the volumes (no retiled copy). Persistent blocks, one
// per SM, walk the tiles blockIdx.x, + gridDim.x, ...: the SMs' counts differ by at most one tile. Each
// block has three roles:
// - one producer thread streams the items of its tiles, in order, into a ring of slots in shared memory,
//   each with a full and an empty mbarrier; the ring runs on from one tile's value segments into the next
//   tile's query and keys, so the next tile's loads are in flight while this one computes;
// - the key warps take the query row and the key segments: each thread owns 16-byte chunks (8 columns)
//   of a row, a segment's rows are loaded together and yield kw partial dot products per thread, summed
//   across the warp by a transposed shuffle reduction and left per warp in shared memory;
// - the value warps each sum the key warps' partials in warp order and compute the softmax (K <= 64
//   logits, two per lane, p rounded to bf16), fold the value segments into fp32 accumulators of their 8
//   columns in tile order (it, ih, iw), and store the output row in 16-byte stores.
// The key warps work on the next tile while the value warps fold this one. What limits the kernel is
// the consumer warps' instructions, not the loads (PERF.md has the ablations): with one chain of loads,
// reductions and folds per warp, the kernel took 70.6 us at the b 1 shape where its copies alone took 40.0.
// No atomics: the result does not depend on timing. scale and bias come by value, or from device memory
// (the clip-scale path's exp(logit_scale)), so no call needs a host sync.
#include "hopper.cuh"

namespace {

constexpr int MAX_K = 64;
constexpr int MAX_WARPS = 8;          // warps of each of the key and value roles
constexpr int MAX_CHUNKS = 4;         // 16-byte chunks per thread: d <= 8 * 32 * 4 chunks (8192 bf16, 4096 fp32)
constexpr int MAX_SLOTS = 32;
constexpr int RING_BYTES = 210 * 1024;  // of the SM's 228 KB, less the barriers and red
constexpr int MAX_SEGMENT_BYTES = 49152;  // kw rows of d elements, one slot (48 KB): at least 4 slots
constexpr int ROWS = 4;               // key rows of a segment reduced together

template <typename T>
struct Params {
  const T* q;      // (tiles, qk)
  const T* key;    // (t, h, w, qk)
  const T* value;  // (t, h, w, dv)
  T* out;          // (tiles, dv)
  const float* scale_p;  // device scalars, or null for the values below
  const float* bias_p;
  float scale, bias;
  int h, w, qk, dv, kt, kh, kw;
  int tiles, slots, slot_bytes, warps;
};

// bytes (a multiple of 16) from device memory at src to shared memory at dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// elements of T in a 16-byte chunk
template <typename T>
__host__ __device__ constexpr int per_chunk() { return 16 / (int)sizeof(T); }

// A 16-byte chunk of shared memory (one 16-byte load: read through a reference, the chunk would be four
// 4-byte loads with 4-way bank conflicts between lanes 16 bytes apart) as floats: 8 bf16 or 4 floats.
__device__ __forceinline__ void unpack(const unsigned char* chunk, float* f, const bf16*) {
  const uint4 v = *reinterpret_cast<const uint4*>(chunk);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const unsigned char* chunk, float* f, const float*) {
  const float4 v = *reinterpret_cast<const float4*>(chunk);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

// the output chunk of 8 bf16 or 4 floats from its fp32 accumulators, stored as is (16 bytes)
__device__ __forceinline__ void store_chunk(bf16* out, const float* acc) {
  uint4 o;
  o.x = pack_bf16(acc[0], acc[1]);
  o.y = pack_bf16(acc[2], acc[3]);
  o.z = pack_bf16(acc[4], acc[5]);
  o.w = pack_bf16(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(out) = o;
}
__device__ __forceinline__ void store_chunk(float* out, const float* acc) {
  *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// p as the TPU kernel has it before the weighted sum: rounded to the values' type
__device__ __forceinline__ float round_p(float x, const bf16*) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float round_p(float x, const float*) { return x; }

// part[r] += qc . (chunk c of row r), rows 0 .. R - 1 of a segment; the R loads go out together
template <typename T, int R>
__device__ __forceinline__ void dot_rows(const unsigned char* rows, int row_bytes, int c, const float* qc,
                                         float* part) {
  constexpr int E = per_chunk<T>();
  float k[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) unpack(rows + (size_t)r * row_bytes + c * 16, k[r], (const T*)nullptr);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) part[r] = fmaf(qc[e], k[r][e], part[r]);
}

// acc += pr[r] * (chunk c of row r), rows 0 .. R - 1 in order
template <typename T, int R>
__device__ __forceinline__ void fold_rows(const unsigned char* rows, int row_bytes, int c, const float* pr,
                                          float* acc) {
  constexpr int E = per_chunk<T>();
  float v[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) unpack(rows + (size_t)r * row_bytes + c * 16, v[r], (const T*)nullptr);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(pr[r], v[r][e], acc[e]);
}

// One role's place in the ring: the slot of its next item and the parity of that slot's current round.
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int items, int slots) {
    for (slot += items; slot >= slots; slot -= slots) phase ^= 1;
  }
};

// The sum over the warp's lanes of part[0..3], row r's total on lane 8r: a transposed reduction, 6
// shuffles where one tree per row would take 20. Each lane first keeps half of the rows and sends the
// other half across (xor 16), then one of its two (xor 8), then sums its row over the remaining lanes.
__device__ __forceinline__ float reduce_rows4(const float* part, int lane) {
  const bool hi = lane & 16;
  const float a0 = (hi ? part[2] : part[0]) + __shfl_xor_sync(0xffffffffu, hi ? part[0] : part[2], 16);
  const float a1 = (hi ? part[3] : part[1]) + __shfl_xor_sync(0xffffffffu, hi ? part[1] : part[3], 16);
  const bool odd = lane & 8;
  float b = (odd ? a1 : a0) + __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) b += __shfl_xor_sync(0xffffffffu, b, o);
  return b;
}

template <typename T>
__global__ void __launch_bounds__((2 * MAX_WARPS + 1) * 32, 1) tile_attn_kernel(const Params<T> p) {
  constexpr int E = per_chunk<T>();
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = p.slots;
  const int ncw = p.warps;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)S * p.slot_bytes);
  uint64_t* empty = full + S;
  uint64_t* logits_ready = empty + S;  // [2]: every key warp's logit partials of a tile are in red
  uint64_t* red_free = logits_ready + 2;  // [2]: every value warp has read them
  float* red = reinterpret_cast<float*>(red_free + 2);  // [2][MAX_WARPS][MAX_K]: the key warps' logit partials
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), ncw);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(logits_ready + b), ncw);
      mbar_init(smem_u32(red_free + b), ncw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int h1 = p.h / p.kh;
  const int w1 = p.w / p.kw;
  const int nseg = p.kt * p.kh;
  const int K = nseg * p.kw;
  const int nc = ncw * 32;

  if (warp == 2 * ncw) {  // the producer: per tile its query row, key segments, value segments
    if (lane != 0) return;
    RingPos at;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int c = tile % w1;
      const int bb = (tile / w1) % h1;
      const int a = tile / (w1 * h1);
      for (int item = 0; item <= 2 * nseg; ++item, at.advance(1, S)) {
        const T* src = p.q + (size_t)tile * p.qk;
        uint32_t bytes = p.qk * ES;
        if (item > 0) {
          const int seg = (item - 1) % nseg;  // (it, ih) = (seg / kh, seg % kh)
          const size_t pos = ((size_t)(a * p.kt + seg / p.kh) * p.h + (bb * p.kh + seg % p.kh)) * p.w + c * p.kw;
          const bool is_value = item > nseg;
          src = is_value ? p.value + pos * p.dv : p.key + pos * p.qk;
          bytes = p.kw * (is_value ? p.dv : p.qk) * ES;
        }
        mbar_wait(smem_u32(empty + at.slot), at.phase ^ 1);  // the slot's last item was released
        mbar_expect_tx(smem_u32(full + at.slot), bytes);
        bulk_load(smem_u32(smem + (size_t)at.slot * p.slot_bytes), src, bytes, smem_u32(full + at.slot));
      }
    }
    return;
  }

  auto wait_item = [&](const RingPos& at) {
    mbar_wait(smem_u32(full + at.slot), at.phase);
    return static_cast<const unsigned char*>(smem + (size_t)at.slot * p.slot_bytes);
  };
  auto release_item = [&](RingPos& at) {  // one arrival per warp of the role that read the item
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + at.slot));
    at.advance(1, S);
  };

  if (warp < ncw) {  // the key warps: thread ct owns the 16-byte chunks ct, ct + nc, ... of a row
    const int ct = threadIdx.x;
    const int nck = p.qk / E;
    RingPos at;
    for (int tile = blockIdx.x, it = 0; tile < p.tiles; tile += gridDim.x, ++it) {
      const unsigned char* row = wait_item(at);
      float qf[MAX_CHUNKS][E];
#pragma unroll
      for (int i = 0; i < MAX_CHUNKS; ++i) {
        const int c = ct + i * nc;
        if (c < nck) {
          unpack(row + c * 16, qf[i], (const T*)nullptr);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) qf[i][e] = 0.f;
        }
      }
      release_item(at);

      const int b = it & 1;
      float* red_t = red + b * MAX_WARPS * MAX_K;
      mbar_wait(smem_u32(red_free + b), ((it >> 1) & 1) ^ 1);  // the value warps have read tile it - 2's
      for (int seg = 0; seg < nseg; ++seg) {
        const unsigned char* rows = wait_item(at);
        for (int r0 = 0; r0 < p.kw; r0 += ROWS) {
          const int nr = p.kw - r0 < ROWS ? p.kw - r0 : ROWS;
          const unsigned char* seg_rows = rows + (size_t)r0 * p.qk * ES;
          float part[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) part[r] = 0.f;
#pragma unroll
          for (int i = 0; i < MAX_CHUNKS; ++i) {
            const int c = ct + i * nc;
            if (c < nck) {
              switch (nr) {
                case 1: dot_rows<T, 1>(seg_rows, p.qk * ES, c, qf[i], part); break;
                case 2: dot_rows<T, 2>(seg_rows, p.qk * ES, c, qf[i], part); break;
                case 3: dot_rows<T, 3>(seg_rows, p.qk * ES, c, qf[i], part); break;
                default: dot_rows<T, 4>(seg_rows, p.qk * ES, c, qf[i], part); break;
              }
            }
          }
          const float total = reduce_rows4(part, lane);
          if (lane % 8 == 0 && lane / 8 < nr) red_t[warp * MAX_K + seg * p.kw + r0 + lane / 8] = total;
        }
        release_item(at);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(logits_ready + b));
      at.advance(nseg, S);  // the value segments
    }
    return;
  }

  // the value warps: the softmax of each tile (in every warp), then the weighted sum of its values
  const int ct = threadIdx.x - nc;
  const int ncv = p.dv / E;
  const float scale = p.scale_p != nullptr ? *p.scale_p : p.scale;
  const float bias = p.bias_p != nullptr ? *p.bias_p : p.bias;
  RingPos at;
  for (int tile = blockIdx.x, it = 0; tile < p.tiles; tile += gridDim.x, ++it) {
    at.advance(1 + nseg, S);  // the query row and the key segments
    const int b = it & 1;
    const float* red_t = red + b * MAX_WARPS * MAX_K;
    mbar_wait(smem_u32(logits_ready + b), (it >> 1) & 1);
    // logit j on lane j % 32: the key warps' partials summed in warp order; p rounded to the values' type
    // as the TPU kernel rounds it
    float l0 = -INFINITY, l1 = -INFINITY;
    if (lane < K) {
      float s = 0.f;
      for (int wi = 0; wi < ncw; ++wi) s += red_t[wi * MAX_K + lane];
      l0 = s * scale + bias;
    }
    if (lane + 32 < K) {
      float s = 0.f;
      for (int wi = 0; wi < ncw; ++wi) s += red_t[wi * MAX_K + lane + 32];
      l1 = s * scale + bias;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(red_free + b));
    float m = fmaxf(l0, l1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = lane < K ? expf(l0 - m) : 0.f;
    const float e1 = lane + 32 < K ? expf(l1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p0 = round_p(e0 / sum, (const T*)nullptr);
    const float p1 = round_p(e1 / sum, (const T*)nullptr);

    float acc[MAX_CHUNKS][E];
#pragma unroll
    for (int i = 0; i < MAX_CHUNKS; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    for (int seg = 0; seg < nseg; ++seg) {
      const unsigned char* rows = wait_item(at);
      for (int r0 = 0; r0 < p.kw; r0 += ROWS) {
        const int nr = p.kw - r0 < ROWS ? p.kw - r0 : ROWS;
        const unsigned char* seg_rows = rows + (size_t)r0 * p.dv * ES;
        float pr[ROWS];  // p of rows r0 .. r0 + 3 (those past the segment unused)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int j = seg * p.kw + r0 + r;
          pr[r] = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
        }
#pragma unroll
        for (int i = 0; i < MAX_CHUNKS; ++i) {
          const int c = ct + i * nc;
          if (c < ncv) {
            switch (nr) {
              case 1: fold_rows<T, 1>(seg_rows, p.dv * ES, c, pr, acc[i]); break;
              case 2: fold_rows<T, 2>(seg_rows, p.dv * ES, c, pr, acc[i]); break;
              case 3: fold_rows<T, 3>(seg_rows, p.dv * ES, c, pr, acc[i]); break;
              default: fold_rows<T, 4>(seg_rows, p.dv * ES, c, pr, acc[i]); break;
            }
          }
        }
      }
      release_item(at);
    }
#pragma unroll
    for (int i = 0; i < MAX_CHUNKS; ++i) {
      const int c = ct + i * nc;
      if (c < ncv) store_chunk(p.out + (size_t)tile * p.dv + c * E, acc[i]);
    }
  }
}

template <typename T>
cudaError_t tile_attention(const void* q, const void* key, const void* value, void* out, const float* scale_p,
                           const float* bias_p, float scale, float bias, int t, int h, int w, int qk, int dv, int kt,
                           int kh, int kw, int sms, cudaStream_t stream) {
  const int d = qk > dv ? qk : dv;
  constexpr int E = per_chunk<T>();
  if (kt <= 0 || kh <= 0 || kw <= 0 || t % kt || h % kh || w % kw || kt * kh * kw > MAX_K || qk <= 0 ||
      dv <= 0 || qk % E || dv % E || d > MAX_WARPS * 32 * MAX_CHUNKS * E ||
      kw * d * (int)sizeof(T) > MAX_SEGMENT_BYTES || sms <= 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(value) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.key = static_cast<const T*>(key);
  p.value = static_cast<const T*>(value);
  p.out = static_cast<T*>(out);
  p.scale_p = scale_p, p.bias_p = bias_p, p.scale = scale, p.bias = bias;
  p.h = h, p.w = w, p.qk = qk, p.dv = dv, p.kt = kt, p.kh = kh, p.kw = kw;
  p.tiles = (t / kt) * (h / kh) * (w / kw);
  if (p.tiles == 0) return cudaSuccess;
  p.slot_bytes = kw * d * (int)sizeof(T);
  p.slots = RING_BYTES / p.slot_bytes < MAX_SLOTS ? RING_BYTES / p.slot_bytes : MAX_SLOTS;
  const int chunks = d / E;
  p.warps = (chunks + 31) / 32 < MAX_WARPS ? (chunks + 31) / 32 : MAX_WARPS;
  const int smem = p.slots * (p.slot_bytes + 16) + 4 * 8 + 2 * MAX_WARPS * MAX_K * 4;
  const cudaError_t err = cudaFuncSetAttribute(tile_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  tile_attn_kernel<T><<<grid, (2 * p.warps + 1) * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (t1, h1, w1, qk), key (t, h, w, qk), value (t, h, w, dv), out (t1, h1, w1, dv): bf16, or fp32 when fp32 is
// nonzero; contiguous, 16-byte aligned. scale and bias: device fp32 scalars at scale_p / bias_p, or (when null)
// the values given. The tile grid divides the volume, K = kt * kh * kw <= 64, qk and dv fill whole 16-byte
// chunks and are at most 8192 bf16 or 4096 fp32, and kw * max(qk, dv) elements fit one 48 KB ring slot. sms:
// the card's SMs, which the persistent grid fills. Returns a CUDA error code (0 when the launch was accepted).
extern "C" int hicom_tile_attention(const void* q, const void* key, const void* value, void* out,
                                    const float* scale_p, const float* bias_p, float scale, float bias, int t,
                                    int h, int w, int qk, int dv, int kt, int kh, int kw, int sms, int fp32,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) return (int)tile_attention<float>(q, key, value, out, scale_p, bias_p, scale, bias, t, h, w, qk, dv, kt,
                                              kh, kw, sms, s);
  return (int)tile_attention<bf16>(q, key, value, out, scale_p, bias_p, scale, bias, t, h, w, qk, dv, kt, kh, kw,
                                   sms, s);
}
