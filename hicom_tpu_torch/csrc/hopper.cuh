// Building blocks shared by the kernels for Hopper (sm_90a) in this directory: cp.async, ldmatrix and
// mma.sync fragments (flash_bwd.cu's K5, flash_decode.cu), and mbarriers, TMA tile loads, wgmma
// descriptors and products with the shared-memory tile layout they agree on (flash_fwd.cu, K6).
//
// Tile layout: a tile of R rows and DP (padded d) bf16 columns holds NB = DP / 64 boxes of 64 columns,
// R rows of 128 B each in the 128-byte swizzle (8-row atoms of 1 KB), then the TAIL = DP % 64 columns
// past them as 16-byte chunks of R rows without swizzle (d 72: one box, the chunk of columns 64-71 and
// a chunk of zeros for 72-79). TMA writes both forms; rows past the tensor's extent arrive as zeros.
// Tiles start on 1 KB boundaries.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through cudaGetDriverEntryPointByVersion
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 16 bytes from device to shared memory, asynchronously; zeros when !in (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Four 8 x 8 bf16 matrices from shared memory; lanes 8j..8j+7 give the row addresses of matrix j,
// and r[j] is this lane's mma fragment of it (transposed with ldmatrix_x4_trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of TMA transactions before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@!done bra WAIT;\n}\n" ::"r"(
          bar),
      "r"(parity)
      : "memory");
}
// A TMA box of a 3-D tensor map (columns, rows, heads) to shared memory at dst, completing on the
// barrier. Rows and columns past the map's extent arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// This thread's finished generic-proxy writes to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from reading or writing accumulators between a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: the start address, and the byte offsets between 8-row core matrices
// along K (leading) and along M or N (stride), each in 16-byte units; SW128 marks the 128-byte
// swizzle (rows of 128 B, 8-row atoms of 1 KB), else no swizzle (8 x 16-byte core matrices).
constexpr uint64_t SW128 = 1ull << 62;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N fp32, the warpgroup's accumulator) = a (64 x 16 bf16, registers) * b (16 x N bf16,
// shared memory; K-major when TRANS_B = 0, MN-major when 1) + (scale_d ? d : 0).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N not instantiated");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
}

// d (64 x 64 fp32) = a (64 x 16 bf16, K-major in shared memory) * b (16 x 64 bf16, K-major in shared
// memory) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The tile layout at padded width DP (see the header comment). tail_loaded is the number of tail
// chunks that hold columns below d; the rest are zeros the kernel writes once.
template <int DP>
struct Tile {
  static constexpr int NB = DP / 64;
  static constexpr int TAIL = DP % 64;
  // TMA copies of a tile of R rows starting at row r0 of head hd, completing on barrier
  static __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* sw, const CUtensorMap* narrow, int R,
                                              int r0, int hd, uint32_t barrier, int tail_loaded) {
    for (int bx = 0; bx < NB; ++bx) tma_load(dst + bx * R * 128, sw, bx * 64, r0, hd, barrier);
    for (int c = 0; c < tail_loaded; ++c)
      tma_load(dst + NB * R * 128 + c * R * 16, narrow, NB * 64 + c * 8, r0, hd, barrier);
  }
  static __device__ __forceinline__ uint32_t bytes(int R, int tail_loaded) {
    return NB * R * 128 + tail_loaded * R * 16;
  }
  // K-major operand descriptor for columns kc * 16 .. + 15 of rows row0 .. of a tile of R rows
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int R, int row0, int kc) {
    if (kc < NB * 4) return make_desc(base + (kc / 4) * R * 128 + row0 * 128 + (kc % 4) * 32, 16, 1024) | SW128;
    return make_desc(base + NB * R * 128 + (kc * 2 - NB * 8) * R * 16 + row0 * 16, R * 16, 128);
  }
  // acc (64 x DP) += a (64 x 16, registers) * rows kc * 16 .. + 15 of a tile of R rows read as an
  // MN-major B: in a box, rows 128 B apart in 8-row atoms of 1 KB; in the tail, 8-row groups 128 B
  // apart and 8-column chunks R * 16 B apart
  static __device__ __forceinline__ void rs_mn(float* acc, const uint32_t* a, uint32_t base, int R, int kc) {
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
      wgmma_rs<64, 1>(acc + bx * 32, a, make_desc(base + bx * R * 128 + kc * 2048, R * 128, 1024) | SW128, 1);
    if constexpr (TAIL > 0) wgmma_rs<TAIL, 1>(acc + NB * 32, a, make_desc(base + NB * R * 128 + kc * 256, 128, R * 16), 1);
  }
  // zero the tail chunks past d (columns 72-79 at d 72) of the tile at base; thread idx of n threads
  static __device__ __forceinline__ void zero_pad(uint32_t base, int R, int tail_loaded, int idx, int n) {
    const int npad = TAIL / 8 - tail_loaded;
    for (int i = idx; i < npad * R; i += n) {
      const uint32_t at = base + NB * R * 128 + (tail_loaded + i % npad) * R * 16 + (i / npad) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0u) : "memory");
    }
  }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// (heads, rows, d) bf16 at base as a 3-D TMA map: columns, rows, heads; boxes of box_cols columns x
// box_rows rows, with the 128-byte swizzle when box_cols is 64. Rows past the extent arrive as zeros.
cudaError_t tile_map(CUtensorMap* map, const void* base, int d, int rows, int heads, int box_cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The swizzled map (64-column boxes) and the narrow map (8-column boxes, for the columns past the last
// whole box) of one (heads, rows, d) tensor, with box_rows rows per box; either is left unset when the
// width has no columns for it.
cudaError_t tile_maps(CUtensorMap* sw, CUtensorMap* narrow, const void* base, int d, int rows, int heads, int box_rows) {
  const int boxes = (d + 15) / 16 * 16 / 64;
  cudaError_t err = cudaSuccess;
  if (boxes > 0) err = tile_map(sw, base, d, rows, heads, 64, box_rows);
  if (err == cudaSuccess && d > boxes * 64) err = tile_map(narrow, base, d, rows, heads, 8, box_rows);
  return err;
}

}  // namespace
