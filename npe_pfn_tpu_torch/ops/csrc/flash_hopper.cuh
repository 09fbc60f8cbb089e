// Building blocks of the Hopper (sm_90a) row-attention kernels, shared by
// flash_row_attention.cu and flash_row_attention_bwd.cu: the mbarrier ring,
// the TMA tile loaders and their tensor maps, the wgmma shared-memory
// descriptors and instructions, and register reallocation. Everything is
// inline PTX, so the sources build with plain nvcc in seconds (no CUTLASS,
// no PyTorch headers).
//
// Shared-memory tiles. A tile holds ROWS rows of 128 bf16 (a head of 128) as
// two column halves of 64 elements, [half][ROWS][64]: every row of a half is
// 128 bytes, the width of the 128-byte swizzle, and half 1 starts ROWS * 128
// bytes after half 0. TMA writes each half with the 128-byte swizzle (16-byte
// chunk c of row r lands at chunk c ^ (r % 8)), which is the layout the wgmma
// descriptors below read. Tiles start on 1024-byte boundaries, so the swizzle
// pattern lines up with the row index.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int HD = 128;        // head dim the design serves
constexpr int HALF_COLS = 64;  // bf16 columns per 128-byte swizzle row
constexpr int BOX_ROWS = 64;   // rows per TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// some 10 s (a pipeline fault) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// ---- TMA and bulk copies -----------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ROWS rows (a multiple of 64) of one head of a [B, L, H, 128] tensor, rows
// row0.., into a tile of ROWS rows: two column halves, 64-row boxes. Rows at
// or past L are zero-filled by the TMA unit.
template <int ROWS>
__device__ __forceinline__ void tma_load_rows(unsigned char* tile, const CUtensorMap* map,
                                              uint64_t* bar, int b, int h, int row0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int r = 0; r < ROWS; r += BOX_ROWS) {
      tma_load_4d(tile + half * ROWS * 128 + r * 128, map, bar, half * HALF_COLS, h, row0 + r, b);
    }
  }
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (each in 16-byte units), layout
// type 1 (128-byte swizzle), base offset 0 (tiles are 1024-byte aligned).
//   K-major (rows of the operand along M or N, K contiguous): LBO unused (1),
//   SBO = 1024, the step from one 8-row group to the next; a k16 step inside
//   a half moves the start by 32 bytes.
//   MN-major (K along the rows, M or N contiguous): LBO = the step from one
//   64-column half to the next (ROWS * 128), SBO = 1024, the step from 8 rows
//   of K to the next 8; a k16 step moves the start by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Descriptor of k16 step kk (0..7 over the 128 columns) of a K-major tile.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// Descriptor of k16 step kk (16 rows) of an MN-major tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A and B both in shared memory,
// K-major; D f32 in registers. scale_d = 0 overwrites D, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B both in shared memory,
// K-major; D f32 in registers. scale_d = 0 overwrites D, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// wgmma_ss_n64 or wgmma_ss_n128 by the width N.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 64, "wgmma_ss: N is 64 or 128");
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  }
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]: A in registers (four bf16 pairs a
// thread, the mma.m16n8k16 A fragment of the warp's 16 rows), B in shared
// memory MN-major (the transpose bit set); D f32 in registers.
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Two f32 as one bf16 pair (first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step kk from an m64nN f32 accumulator (columns
// 16kk..16kk+15 become the k index): the accumulator and mma.m16n8k16's A
// fragment share their thread-to-element map, so no data moves between
// threads.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[kk * 8 + 0], acc[kk * 8 + 1]);
  a[1] = pack_bf16(acc[kk * 8 + 2], acc[kk * 8 + 3]);
  a[2] = pack_bf16(acc[kk * 8 + 4], acc[kk * 8 + 5]);
  a[3] = pack_bf16(acc[kk * 8 + 6], acc[kk * 8 + 7]);
}

// ---- warp specialisation ------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Byte offset of element (row, col) in a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int swizzled(int row, int col) {
  return (col >> 6) * ROWS * 128 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// Accumulator fragment of an m64nN wgmma: the thread holds rows r and r + 8
// (r = 16 * warp + lane / 4 within the warpgroup's 64) and, for each 8-column
// block n, columns 8n + 2 * (lane % 4) + {0, 1}: acc[4n + j] is (r, .. + j),
// acc[4n + 2 + j] is (r + 8, .. + j).

// Write a warpgroup's m64n128 f32 accumulator, times the per-row factors
// (f_lo for row r, f_hi for row r + 8), as bf16 into rows row0.. of a
// swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ void stage_acc(unsigned char* tile, const float (&acc)[64], int row0,
                                          float f_lo, float f_hi) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(tile + swizzled<ROWS>(r, c)) =
        pack_bf16(acc[4 * n] * f_lo, acc[4 * n + 1] * f_lo);
    *reinterpret_cast<uint32_t*>(tile + swizzled<ROWS>(r + 8, c)) =
        pack_bf16(acc[4 * n + 2] * f_hi, acc[4 * n + 3] * f_hi);
  }
}

// Copy 64 staged rows (row0.. of a swizzled tile of ROWS rows) to a [L, 128]
// slab of bf16 with row stride `ld` (elements), 16 bytes per thread per step,
// rows from grow0 on, those at or past n_valid skipped. One warpgroup.
template <int ROWS>
__device__ __forceinline__ void store_tile_rows(__nv_bfloat16* dst, long long ld,
                                                const unsigned char* tile, int row0, int grow0,
                                                int n_valid) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = t + i * 128;
    const int r = idx >> 4;
    const int chunk = idx & 15;
    const int half = chunk >> 3;
    const int c8 = chunk & 7;
    if (grow0 + r < n_valid) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          tile + half * ROWS * 128 + (row0 + r) * 128 + ((c8 ^ ((row0 + r) & 7)) << 4));
      *reinterpret_cast<uint4*>(dst + (long long)(grow0 + r) * ld + half * HALF_COLS + c8 * 8) = v;
    }
  }
}

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime: no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, L, H, 128] tensor read through its strides (in
// elements; the last dim contiguous), boxes of 64 columns x 64 rows of one
// (b, h), 128-byte swizzle, zero fill out of bounds. A dim of size 1 gets a
// canonical stride (its stride is never stepped). Returns cudaSuccess or
// cudaErrorInvalidValue.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int L, int H,
                            long long sb, long long sl, long long sh) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t elem = 2;
  cuuint64_t sh_b = H == 1 ? HD * elem : (cuuint64_t)sh * elem;
  cuuint64_t sl_b = L == 1 ? sh_b * H : (cuuint64_t)sl * elem;
  cuuint64_t sb_b = B == 1 ? sl_b * L : (cuuint64_t)sb * elem;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {sh_b, sl_b, sb_b};
  const cuuint32_t box[4] = {HALF_COLS, 1, BOX_ROWS, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
