// Row-axis flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the backward of npe_pfn_tpu/ops/flash_attention.py::
// flash_row_attention_trainable, _trainable_bwd (a plain-XLA lax.scan over
// key blocks on the TPU, no Pallas kernel). Given q, k, v, the key mask, the
// forward's output o and logsumexp lse (flash_row_attention_fwd_lse) and the
// output cotangent dO, it returns dq, dk, dv with the flash recomputation:
//   P  = exp(q k^T * scale - lse)      (0 for masked keys)
//   dV = P^T dO
//   dP = dO v^T
//   dS = P * (dP - delta) * scale,     delta = rowsum(dO * o)
//   dQ = dS k,   dK = dS^T q
// and zero gradients for every batch row with no valid key (the TPU code
// zeroes dO there). The mask gets no gradient.
//
// Three kernels, launched in a row by each entry point, no atomics, so the
// gradients repeat bit for bit from run to run:
//   1. delta_kernel: delta [B, H, Lq] f32, one 16-byte load per lane;
//   2. a dK/dV kernel: a CTA owns a block of keys of one (b, h) and loops
//      over every query tile, with dK and dV accumulated across the loop;
//   3. a dQ kernel: a CTA owns a block of queries of one (b, h) and loops
//      over every key tile, with dQ accumulated across the loop.
// Between them they run seven products per (query, key) pair, where five
// would do (q k^T and dO v^T are recomputed in both kernels): the price of
// no atomics. At the training shape it moves the bound from 0.40 to 0.56 ms.
//
// What bounds it on the card: at the training context shape (B 264, H 2,
// Lq = Lk = 768, hd 128) the five products are 10*B*H*Lq*Lk*hd = 4.0e11
// FLOP against about 0.83 GB of q/k/v/o/dO/dq/dk/dv, above the H100's ~295
// FLOP/byte ridge: tensor-core throughput bounds it. P and dS are rounded to
// bf16 before their products (the TPU code keeps them f32).
//
// Two designs, chosen by the wrapper from dtype and head_dim before the
// launch (ops/flash_attention.py::kernel_design):
//   - wg:: (entry flash_row_attention_bwd_wgmma), bf16 at head_dim 128, the
//     only shape the shipped models train. Warp-specialised: a producer
//     warpgroup loads by TMA (4-D tensor maps over the strided layouts,
//     128-byte swizzle, zero fill past the edges) and bulk copies into a
//     2-stage mbarrier ring; two consumer warpgroups run every product with
//     wgmma and keep every accumulator (S, dP, dK, dV or dQ) in registers.
//     Tiles: 128 owned rows per CTA (64 per consumer warpgroup), 64 streamed
//     rows per stage; one CTA of 384 threads per SM. Described above
//     namespace wg below.
//   - the WMMA design (entry flash_row_attention_bwd), for f32 inputs (plain
//     FMA, no TF32, a 32-row streamed tile) and bf16 at head_dim 16 and 32:
//     WMMA 16x16x16 fragments, 64 owned rows per CTA, each warp owning 16
//     output rows with its f32 gradient rows in shared memory, synchronous
//     loads.
//
// Layout: q [B, Lq, H, hd] and k, v [B, Lk, H, hd] are read through their
// strides (last dim contiguous, rows 16-byte aligned); o, dO, dq, dk, dv are
// contiguous [B, L, H, hd]; lse and delta are contiguous [B, H, Lq] f32. The
// mask is f32 [B, Lk] with row stride mask_sb (0 = shared [Lk] row); valid
// is f32 [B] with stride valid_sb (0 = one flag for all), 0 where the batch
// row has no valid key. Ragged Lq/Lk edges are masked in-kernel: rows past
// the edge load as zeros, get P = 0 and are never written. The kernels
// allocate nothing and never synchronise with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int BO = 64;  // rows a CTA owns: keys (dkdv) or queries (dq), 16 per warp
constexpr int NWARPS = BO / 16;
constexpr int NTHREADS = NWARPS * 32;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T, int HD>
struct Tiles {
  static constexpr int SN = kIsBf16<T> ? 64 : 32;  // streamed rows per tile
  static constexpr int LDT = HD + 8;                 // q/k/v/dO tiles, elements of T
  static constexpr int LDS = SN + 4;                 // scores / dP, f32
  static constexpr int LDP = SN + 8;                 // P / dS, elements of T
  static constexpr int LDA = HD + 4;                 // f32 gradient accumulators
  static constexpr size_t tile_own = align128(sizeof(T) * BO * LDT);
  static constexpr size_t tile_str = align128(sizeof(T) * SN * LDT);
  static constexpr size_t scores = align128(sizeof(float) * BO * LDS);
  static constexpr size_t probs = align128(sizeof(T) * BO * LDP);
  static constexpr size_t acc = align128(sizeof(float) * BO * LDA);
  static constexpr size_t vec = align128(sizeof(float) * (BO > SN ? BO : SN));
  // dkdv: K, V (owned); Q, dO (streamed); S; P; dS; dK; dV; lse; delta.
  static constexpr size_t dkdv_bytes = 2 * tile_own + 2 * tile_str + scores + 2 * probs +
                                       2 * acc + 2 * vec;
  // dq: Q, dO (owned); K, V (streamed); S; dS; dQ; mask.
  static constexpr size_t dq_bytes = 2 * tile_own + 2 * tile_str + scores + probs + acc + vec;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy ROWS x HD elements (rows row0.. of a strided [L, HD] slab) into a
// shared tile of pitch LDT, 16 bytes per thread per step; rows >= n_valid
// are zero-filled.
template <typename T, int HD, int LDT, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int row0, int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// C[0:16, 0:N] = A[0:16, 0:K] . B[0:N, 0:K]^T (f32), one warp. A and B are
// row-major with K contiguous (pitches LDA_, LDB_); C has pitch LDC_.
template <typename T, int K, int N, int LDA_, int LDB_, int LDC_>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* C, int lane) {
  if constexpr (kIsBf16<T>) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + kk * 16, LDA_);
        wmma::load_matrix_sync(b, B + (n * 16) * LDB_ + kk * 16, LDB_);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, LDC_, wmma::mem_row_major);
    }
  } else {
    for (int e = lane; e < 16 * N; e += 32) {
      const int r = e / N;
      const int c = e % N;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < K; ++d) acc += to_f32(A[r * LDA_ + d]) * to_f32(B[c * LDB_ + d]);
      C[r * LDC_ + c] = acc;
    }
  }
}

// C[0:16, 0:N] += A[0:16, 0:K] . B[0:K, 0:N] (f32 accumulate), one warp. A
// and B are row-major (pitches LDA_, LDB_); C has pitch LDC_.
template <typename T, int K, int N, int LDA_, int LDB_, int LDC_>
__device__ __forceinline__ void warp_ab_acc(const T* A, const T* B, float* C, int lane) {
  if constexpr (kIsBf16<T>) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, C + n * 16, LDC_, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + kk * 16, LDA_);
        wmma::load_matrix_sync(b, B + (kk * 16) * LDB_ + n * 16, LDB_);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, LDC_, wmma::mem_row_major);
    }
  } else {
    for (int e = lane; e < 16 * N; e += 32) {
      const int r = e / N;
      const int c = e % N;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) acc += to_f32(A[r * LDA_ + j]) * to_f32(B[j * LDB_ + c]);
      C[r * LDC_ + c] += acc;
    }
  }
}

// Write a warp's 16 f32 accumulator rows (pitch LDA_) to a contiguous
// [L, H, HD] slab of T, rows row0.. below n_valid.
template <typename T, int HD, int LDA_>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride, const float* acc,
                                           int row0, int n_valid, int lane) {
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e / HD;
    const int c = e % HD;
    if (row0 + r < n_valid) dst[(int64_t)(row0 + r) * row_stride + c] = from_f32<T>(acc[r * LDA_ + c]);
  }
}

template <typename T, int HD>
__device__ __forceinline__ void zero_rows(T* dst, int64_t row_stride, int row0, int n_valid) {
  for (int e = threadIdx.x; e < BO * HD; e += NTHREADS) {
    const int r = e / HD;
    if (row0 + r < n_valid) dst[(int64_t)(row0 + r) * row_stride + e % HD] = from_f32<T>(0.0f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  const float* valid;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;  // [B*H, delta_ld] f32
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long mask_sb, valid_sb;
  float scale;
  int delta_ld;  // row pitch of delta: Lq here, the padded length in the Hopper design
};

// delta[b, h, q] = sum_d dO[b, q, h, d] * o[b, q, h, d] in f32. LPR lanes
// share one row, 16 bytes each, and reduce with shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPR = HD / VEC;
  const int64_t rows = (int64_t)a.B * a.Lq * a.H;
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = gtid / LPR;  // (b, q, h) in memory order
  const int part = (int)(gtid % LPR);
  float acc = 0.0f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + row * HD + part * VEC);
    const uint4 dv = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + row * HD + part * VEC);
    const T* op = reinterpret_cast<const T*>(&ov);
    const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc += to_f32(dp[i]) * to_f32(op[i]);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) {
    const int64_t per_b = (int64_t)a.Lq * a.H;
    const int64_t b = row / per_b;
    const int q = (int)((row % per_b) / a.H);
    const int h = (int)(row % a.H);
    a.delta[(b * a.H + h) * a.delta_ld + q] = acc;
  }
}

// dK, dV for 64 keys of one (b, h); loops over all query tiles.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const Args a) {
  using L = Tiles<T, HD>;
  constexpr int SN = L::SN;
  constexpr int HALF = SN / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* sK = reinterpret_cast<T*>(ptr);       ptr += L::tile_own;
  T* sV = reinterpret_cast<T*>(ptr);       ptr += L::tile_own;
  T* sQ = reinterpret_cast<T*>(ptr);       ptr += L::tile_str;
  T* sdO = reinterpret_cast<T*>(ptr);      ptr += L::tile_str;
  float* sS = reinterpret_cast<float*>(ptr); ptr += L::scores;
  T* sP = reinterpret_cast<T*>(ptr);       ptr += L::probs;
  T* sDS = reinterpret_cast<T*>(ptr);      ptr += L::probs;
  float* sdK = reinterpret_cast<float*>(ptr); ptr += L::acc;
  float* sdV = reinterpret_cast<float*>(ptr); ptr += L::acc;
  float* sLse = reinterpret_cast<float*>(ptr); ptr += L::vec;
  float* sDelta = reinterpret_cast<float*>(ptr);

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = blockIdx.y * BO;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16;  // this warp's first key row in the tile
  const int64_t ld = (int64_t)a.H * HD;  // row stride of the contiguous outputs
  T* dkp = static_cast<T*>(a.dk) + (int64_t)b * a.Lk * ld + (int64_t)h * HD;
  T* dvp = static_cast<T*>(a.dv) + (int64_t)b * a.Lk * ld + (int64_t)h * HD;

  if (a.valid[(int64_t)b * a.valid_sb] == 0.0f) {  // no valid key: zero gradients
    zero_rows<T, HD>(dkp, ld, k0, a.Lk);
    zero_rows<T, HD>(dvp, ld, k0, a.Lk);
    return;
  }

  const T* qp = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const T* dop = static_cast<const T*>(a.dout) + (int64_t)b * a.Lq * ld + (int64_t)h * HD;
  const float* lsep = a.lse + (int64_t)bh * a.Lq;
  const float* deltap = a.delta + (int64_t)bh * a.Lq;

  load_tile<T, HD, L::LDT, BO>(sK, kp, a.k_sl, k0, a.Lk);
  load_tile<T, HD, L::LDT, BO>(sV, vp, a.v_sl, k0, a.Lk);
  for (int i = tid; i < BO * L::LDA; i += NTHREADS) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }

  // Elementwise ownership: two lanes per key row, HALF queries each. Lanes
  // of warp w own key rows 16w..16w+15, the rows the warp's MMAs produce.
  const int row = tid >> 1;
  const int half = tid & 1;
  const bool key_ok = k0 + row < a.Lk && a.mask[(int64_t)b * a.mask_sb + k0 + row] != 0.0f;
  const int n_tiles = (a.Lq + SN - 1) / SN;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * SN;
    __syncthreads();  // previous tile's Q/dO/lse/delta fully consumed
    load_tile<T, HD, L::LDT, SN>(sQ, qp, a.q_sl, q0, a.Lq);
    load_tile<T, HD, L::LDT, SN>(sdO, dop, ld, q0, a.Lq);
    for (int i = tid; i < SN; i += NTHREADS) {
      const bool in = q0 + i < a.Lq;
      sLse[i] = in ? lsep[q0 + i] : 0.0f;
      sDelta[i] = in ? deltap[q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T = K Q^T, then P^T in registers (f32) and in sP (T).
    warp_abt<T, HD, SN, L::LDT, L::LDT, L::LDS>(sK + r0 * L::LDT, sQ, sS + r0 * L::LDS, lane);
    __syncwarp();
    float p[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      const bool ok = key_ok && q0 + c < a.Lq;
      p[j] = ok ? expf(sS[row * L::LDS + c] * a.scale - sLse[c]) : 0.0f;
      sP[row * L::LDP + c] = from_f32<T>(p[j]);
    }
    __syncwarp();  // S read by both lanes of every row before dP overwrites it

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) * scale.
    warp_abt<T, HD, SN, L::LDT, L::LDT, L::LDS>(sV + r0 * L::LDT, sdO, sS + r0 * L::LDS, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      sDS[row * L::LDP + c] = from_f32<T>(p[j] * (sS[row * L::LDS + c] - sDelta[c]) * a.scale);
    }
    __syncwarp();

    // dV += P^T dO; dK += dS^T Q.
    warp_ab_acc<T, SN, HD, L::LDP, L::LDT, L::LDA>(sP + r0 * L::LDP, sdO, sdV + r0 * L::LDA, lane);
    warp_ab_acc<T, SN, HD, L::LDP, L::LDT, L::LDA>(sDS + r0 * L::LDP, sQ, sdK + r0 * L::LDA, lane);
  }
  __syncwarp();
  store_rows<T, HD, L::LDA>(dkp, ld, sdK + r0 * L::LDA, k0 + r0, a.Lk, lane);
  store_rows<T, HD, L::LDA>(dvp, ld, sdV + r0 * L::LDA, k0 + r0, a.Lk, lane);
}

// dQ for 64 queries of one (b, h); loops over all key tiles.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Args a) {
  using L = Tiles<T, HD>;
  constexpr int SN = L::SN;
  constexpr int HALF = SN / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* sQ = reinterpret_cast<T*>(ptr);       ptr += L::tile_own;
  T* sdO = reinterpret_cast<T*>(ptr);      ptr += L::tile_own;
  T* sK = reinterpret_cast<T*>(ptr);       ptr += L::tile_str;
  T* sV = reinterpret_cast<T*>(ptr);       ptr += L::tile_str;
  float* sS = reinterpret_cast<float*>(ptr); ptr += L::scores;
  T* sDS = reinterpret_cast<T*>(ptr);      ptr += L::probs;
  float* sdQ = reinterpret_cast<float*>(ptr); ptr += L::acc;
  float* sMask = reinterpret_cast<float*>(ptr);

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.y * BO;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16;  // this warp's first query row in the tile
  const int64_t ld = (int64_t)a.H * HD;
  T* dqp = static_cast<T*>(a.dq) + (int64_t)b * a.Lq * ld + (int64_t)h * HD;

  if (a.valid[(int64_t)b * a.valid_sb] == 0.0f) {
    zero_rows<T, HD>(dqp, ld, q0, a.Lq);
    return;
  }

  const T* qp = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const T* dop = static_cast<const T*>(a.dout) + (int64_t)b * a.Lq * ld + (int64_t)h * HD;
  const float* mp = a.mask + (int64_t)b * a.mask_sb;

  load_tile<T, HD, L::LDT, BO>(sQ, qp, a.q_sl, q0, a.Lq);
  load_tile<T, HD, L::LDT, BO>(sdO, dop, ld, q0, a.Lq);
  for (int i = tid; i < BO * L::LDA; i += NTHREADS) sdQ[i] = 0.0f;

  // Two lanes per query row, HALF keys each; rows past Lq compute garbage
  // that is never written.
  const int row = tid >> 1;
  const int half = tid & 1;
  const bool q_in = q0 + row < a.Lq;
  const float lse_r = q_in ? a.lse[(int64_t)bh * a.Lq + q0 + row] : 0.0f;
  const float delta_r = q_in ? a.delta[(int64_t)bh * a.Lq + q0 + row] : 0.0f;
  const int n_tiles = (a.Lk + SN - 1) / SN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * SN;
    __syncthreads();  // previous tile's K/V/mask fully consumed
    load_tile<T, HD, L::LDT, SN>(sK, kp, a.k_sl, k0, a.Lk);
    load_tile<T, HD, L::LDT, SN>(sV, vp, a.v_sl, k0, a.Lk);
    for (int j = tid; j < SN; j += NTHREADS) sMask[j] = (k0 + j < a.Lk) ? mp[k0 + j] : 0.0f;
    __syncthreads();

    warp_abt<T, HD, SN, L::LDT, L::LDT, L::LDS>(sQ + r0 * L::LDT, sK, sS + r0 * L::LDS, lane);
    __syncwarp();
    float p[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      p[j] = sMask[c] != 0.0f ? expf(sS[row * L::LDS + c] * a.scale - lse_r) : 0.0f;
    }
    __syncwarp();

    warp_abt<T, HD, SN, L::LDT, L::LDT, L::LDS>(sdO + r0 * L::LDT, sV, sS + r0 * L::LDS, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      sDS[row * L::LDP + c] = from_f32<T>(p[j] * (sS[row * L::LDS + c] - delta_r) * a.scale);
    }
    __syncwarp();

    warp_ab_acc<T, SN, HD, L::LDP, L::LDT, L::LDA>(sDS + r0 * L::LDP, sK, sdQ + r0 * L::LDA, lane);
  }
  __syncwarp();
  store_rows<T, HD, L::LDA>(dqp, ld, sdQ + r0 * L::LDA, q0 + r0, a.Lq, lane);
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Tiles<T, HD>;
  static bool configured = false;  // per instantiation, one device per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::dkdv_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::dq_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int LPR = HD / (16 / sizeof(T));
  const int64_t threads = (int64_t)a.B * a.Lq * a.H * LPR;
  delta_kernel<T, HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD><<<dim3(a.B * a.H, (a.Lk + BO - 1) / BO), NTHREADS, L::dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3(a.B * a.H, (a.Lq + BO - 1) / BO), NTHREADS, L::dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The WMMA design: f32 inputs (head_dim 16, 32, 128) and bf16 at head_dim
// 16 and 32. bf16 at head_dim 128 is the Hopper design's alone
// (flash_row_attention_bwd_wgmma) and is refused here.
template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 128:
      if constexpr (std::is_same<T, float>::value) return launch<T, 128>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// ---- The Hopper design: bf16, head_dim 128 ------------------------------
//
// Two kernels after the delta pass, as in the WMMA design (seven products
// per (query, key) pair, no atomics, so the gradients repeat bit for bit).
// Each CTA has three warpgroups, 384 threads, one CTA per SM: warpgroup 0 is
// the producer (setmaxnreg 24; one thread issues TMA and bulk copies into a
// ring of STAGES buffers behind full/empty mbarriers), warpgroups 1 and 2 are
// consumers (setmaxnreg 240) with 64 owned rows each and every accumulator
// in registers.
//   dkdv_kernel: a CTA owns 128 keys (K and V resident in shared memory) and
//     streams 64-query tiles of Q and dO with their lse and delta. Per tile
//     and warpgroup: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (both
//     operands K-major in shared memory); P^T = exp(S^T scale - lse) and
//     dS^T = P^T (dP^T - delta) scale in registers; dV += P^T dO and
//     dK += dS^T Q by wgmma m64n128k16 with P^T and dS^T (bf16) as register
//     A operands and dO, Q read MN-major from the same tiles.
//   dq_kernel: a CTA owns 128 queries (Q and dO resident, lse and delta in
//     registers) and streams 64-key tiles of K and V with their mask; S and
//     dP by m64n64k16, dS in registers, dQ += dS K by m64n128k16 with K read
//     MN-major.
// lse arrives pre-multiplied by log2(e) and padded with +inf past Lq (so P
// is 0 there), delta padded with 0, both [B*H, lq_pad], lq_pad % 128 == 0.
namespace wg {

using namespace hopper;

constexpr int BO = 128;  // rows a CTA owns: keys (dkdv) or queries (dq), 64 per consumer
constexpr int BS = 64;   // streamed rows per tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr uint32_t OWN = BO * HD * 2;  // 32 KB
constexpr uint32_t STR = BS * HD * 2;  // 16 KB
constexpr int OWN_OFF = 0;             // two owned tiles (K, V or Q, dO)
constexpr int STR_OFF = 2 * OWN;       // stage s: two streamed tiles at STR_OFF + 2s STR
constexpr int VEC_OFF = STR_OFF + STAGES * 2 * STR;  // stage s: 2 x BS f32 at VEC_OFF + s * 8 BS
constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * BS * 4;
constexpr int SMEM_BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const float* mask;   // [B, Lk_pad] f32, row stride mask_sb (0: shared), zero past Lk
  const float* valid;  // [B] f32, stride valid_sb
  const float* lse2;   // [B*H, lq_pad] lse * log2(e), +inf past Lq
  const float* delta;  // [B*H, lq_pad], 0 past Lq
  __nv_bfloat16* dq;   // contiguous [B, Lq, H, 128]
  __nv_bfloat16* dk;   // contiguous [B, Lk, H, 128]
  __nv_bfloat16* dv;
  int B, H, Lq, Lk, lq_pad;
  long long mask_sb, valid_sb;
  float scale, scale_log2;
};

// Zero rows row0..row0+BO-1 (below n_valid) of one head of a contiguous
// [B, L, H, 128] bf16 gradient; every thread of the CTA.
__device__ __forceinline__ void zero_head_rows(__nv_bfloat16* p, long long ld, int row0,
                                               int n_valid) {
  for (int e = threadIdx.x; e < BO * HD / 8; e += NTHREADS) {
    const int r = e / (HD / 8);
    if (row0 + r < n_valid) {
      *reinterpret_cast<uint4*>(p + (long long)(row0 + r) * ld + (e % (HD / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // the owned tiles
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);                 // full
      mbar_init(&bars[1 + STAGES + s], 2 * 128);  // empty
    }
    fence_barrier_init();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int k_tiles = (a.Lk + BO - 1) / BO;
  const int k0 = (blockIdx.x % k_tiles) * BO;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const long long ld = (long long)a.H * HD;
  __nv_bfloat16* dkp = a.dk + (long long)b * a.Lk * ld + (long long)h * HD;
  __nv_bfloat16* dvp = a.dv + (long long)b * a.Lk * ld + (long long)h * HD;
  if (a.valid[(long long)b * a.valid_sb] == 0.0f) {  // no valid key: zero gradients
    zero_head_rows(dkp, ld, k0, a.Lk);
    zero_head_rows(dvp, ld, k0, a.Lk);
    return;
  }
  const int n_tiles = (a.Lq + BS - 1) / BS;
  init_ring(own_full);

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(own_full, 2 * OWN);
      tma_load_rows<BO>(sm + OWN_OFF, &tk, own_full, b, h, k0);
      tma_load_rows<BO>(sm + OWN_OFF + OWN, &tv, own_full, b, h, k0);
      const float* lse_row = a.lse2 + (long long)bh * a.lq_pad;
      const float* delta_row = a.delta + (long long)bh * a.lq_pad;
      for (int qt = 0; qt < n_tiles; ++qt) {
        const int s = qt % STAGES;
        mbar_wait(&empty[s], ((qt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * STR + 2 * BS * 4);
        unsigned char* t = sm + STR_OFF + s * 2 * STR;
        tma_load_rows<BS>(t, &tq, &full[s], b, h, qt * BS);
        tma_load_rows<BS>(t + STR, &tdo, &full[s], b, h, qt * BS);
        float* vec = reinterpret_cast<float*>(sm + VEC_OFF + s * 2 * BS * 4);
        bulk_load(vec, lse_row + qt * BS, BS * 4, &full[s]);
        bulk_load(vec + BS, delta_row + qt * BS, BS * 4, &full[s]);
      }
    }
  } else {
    reg_alloc<240>();
    const int cw = warpgroup - 1;
    const int lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // key row, and + 8
    const int c0 = (lane & 3) * 2;
    const float* mrow = a.mask + (long long)b * a.mask_sb;
    const bool ok_lo = mrow[k0 + r_lo] != 0.0f;  // zero past Lk (padded mask)
    const bool ok_hi = mrow[k0 + r_lo + 8] != 0.0f;
    const uint32_t k_tile = smem_u32(sm + OWN_OFF + cw * 64 * 128);
    const uint32_t v_tile = k_tile + OWN;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk[i] = 0.0f;
      dv[i] = 0.0f;
    }
    mbar_wait(own_full, 0);
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int s = qt % STAGES;
      mbar_wait(&full[s], (qt / STAGES) & 1);
      const uint32_t q_tile = smem_u32(sm + STR_OFF + s * 2 * STR);
      const uint32_t do_tile = q_tile + STR;
      const float* lse = reinterpret_cast<const float*>(sm + VEC_OFF + s * 2 * BS * 4);
      const float* delta = lse + BS;

      // S^T and dP^T go to the tensor cores as two groups; P^T is formed
      // while dP^T runs, dV += P^T dO is issued before dS^T is formed.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n64(st, desc_k<BO>(k_tile, kk), desc_k<BS>(q_tile, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n64(dpt, desc_k<BO>(v_tile, kk), desc_k<BS>(do_tile, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T in registers (rows: keys; columns: queries).
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float l2 = lse[n * 8 + c0 + j];
          st[4 * n + j] = ok_lo ? exp2f(st[4 * n + j] * a.scale_log2 - l2) : 0.0f;
          st[4 * n + 2 + j] = ok_hi ? exp2f(st[4 * n + 2 + j] * a.scale_log2 - l2) : 0.0f;
        }
      }
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(st, kk, pf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128_mn(dv, pf[kk], desc_mn<BS>(do_tile, kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV may still run
      fence_regs(dpt);

      // dS^T = P^T (dP^T - delta) scale.
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dl = delta[n * 8 + c0 + j];
          dpt[4 * n + j] = st[4 * n + j] * (dpt[4 * n + j] - dl) * a.scale;
          dpt[4 * n + 2 + j] = st[4 * n + 2 + j] * (dpt[4 * n + 2 + j] - dl) * a.scale;
        }
      }
      uint32_t sf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(dpt, kk, sf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128_mn(dk, sf[kk], desc_mn<BS>(q_tile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[s]);
    }

    // Stage bf16 dK and dV in this warpgroup's K and V rows, then store.
    warpgroup_sync(1 + cw);
    stage_acc<BO>(sm + OWN_OFF, dk, cw * 64, 1.0f, 1.0f);
    stage_acc<BO>(sm + OWN_OFF + OWN, dv, cw * 64, 1.0f, 1.0f);
    warpgroup_sync(1 + cw);
    store_tile_rows<BO>(dkp, ld, sm + OWN_OFF, cw * 64, k0 + cw * 64, a.Lk);
    store_tile_rows<BO>(dvp, ld, sm + OWN_OFF + OWN, cw * 64, k0 + cw * 64, a.Lk);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int q_tiles = (a.Lq + BO - 1) / BO;
  const int q0 = (blockIdx.x % q_tiles) * BO;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const long long ld = (long long)a.H * HD;
  __nv_bfloat16* dqp = a.dq + (long long)b * a.Lq * ld + (long long)h * HD;
  if (a.valid[(long long)b * a.valid_sb] == 0.0f) {
    zero_head_rows(dqp, ld, q0, a.Lq);
    return;
  }
  const int n_tiles = (a.Lk + BS - 1) / BS;
  init_ring(own_full);

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(own_full, 2 * OWN);
      tma_load_rows<BO>(sm + OWN_OFF, &tq, own_full, b, h, q0);
      tma_load_rows<BO>(sm + OWN_OFF + OWN, &tdo, own_full, b, h, q0);
      const float* mrow = a.mask + (long long)b * a.mask_sb;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * STR + BS * 4);
        unsigned char* t = sm + STR_OFF + s * 2 * STR;
        tma_load_rows<BS>(t, &tk, &full[s], b, h, kt * BS);
        tma_load_rows<BS>(t + STR, &tv, &full[s], b, h, kt * BS);
        bulk_load(sm + VEC_OFF + s * 2 * BS * 4, mrow + kt * BS, BS * 4, &full[s]);
      }
    }
  } else {
    reg_alloc<240>();
    const int cw = warpgroup - 1;
    const int lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // query row, and + 8
    const int c0 = (lane & 3) * 2;
    const float* lse_row = a.lse2 + (long long)bh * a.lq_pad + q0;  // padded: no edge test
    const float* delta_row = a.delta + (long long)bh * a.lq_pad + q0;
    const float l2_lo = lse_row[r_lo], l2_hi = lse_row[r_lo + 8];
    const float d_lo = delta_row[r_lo], d_hi = delta_row[r_lo + 8];
    const uint32_t q_tile = smem_u32(sm + OWN_OFF + cw * 64 * 128);
    const uint32_t do_tile = q_tile + OWN;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
    mbar_wait(own_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t k_tile = smem_u32(sm + STR_OFF + s * 2 * STR);
      const uint32_t v_tile = k_tile + STR;
      const float* msk = reinterpret_cast<const float*>(sm + VEC_OFF + s * 2 * BS * 4);

      // S and dP go to the tensor cores as two groups; P is formed while dP
      // runs.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n64(sc, desc_k<BO>(q_tile, kk), desc_k<BS>(k_tile, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n64(dp, desc_k<BO>(do_tile, kk), desc_k<BS>(v_tile, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = msk[n * 8 + c0 + j] != 0.0f;
          sc[4 * n + j] = ok ? exp2f(sc[4 * n + j] * a.scale_log2 - l2_lo) : 0.0f;
          sc[4 * n + 2 + j] = ok ? exp2f(sc[4 * n + 2 + j] * a.scale_log2 - l2_hi) : 0.0f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dp[4 * n + j] = sc[4 * n + j] * (dp[4 * n + j] - d_lo) * a.scale;
          dp[4 * n + 2 + j] = sc[4 * n + 2 + j] * (dp[4 * n + 2 + j] - d_hi) * a.scale;
        }
      }
      uint32_t sf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(dp, kk, sf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128_mn(dq, sf[kk], desc_mn<BS>(k_tile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(&empty[s]);
    }

    warpgroup_sync(1 + cw);
    stage_acc<BO>(sm + OWN_OFF, dq, cw * 64, 1.0f, 1.0f);
    warpgroup_sync(1 + cw);
    store_tile_rows<BO>(dqp, ld, sm + OWN_OFF, cw * 64, q0 + cw * 64, a.Lq);
  }
}

cudaError_t launch(const CUtensorMap (&maps)[4], const Args& da, const BwdArgs& a,
                   cudaStream_t stream) {
  static bool configured = false;  // one device per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkdv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int LPR = HD / 8;  // lanes per row of the delta pass
  const long long threads = (long long)a.B * a.Lq * a.H * LPR;
  delta_kernel<__nv_bfloat16, HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(da);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bh = (long long)a.B * a.H;
  const long long kv_ctas = (long long)((a.Lk + BO - 1) / BO) * bh;
  const long long q_ctas = (long long)((a.Lq + BO - 1) / BO) * bh;
  if (kv_ctas > 0x7fffffffLL || q_ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  dkdv_kernel<<<(unsigned)kv_ctas, NTHREADS, SMEM_BYTES, stream>>>(maps[0], maps[1], maps[2],
                                                                   maps[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<<<(unsigned)q_ctas, NTHREADS, SMEM_BYTES, stream>>>(maps[0], maps[1], maps[2],
                                                                maps[3], a);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v strides are in elements; o, dout,
// dq, dk, dv are contiguous [B, L, H, hd]; lse, delta contiguous [B, H, Lq]
// f32 (delta is scratch, written here). Launches delta_kernel, dkdv_kernel
// and dq_kernel on `stream`; returns the first cudaError_t of the launches.
extern "C" int flash_row_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v, const float* mask,
    const float* valid, const void* o, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long mask_sb, long long valid_sb,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, valid, o, dout, lse, delta, dq, dk, dv, B, H, Lq, Lk,
               q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb, valid_sb, scale,
               Lq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(head_dim, a, s);
    case 1: return (int)dispatch_hd<__nv_bfloat16>(head_dim, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The Hopper design, bf16 with head_dim 128 (see wg:: above). q/k/v strides
// in elements (multiples of 8, none 0 on a dim of size > 1); o, dout, dq, dk,
// dv contiguous [B, L, H, 128]; lse2 f32 [B*H, lq_pad]: lse * log2(e), +inf
// past Lq; delta f32 [B*H, lq_pad], zero-filled (written here, zero past Lq);
// mask f32 [B, Lk_pad] (Lk_pad % 128 == 0, zero past Lk), row stride mask_sb
// (0 = shared); valid f32 [B], stride valid_sb. Launches the delta pass, the
// dK/dV kernel and the dQ kernel; returns the first cudaError_t.
extern "C" int flash_row_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const float* mask, const float* valid,
    const void* o, const void* dout, const float* lse2, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int Lq, int Lk, int lq_pad, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long mask_sb, long long valid_sb, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || lq_pad % wg::BO != 0 || lq_pad < Lq) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ld = (long long)H * hopper::HD;
  CUtensorMap maps[4];
  cudaError_t err = hopper::make_map(&maps[0], q, B, Lq, H, q_sb, q_sl, q_sh);
  if (err == cudaSuccess) err = hopper::make_map(&maps[1], k, B, Lk, H, k_sb, k_sl, k_sh);
  if (err == cudaSuccess) err = hopper::make_map(&maps[2], v, B, Lk, H, v_sb, v_sl, v_sh);
  if (err == cudaSuccess) err = hopper::make_map(&maps[3], dout, B, Lq, H, Lq * ld, ld, hopper::HD);
  if (err != cudaSuccess) return (int)err;
  const Args da{q, k, v, mask, valid, o, dout, nullptr, delta, dq, dk, dv, B, H, Lq, Lk,
                q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb, valid_sb, scale,
                lq_pad};
  const wg::BwdArgs a{mask, valid, lse2, delta, static_cast<__nv_bfloat16*>(dq),
                      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                      B, H, Lq, Lk, lq_pad, mask_sb, valid_sb, scale, scale * wg::LOG2E};
  return (int)wg::launch(maps, da, a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_row_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
