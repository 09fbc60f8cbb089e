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
// Three kernels, launched in a row by flash_row_attention_bwd, no atomics, so
// the gradients repeat bit for bit from run to run:
//   1. delta_kernel: delta [B, H, Lq] f32, one 16-byte load per lane;
//   2. dkdv_kernel: one CTA owns 64 keys of one (b, h) and loops over every
//      query tile; each warp owns 16 keys and keeps their dK/dV rows in f32
//      shared memory across the loop;
//   3. dq_kernel: one CTA owns 64 queries of one (b, h) and loops over every
//      key tile; each warp owns 16 query rows and keeps their dQ in f32.
// Between them they run seven products per (query, key) pair, where five
// would do (q k^T and dO v^T are recomputed in both kernels): the simple
// first version, without atomics.
//
// What bounds it on the card: at the training context shape (B 264, H 2,
// Lq = Lk = 768, hd 128) the five products are 10*B*H*Lq*Lk*hd = 4.0e11
// FLOP against about 0.83 GB of q/k/v/o/dO/dq/dk/dv, above the H100's ~295
// FLOP/byte ridge: tensor-core throughput bounds it. The design answers that
// as the forward does: bf16 WMMA 16x16x16 fragments with f32 accumulation
// for every product, tiles staged in shared memory, per-warp ownership of 16
// output rows so that the softmax-like elementwise work needs only warp
// synchronisation. P and dS are rounded to bf16 before their products (the
// TPU code keeps them f32); their f32 values stay in registers for dS. f32
// inputs take a plain-FMA path (no TF32), with a 32-row streamed tile so the
// shared memory fits. No TMA, no wgmma, no pipelining: later work.
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
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long mask_sb, valid_sb;
  float scale;
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
    a.delta[(b * a.H + h) * a.Lq + q] = acc;
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

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

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
               q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb, valid_sb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(head_dim, a, s);
    case 1: return (int)dispatch_hd<__nv_bfloat16>(head_dim, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_row_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
