// Row-axis flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel npe_pfn_tpu/ops/flash_attention.py::_flash_kernel
// in both of its variants: _flash_fwd(with_lse=False) / flash_row_attention
// (entry point flash_row_attention_fwd) and _flash_fwd(with_lse=True) /
// _flash_fwd_lse, the forward of the trainable path (entry point
// flash_row_attention_fwd_lse). For every (batch, head) it computes
// softmax(q k^T * hd^-0.5 + mask) v with an online softmax, so the [Lq, Lk]
// score matrix never reaches device memory. The lse variant also writes the
// per-query logsumexp m + log(max(l, 1e-30)) as f32 [B, H, Lq] at the
// finalize step (the TPU kernel's lane-broadcast [B*H, Lq, hd] block is a
// Mosaic tiling artefact and is not carried over). One template flag, LSE,
// selects the variant; with LSE false the kernel is the inference kernel,
// instruction for instruction.
//
// Semantics kept from the TPU kernel:
//   - scores, running max m, running sum l and the output accumulator are f32;
//   - a masked key (mask == 0, or past the ragged Lk edge) scores -1e30
//     before the max update, so a row with no valid key degenerates to the
//     mean of V exactly as on the TPU (the wrapper's any-valid gate zeroes it);
//   - P is cast to V's type before P.V, which accumulates in f32;
//   - l is floored at 1e-30 before the final division.
//
// What bounds it on the card: at the main-path shape (B 17-25, H 2,
// Lq = Lk = 2048, hd 128) one call does 4*B*H*Lq*Lk*hd FLOP (about 1.1e11 at
// B 25) against 4*B*H*L*hd*2 bytes of q/k/v/o, far above the H100's
// ~295 FLOP/byte ridge: the bound is tensor-core throughput (989 TFLOP/s
// bf16, reached only through wgmma). The training shapes (B 264, 768 x 768
// and 128 x 768) are the same kind of work.
//
// Two designs, chosen by the wrapper from dtype and head_dim before the
// launch (ops/flash_attention.py::kernel_design):
//   - wg:: (entry flash_row_attention_fwd_wgmma), bf16 at head_dim 128, the
//     only shape the shipped models run. Warp-specialised: a producer
//     warpgroup loads by TMA (cp.async.bulk.tensor, 4-D tensor maps over the
//     strided [B, L, H, hd] layouts, 128-byte swizzle, zero fill past the
//     ragged edge) into a 4-stage mbarrier ring; two consumer warpgroups run
//     wgmma with the S and O accumulators in registers. Tiles: 128 query rows
//     per CTA (64 per consumer warpgroup), 64 keys per stage; shared memory
//     32 KB of Q + 4 x 32 KB of K/V + the mask, one CTA of 384 threads per
//     SM. The design is described above namespace wg below.
//   - the WMMA design (entries flash_row_attention_fwd and _fwd_lse), for
//     f32 inputs (plain FMA, no TF32) and bf16 at head_dim 16 and 32: WMMA
//     16x16x16 fragments, K/V tiles staged once in shared memory per 64
//     query rows, per-warp ownership of 16 query rows, synchronous loads.
//
// Layout (both designs): q, o are [B, Lq, H, hd] and k, v are [B, Lk, H, hd],
// read through their strides (last dim contiguous, rows 16-byte aligned; the
// wrapper checks).
// The mask is f32 [B, Lk] with row stride mask_sb; mask_sb == 0 shares one
// [Lk] row across the batch, so shared and per-batch masks take one path.
// One CTA per (b*h, 64 or 128 query rows); the loop over key tiles inside the
// CTA replaces the TPU's sequential key axis of the grid. Ragged Lq/Lk edges are
// masked here: rows past Lq are neither read nor written, keys past Lk load
// as zeros and score -1e30. The kernel allocates nothing and never
// synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;         // query rows per CTA (16 per warp)
constexpr int BN = 64;         // keys per tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

template <typename T, int HD>
struct Layout {
  // Row pitches, padded to stagger shared-memory banks. Every tile offset and
  // every 16-row / 16-column fragment start stays 32-byte aligned (WMMA).
  static constexpr int LDT = HD + 8;  // Q/K/V tiles, elements of T
  static constexpr int LDS = BN + 4;  // scores, f32
  static constexpr int LDP = BN + 8;  // probabilities, elements of T
  static constexpr int LDO = HD + 4;  // output accumulator, f32
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BM * LDT;
  static constexpr size_t v_off = k_off + sizeof(T) * BN * LDT;
  static constexpr size_t s_off = v_off + sizeof(T) * BN * LDT;
  static constexpr size_t p_off = s_off + sizeof(float) * BM * LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * BM * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * BM * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BM;
  static constexpr size_t mask_off = l_off + sizeof(float) * BM;
  static constexpr size_t bytes = mask_off + sizeof(float) * BN;
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

// S[r0:r0+16, 0:BN] = Q[r0:r0+16, :] . K[0:BN, :]^T (f32), one warp.
template <typename T, int HD>
__device__ __forceinline__ void warp_scores(const T* sQ, const T* sK, float* sS, int r0,
                                            int lane) {
  using L = Layout<T, HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + r0 * L::LDT + kk * 16, L::LDT);
        wmma::load_matrix_sync(b, sK + (n * 16) * L::LDT + kk * 16, L::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
  } else {
    // f32 inputs: plain FMA, so f32 stays f32 (no TF32 rounding).
    for (int e = lane; e < 16 * BN; e += 32) {
      const int r = r0 + e / BN;
      const int c = e % BN;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc += to_f32(sQ[r * L::LDT + d]) * to_f32(sK[c * L::LDT + d]);
      sS[r * L::LDS + c] = acc;
    }
  }
}

// O[r0:r0+16, :] += P[r0:r0+16, 0:BN] . V[0:BN, :] (f32 accumulate), one warp.
template <typename T, int HD>
__device__ __forceinline__ void warp_pv(const T* sP, const T* sV, float* sO, int r0, int lane) {
  using L = Layout<T, HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + r0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sV + (kk * 16) * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * L::LDO + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
  } else {
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = r0 + e / HD;
      const int c = e % HD;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < BN; ++j) acc += to_f32(sP[r * L::LDP + j]) * to_f32(sV[j * L::LDT + c]);
      sO[r * L::LDO + c] += acc;
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* o;
  int B, H, Lq, Lk;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long mask_sb;
  float scale;
};

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_row_attention_kernel(const Args a, float* __restrict__ lse) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  float* sMask = reinterpret_cast<float*>(smem + L::mask_off);

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first query row in the tile

  const T* qp = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const float* mp = a.mask + (int64_t)b * a.mask_sb;

  load_tile<T, HD, L::LDT, BM>(sQ, qp, a.q_sl, q0, a.Lq);
  for (int i = tid; i < BM * L::LDO; i += NTHREADS) sO[i] = 0.0f;
  for (int i = tid; i < BM; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }

  // Softmax ownership: two lanes per query row, 32 keys each. Lanes of warp
  // w own rows 16w..16w+15, the same rows the warp's MMAs produce.
  const int row = tid >> 1;
  const int half = tid & 1;
  const int n_tiles = (a.Lk + BN - 1) / BN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tile's K/V/mask fully consumed
    load_tile<T, HD, L::LDT, BN>(sK, kp, a.k_sl, k0, a.Lk);
    load_tile<T, HD, L::LDT, BN>(sV, vp, a.v_sl, k0, a.Lk);
    for (int j = tid; j < BN; j += NTHREADS) sMask[j] = (k0 + j < a.Lk) ? mp[k0 + j] : 0.0f;
    __syncthreads();

    warp_scores<T, HD>(sQ, sK, sS, r0, lane);
    __syncwarp();

    float s[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const float val = sMask[c] != 0.0f ? sS[row * L::LDS + c] * a.scale : NEG_INF;
      s[j] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = sM[row];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      sP[row * L::LDP + half * 32 + j] = from_f32<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float l_prev = sL[row];
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c) sO[row * L::LDO + c] *= alpha;
    __syncwarp();  // both lanes of the row have read m_prev / l_prev
    if (half == 0) {
      sM[row] = m_new;
      sL[row] = l_prev * alpha + sum;
    }
    __syncwarp();  // P and the rescaled accumulator are visible to the warp

    warp_pv<T, HD>(sP, sV, sO, r0, lane);
    __syncwarp();
  }

  T* op = static_cast<T*>(a.o) + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = r0 + e / HD;
    const int c = e % HD;
    if (q0 + r < a.Lq) {
      const float l = fmaxf(sL[r], 1e-30f);
      op[(int64_t)(q0 + r) * a.o_sl + c] = from_f32<T>(sO[r * L::LDO + c] / l);
    }
  }
  if constexpr (LSE) {
    // lse [B, H, Lq] f32: lanes 0-15 write this warp's 16 rows.
    if (lane < 16 && q0 + r0 + lane < a.Lq) {
      const int r = r0 + lane;
      lse[(int64_t)bh * a.Lq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, int HD, bool LSE>
cudaError_t launch(const Args& a, float* lse, cudaStream_t stream) {
  using L = Layout<T, HD>;
  static bool configured = false;  // per instantiation, one device per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_row_attention_kernel<T, HD, LSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.B * a.H, (a.Lq + BM - 1) / BM);
  flash_row_attention_kernel<T, HD, LSE><<<grid, NTHREADS, L::bytes, stream>>>(a, lse);
  return cudaGetLastError();
}

// The WMMA design: f32 inputs (head_dim 16, 32, 128) and bf16 at head_dim
// 16 and 32. bf16 at head_dim 128 is the Hopper design's alone
// (flash_row_attention_fwd_wgmma) and is refused here.
template <typename T, bool LSE>
cudaError_t dispatch_hd(int hd, const Args& a, float* lse, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, LSE>(a, lse, stream);
    case 32: return launch<T, 32, LSE>(a, lse, stream);
    case 128:
      if constexpr (std::is_same<T, float>::value) return launch<T, 128, LSE>(a, lse, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <bool LSE>
int dispatch(int dtype, int head_dim, const Args& a, float* lse, cudaStream_t s) {
  switch (dtype) {
    case 0: return (int)dispatch_hd<float, LSE>(head_dim, a, lse, s);
    case 1: return (int)dispatch_hd<__nv_bfloat16, LSE>(head_dim, a, lse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- The Hopper design: bf16, head_dim 128 ------------------------------
//
// CTA: three warpgroups, 384 threads, one CTA per SM. Warpgroup 0 is the
// producer: after giving up its registers (setmaxnreg 24), one thread loads
// the CTA's 128 query rows once and then streams K and V tiles of BN keys,
// with their BN mask values, by TMA into a ring of STAGES buffers, each
// guarded by a "full" mbarrier (transaction bytes) and an "empty" mbarrier
// (arrivals of the 256 consumer threads). Warpgroups 1 and 2 are consumers
// (setmaxnreg 240), each owning 64 query rows:
//   S = Q K^T       wgmma m64nBNk16, Q and K from shared memory (K-major),
//                   BN / 2 f32 accumulators a thread;
//   softmax         scale and mask in registers, row max and sum over the
//                   quad of lanes that share a row, O rescaled in registers;
//   O += P V        wgmma m64n128k16 with P as the register A operand (the
//                   S accumulator converted to bf16 in place) and V read
//                   MN-major from shared memory: V is never transposed;
//                   O stays in registers across the whole key loop.
// The products of tile j, S_j and O += P_{j-1} V_{j-1}, go to the tensor
// cores together, and the softmax of S_j runs while P_{j-1} V_{j-1} is still
// in flight; the last tile's P V closes the loop.
// The epilogue divides by max(l, 1e-30), stages bf16 O through the
// warpgroup's own Q rows (swizzled) and writes 16-byte stores masked at the
// Lq edge; with LSE it writes m + log(max(l, 1e-30)). The softmax runs in
// base 2 (exp2 of scores times scale * log2(e)); a masked key scores
// -1e30 * log2(e), i.e. -1e30 in natural units, as in the TPU kernel.
namespace wg {

using namespace hopper;

constexpr int BM = 128;  // query rows per CTA, 64 per consumer warpgroup
// 64 keys per tile, 4 stages. With 128 keys per tile (3 stages fit) ptxas
// gives the consumers no more than about 176 registers, spills and
// serialises the wgmma chains; 64 keys need no spill (PERF.md).
constexpr int BN = 64;  // keys per tile (64 or 128)
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;
constexpr uint32_t TILE = BM * HD * 2;     // the 128-row bf16 Q tile, 32 KB
constexpr uint32_t KV_TILE = BN * HD * 2;  // one K or V tile
constexpr int Q_OFF = 0;
constexpr int KV_OFF = TILE;  // stage s: K at KV_OFF + 2s KV_TILE, V after it
constexpr int MASK_OFF = KV_OFF + STAGES * 2 * KV_TILE;
constexpr int BAR_OFF = MASK_OFF + STAGES * BN * 4;
constexpr int SMEM_BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = -1e30f * LOG2E;

struct Args {
  const float* mask;  // [B, Lk_pad] f32, row stride mask_sb (0: shared), Lk_pad % BN == 0
  __nv_bfloat16* o;
  float* lse;
  int B, H, Lq, Lk;
  long long o_sb, o_sl, o_sh;
  long long mask_sb;
  float scale_log2;  // hd^-0.5 * log2(e)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One tile of the online softmax, in base 2, on an m64nBN score fragment:
// scale, mask (a masked key scores NEG2), update the running row maxima
// m_lo / m_hi (rows r and r + 8), turn the scores into exp2(s - m) in place,
// and return the factors alpha that rescale the earlier sums and output, and
// this thread's partial row sums of the new P.
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], const float* msk, int c0,
                                               float scale_log2, float& m_lo, float& m_hi,
                                               float& alpha_lo, float& alpha_hi, float& sum_lo,
                                               float& sum_hi) {
  float mx_lo = NEG2, mx_hi = NEG2;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = msk[n * 8 + c0 + j] != 0.0f;
      sc[4 * n + j] = ok ? sc[4 * n + j] * scale_log2 : NEG2;
      sc[4 * n + 2 + j] = ok ? sc[4 * n + 2 + j] * scale_log2 : NEG2;
      mx_lo = fmaxf(mx_lo, sc[4 * n + j]);
      mx_hi = fmaxf(mx_hi, sc[4 * n + 2 + j]);
    }
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  alpha_lo = exp2f(m_lo - mn_lo);
  alpha_hi = exp2f(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  sum_lo = 0.0f;
  sum_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[4 * n + j] = exp2f(sc[4 * n + j] - mn_lo);
      sc[4 * n + 2 + j] = exp2f(sc[4 * n + 2 + j] - mn_hi);
      sum_lo += sc[4 * n + j];
      sum_hi += sc[4 * n + 2 + j];
    }
  }
}

template <bool LSE>
__global__ void __launch_bounds__(NTHREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q_tiles = (a.Lq + BM - 1) / BM;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int n_tiles = (a.Lk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, TILE);
      tma_load_rows<BM>(sm + Q_OFF, &tq, q_full, b, h, q0);
      const float* mrow = a.mask + (long long)b * a.mask_sb;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * KV_TILE + BN * 4);
        unsigned char* kv = sm + KV_OFF + s * 2 * KV_TILE;
        tma_load_rows<BN>(kv, &tk, &full[s], b, h, kt * BN);
        tma_load_rows<BN>(kv + KV_TILE, &tv, &full[s], b, h, kt * BN);
        bulk_load(sm + MASK_OFF + s * BN * 4, mrow + kt * BN, BN * 4, &full[s]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<240>();
    const int cw = warpgroup - 1;
    const int lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // and r_lo + 8
    const int c0 = (lane & 3) * 2;
    const uint32_t q_tile = smem_u32(sm + Q_OFF + cw * 64 * 128);

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    float m_lo = NEG2, m_hi = NEG2, l_lo = 0.0f, l_hi = 0.0f;
    uint32_t pf[BN / 16][4];  // P of the tile before, the A operand of its P V
    auto k_tile = [&](int st) { return smem_u32(sm + KV_OFF + st * 2 * KV_TILE); };
    auto mask_of = [&](int st) {
      return reinterpret_cast<const float*>(sm + MASK_OFF + st * BN * 4);
    };

    // Tile 0: S and its softmax; its P V is issued with tile 1's S.
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    {
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss<BN>(sc, desc_k<BM>(q_tile, kk), desc_k<BN>(k_tile(0), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha_lo, alpha_hi;
      online_softmax(sc, mask_of(0), c0, a.scale_log2, m_lo, m_hi, alpha_lo, alpha_hi, l_lo,
                     l_hi);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(sc, kk, pf[kk]);
    }
    // Tile kt: S = Q K^T and the previous tile's O += P V go to the tensor
    // cores together; the softmax of S runs while P V is still in flight.
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % STAGES;
      const int sp = (kt - 1) % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss<BN>(sc, desc_k<BM>(q_tile, kk), desc_k<BN>(k_tile(s), kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs_n128_mn(o, pf[kk], desc_mn<BN>(k_tile(sp) + KV_TILE, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is in; P V may still run
      fence_regs(sc);
      float alpha_lo, alpha_hi, sum_lo, sum_hi;
      online_softmax(sc, mask_of(s), c0, a.scale_log2, m_lo, m_hi, alpha_lo, alpha_hi, sum_lo,
                     sum_hi);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[sp]);  // the previous tile's K and V are consumed
      l_lo = l_lo * alpha_lo + sum_lo;  // per-thread partial sums; the quad sums at the end
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[4 * n] *= alpha_lo;
        o[4 * n + 1] *= alpha_lo;
        o[4 * n + 2] *= alpha_hi;
        o[4 * n + 3] *= alpha_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(sc, kk, pf[kk]);
    }
    // The last tile's P V.
    {
      const int sl = (n_tiles - 1) % STAGES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs_n128_mn(o, pf[kk], desc_mn<BN>(k_tile(sl) + KV_TILE, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[sl]);
    }

    // Epilogue: normalise, stage bf16 O in this warpgroup's Q rows, store.
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
    warpgroup_sync(1 + cw);  // every warp of the group is done reading its Q rows
    stage_acc<BM>(sm + Q_OFF, o, cw * 64, inv_lo, inv_hi);
    warpgroup_sync(1 + cw);
    __nv_bfloat16* op = a.o + (long long)b * a.o_sb + (long long)h * a.o_sh;
    store_tile_rows<BM>(op, a.o_sl, sm + Q_OFF, cw * 64, q0 + cw * 64, a.Lq);
    if constexpr (LSE) {
      if ((lane & 3) == 0) {
        float* lp = a.lse + (long long)bh * a.Lq + q0;
        if (q0 + r_lo < a.Lq) lp[r_lo] = m_lo * LN2 + logf(fmaxf(l_lo, 1e-30f));
        if (q0 + r_lo + 8 < a.Lq) lp[r_lo + 8] = m_hi * LN2 + logf(fmaxf(l_hi, 1e-30f));
      }
    }
  }
}

template <bool LSE>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Args& a, cudaStream_t stream) {
  static bool configured = false;  // per instantiation, one device per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel<LSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // One CTA per (b, h, 128 query rows); the query tiles of one (b, h) are
  // neighbours, so they share K and V through L2.
  const long long ctas = (long long)((a.Lq + BM - 1) / BM) * a.B * a.H;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwd_kernel<LSE><<<(unsigned)ctas, NTHREADS, SMEM_BYTES, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (cudaGetLastError() right after it).
extern "C" int flash_row_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v, const float* mask,
    void* o, int B, int H, int Lq, int Lk, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long o_sb, long long o_sl, long long o_sh, long long mask_sb,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, o, B, H, Lq, Lk, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
               v_sb, v_sl, v_sh, o_sb, o_sl, o_sh, mask_sb, scale};
  return dispatch<false>(dtype, head_dim, a, nullptr, static_cast<cudaStream_t>(stream));
}

// As flash_row_attention_fwd, and also writes lse, f32 [B, H, Lq] contiguous.
extern "C" int flash_row_attention_fwd_lse(
    int dtype, int head_dim, const void* q, const void* k, const void* v, const float* mask,
    void* o, float* lse, int B, int H, int Lq, int Lk, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl, long long o_sh,
    long long mask_sb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, o, B, H, Lq, Lk, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
               v_sb, v_sl, v_sh, o_sb, o_sl, o_sh, mask_sb, scale};
  return dispatch<true>(dtype, head_dim, a, lse, static_cast<cudaStream_t>(stream));
}

// The Hopper design, bf16 q/k/v with head_dim 128 (see wg:: above). mask is
// f32 [B, Lk_pad] with Lk_pad a multiple of 128, zero past Lk, row stride
// mask_sb (0 = shared), 16-byte aligned; o is bf16 [B, Lq, H, 128]; lse, if
// not null, f32 [B, H, Lq] contiguous. Strides in elements, multiples of 8,
// none 0 on a dim of size > 1. Returns the cudaError_t of the launch.
extern "C" int flash_row_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, const float* mask, void* o, float* lse, int B,
    int H, int Lq, int Lk, long long q_sb, long long q_sl, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh, long long mask_sb, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::make_map(&tq, q, B, Lq, H, q_sb, q_sl, q_sh);
  if (err == cudaSuccess) err = hopper::make_map(&tk, k, B, Lk, H, k_sb, k_sl, k_sh);
  if (err == cudaSuccess) err = hopper::make_map(&tv, v, B, Lk, H, v_sb, v_sl, v_sh);
  if (err != cudaSuccess) return (int)err;
  const wg::Args a{mask, static_cast<__nv_bfloat16*>(o), lse, B, H, Lq, Lk, o_sb, o_sl, o_sh,
                   mask_sb, scale * wg::LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(lse != nullptr ? wg::launch<true>(tq, tk, tv, a, s)
                              : wg::launch<false>(tq, tk, tv, a, s));
}

extern "C" const char* flash_row_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
