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
// ~295 FLOP/byte ridge: the bound is tensor-core throughput. The design
// answers that with bf16 tensor-core MMAs (WMMA 16x16x16 fragments, f32
// accumulate) for both products, K/V tiles staged once in shared memory per
// 64 query rows, and per-warp ownership of 16 query rows so the softmax needs
// only warp-level synchronisation. It is the simple first version: no TMA,
// no wgmma, no warp specialisation, no software pipelining (later work).
//
// Layout: q, o are [B, Lq, H, hd] and k, v are [B, Lk, H, hd], read through
// their strides (last dim contiguous, rows 16-byte aligned; the wrapper checks).
// The mask is f32 [B, Lk] with row stride mask_sb; mask_sb == 0 shares one
// [Lk] row across the batch, so shared and per-batch masks take one path.
// One CTA per (b*h, 64 query rows); the loop over key tiles inside the CTA
// replaces the TPU's sequential key axis of the grid. Ragged Lq/Lk edges are
// masked here: rows past Lq are neither read nor written, keys past Lk load
// as zeros and score -1e30. The kernel allocates nothing and never
// synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

template <typename T, bool LSE>
cudaError_t dispatch_hd(int hd, const Args& a, float* lse, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, LSE>(a, lse, stream);
    case 32: return launch<T, 32, LSE>(a, lse, stream);
    case 128: return launch<T, 128, LSE>(a, lse, stream);
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

extern "C" const char* flash_row_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
