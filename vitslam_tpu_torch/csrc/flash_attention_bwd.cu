// Flash attention backward for Hopper (sm_90a), bf16 in, bf16 out: K4 of
// the port, two kernels.
//
// Replaces:
//   vitslam_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:384) and
//   ::_flash_bwd_dkv_kernel (:421), launched by _flash_backward (:462):
//   the FA2 backward of softmax(Q K^T * scale) V from the saved output O
//   and the log2-domain row logsumexp (K3's lse output), self or cross
//   (Nq != Nk), head dim 64 or 128.
// Math, per (batch, head), with qs = q * scale * log2(e) (rounded to bf16
// by the wrapper, as the forward's q) and Dvec = rowsum(dO * O) (computed
// in fp32 by the wrapper, as the reference computes it in XLA):
//   P  = exp2(qs K^T - lse)            rebuilt per tile, no max tracking
//   dP = dO V^T,  dS = P * (dP - Dvec)
//   dq = scale * dS K,  dk = dS^T qs / log2(e),  dv = P^T dO
// dS and P enter their products rounded to bf16 (the reference casts them
// to the input dtype); every product accumulates in fp32.
// Masks: keys >= Nk get P = 0 in both kernels (their zero-filled rows
// would otherwise carry exp2(-lse) of mass); query rows >= Nq get lse =
// +inf and Dvec = 0, so P = 0 and they add nothing to dk and dv (the
// reference pads lse with +inf the same way). Rows past the end are never
// stored.
//
// What bounds it on the H100: five Nq x Nk x D products per head (two in
// each kernel recompute S and dP, then dq; dk and dv), 10 Nq Nk D H FLOP,
// against O((Nq + Nk) D) bytes: tensor-core bound (the AlignmentHead's
// global attention at 10,738 tokens, 8 heads of 128: 1.18 ms at 989
// TFLOP/s). Design: the TPU grid's sequential K (or Q) axis becomes a loop
// inside the CTA, so nothing is carried between CTAs and no atomics are
// needed: the dq kernel gives each CTA 128 query rows (16 per warp) and
// streams K/V tiles of 64 keys; the dk/dv kernel gives each CTA 128 key
// rows and streams Q/dO tiles (64 queries at D = 64, 32 at D = 128, so the
// two fp32 accumulators of 2 x D / 2 registers each fit beside the tile's
// logits) with their lse and Dvec. Tiles come through a two-stage cp.async
// ring (the next tile loads while this one computes); the rows a CTA owns
// stay in shared memory and their fragments are re-read with ldmatrix per
// tile, which keeps registers for the accumulators. S, dP and dS stay in
// registers: the products are mma.sync m16n8k16 bf16 -> fp32 over the
// fragment layouts of attention_common.cuh (mma_xyt for X Y^T, mma_py for
// P Y with the P fragments re-packed from an accumulator tile). One CTA
// per SM (up to 255 registers a thread). Not done yet: wgmma, TMA, warp
// specialisation, and a single kernel that computes S and dP once for all
// three gradients (with atomics on dq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using vitslam::load_tile;
using vitslam::mma_py;
using vitslam::mma_xyt;
using vitslam::pack_a;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows a CTA owns: queries (dq) or keys (dk/dv)
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Tiles {
  static constexpr int kStride = kD + 8;  // padded smem row (bf16), 16-B aligned
  static constexpr int kTileK = 64;                 // keys per tile of the dq kernel
  static constexpr int kTileQ = kD == 128 ? 32 : 64;  // queries per tile of the dk/dv kernel
  static constexpr size_t kRowBytes = sizeof(__nv_bfloat16) * kStride;
  // dq: q and dO of the CTA's rows + 2 stages of k and v
  static constexpr size_t kDqSmem = kRowBytes * (2 * kRows + 4 * kTileK);
  // dk/dv: k and v of the CTA's rows + 2 stages of qs and dO + 2 stages of lse and Dvec
  static constexpr size_t kDkvSmem =
      kRowBytes * (2 * kRows + 4 * kTileQ) + sizeof(float) * 4 * kTileQ;
};

struct Params {
  const __nv_bfloat16* q;   // carries scale * log2(e)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;   // (B, H, nq) fp32, log2 domain
  const float* dvec;  // (B, H, nq) fp32, rowsum(dO * O)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int nq, nk;
  float scale;
  // element strides of (batch, head, token); the head dim is contiguous
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, do_sb, do_sh, do_sn;
  long long dq_sb, dq_sh, dq_sn, dk_sb, dk_sh, dk_sn, dv_sb, dv_sh, dv_sn;
};

// dq = scale * sum over key tiles of dS K, dS = exp2(S - lse) * (dO V^T - Dvec)
template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const Params p) {
  using T = Tiles<kD>;
  constexpr int kN = T::kTileK;
  extern __shared__ __align__(16) unsigned char smem[];
  auto q_s = reinterpret_cast<__nv_bfloat16 (*)[T::kStride]>(smem);
  auto do_s = q_s + kRows;
  auto k_s = reinterpret_cast<__nv_bfloat16 (*)[kN][T::kStride]>(do_s + kRows);
  auto v_s = k_s + 2;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int n_tiles = (p.nk + kN - 1) / kN;

  load_tile<kRows, kD, kThreads>(q_s, qb, p.q_sn, q0, p.nq);
  load_tile<kRows, kD, kThreads>(do_s, dob, p.do_sn, q0, p.nq);
  load_tile<kN, kD, kThreads>(k_s[0], kb, p.k_sn, 0, p.nk);
  load_tile<kN, kD, kThreads>(v_s[0], vb, p.v_sn, 0, p.nk);
  vitslam::cp_async_commit();

  // the lse and Dvec of this lane's two rows; rows past the end get
  // lse = +inf (P = 0) and are never stored
  const int n0 = q0 + warp * 16 + g;
  const int n1 = n0 + 8;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * p.nq;
  const float lse0 = n0 < p.nq ? p.lse[row_base + n0] : INFINITY;
  const float lse1 = n1 < p.nq ? p.lse[row_base + n1] : INFINITY;
  const float dd0 = n0 < p.nq ? p.dvec[row_base + n0] : 0.f;
  const float dd1 = n1 < p.nq ? p.dvec[row_base + n1] : 0.f;

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile<kN, kD, kThreads>(k_s[cur ^ 1], kb, p.k_sn, (it + 1) * kN, p.nk);
      load_tile<kN, kD, kThreads>(v_s[cur ^ 1], vb, p.v_sn, (it + 1) * kN, p.nk);
      vitslam::cp_async_commit();
      vitslam::cp_async_wait<1>();
    } else {
      vitslam::cp_async_wait<0>();
    }
    __syncthreads();

    float s[kN / 8][4];
    mma_xyt<kN, kD>(s, q_s + warp * 16, k_s[cur], lane);    // log2-domain logits
    float dp[kN / 8][4];
    mma_xyt<kN, kD>(dp, do_s + warp * 16, v_s[cur], lane);  // dO V^T
    const int k0 = it * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + j * 8 + c2 + (e & 1) < p.nk;
        const float pr = valid ? exp2f(s[j][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = pr * (dp[j][e] - (e < 2 ? dd0 : dd1));  // dS
      }
    }
    uint32_t dsa[kN / 16][4];
    pack_a<kN>(s, dsa);
    mma_py<kN, kD>(acc, dsa, k_s[cur], lane);  // dq += dS K
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  __nv_bfloat16* out = p.dq + b * p.dq_sb + h * p.dq_sh + c2;
  vitslam::store_scaled(acc, p.scale, p.scale, n0 < p.nq ? out + n0 * p.dq_sn : nullptr,
                        n1 < p.nq ? out + n1 * p.dq_sn : nullptr);
}

// Load one tile's lse and Dvec (queries [q0, q0 + kN)) into shared memory;
// queries past the end get lse = +inf and Dvec = 0, so their P is 0.
template <int kN>
__device__ __forceinline__ void load_rows(float* lse_s, float* dd_s, const float* lse,
                                          const float* dvec, int q0, int nq) {
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const int n = q0 + i;
    lse_s[i] = n < nq ? lse[n] : INFINITY;
    dd_s[i] = n < nq ? dvec[n] : 0.f;
  }
}

// dv = sum over query tiles of P^T dO; dk = sum of dS^T qs / log2(e), with
// the transposed tiles S^T = K qs^T and dP^T = V dO^T computed directly
// (rows keys, columns queries)
template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const Params p) {
  using T = Tiles<kD>;
  constexpr int kN = T::kTileQ;
  extern __shared__ __align__(16) unsigned char smem[];
  auto k_s = reinterpret_cast<__nv_bfloat16 (*)[T::kStride]>(smem);
  auto v_s = k_s + kRows;
  auto q_s = reinterpret_cast<__nv_bfloat16 (*)[kN][T::kStride]>(v_s + kRows);
  auto do_s = q_s + 2;
  auto lse_s = reinterpret_cast<float (*)[kN]>(do_s + 2);
  auto dd_s = lse_s + 2;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * p.nq;
  const float* lseb = p.lse + row_base;
  const float* ddb = p.dvec + row_base;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int n_tiles = (p.nq + kN - 1) / kN;

  load_tile<kRows, kD, kThreads>(k_s, kb, p.k_sn, k0, p.nk);
  load_tile<kRows, kD, kThreads>(v_s, vb, p.v_sn, k0, p.nk);
  load_tile<kN, kD, kThreads>(q_s[0], qb, p.q_sn, 0, p.nq);
  load_tile<kN, kD, kThreads>(do_s[0], dob, p.do_sn, 0, p.nq);
  vitslam::cp_async_commit();
  load_rows<kN>(lse_s[0], dd_s[0], lseb, ddb, 0, p.nq);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      const int next = (it + 1) * kN;
      load_tile<kN, kD, kThreads>(q_s[cur ^ 1], qb, p.q_sn, next, p.nq);
      load_tile<kN, kD, kThreads>(do_s[cur ^ 1], dob, p.do_sn, next, p.nq);
      vitslam::cp_async_commit();
      load_rows<kN>(lse_s[cur ^ 1], dd_s[cur ^ 1], lseb, ddb, next, p.nq);
      vitslam::cp_async_wait<1>();
    } else {
      vitslam::cp_async_wait<0>();
    }
    __syncthreads();

    float s[kN / 8][4];
    mma_xyt<kN, kD>(s, k_s + warp * 16, q_s[cur], lane);    // S^T, log2 domain
    float dp[kN / 8][4];
    mma_xyt<kN, kD>(dp, v_s + warp * 16, do_s[cur], lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + c2 + (e & 1);  // the query of this element
        s[j][e] = exp2f(s[j][e] - lse_s[cur][col]);           // P^T
        dp[j][e] = s[j][e] * (dp[j][e] - dd_s[cur][col]);     // dS^T
      }
    }
    uint32_t pa[kN / 16][4];
    pack_a<kN>(s, pa);
    mma_py<kN, kD>(dv_acc, pa, do_s[cur], lane);  // dv += P^T dO
    uint32_t dsa[kN / 16][4];
    pack_a<kN>(dp, dsa);
    mma_py<kN, kD>(dk_acc, dsa, q_s[cur], lane);  // dk += dS^T qs
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int r0 = k0 + warp * 16 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh + c2;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh + c2;
  // qs carries scale * log2(e): dividing by log2(e) leaves exactly scale
  vitslam::store_scaled(dk_acc, 1.0f / kLog2e, 1.0f / kLog2e,
                        r0 < p.nk ? dkb + r0 * p.dk_sn : nullptr,
                        r1 < p.nk ? dkb + r1 * p.dk_sn : nullptr);
  vitslam::store_scaled(dv_acc, 1.0f, 1.0f, r0 < p.nk ? dvb + r0 * p.dv_sn : nullptr,
                        r1 < p.nk ? dvb + r1 * p.dv_sn : nullptr);
}

template <int kD>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  using T = Tiles<kD>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kDqSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kDkvSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.nq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<kD><<<grid_q, kThreads, T::kDqSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((p.nk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<kD><<<grid_k, kThreads, T::kDkvSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q (carrying scale * log2(e)),
// dout, dq: bf16 (B, H, Nq, dh); k, v, dk, dv: bf16 (B, H, Nk, dh); dh 64 or
// 128; each addressed through the given element strides of (batch, head,
// token) with a contiguous head dim, every row 16-byte aligned. lse (log2
// domain) and dvec (rowsum(dout * out)): fp32 (B, H, Nq) contiguous.
// Launches the dq kernel, then the dk/dv kernel, on `stream`; allocates
// nothing; returns the first non-zero cudaGetLastError() (cudaErrorInvalid
// Value for a shape it does not take).
extern "C" int vitslam_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dvec, void* dq, void* dk, void* dv, int B, int H, int nq, int nk, int dh,
    float scale, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long do_sb,
    long long do_sh, long long do_sn, long long dq_sb, long long dq_sh, long long dq_sn,
    long long dk_sb, long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh,
    long long dv_sn, void* stream) {
  if ((dh != 64 && dh != 128) || B < 1 || H < 1 || nq < 1 || nk < 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
                 static_cast<const float*>(lse), static_cast<const float*>(dvec),
                 static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), nq, nk, scale,
                 q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, do_sb, do_sh, do_sn,
                 dq_sb, dq_sh, dq_sn, dk_sb, dk_sh, dk_sn, dv_sb, dv_sh, dv_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh == 64 ? launch<64>(p, B, H, s) : launch<128>(p, B, H, s);
  return static_cast<int>(err);
}
