// Streaming flash attention forward for Hopper (sm_90a), bf16 in, bf16 out:
// one kernel for K2 and K3 of the port.
//
// Replaces:
//   K2 vitslam_tpu/ops/fused_attention.py::_flat_stream_tns_kernel (:483)
//      and ::_flat_stream_kernel (:402), launched by _flat_forward (:553):
//      attention over pre-prepped flat (B, N, C) q/k/v, fixed shift;
//   K3 vitslam_tpu/ops/flash_attention.py::_flash_kernel (:116), launched
//      by _flash_forward (:281): attention over (B*H, N, D) q/k/v, self or
//      cross (Nq != Nk), fixed shift or online max (the forward only: its
//      log2 lse output belongs to the training slice).
// Both compute O = softmax(Q K^T) V per (batch, head) in the exp2 domain,
// with scale * log2(e) already folded into q by the wrapper. Q, K, V and O
// are addressed through (batch, head, token) strides, so K2's flat layout
// (head h at column h * 64, token stride C) and K3's (B, H, N, D) layout
// are the same kernel. The TPU kernels' TNS (transposed accumulator)
// variant, head groups, inner-K splits and single-K schedule are TPU layout
// tuning: they compute the same numbers, and none is carried over.
//
// Softmax: with a fixed shift (qk-normed attention, the bound read from
// device memory through a pointer, so no launch syncs the host) or an
// online row max. The ragged K tail is masked to -inf; the TPU kernels
// instead subtract the zero-padded keys' mass n_pad * 2^-shift, which
// gives the same numbers.
//
// What bounds it on the H100: per head two Nq * Nk * 64 products against
// O((Nq + Nk) * 64) bytes; K2 at 75/30 (Nq = Nk = 30,900, 16 heads) is
// 3.91 TFLOP for 253 MB, so it is tensor-core bound (3.95 ms at 989
// TFLOP/s against 0.08 ms at 3.35 TB/s). Design: S and P stay in
// registers (mma.sync m16n8k16 bf16 -> fp32, the softmax on the
// accumulator fragments, P re-packed as the A operand of P V: the attention
// core shared with K1 in attention_common.cuh). A CTA of 8 warps owns 128
// query rows of one (batch, head), 16 rows a warp, so each K/V tile read
// from L2 serves 128 rows. K/V tiles of 64 keys stream through a two-stage
// cp.async ring (the next tile loads while this one computes); fragments
// come out of padded shared memory with ldmatrix (.trans for V), without
// bank conflicts. Not done yet: wgmma, TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using vitslam::kBlockN;
using vitslam::kDh;
using vitslam::mma_bf16_16816;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // 128 query rows per CTA
constexpr int kStride = kDh + 8;      // padded smem row (bf16): 144 B, 16-B aligned
constexpr int kChunks = kDh / 8;      // 16-byte chunks per row
constexpr size_t kQBytes = sizeof(__nv_bfloat16) * kBlockM * kStride;
constexpr size_t kKvBytes = sizeof(__nv_bfloat16) * kBlockN * kStride;
constexpr size_t kSmemBytes = kQBytes + 4 * kKvBytes;  // q + 2 stages of k and v

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* shift;
  int nq, nk;
  // element strides of (batch, head, token); the head dim is contiguous
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Start copying rows [row0, row0 + kRows) of one (batch, head) slice into
// a padded shared tile; rows >= n_rows are zero-filled (a zero V row keeps
// the masked keys' 0 * V finite).
template <int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kStride],
                                          const __nv_bfloat16* base, long long row_stride,
                                          int row0, int n_rows) {
  static_assert(kRows * kChunks % kThreads == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int n = row0 + r;
    const bool valid = n < n_rows;
    const __nv_bfloat16* src = valid ? base + n * row_stride + col : base;
    cp_async_16(&dst[r][col], src, valid);
  }
}

template <bool kBounded>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto q_s = reinterpret_cast<__nv_bfloat16 (*)[kStride]>(smem);
  auto k_s = reinterpret_cast<__nv_bfloat16 (*)[kBlockN][kStride]>(smem + kQBytes);
  auto v_s = reinterpret_cast<__nv_bfloat16 (*)[kBlockN][kStride]>(smem + kQBytes + 2 * kKvBytes);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;        // fragment row group
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int n_tiles = (p.nk + kBlockN - 1) / kBlockN;

  load_tile<kBlockM>(q_s, qb, p.q_sn, q0, p.nq);
  load_tile<kBlockN>(k_s[0], kb, p.k_sn, 0, p.nk);
  load_tile<kBlockN>(v_s[0], vb, p.v_sn, 0, p.nk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as the A fragments of Q K^T: lanes 0-15 address
  // rows 0-15 at column 0 of a 16-wide k-step, lanes 16-31 at column 8
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    ldmatrix_x4(qa[kk], &q_s[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
  }

  float acc[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const float shift = kBounded ? *p.shift : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile<kBlockN>(k_s[cur ^ 1], kb, p.k_sn, (it + 1) * kBlockN, p.nk);
      load_tile<kBlockN>(v_s[cur ^ 1], vb, p.v_sn, (it + 1) * kBlockN, p.nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T, 16 rows x 64 keys: one ldmatrix.x4 gives the B fragments
    // of one 8-key n-tile over 32 head dims (two k-steps)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kh = 0; kh < kDh / 32; ++kh) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &k_s[cur][j * 8 + (lane % 8)][kh * 32 + (lane / 8) * 8]);
        mma_bf16_16816(s[j], qa[2 * kh], kf[0], kf[1]);
        mma_bf16_16816(s[j], qa[2 * kh + 1], kf[2], kf[3]);
      }
    }
    vitslam::mask_tail(s, it * kBlockN, p.nk, c2);
    uint32_t pa[kBlockN / 16][4];
    vitslam::softmax_tile<kBounded>(s, acc, m_row, l_row, shift, pa);

    // O += P V: one ldmatrix.x4.trans gives the B fragments of two 8-wide
    // head-dim n-tiles over one 16-key k-step
#pragma unroll
    for (int jp = 0; jp < kDh / 16; ++jp) {
#pragma unroll
      for (int t = 0; t < kBlockN / 16; ++t) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, &v_s[cur][t * 16 + (lane % 8) + ((lane / 8) & 1) * 8][(2 * jp + lane / 16) * 8]);
        mma_bf16_16816(acc[2 * jp], pa[t], vf[0], vf[1]);
        mma_bf16_16816(acc[2 * jp + 1], pa[t], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int n0 = q0 + warp * 16 + g;
  const int n1 = n0 + 8;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh + c2;
  vitslam::store_rows(acc, l_row, n0 < p.nq ? ob + n0 * p.o_sn : nullptr,
                      n1 < p.nq ? ob + n1 * p.o_sn : nullptr);
}

template <bool kBounded>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kBounded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + kBlockM - 1) / kBlockM, H, B);
  flash_attention_kernel<kBounded><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q: bf16 (B, H, Nq, 64), k/v: bf16
// (B, H, Nk, 64), o: bf16 (B, H, Nq, 64), each addressed through the given
// element strides of (batch, head, token) with a contiguous head dim, every
// row 16-byte aligned; q carries scale * log2(e). shift: fp32 device scalar
// holding the log2-domain softmax shift, or null for the online row max.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int vitslam_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* shift, int B, int H,
    int nq, int nk, int dh, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn, void* stream) {
  if (dh != kDh || B < 1 || H < 1 || nq < 1 || nk < 1 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o),
                 static_cast<const float*>(shift),
                 nq, nk, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = shift != nullptr ? launch<true>(p, B, H, s) : launch<false>(p, B, H, s);
  return static_cast<int>(err);
}
