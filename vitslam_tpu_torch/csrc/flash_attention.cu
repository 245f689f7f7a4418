// Streaming flash attention forward for Hopper (sm_90a), bf16 in, bf16 out:
// one kernel for K2 and K3 of the port.
//
// Replaces:
//   K2 vitslam_tpu/ops/fused_attention.py::_flat_stream_tns_kernel (:483)
//      and ::_flat_stream_kernel (:402), launched by _flat_forward (:553):
//      attention over pre-prepped flat (B, N, C) q/k/v, fixed shift;
//   K3 vitslam_tpu/ops/flash_attention.py::_flash_kernel (:116), launched
//      by _flash_forward (:281): attention over (B*H, N, D) q/k/v, self or
//      cross (Nq != Nk), fixed shift or online max, and its optional log2
//      lse output (:164-165, :234-237), the softmax residual of the
//      backward (K4, flash_attention_bwd.cu).
// Both compute O = softmax(Q K^T) V per (batch, head) in the exp2 domain,
// with scale * log2(e) already folded into q by the wrapper. Q, K, V and O
// are addressed through (batch, head, token) strides, so K2's flat layout
// (head h at column h * 64, token stride C) and K3's (B, H, N, D) layout
// are the same kernel. Head dims 64 (the backbone) and 128 (the
// AlignmentHead: 8 heads over 1024) are two instances of one template.
// The TPU kernels' TNS (transposed accumulator) variant, head groups,
// inner-K splits and single-K schedule are TPU layout tuning: they compute
// the same numbers, and none is carried over.
//
// Softmax: with a fixed shift (qk-normed attention, the bound read from
// device memory through a pointer, so no launch syncs the host) or an
// online row max. The ragged K tail is masked to -inf; the TPU kernels
// instead subtract the zero-padded keys' mass n_pad * 2^-shift, which
// gives the same numbers. With an lse pointer the kernel also writes, per
// query row, shift + log2(l) in fp32: the fixed shift when bounded, the
// running row max otherwise (the same value either way, up to rounding).
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
// bank conflicts. At D = 64 a thread holds 32 fp32 accumulators, 16 q
// fragment registers and 32 logits, and two CTAs share an SM
// (__launch_bounds__(256, 2): at most 128 registers; 55,296 B of shared
// memory each). At D = 128 that grows to 64 + 32 + 32, more than 128
// registers hold, so the D = 128 instance is built for one CTA per SM (up
// to 255 registers; 104,448 B of shared memory), at half the resident
// warps. nvcc's register and spill counts per instance are in PERF.md. Not
// done yet: wgmma, TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using vitslam::kBlockN;
using vitslam::load_tile;
using vitslam::mma_bf16_16816;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // 128 query rows per CTA

template <int kD>
struct Tiles {
  static constexpr int kStride = kD + 8;  // padded smem row (bf16), 16-B aligned
  static constexpr size_t kQBytes = sizeof(__nv_bfloat16) * kBlockM * kStride;
  static constexpr size_t kKvBytes = sizeof(__nv_bfloat16) * kBlockN * kStride;
  static constexpr size_t kSmemBytes = kQBytes + 4 * kKvBytes;  // q + 2 stages of k and v
  static constexpr int kMinBlocks = kD == 64 ? 2 : 1;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* shift;
  float* lse;  // (B, H, nq) fp32, or null
  int nq, nk;
  // element strides of (batch, head, token); the head dim is contiguous
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
};

template <int kD, bool kBounded>
__global__ void __launch_bounds__(kThreads, Tiles<kD>::kMinBlocks)
    flash_attention_kernel(const Params p) {
  using T = Tiles<kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto q_s = reinterpret_cast<__nv_bfloat16 (*)[T::kStride]>(smem);
  auto k_s = reinterpret_cast<__nv_bfloat16 (*)[kBlockN][T::kStride]>(smem + T::kQBytes);
  auto v_s = reinterpret_cast<__nv_bfloat16 (*)[kBlockN][T::kStride]>(smem + T::kQBytes +
                                                                        2 * T::kKvBytes);

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

  load_tile<kBlockM, kD, kThreads>(q_s, qb, p.q_sn, q0, p.nq);
  load_tile<kBlockN, kD, kThreads>(k_s[0], kb, p.k_sn, 0, p.nk);
  load_tile<kBlockN, kD, kThreads>(v_s[0], vb, p.v_sn, 0, p.nk);
  vitslam::cp_async_commit();
  vitslam::cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as the A fragments of Q K^T: lanes 0-15 address
  // rows 0-15 at column 0 of a 16-wide k-step, lanes 16-31 at column 8
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    vitslam::ldmatrix_x4(qa[kk], &q_s[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const float shift = kBounded ? *p.shift : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile<kBlockN, kD, kThreads>(k_s[cur ^ 1], kb, p.k_sn, (it + 1) * kBlockN, p.nk);
      load_tile<kBlockN, kD, kThreads>(v_s[cur ^ 1], vb, p.v_sn, (it + 1) * kBlockN, p.nk);
      vitslam::cp_async_commit();
      vitslam::cp_async_wait<1>();
    } else {
      vitslam::cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T, 16 rows x 64 keys: one ldmatrix.x4 gives the B fragments
    // of one 8-key n-tile over 32 head dims (two k-steps)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kh = 0; kh < kD / 32; ++kh) {
        uint32_t kf[4];
        vitslam::ldmatrix_x4(kf, &k_s[cur][j * 8 + (lane % 8)][kh * 32 + (lane / 8) * 8]);
        mma_bf16_16816(s[j], qa[2 * kh], kf[0], kf[1]);
        mma_bf16_16816(s[j], qa[2 * kh + 1], kf[2], kf[3]);
      }
    }
    vitslam::mask_tail(s, it * kBlockN, p.nk, c2);
    uint32_t pa[kBlockN / 16][4];
    vitslam::softmax_tile<kBounded>(s, acc, m_row, l_row, shift, pa);
    // O += P V
    vitslam::mma_py<kBlockN, kD>(acc, pa, v_s[cur], lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int n0 = q0 + warp * 16 + g;
  const int n1 = n0 + 8;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh + c2;
  vitslam::store_rows(acc, l_row, n0 < p.nq ? ob + n0 * p.o_sn : nullptr,
                      n1 < p.nq ? ob + n1 * p.o_sn : nullptr);
  if (p.lse != nullptr && (lane & 3) == 0) {
    // store_rows left the quad's full row sums in l_row; m_row is the same
    // in every lane of the quad
    float* lb = p.lse + (static_cast<long long>(b) * gridDim.y + h) * p.nq;
    if (n0 < p.nq) lb[n0] = (kBounded ? shift : m_row[0]) + log2f(fmaxf(l_row[0], 1e-30f));
    if (n1 < p.nq) lb[n1] = (kBounded ? shift : m_row[1]) + log2f(fmaxf(l_row[1], 1e-30f));
  }
}

template <int kD, bool kBounded>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kD, kBounded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tiles<kD>::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + kBlockM - 1) / kBlockM, H, B);
  flash_attention_kernel<kD, kBounded><<<grid, kThreads, Tiles<kD>::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q: bf16 (B, H, Nq, dh), k/v:
// bf16 (B, H, Nk, dh), o: bf16 (B, H, Nq, dh), dh 64 or 128, each addressed
// through the given element strides of (batch, head, token) with a
// contiguous head dim, every row 16-byte aligned; q carries scale *
// log2(e). shift: fp32 device scalar holding the log2-domain softmax shift,
// or null for the online row max. lse: fp32 (B, H, Nq) contiguous, written
// with the log2-domain row logsumexp, or null. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int vitslam_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* shift, void* lse, int B,
    int H, int nq, int nk, int dh, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, void* stream) {
  if ((dh != 64 && dh != 128) || B < 1 || H < 1 || nq < 1 || nk < 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o),
                 static_cast<const float*>(shift),
                 static_cast<float*>(lse),
                 nq, nk, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bounded = shift != nullptr;
  cudaError_t err;
  if (dh == 64) {
    err = bounded ? launch<64, true>(p, B, H, s) : launch<64, false>(p, B, H, s);
  } else {
    err = bounded ? launch<128, true>(p, B, H, s) : launch<128, false>(p, B, H, s);
  }
  return static_cast<int>(err);
}
