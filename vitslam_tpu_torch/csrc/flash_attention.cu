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
// Both compute O = softmax(Q K^T) V per (batch, head) in the exp2 domain.
// Q, K, V and O are addressed through (batch, head, token) strides, so K2's
// flat layout (head h at column h * D, token stride C) and K3's (B, H, N, D)
// layout are the same kernel; head dims 64 (the backbone) and 128 (the
// AlignmentHead) are two instances of one template. The TPU kernels' TNS
// variant, head groups, inner-K splits and single-K schedule are TPU layout
// tuning and are not carried over; their zero-padded keys' mass
// subtraction becomes a -inf mask of the ragged tail (the same numbers).
//
// What bounds it on the H100: per head two Nq * Nk * D products against
// O((Nq + Nk) * D) bytes; K2 at 75/30 (Nq = Nk = 30,900, 16 heads) is 3.91
// TFLOP for 253 MB, so it is tensor-core bound (3.95 ms at 989 TFLOP/s
// against 0.08 ms at 3.35 TB/s). Design: the wgmma + TMA core of
// attention_fwd_sm90.cuh (warp-specialised, K/V tiles of 128 keys through
// an mbarrier ring, both products on wgmma, S and P in registers). The
// scale fold costs no launch of its own: each consumer warpgroup multiplies
// its Q rows by scale * log2(e) in fp32 and rounds once to bf16, in shared
// memory, before its first wgmma, which gives the q that K4 rebuilds P
// from bit for bit. The fixed shift is read from the caller's device
// scalar (the natural-log logit bound) and multiplied by log2(e) in the
// kernel, so nothing syncs the host or launches beside the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_sm90.cuh"

namespace {

using vitslam::sm90::FwdParams;
using vitslam::sm90::kThreads;
using vitslam::sm90::launch_fwd;

// K2 and K3: the core with the scale folded into the Q tile.
template <int kD, bool kBounded>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ FwdParams p) {
  vitslam::sm90::attention_fwd<kD, kBounded, true>(p);
}

template <int kD>
cudaError_t launch(const FwdParams& p, const void* q, const void* k, const void* v, int B, int H,
                   const long long (&qs)[3], const long long (&ks)[3], const long long (&vs)[3],
                   cudaStream_t s) {
  auto kernel = p.static_max != nullptr ? flash_attention_kernel<kD, true>
                                        : flash_attention_kernel<kD, false>;
  return launch_fwd<kD>(kernel, p, q, k, v, B, H, qs, ks, vs, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). q: bf16 (B, H, Nq, dh) as it
// comes (the kernel folds log2(e) / sqrt(dh) into it), k/v: bf16
// (B, H, Nk, dh), o: bf16 (B, H, Nq, dh), dh 64 or 128, each addressed
// through the given element strides of (batch, head, token) with a
// contiguous head dim; strides and bases 16-byte aligned (the TMA maps'
// rule). static_max: fp32 device scalar holding the natural-log logit bound
// (the softmax shift is static_max * log2(e)), or null for the online row
// max. lse: fp32 (B, H, Nq) contiguous, written with the log2-domain row
// logsumexp, or null. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// layout it does not take).
extern "C" int vitslam_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* static_max, void* lse,
    int B, int H, int nq, int nk, int dh, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, void* stream) {
  if ((dh != 64 && dh != 128) || B < 1 || H < 1 || nq < 1 || nk < 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sn = o_sn;
  p.static_max = static_cast<const float*>(static_max);
  p.lse = static_cast<float*>(lse);
  p.nq = nq;
  p.nk = nk;
  // the double the wrapper computes (LOG2E / math.sqrt(dh)), rounded once
  p.q_fold = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(dh)));
  const long long qs[3] = {q_sb, q_sh, q_sn};
  const long long ks[3] = {k_sb, k_sh, k_sn};
  const long long vs[3] = {v_sb, v_sh, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh == 64 ? launch<64>(p, q, k, v, B, H, qs, ks, vs, s)
                                   : launch<128>(p, q, k, v, B, H, qs, ks, vs, s);
  return static_cast<int>(err);
}
