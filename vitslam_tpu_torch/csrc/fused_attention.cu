// Fused qkv-packed self-attention for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces: vitslam_tpu/ops/fused_attention.py::_fused_kernel (the Pallas
// TPU kernel behind fused_qkv_attention). Same math: q/k/v are sliced per
// head straight out of the packed (B, N, 3C) projection (row stride 3C,
// nothing transposed in device memory); optional per-head LayerNorm (fp32
// stats E[x^2] - E[x]^2, eps 1e-6) and RoPE x*cos + rotate_half_multi(x)*sin
// run on the q and k tiles in registers; scale*log2(e) is folded into q;
// S = Q K^T in bf16 with fp32 accumulation, key columns >= N masked (a padded
// key row would come out of LayerNorm as the bias vector, which is not zero
// mass); exp2-domain softmax with either a fixed shift (qk-norm bounds the
// logits) or an online row max; P V accumulated in fp32 beside the row sum
// l; output acc / max(l, 1e-30) written as bf16 into the head's column slice
// of the flat (B, N, C) output.
//
// What bounds it on the H100: at dh = 64 the work is two N^2*dh products per
// head (the global attention of the flagship at N = 2060 with 16 heads is
// 4 * 2060^2 * 64 * 16 = 17.4 GFLOP), while the bytes moved are O(N*C), so
// the kernel is tensor-core bound. The design keeps both products on the
// tensor cores (mma.sync m16n8k16 bf16 -> fp32) and keeps S and P in
// registers: the softmax runs on the accumulator fragments, and P is
// re-packed as the A operand of the P V product without a trip through
// shared memory. One CTA of 4 warps owns a 64-row q tile of one (batch,
// head); each warp owns 16 rows. The q tile is prepped once; each 64-key
// tile is prepped as it arrives (LayerNorm + RoPE on k are recomputed per q
// tile: O(N*dh) per tile against O(N*dh*64) for Q K^T). V is stored
// transposed in shared memory so its B fragments are single 32-bit loads.
// The softmax step and the epilogue are the attention core it shares with
// flash_attention.cu (attention_common.cuh).
// Not done yet: wgmma, TMA, cp.async double buffering and preparing K once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using vitslam::kBlockN;
using vitslam::kDh;
using vitslam::kFull;
using vitslam::mma_bf16_16816;
using vitslam::pack_bf16;

constexpr int kBlockM = 64;      // q rows per CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockM / kWarps;  // 16
constexpr int kStride = kDh + 8;  // padded smem row (bf16): conflict-free fragment loads
constexpr float kLnEps = 1e-6f;

// LayerNorm + RoPE of one token row of one head, spread over a warp: lane l
// holds elements 2l and 2l+1. All 32 lanes must call it together.
template <bool kLn, bool kRope>
__device__ __forceinline__ void prep_row(float& x0, float& x1, int lane,
                                         const float* __restrict__ ln_scale,
                                         const float* __restrict__ ln_bias,
                                         const float* __restrict__ cos_row,
                                         const float* __restrict__ sin_row,
                                         int nsplit) {
  const int d = 2 * lane;
  if (kLn) {
    float s = x0 + x1;
    float ss = x0 * x0 + x1 * x1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(kFull, s, o);
      ss += __shfl_xor_sync(kFull, ss, o);
    }
    const float mean = s * (1.0f / kDh);
    const float var = ss * (1.0f / kDh) - mean * mean;
    const float inv = rsqrtf(var + kLnEps);
    x0 = (x0 - mean) * inv * ln_scale[d] + ln_bias[d];
    x1 = (x1 - mean) * inv * ln_scale[d + 1] + ln_bias[d + 1];
  }
  if (kRope) {
    // rotate_half_multi: within each of nsplit blocks of seg elements,
    // out[t] = -x[t + half] for t < half, out[t] = x[t - half] otherwise.
    // half is even, so both of a lane's elements share one partner lane.
    const int seg = kDh / nsplit;
    const int half = seg / 2;
    const bool lower = (d % seg) < half;
    const int src = lower ? lane + half / 2 : lane - half / 2;
    const float p0 = __shfl_sync(kFull, x0, src);
    const float p1 = __shfl_sync(kFull, x1, src);
    const float r0 = lower ? -p0 : p0;
    const float r1 = lower ? -p1 : p1;
    x0 = x0 * cos_row[d] + r0 * sin_row[d];
    x1 = x1 * cos_row[d + 1] + r1 * sin_row[d + 1];
  }
}

template <bool kLn, bool kRope, bool kBounded>
__global__ void __launch_bounds__(kThreads)
fused_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           const float* __restrict__ cos_tab,
                           const float* __restrict__ sin_tab,
                           const float* __restrict__ ln,  // [q_scale|q_bias|k_scale|k_bias], 4*kDh
                           const float* __restrict__ shift_ptr,
                           int N, int H, int nsplit, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockM][kStride];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN][kStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[kDh][kStride];  // [dim][key]

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * kDh;
  const size_t row_stride = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* qkv_b = qkv + static_cast<size_t>(b) * N * row_stride;
  const float* cos_b = kRope ? cos_tab + static_cast<size_t>(b) * N * kDh : nullptr;
  const float* sin_b = kRope ? sin_tab + static_cast<size_t>(b) * N * kDh : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;        // fragment row group
  const int c2 = (lane & 3) * 2;  // fragment column pair

  // ---- q tile: prep once, fold scale*log2(e), keep as A fragments ----
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const int n = q0 + row;  // warp-uniform
    float x0 = 0.f, x1 = 0.f;
    if (n < N) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          qkv_b + n * row_stride + h * kDh + 2 * lane);
      x0 = __low2float(v);
      x1 = __high2float(v);
      prep_row<kLn, kRope>(x0, x1, lane, ln, ln + kDh,
                           kRope ? cos_b + static_cast<size_t>(n) * kDh : nullptr,
                           kRope ? sin_b + static_cast<size_t>(n) * kDh : nullptr, nsplit);
      x0 *= qscale;
      x1 *= qscale;
    }
    *reinterpret_cast<uint32_t*>(&q_s[row][2 * lane]) = pack_bf16(x0, x1);
  }
  __syncwarp();
  uint32_t qa[kDh / 16][4];
  {
    const int r0 = warp * kRowsPerWarp + g;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(&q_s[r0][kk * 16 + c2]);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(&q_s[r0 + 8][kk * 16 + c2]);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(&q_s[r0][kk * 16 + 8 + c2]);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(&q_s[r0 + 8][kk * 16 + 8 + c2]);
    }
  }

  float acc[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // rows g and g+8 of this warp's 16: running max (online) and the lane's
  // partial row sums (reduced over the quad at the end)
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const float shift = kBounded ? *shift_ptr : 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int n = k0 + row;  // warp-uniform
      float x0 = 0.f, x1 = 0.f;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (n < N) {
        const __nv_bfloat16* tok = qkv_b + n * row_stride + h * kDh + 2 * lane;
        const __nv_bfloat162 k = *reinterpret_cast<const __nv_bfloat162*>(tok + C);
        v = *reinterpret_cast<const __nv_bfloat162*>(tok + 2 * C);
        x0 = __low2float(k);
        x1 = __high2float(k);
        prep_row<kLn, kRope>(x0, x1, lane, ln + 2 * kDh, ln + 3 * kDh,
                             kRope ? cos_b + static_cast<size_t>(n) * kDh : nullptr,
                             kRope ? sin_b + static_cast<size_t>(n) * kDh : nullptr, nsplit);
      }
      *reinterpret_cast<uint32_t*>(&k_s[row][2 * lane]) = pack_bf16(x0, x1);
      vt_s[2 * lane][row] = v.x;
      vt_s[2 * lane + 1][row] = v.y;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][kk * 16 + c2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][kk * 16 + 8 + c2]);
        mma_bf16_16816(s[j], qa[kk], b0, b1);
      }
    }
    vitslam::mask_tail(s, k0, N, c2);
    // P in bf16, laid out directly as the A fragments of P V
    uint32_t pa[kBlockN / 16][4];
    vitslam::softmax_tile<kBounded>(s, acc, m_row, l_row, shift, pa);

    // O += P V over 8 n-tiles of the head dim
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
#pragma unroll
      for (int t = 0; t < kBlockN / 16; ++t) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&vt_s[j * 8 + g][t * 16 + c2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&vt_s[j * 8 + g][t * 16 + 8 + c2]);
        mma_bf16_16816(acc[j], pa[t], b0, b1);
      }
    }
  }

  // ---- finalize: normalise, write the head's column slice ----
  const int n0 = q0 + warp * kRowsPerWarp + g;
  const int n1 = n0 + 8;
  __nv_bfloat16* out_b = out + static_cast<size_t>(b) * N * C + h * kDh + c2;
  vitslam::store_rows(acc, l_row, n0 < N ? out_b + static_cast<size_t>(n0) * C : nullptr,
                      n1 < N ? out_b + static_cast<size_t>(n1) * C : nullptr);
}

template <bool kLn, bool kRope, bool kBounded>
void launch(const void* qkv, void* out, const void* cos_tab, const void* sin_tab,
            const void* ln, const void* shift, int B, int N, int H, int nsplit,
            float qscale, cudaStream_t stream) {
  const dim3 grid((N + kBlockM - 1) / kBlockM, H, B);
  fused_qkv_attention_kernel<kLn, kRope, kBounded><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(cos_tab), static_cast<const float*>(sin_tab),
      static_cast<const float*>(ln), static_cast<const float*>(shift), N, H, nsplit, qscale);
}

}  // namespace

// Plain C entry point (bound with ctypes). qkv: bf16 (B, N, 3*H*dh)
// contiguous; out: bf16 (B, N, H*dh) contiguous; cos/sin: fp32 (B, N, dh)
// contiguous, or null without RoPE; ln: fp32 [q_scale|q_bias|k_scale|k_bias]
// (4*dh), or null without LayerNorm; shift: fp32 device scalar holding the
// log2-domain softmax shift, or null for the online row max. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it does not support).
extern "C" int vitslam_fused_qkv_attention_bf16(const void* qkv, void* out,
                                                const void* cos_tab, const void* sin_tab,
                                                const void* ln, const void* shift,
                                                int B, int N, int H, int dh, int nsplit,
                                                float qscale, void* stream) {
  if (dh != kDh || N < 1 || B < 1 || H < 1 || (nsplit != 1 && nsplit != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool do_ln = ln != nullptr;
  const bool do_rope = cos_tab != nullptr && sin_tab != nullptr;
  const bool bounded = shift != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VITSLAM_LAUNCH(L, R, Bd) \
  launch<L, R, Bd>(qkv, out, cos_tab, sin_tab, ln, shift, B, N, H, nsplit, qscale, s)
  if (do_ln) {
    if (do_rope) {
      if (bounded) VITSLAM_LAUNCH(true, true, true); else VITSLAM_LAUNCH(true, true, false);
    } else {
      if (bounded) VITSLAM_LAUNCH(true, false, true); else VITSLAM_LAUNCH(true, false, false);
    }
  } else {
    if (do_rope) {
      if (bounded) VITSLAM_LAUNCH(false, true, true); else VITSLAM_LAUNCH(false, true, false);
    } else {
      if (bounded) VITSLAM_LAUNCH(false, false, true); else VITSLAM_LAUNCH(false, false, false);
    }
  }
#undef VITSLAM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
