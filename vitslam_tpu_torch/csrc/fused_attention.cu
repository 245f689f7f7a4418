// Fused qkv-packed self-attention for Hopper (sm_90a), bf16 in, bf16 out:
// K1 of the port, a prep kernel and the wgmma + TMA attention core.
//
// Replaces: vitslam_tpu/ops/fused_attention.py::_fused_kernel (:75, the
// Pallas TPU kernel behind fused_qkv_attention; its q/k prep is _prep_tile,
// :56). Same math: q/k/v are sliced per head straight out of the packed
// (B, N, 3C) projection; optional per-head LayerNorm (fp32 stats
// E[x^2] - E[x]^2 without a clamp, eps 1e-6) and RoPE
// x*cos + rotate_half_multi(x)*sin on q and k; scale*log2(e) folded into q;
// exp2-domain softmax with a fixed shift (qk-norm bounds the logits) or an
// online row max; the output written as flat (B, N, C).
//
// What bounds it on the H100: at N = 412 (a frame) the bytes (3C in, C out
// per token) and the products weigh about the same; at N = 2,060 the two
// N^2 * 64 products per head dominate. The TPU kernel preps every K tile
// again for every q tile (33 times per key at N = 2,060); here:
// - qk_prep_kernel reads each (token, head) of q and k once, in 16-byte
//   chunks (8 lanes per head row: the LayerNorm sums are 3 shuffles, the
//   RoPE partner chunk is lane ^ 2 or lane ^ 4), applies LayerNorm, RoPE
//   and (q only) the scale fold in fp32 with the plain version's operation
//   order, rounds once to bf16 (where the TPU kernel rounds too) and writes
//   q^ and k^ to scratch the wrapper allocates.
// - the attention is attention_fwd_sm90.cuh's core at head dim 64 on
//   q^, k^ and V read straight from the qkv slice through a tensor map with
//   row stride 3C (never copied). Without LayerNorm and RoPE (patch embed)
//   there is no prep launch: the core reads q and k from qkv too and folds
//   the scale into its Q tile, as for K2/K3 (a prep pass that only folded
//   would cost a read and a write of q, 13% of the call at 75/30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_sm90.cuh"

namespace {

constexpr int kDh = 64;
constexpr int kChunks = kDh / 8;  // 16-byte chunks (8 bf16) per head row
constexpr int kPrepThreads = 256;
constexpr float kLnEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

struct PrepParams {
  const __nv_bfloat16* qkv;  // (B, N, 3C) contiguous
  __nv_bfloat16* q_out;      // (B, N, C) contiguous
  __nv_bfloat16* k_out;      // (B, N, C) contiguous, or null without a k prep
  const float* cos;          // (B, N, dh) rows at (tab_sb, tab_sn) element strides
  const float* sin;
  long long tab_sb, tab_sn;
  const float* ln[4];  // q scale, q bias, k scale, k bias: fp32 (dh,)
  int B, N, H, nsplit;
  float q_fold;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __low2float(h[e]);
    x[2 * e + 1] = __high2float(h[e]);
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[8]) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = vitslam::sm90::pack_bf16(x[2 * e], x[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void load8f(const float* src, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// LayerNorm + RoPE of one head row held by 8 lanes (this lane: columns
// d0 .. d0 + 7), in the plain version's order: (x - mean) * rsqrt(var +
// eps), * scale, + bias; x * cos + rot * sin. All 32 lanes call it.
template <bool kLn, bool kRope>
__device__ __forceinline__ void prep8(float (&x)[8], int d0, const float* scale,
                                      const float* bias, const float (&c)[8], const float (&s)[8],
                                      int partner_xor, bool lower) {
  if (kLn) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sum += x[e];
      sq = __fadd_rn(sq, __fmul_rn(x[e], x[e]));  // no FMA: the plain version rounds x^2
    }
#pragma unroll
    for (int off = 1; off < kChunks; off <<= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
      sq += __shfl_xor_sync(kFull, sq, off);
    }
    const float mean = sum * (1.0f / kDh);
    const float var = __fsub_rn(sq * (1.0f / kDh), __fmul_rn(mean, mean));
    const float inv = rsqrtf(var + kLnEps);
    float w[8], bb[8];
    load8f(scale + d0, w);
    load8f(bias + d0, bb);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[e], mean), inv), w[e]), bb[e]);
    }
  }
  if (kRope) {
    // rotate_half_multi: within each block of 64 / nsplit columns,
    // rot[d] = -x[d + half] in the lower half, x[d - half] in the upper;
    // the partner chunk is lane ^ (half / 8)
    float r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pv = __shfl_xor_sync(kFull, x[e], partner_xor);
      r[e] = lower ? -pv : pv;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __fadd_rn(__fmul_rn(x[e], c[e]), __fmul_rn(r[e], s[e]));
  }
}

template <bool kLn, bool kRope>
__global__ void __launch_bounds__(kPrepThreads) qk_prep_kernel(const PrepParams p) {
  const long long idx = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const int chunk = static_cast<int>(idx % kChunks);
  const long long rh = idx / kChunks;  // (token row, head), head fastest
  const long long rows = static_cast<long long>(p.B) * p.N;
  // lanes of one head row are all in or all out (8 | 32): no early return
  // before the shuffles
  const bool valid = rh < rows * p.H;
  const long long r = valid ? rh / p.H : 0;
  const int h = valid ? static_cast<int>(rh % p.H) : 0;
  const int C = p.H * kDh;
  const int d0 = chunk * 8;
  const __nv_bfloat16* src = p.qkv + r * 3 * C + h * kDh + d0;

  float c[8], s[8];
  int partner_xor = 0;
  bool lower = false;
  if (kRope) {
    const long long b = r / p.N, n = r % p.N;
    load8f(p.cos + b * p.tab_sb + n * p.tab_sn + d0, c);
    load8f(p.sin + b * p.tab_sb + n * p.tab_sn + d0, s);
    const int seg = kDh / p.nsplit;
    const int half = seg / 2;
    partner_xor = half / 8;
    lower = (d0 % seg) < half;
  }
  float x[8];
  load8(src, x);
  prep8<kLn, kRope>(x, d0, p.ln[0], p.ln[1], c, s, partner_xor, lower);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], p.q_fold);
  if (valid) store8(p.q_out + r * C + h * kDh + d0, x);
  if (kLn || kRope) {
    load8(src + C, x);
    prep8<kLn, kRope>(x, d0, p.ln[2], p.ln[3], c, s, partner_xor, lower);
    if (valid) store8(p.k_out + r * C + h * kDh + d0, x);
  }
}

template <bool kLn, bool kRope>
cudaError_t launch_prep(const PrepParams& p, cudaStream_t stream) {
  const long long threads = static_cast<long long>(p.B) * p.N * p.H * kChunks;
  const long long blocks = (threads + kPrepThreads - 1) / kPrepThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  qk_prep_kernel<kLn, kRope><<<static_cast<unsigned>(blocks), kPrepThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K1's attention: the core at head dim 64 on q^ (already folded) or, for
// the patch embed, on the raw q slice (kFold: the core folds it).
template <bool kBounded, bool kFold>
__global__ void __launch_bounds__(vitslam::sm90::kThreads, 1)
    fused_qkv_attention_kernel(const __grid_constant__ vitslam::sm90::FwdParams p) {
  vitslam::sm90::attention_fwd<kDh, kBounded, kFold>(p);
}

// What the prep takes (the entry points return cudaErrorInvalidValue else).
bool check_prep(const void* q_scale, const void* q_bias, const void* k_scale, const void* k_bias,
               const void* cos, const void* sin, const void* k_out, int B, int N, int H, int dh,
               int nsplit) {
  const bool do_ln = q_scale != nullptr;
  const bool do_rope = cos != nullptr;
  return dh == kDh && B >= 1 && N >= 1 && H >= 1 && (nsplit == 1 || nsplit == 2) &&
         (!do_rope || sin != nullptr) &&
         (!do_ln || (q_bias != nullptr && k_scale != nullptr && k_bias != nullptr)) &&
         (!(do_ln || do_rope) || k_out != nullptr);
}

cudaError_t prep(const void* qkv, void* q_out, void* k_out, const void* cos, const void* sin,
                 long long tab_sb, long long tab_sn, const void* q_scale, const void* q_bias,
                 const void* k_scale, const void* k_bias, int B, int N, int H, int nsplit,
                 float q_fold, cudaStream_t s) {
  PrepParams p{static_cast<const __nv_bfloat16*>(qkv),
               static_cast<__nv_bfloat16*>(q_out),
               static_cast<__nv_bfloat16*>(k_out),
               static_cast<const float*>(cos),
               static_cast<const float*>(sin),
               tab_sb,
               tab_sn,
               {static_cast<const float*>(q_scale), static_cast<const float*>(q_bias),
                static_cast<const float*>(k_scale), static_cast<const float*>(k_bias)},
               B,
               N,
               H,
               nsplit,
               q_fold};
  if (q_scale != nullptr) {
    return cos != nullptr ? launch_prep<true, true>(p, s) : launch_prep<true, false>(p, s);
  }
  return cos != nullptr ? launch_prep<false, true>(p, s) : launch_prep<false, false>(p, s);
}

}  // namespace

// Plain C entry points (bound with ctypes); each launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for what it does not take).
//
// The prep alone: qkv bf16 (B, N, 3*H*64) contiguous, 16-byte aligned;
// q_out bf16 (B, N, H*64) contiguous, written with LN + RoPE of q, times
// q_fold, in bf16; k_out the same for k without the fold, or null when
// there is neither LayerNorm nor RoPE. cos/sin: fp32 with a contiguous last
// dim of at least 64 at element strides (tab_sb, tab_sn) of (batch, token),
// 16-byte aligned rows, or null without RoPE; ln_*: fp32 (64,) contiguous
// and 16-byte aligned, all four or none.
extern "C" int vitslam_qk_prep_bf16(const void* qkv, void* q_out, void* k_out, const void* cos,
                                    const void* sin, long long tab_sb, long long tab_sn,
                                    const void* q_scale, const void* q_bias, const void* k_scale,
                                    const void* k_bias, int B, int N, int H, int dh, int nsplit,
                                    float q_fold, void* stream) {
  if (!check_prep(q_scale, q_bias, k_scale, k_bias, cos, sin, k_out, B, N, H, dh, nsplit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(prep(qkv, q_out, k_out, cos, sin, tab_sb, tab_sn, q_scale, q_bias,
                               k_scale, k_bias, B, N, H, nsplit, q_fold,
                               static_cast<cudaStream_t>(stream)));
}

// K1: the prep (arguments as above; q_fold = scale * log2(e)) into the
// scratch q_hat and k_hat, then the attention core over q^, k^ and the v
// slice of qkv (row stride 3C, read in place) into out, bf16 (B, N, H*64)
// contiguous: two launches. Without LayerNorm and RoPE (q_hat and k_hat
// null) there is nothing to prep: one launch of the core on the q and k
// slices of qkv, folding q_fold into q in shared memory as K2/K3 do (the
// same fp32 multiply and one rounding as the prep's). static_max: fp32
// device scalar holding the natural-log logit bound (the shift is
// static_max * log2(e)), or null for the online row max.
extern "C" int vitslam_fused_qkv_attention_bf16(
    const void* qkv, void* q_hat, void* k_hat, void* out, const void* cos, const void* sin,
    long long tab_sb, long long tab_sn, const void* q_scale, const void* q_bias,
    const void* k_scale, const void* k_bias, const void* static_max, int B, int N, int H, int dh,
    int nsplit, float q_fold, void* stream) {
  const bool prepped = q_scale != nullptr || cos != nullptr;
  if (!check_prep(q_scale, q_bias, k_scale, k_bias, cos, sin, k_hat, B, N, H, dh, nsplit) ||
      prepped != (q_hat != nullptr) || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (prepped) {
    err = prep(qkv, q_hat, k_hat, cos, sin, tab_sb, tab_sn, q_scale, q_bias, k_scale, k_bias, B,
               N, H, nsplit, q_fold, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  using vitslam::sm90::launch_fwd;
  const long long C = static_cast<long long>(H) * kDh;
  const long long n = N;
  const __nv_bfloat16* qkv_b = static_cast<const __nv_bfloat16*>(qkv);
  // q^ and k^ are (B, N, C); the raw q and k slices of qkv have row stride 3C
  const void* q = prepped ? q_hat : static_cast<const void*>(qkv_b);
  const void* k = prepped ? k_hat : static_cast<const void*>(qkv_b + C);
  const long long qk_sn = prepped ? C : 3 * C;
  vitslam::sm90::FwdParams p{};
  p.o = static_cast<__nv_bfloat16*>(out);
  p.o_sb = n * C;
  p.o_sh = kDh;
  p.o_sn = C;
  p.static_max = static_cast<const float*>(static_max);
  p.nq = N;
  p.nk = N;
  p.q_fold = q_fold;
  const long long qs[3] = {n * qk_sn, kDh, qk_sn};
  const long long vs[3] = {n * 3 * C, kDh, 3 * C};
  const void* v = qkv_b + 2 * C;
  const bool bounded = static_max != nullptr;
  auto kernel = prepped ? (bounded ? fused_qkv_attention_kernel<true, false>  // q^ arrives folded
                                   : fused_qkv_attention_kernel<false, false>)
                        : (bounded ? fused_qkv_attention_kernel<true, true>
                                   : fused_qkv_attention_kernel<false, true>);
  return static_cast<int>(launch_fwd<kDh>(kernel, p, q, k, v, B, H, qs, qs, vs, s));
}
