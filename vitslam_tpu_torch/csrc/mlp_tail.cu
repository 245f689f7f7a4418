// Fused dense block tail for Hopper (sm_90a): x' = res + act(h) W^T + b in
// an fp32 accumulator, optionally followed by a LayerNorm of x' in the same
// kernel. bf16 h, W, res and outputs; fp32 b, gamma, beta. K5 of the port.
//
// Replaces: vitslam_tpu/ops/mlp_tail.py::_mlp_tail_kernel (:54), launched
// by _mlp_tail_call (:144). Same math: with kGelu the exact (erf) gelu runs
// in fp32 on each bf16 h element and is rounded back to bf16 before the
// product, as mlp_tail_reference does (with erff, as torch's gelu: the
// same bits); the product accumulates in fp32; the epilogue adds the fp32
// bias and the residual, writes x' in bf16, and with the LayerNorm takes
// the row mean, then the centered variance sum((x' - mean)^2) / C of the
// fp32 x' (not the cast one), eps as given, and writes y = (x' - mean) *
// rsqrt(var + eps) * gamma + beta in bf16.
//
// Layout: h is (M, F) and W the port's (C, F) torch weight, so both
// operands are K-major; res, x' and y are (M, C); all contiguous. F and C
// are any multiples of 8 (the TMA maps' 16-byte row rule; the wrapper
// zero-pads other widths), C at most 4,096 with the LayerNorm. The last K
// slice past F, rows past M and W rows past C (the last CTA's columns past
// C) are zero-filled by TMA; columns past C are never read from b or res
// and never stored, and the LayerNorm's statistics take the true width
// c_ln (= C unless the wrapper padded C). The JAX kernel sums only F //
// 1024 blocks of 1,024 at F above 1,024 (so at F 1,536 it drops a third of
// the reduction); this kernel sums all of F.
//
// What bounds it on the H100: 2 M F C FLOP against (M F + C F + 3 M C) x 2
// bytes. At the flagship's C 1,024 the mlp site (F 4,096) does 17.3 GFLOP at
// M 2,060 for 25 MB (tensor-core bound, 17.5 us) and the proj site (F
// 1,024, LayerNorm) 4.3 GFLOP for 19 MB (memory bound, 5.7 us).
//
// Design: a wgmma GEMM fed by TMA, one launch per call.
// - A CTA owns a 64 x 256 output tile (one consumer warpgroup) or 128 x 256
//   (two, 64 rows each, sharing the W slices). The host takes 64-row tiles
//   while they need at most two waves of CTAs on the card's SMs, else
//   128-row tiles: at M 2,060 and C 1,024 that is 33 x 4 = 132 CTAs, one
//   wave on 132 SMs; at M 30,900, 242 x 4 = 968 CTAs in 7.3 waves of one
//   CTA per SM (ops/mlp_tail.py::k5_schedule mirrors the choice).
// - One producer thread streams 64-wide K slices of h (2-D map, box 64 x
//   64 or 64 x 128) and W (box 64 x 256), 128-byte swizzled, through a ring
//   of 5 (64-row tiles) or 4 (128-row tiles) stages; the consumers take the
//   producer warpgroup's registers with setmaxnreg.
// - Each k16 step is one wgmma m64n256k16 with both operands in shared
//   memory; a slice's product is issued before the last one is waited for.
// - The gelu is applied in place to each h slice as it lands, up to the
//   ring's depth ahead of the products, behind its own mbarrier: by a gelu
//   warpgroup with 64-row tiles, by the two consumer warpgroups with
//   128-row tiles (two m64n256 accumulators leave no registers for a fourth
//   warpgroup), and in both by the producer warpgroup's three idle warps.
//   Each h element's gelu is computed once per CTA, C / 256 = 4 times at C
//   1,024. What bounds the gelu sites is the FP32 issue rate of those
//   gelus (erff takes ~45 issue slots an element): about twice the time of
//   the products at M 2,060, more at M 30,900, where the 128 x 256 tiles'
//   operand traffic also meets the L2's bandwidth (PERF.md §6).
// - Epilogue from the accumulator registers: bias and residual read
//   through the read-only path and restrict pointers, so a column group's
//   loads are issued ahead of its stores (a possible alias of res and x
//   otherwise keeps them one after another).
// - The LayerNorm runs on the accumulator registers: a cluster of
//   ceil(C / 256) CTAs along C holds whole rows, up to 16 at C 4,096
//   (above 8 the H100's non-portable cluster size: 16 CTAs of one SM each
//   fit in one GPC; a wider tile would halve the CTAs the small rows of
//   the common widths get). Each CTA reduces its 256 columns per row
//   (the four lanes of a fragment quad), and the partial sums go through
//   distributed shared memory in two rounds, the mean, then the centered
//   sum of squares, so every CTA of the cluster normalises with the same
//   statistics.
// Tried on the H100 and dropped, each slower than the gelu warps here
// (PERF.md §6): the gelu on wgmma A fragments in the consumers'
// registers, a bf16 table of the gelu in shared memory, branch-free
// polynomial erfs, and CTA pairs along C splitting each slice's gelu
// through distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace vitslam::sm90;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;   // K slice per stage: one 128-byte swizzle row
constexpr int kBN = 256;  // output columns per CTA
constexpr int kMaxCluster = 16;  // non-portable above 8

template <int kWG, bool kGelu>
struct Tail {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kStages = kWG == 1 ? 5 : 4;
  static constexpr int kProducer = kWG * 128;  // the producer warpgroup's first thread
  // one consumer warpgroup leaves room (registers) for a gelu warpgroup
  static constexpr bool kGeluWG = kGelu && kWG == 1;
  static constexpr int kThreads = (kWG + 1 + (kGeluWG ? 1 : 0)) * 128;
  // the gelu's threads: the gelu warpgroup, else the consumers; and the
  // producer warpgroup's warps 1-3
  static constexpr int kGeluThreads = 128 * (kGeluWG ? 1 : kWG) + 96;
  static constexpr int kA = kBM * 128;  // bytes of a stage's h slice
  static constexpr int kB = kBN * 128;  // bytes of a stage's W slice
  static constexpr int kStage = kA + kB;
  static constexpr int kRed = kStages * kStage;  // LayerNorm partial sums: 2 x kBM fp32
  static constexpr int kBar = kRed + 2 * kBM * 4;
  // full, gelu-done and empty barriers per stage
  static constexpr int kBytes = kBar + 24 * kStages + 1024;
  // registers per thread after setmaxnreg. An increase is served only from
  // what the CTA's own warps give back: at 384 threads the launch gives 168
  // a thread, and 128 x (240 - 168) = 128 x (168 - 96) with one consumer
  // and a gelu warpgroup (which keeps 168), 2 x (208 - 168) = 168 - 88 with
  // two consumers.
  static constexpr int kConsumerRegs = kWG == 1 ? 240 : 208;
  static constexpr int kProducerRegs = kWG == 1 ? 96 : 88;
};

struct TailParams {
  CUtensorMap h_map, w_map;
  const float* b;
  const bf16* res;
  const float* gamma;
  const float* beta;
  bf16* x;
  bf16* y;
  int M, F, C;
  int c_ln;  // the LayerNorm's width: columns >= c_ln are padding
  float eps;
};

// The exact (erf) gelu in fp32, as torch's: v / 2 (1 + erf(v / sqrt(2))).
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t gelu_bf16x2(uint32_t p) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p));
  return pack_bf16(gelu_erf(f.x), gelu_erf(f.y));
}

// In place on one landed h slice: each bf16 h -> bf16(gelu(fp32(h))). The
// gelu is elementwise, so the 128-byte swizzle does not matter: the slice
// is walked as flat 16-byte chunks, gelu thread t of kThreads taking chunks
// t, t + kThreads, ...
template <int kBytes, int kThreads>
__device__ __forceinline__ void gelu_slice(unsigned char* slice, int t) {
#pragma unroll
  for (int i = 0; i < (kBytes / 16 + kThreads - 1) / kThreads; ++i) {
    const int c = i * kThreads + t;
    if (c < kBytes / 16) {
      uint4* const chunk = reinterpret_cast<uint4*>(slice) + c;
      uint4 v = *chunk;
      v.x = gelu_bf16x2(v.x);
      v.y = gelu_bf16x2(v.y);
      v.z = gelu_bf16x2(v.z);
      v.w = gelu_bf16x2(v.w);
      *chunk = v;
    }
  }
}

// kClip: C is not a multiple of kBN (the last column tile is clipped) or
// the LayerNorm's width c_ln is below C. Without it the epilogue has no
// column guard, so a column group's loads go out ahead of its stores (the
// guards cost the LayerNorm sites a quarter to a half of their time at C
// 1,024).
template <int kWG, bool kGelu, bool kLn, bool kClip>
__global__ void __launch_bounds__(Tail<kWG, kGelu>::kThreads, 1)
    mlp_tail_kernel(const __grid_constant__ TailParams p) {
  using T = Tail<kWG, kGelu>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-byte aligned: the swizzle atom
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + T::kBar;           // + 8 * stage: the slices have landed
  const uint32_t gelu_done = full + 8 * kStages;  // + 8 * stage: h holds gelu(h)
  const uint32_t empty = gelu_done + 8 * kStages;  // + 8 * stage: the products are done
  auto a_slice = [&](int s) { return base + s * T::kStage; };
  auto b_slice = [&](int s) { return base + s * T::kStage + T::kA; };
  // gelu thread t applies the gelu to its chunks of slice `it`, then
  // releases the slice to the products
  auto gelu_stage = [&](int it, int t) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    gelu_slice<T::kA, T::kGeluThreads>(gbase + s * T::kStage, t);
    fence_async_smem();  // the wgmma reads it through the async proxy
    mbar_arrive(gelu_done + 8 * s);
  };

  const int m0 = blockIdx.x * T::kBM;
  const int n0 = blockIdx.y * kBN;
  const int nk = (p.F + kBK - 1) / kBK;  // the last slice zero-filled past F

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(gelu_done + 8 * s, T::kGeluThreads);
      mbar_init(empty + 8 * s, kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::kProducer) {
    if (threadIdx.x < T::kProducer + 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs) : "memory");
    }
    if (threadIdx.x == T::kProducer) {
      // ---- producer: one thread issues every load ----
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full + 8 * s, T::kStage);
        tma_load_2d(a_slice(s), &p.h_map, full + 8 * s, it * kBK, m0);
        tma_load_2d(b_slice(s), &p.w_map, full + 8 * s, it * kBK, n0);
      }
    } else if (kGelu && threadIdx.x >= T::kProducer + 32) {
      // ---- the gelu warpgroup and the producer's warps 1-3: the gelu of
      // each slice as it lands, up to kStages slices ahead of the products
      const int t = threadIdx.x - T::kProducer - 32 + (T::kGeluWG ? 0 : kWG * 128);
      for (int it = 0; it < nk; ++it) gelu_stage(it, t);
    }
    if (kLn) {  // the consumers' three cluster barriers
      cluster_sync();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows x 256 columns each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;        // fragment row group
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int lr = wg * 64 + warp * 16 + g;  // the CTA's rows of this thread: lr, lr + 8
  // without a gelu warpgroup the consumers take part in the gelu
  constexpr bool kConsumerGelu = kGelu && !T::kGeluWG;

  float acc[32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t a_rows = wg * 64 * 128;
  if (kConsumerGelu) gelu_stage(0, threadIdx.x);
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (kGelu) mbar_wait(gelu_done + 8 * s, (it / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_m64n256k16(acc, desc_sw128(a_slice(s) + a_rows + kk * 32),
                          desc_sw128(b_slice(s) + kk * 32), 1);
    }
    wgmma_commit();
    // the next slice's gelu while this product runs
    if (kConsumerGelu && it + 1 < nk) gelu_stage(it + 1, threadIdx.x);
    wgmma_wait<1>();  // the previous slice's product is done: release its stage
    fence_regs(acc);
    if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: x' = acc + b + res in fp32 (kept in acc), stored as bf16 ----
  // Read-only operands through the non-coherent path and restrict pointers,
  // so the loads of a group of columns are issued ahead of its stores.
  const float* __restrict__ bias_p = p.b;
  const bf16* __restrict__ res_p = p.res;
  bf16* __restrict__ x_p = p.x;
  const int row0 = m0 + lr;
  const bool in0 = row0 < p.M;
  const bool in1 = row0 + 8 < p.M;
  const size_t off0 = static_cast<size_t>(row0) * p.C + n0 + c2;
  const size_t off1 = off0 + 8 * static_cast<size_t>(p.C);
  // columns of this CTA inside C: C is a multiple of 8, so an n8 block is
  // in or out; the accumulator of a block past C stays 0
  const int c_in = p.C - n0;
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 4) {
    uint32_t r[4][2];
    float2 bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (j0 + j) * 8;
      const bool cin = !kClip || col < c_in;
      bias[j] = cin ? __ldg(reinterpret_cast<const float2*>(bias_p + n0 + c2 + col))
                    : make_float2(0.f, 0.f);
      r[j][0] = in0 && cin ? __ldg(reinterpret_cast<const unsigned int*>(res_p + off0 + col)) : 0u;
      r[j][1] = in1 && cin ? __ldg(reinterpret_cast<const unsigned int*>(res_p + off1 + col)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (j0 + j) * 8;
      if (kClip && col >= c_in) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[j][half]));
        float& v0 = acc[j0 + j][2 * half];
        float& v1 = acc[j0 + j][2 * half + 1];
        v0 += bias[j].x;
        v1 += bias[j].y;
        v0 += rv.x;
        v1 += rv.y;
        if (half ? in1 : in0) {
          *reinterpret_cast<uint32_t*>(x_p + (half ? off1 : off0) + col) = pack_bf16(v0, v1);
        }
      }
    }
  }
  if constexpr (kLn) {
    // row sums of this CTA's 256 columns: a row's columns lie in the four
    // lanes of its fragment quad
    float* const red = reinterpret_cast<float*>(gbase + T::kRed);  // [sums kBM][squares kBM]
    const int nc = gridDim.y;  // the cluster spans C
    const float inv_c = 1.0f / static_cast<float>(p.c_ln);
    const int ln_in = p.c_ln - n0 - c2;  // this thread's columns j * 8 + e (e < 2) below it
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[0] += acc[j][0] + acc[j][1];
      s[1] += acc[j][2] + acc[j][3];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s[half] += __shfl_xor_sync(kFull, s[half], 1);
      s[half] += __shfl_xor_sync(kFull, s[half], 2);
      if ((lane & 3) == 0) red[lr + 8 * half] = s[half];
    }
    cluster_sync();
    float mean[2], q[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tot = 0.f;
      for (int r = 0; r < nc; ++r) tot += ld_dsmem_f32(smem_u32(red + lr + 8 * half), r);
      mean[half] = tot * inv_c;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d =
            !kClip || j * 8 + (e & 1) < ln_in ? acc[j][e] - mean[e / 2] : 0.f;
        q[e / 2] += d * d;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      q[half] += __shfl_xor_sync(kFull, q[half], 1);
      q[half] += __shfl_xor_sync(kFull, q[half], 2);
      if ((lane & 3) == 0) red[T::kBM + lr + 8 * half] = q[half];
    }
    cluster_sync();
    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tot = 0.f;
      for (int r = 0; r < nc; ++r) tot += ld_dsmem_f32(smem_u32(red + T::kBM + lr + 8 * half), r);
      inv[half] = rsqrtf(tot * inv_c + p.eps);
    }
    const float* __restrict__ gamma_p = p.gamma;
    const float* __restrict__ beta_p = p.beta;
    bf16* __restrict__ y_p = p.y;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = j * 8;
      if (kClip && col >= c_in) continue;
      const float2 gm = __ldg(reinterpret_cast<const float2*>(gamma_p + n0 + c2 + col));
      const float2 bt = __ldg(reinterpret_cast<const float2*>(beta_p + n0 + c2 + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half ? in1 : in0) {
          const float y0 = (acc[j][2 * half] - mean[half]) * inv[half] * gm.x + bt.x;
          const float y1 = (acc[j][2 * half + 1] - mean[half]) * inv[half] * gm.y + bt.y;
          *reinterpret_cast<uint32_t*>(y_p + (half ? off1 : off0) + col) = pack_bf16(y0, y1);
        }
      }
    }
    cluster_sync();  // no CTA leaves while another still reads its sums
  }
}

template <int kWG, bool kGelu, bool kLn, bool kClip>
cudaError_t launch(TailParams p, const void* h, const void* w, cudaStream_t stream) {
  using T = Tail<kWG, kGelu>;
  if (!make_map_2d(&p.h_map, h, p.F, p.M, T::kBM) || !make_map_2d(&p.w_map, w, p.F, p.C, kBN)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = mlp_tail_kernel<kWG, kGelu, kLn, kClip>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  const int col_tiles = (p.C + kBN - 1) / kBN;
  if (kLn && col_tiles > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + T::kBM - 1) / T::kBM, col_tiles, 1);
  cfg.blockDim = dim3(T::kThreads, 1, 1);
  cfg.dynamicSmemBytes = T::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kLn ? col_tiles : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kLn ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, p);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <int kWG, bool kClip>
cudaError_t dispatch_epilogue(const TailParams& p, const void* h, const void* w, bool gelu,
                              bool ln, cudaStream_t s) {
  if (gelu) {
    return ln ? launch<kWG, true, true, kClip>(p, h, w, s)
              : launch<kWG, true, false, kClip>(p, h, w, s);
  }
  return ln ? launch<kWG, false, true, kClip>(p, h, w, s)
            : launch<kWG, false, false, kClip>(p, h, w, s);
}

template <int kWG>
cudaError_t dispatch(const TailParams& p, const void* h, const void* w, bool gelu, bool ln,
                     cudaStream_t s) {
  const bool clip = p.C % kBN != 0 || (ln && p.c_ln != p.C);
  return clip ? dispatch_epilogue<kWG, true>(p, h, w, gelu, ln, s)
              : dispatch_epilogue<kWG, false>(p, h, w, gelu, ln, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). h: bf16 (M, F); w: bf16 (C, F);
// b: fp32 (C,); res, x: bf16 (M, C); with ln, gamma/beta fp32 (C,) and y
// bf16 (M, C), else they may be null. All contiguous and 16-byte aligned;
// F and C multiples of 8. c_ln: the LayerNorm's width, C, or fewer when
// columns c_ln .. C - 1 are zero padding (zero W rows, b and res there).
// Launches one kernel on `stream` (a cluster of ceil(C / 256) CTAs along C
// with ln), allocates nothing, and returns the launch's error
// (cudaErrorInvalidValue for a shape it does not take: F or C not a
// positive multiple of 8, or with ln C above 4,096).
extern "C" int vitslam_mlp_tail_bf16(const void* h, const void* w, const void* b,
                                     const void* res, const void* gamma, const void* beta,
                                     void* x, void* y, int M, int F, int C, int c_ln, int gelu,
                                     int ln, float eps, void* stream) {
  if (M < 1 || F < 8 || F % 8 != 0 || C < 8 || C % 8 != 0 || c_ln < 1 || c_ln > C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ln && (gamma == nullptr || beta == nullptr || y == nullptr ||
             (C + kBN - 1) / kBN > kMaxCluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailParams p{};
  p.b = static_cast<const float*>(b);
  p.res = static_cast<const bf16*>(res);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.x = static_cast<bf16*>(x);
  p.y = static_cast<bf16*>(y);
  p.M = M;
  p.F = F;
  p.C = C;
  p.c_ln = c_ln;
  p.eps = eps;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 64-row tiles while they fill at most two waves, else 128-row tiles
  const long long tiles64 = static_cast<long long>((M + 63) / 64) * ((C + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = tiles64 <= 2LL * sms ? dispatch<1>(p, h, w, gelu != 0, ln != 0, s)
                             : dispatch<2>(p, h, w, gelu != 0, ln != 0, s);
  return static_cast<int>(err);
}
