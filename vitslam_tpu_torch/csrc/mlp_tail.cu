// Fused dense block tail for Hopper (sm_90a): x' = res + act(h) W^T + b in
// an fp32 accumulator, optionally followed by a LayerNorm of x' in the same
// kernel. bf16 h, W, res and outputs; fp32 b, gamma, beta.
//
// Replaces: vitslam_tpu/ops/mlp_tail.py::_mlp_tail_kernel (the Pallas TPU
// kernel behind mlp_tail). Same math: with kGelu the exact (erf) gelu runs
// in fp32 on each bf16 h element and is rounded back to bf16 before the
// product, as mlp_tail_reference does; the product accumulates in fp32; the
// epilogue adds the fp32 bias and the residual, writes x' in bf16, and with
// the LayerNorm takes the row mean, then the centered variance
// sum((x' - mean)^2) / C of the fp32 x' (not the cast one) and writes
// y = (x' - mean) * rsqrt(var + eps) * gamma + beta in bf16.
//
// Layout: h is (M, F) and W the port's (C, F) torch weight, so A and B are
// both K-contiguous, the row.col layout of mma.sync; res, x' and y are
// (M, C), all contiguous. Rows past M are zero-filled on load and masked on
// store; F must be a multiple of 64 and C of 128.
//
// What bounds it on the H100: at the flagship's shapes the mlp site
// (F 4096 -> C 1024) does 2 M F C = 17.3 GFLOP at M 2,060 against 24 MB of
// traffic, so it is bound by the tensor cores; the proj site (F 1024) does a
// quarter of that over 12.6 MB and is bound by memory. The design keeps the
// product on the tensor cores (mma.sync m16n8k16 bf16 -> fp32, operands
// through ldmatrix from padded shared memory, 2-stage cp.async over 64-wide
// K slices) and never writes the fp32 accumulator or the activation to
// device memory:
// * without the LayerNorm, a CTA of 8 warps owns a 128 x 128 output tile
//   (warps 2 x 4, each 64 rows x 32 columns);
// * with it, the statistics need whole rows of fp32 x' (C = 1024 is 128 KB
//   for 32 rows, more than registers hold), so a CTA owns 32 rows and walks
//   the C / 128 column tiles, keeping each tile's fp32 x' in shared memory;
//   after the last tile each warp normalises 4 rows.
// Not done yet: wgmma, TMA, a persistent schedule, and a cluster that shares
// the row sums so the LayerNorm CTAs can own more rows (the 32-row CTAs
// re-read W once per 32 rows, from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;         // K slice per pipeline stage
constexpr int kBN = 128;        // output columns per tile
constexpr int kWarps = 8;       // 2 (rows) x 4 (columns)
constexpr int kThreads = kWarps * 32;
constexpr int kPad = kBK + 8;   // padded smem row (bf16): conflict-free ldmatrix
constexpr int kGemmRows = 128;  // rows per CTA without the LayerNorm
constexpr int kLnRows = 32;     // rows per CTA with the LayerNorm
constexpr int kXsPad = 4;       // fp32 x' row padding (keeps 16-byte rows)
constexpr int kMaxSmem = 232448;

struct Params {
  const bf16* h;
  const bf16* w;
  const float* b;
  const bf16* res;
  const float* gamma;
  const float* beta;
  bf16* x;
  bf16* y;
  int M, F, C;
  float eps;
};

template <int kBM>
struct Tiles {
  static constexpr int kA = kBM * kPad;  // elements of one stage's h tile
  static constexpr int kStage = kA + kBN * kPad;
  static constexpr size_t kBytes = 2 * kStage * sizeof(bf16);
};

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// In place: each bf16 h element of the stage's tile -> bf16(gelu(fp32(h))).
template <int kBM>
__device__ __forceinline__ void gelu_tile(bf16 (*a)[kPad]) {
  constexpr int kPairs = kBM * kBK / 2;
  for (int i = threadIdx.x; i < kPairs; i += kThreads) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&a[i / (kBK / 2)][(i % (kBK / 2)) * 2]);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(gelu_erf(f.x), gelu_erf(f.y));
  }
}

// acc = act(h[m0:m0+kBM]) W[n0:n0+128]^T over the whole of F. A warp owns
// kBM / 2 rows (kBM / 32 m16 tiles) and 32 columns (4 n8 tiles); acc[mt][j]
// is the m16n8 fragment of its m-tile mt and n-tile j. Ends with all warps
// past their last read of the tiles.
template <int kBM, bool kGelu>
__device__ __forceinline__ void gemm_tile(float (&acc)[kBM / 32][4][4], const Params& p,
                                          bf16* smem, int m0, int n0) {
  constexpr int kMT = kBM / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * (kBM / 2);
  const int c0 = (warp % 4) * 32;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    }
  }
  auto a_tile = [&](int s) { return reinterpret_cast<bf16(*)[kPad]>(smem + s * Tiles<kBM>::kStage); };
  auto b_tile = [&](int s) {
    return reinterpret_cast<bf16(*)[kPad]>(smem + s * Tiles<kBM>::kStage + Tiles<kBM>::kA);
  };
  auto load = [&](int kt, int s) {
    vitslam::load_tile<kBM, kBK, kThreads>(a_tile(s), p.h + kt * kBK, p.F, m0, p.M);
    vitslam::load_tile<kBN, kBK, kThreads>(b_tile(s), p.w + kt * kBK, p.F, n0, p.C);
    vitslam::cp_async_commit();
  };
  const int nk = p.F / kBK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load(kt + 1, s ^ 1);
      vitslam::cp_async_wait<1>();
    } else {
      vitslam::cp_async_wait<0>();
    }
    __syncthreads();
    bf16(*A)[kPad] = a_tile(s);
    bf16(*B)[kPad] = b_tile(s);
    if (kGelu) {
      gelu_tile<kBM>(A);
      __syncthreads();
    }
#pragma unroll
    for (int kh = 0; kh < kBK / 32; ++kh) {
      uint32_t a0[kMT][4], a1[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = r0 + mt * 16 + (lane % 16);
        vitslam::ldmatrix_x4(a0[mt], &A[r][kh * 32 + (lane / 16) * 8]);
        vitslam::ldmatrix_x4(a1[mt], &A[r][kh * 32 + 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        vitslam::ldmatrix_x4(bf, &B[c0 + j * 8 + (lane % 8)][kh * 32 + (lane / 8) * 8]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          vitslam::mma_bf16_16816(acc[mt][j], a0[mt], bf[0], bf[1]);
          vitslam::mma_bf16_16816(acc[mt][j], a1[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the next load overwrites this stage
  }
}

// x' = acc + b + res for the fragment element pair (e, e + 1) of rows
// `row` and columns (col, col + 1); rows >= M are not read or written.
// Returns the fp32 pair; writes its bf16 rounding to x.
__device__ __forceinline__ float2 tail_pair(const Params& p, const float* acc, int row, int col) {
  const float2 bias = *reinterpret_cast<const float2*>(p.b + col);
  float2 v = make_float2(acc[0] + bias.x, acc[1] + bias.y);
  if (row < p.M) {
    const size_t off = static_cast<size_t>(row) * p.C + col;
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + off));
    v.x += r.x;
    v.y += r.y;
    *reinterpret_cast<__nv_bfloat162*>(p.x + off) = __floats2bfloat162_rn(v.x, v.y);
  }
  return v;
}

template <bool kGelu>
__global__ void __launch_bounds__(kThreads) mlp_tail_gemm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kBN;
  float acc[kGemmRows / 32][4][4];
  gemm_tile<kGemmRows, kGelu>(acc, p, smem, m0, n0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < kGemmRows / 32; ++mt) {
    const int row = m0 + (warp / 4) * (kGemmRows / 2) + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + (warp % 4) * 32 + j * 8 + c2;
      tail_pair(p, &acc[mt][j][0], row, col);
      tail_pair(p, &acc[mt][j][2], row + 8, col);
    }
  }
}

template <bool kGelu>
__global__ void __launch_bounds__(kThreads) mlp_tail_ln_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + Tiles<kLnRows>::kBytes);  // [kLnRows][C + pad]
  const int xs_stride = p.C + kXsPad;
  const int m0 = blockIdx.x * kLnRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int r_local = (warp / 4) * (kLnRows / 2) + g;  // one m16 tile per warp
  for (int n0 = 0; n0 < p.C; n0 += kBN) {
    float acc[1][4][4];
    gemm_tile<kLnRows, kGelu>(acc, p, smem, m0, n0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + (warp % 4) * 32 + j * 8 + c2;
      const float2 lo = tail_pair(p, &acc[0][j][0], m0 + r_local, col);
      const float2 hi = tail_pair(p, &acc[0][j][2], m0 + r_local + 8, col);
      *reinterpret_cast<float2*>(xs + r_local * xs_stride + col) = lo;
      *reinterpret_cast<float2*>(xs + (r_local + 8) * xs_stride + col) = hi;
    }
  }
  __syncthreads();
  const float inv_c = 1.0f / static_cast<float>(p.C);
#pragma unroll
  for (int rr = 0; rr < kLnRows / kWarps; ++rr) {
    const int r = warp * (kLnRows / kWarps) + rr;
    const int row = m0 + r;
    if (row >= p.M) break;  // warp-uniform; later rows of the warp are past M too
    const float* xr = xs + r * xs_stride;
    float s = 0.f;
    for (int c = 2 * lane; c < p.C; c += 64) {
      const float2 v = *reinterpret_cast<const float2*>(xr + c);
      s += v.x + v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(vitslam::kFull, s, o);
    const float mean = s * inv_c;
    float q = 0.f;
    for (int c = 2 * lane; c < p.C; c += 64) {
      const float2 v = *reinterpret_cast<const float2*>(xr + c);
      const float d0 = v.x - mean;
      const float d1 = v.y - mean;
      q += d0 * d0 + d1 * d1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(vitslam::kFull, q, o);
    const float inv = rsqrtf(q * inv_c + p.eps);
    bf16* yr = p.y + static_cast<size_t>(row) * p.C;
    for (int c = 2 * lane; c < p.C; c += 64) {
      const float2 v = *reinterpret_cast<const float2*>(xr + c);
      const float2 gm = *reinterpret_cast<const float2*>(p.gamma + c);
      const float2 bt = *reinterpret_cast<const float2*>(p.beta + c);
      *reinterpret_cast<__nv_bfloat162*>(yr + c) = __floats2bfloat162_rn(
          (v.x - mean) * inv * gm.x + bt.x, (v.y - mean) * inv * gm.y + bt.y);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). h: bf16 (M, F); w: bf16 (C, F);
// b: fp32 (C,); res, x: bf16 (M, C); with ln, gamma/beta fp32 (C,) and y
// bf16 (M, C), else they may be null. All contiguous and 16-byte aligned.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape it does not take:
// F not a multiple of 64, C not a multiple of 128, or with ln a C whose
// fp32 rows do not fit the shared memory).
extern "C" int vitslam_mlp_tail_bf16(const void* h, const void* w, const void* b,
                                     const void* res, const void* gamma, const void* beta,
                                     void* x, void* y, int M, int F, int C, int gelu, int ln,
                                     float eps, void* stream) {
  if (M < 1 || F < kBK || F % kBK != 0 || C < kBN || C % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const bf16*>(h),     static_cast<const bf16*>(w),
                 static_cast<const float*>(b),    static_cast<const bf16*>(res),
                 static_cast<const float*>(gamma), static_cast<const float*>(beta),
                 static_cast<bf16*>(x),           static_cast<bf16*>(y),
                 M,  F,  C,  eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln) {
    const size_t smem = Tiles<kLnRows>::kBytes +
                        static_cast<size_t>(kLnRows) * (C + kXsPad) * sizeof(float);
    if (gamma == nullptr || beta == nullptr || y == nullptr || smem > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((M + kLnRows - 1) / kLnRows);
    return static_cast<int>(gelu ? launch(mlp_tail_ln_kernel<true>, grid, smem, p, s)
                                 : launch(mlp_tail_ln_kernel<false>, grid, smem, p, s));
  }
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, C / kBN);
  const size_t smem = Tiles<kGemmRows>::kBytes;
  return static_cast<int>(gelu ? launch(mlp_tail_gemm_kernel<true>, grid, smem, p, s)
                               : launch(mlp_tail_gemm_kernel<false>, grid, smem, p, s));
}
