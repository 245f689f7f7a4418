// Attention core shared by the port's Hopper kernels (fused_attention.cu,
// K1; flash_attention.cu, K2 and K3; flash_attention_bwd.cu, K4): bf16
// mma.sync m16n8k16 with fp32 accumulation, the exp2-domain softmax step
// over one 64-key tile, the normalise-and-store epilogue, cp.async tile
// loads into padded shared memory and the two warp-level products every
// kernel is built from. All of it works on the register fragments of one
// warp that owns 16 rows: lane l holds rows g = l / 4 and g + 8, and the
// column pair c2 = 2 * (l % 4) of every 8-wide n-tile.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vitslam {

constexpr int kDh = 64;      // head dim of K1 (K2-K4 are templated on it)
constexpr int kBlockN = 64;  // keys per inner iteration of the forward kernels
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sum of the two bf16 halves of a packed pair, in fp32: the row sum l adds
// the same rounded P values that enter the P V product.
__device__ __forceinline__ float sum_bf16x2(uint32_t p) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&p);
  return __low2float(v) + __high2float(v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Start copying rows [row0, row0 + kRows) of one (batch, head) slice, kD
// bf16 wide with a contiguous row, into a padded shared tile (rows kD + 8
// wide: 16-byte aligned, and ldmatrix reads them without bank conflicts);
// rows >= n_rows are zero-filled (a zero V row keeps a masked key's 0 * V
// finite). All kThreads threads of the CTA call it together.
template <int kRows, int kD, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kD + 8],
                                          const __nv_bfloat16* base, long long row_stride,
                                          int row0, int n_rows) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
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

// c = X Y^T for one warp: X is the warp's 16 rows at xs, Y the kN rows at
// ys, both kD wide in padded shared memory; c holds the 16 x kN product as
// kN / 8 accumulator n-tiles (overwritten). Per 32-wide slice of kD, two
// ldmatrix.x4 give X's A fragments of two k-steps and one ldmatrix.x4 per
// 8-row n-tile gives Y's B fragments of both.
template <int kN, int kD>
__device__ __forceinline__ void mma_xyt(float (&c)[kN / 8][4], __nv_bfloat16 (*xs)[kD + 8],
                                        __nv_bfloat16 (*ys)[kD + 8], int lane) {
  static_assert(kD % 32 == 0 && kN % 8 == 0, "32-wide k slices, 8-row n-tiles");
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  }
#pragma unroll
  for (int kh = 0; kh < kD / 32; ++kh) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, &xs[lane % 16][kh * 32 + (lane / 16) * 8]);
    ldmatrix_x4(a1, &xs[lane % 16][kh * 32 + 16 + (lane / 16) * 8]);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &ys[j * 8 + (lane % 8)][kh * 32 + (lane / 8) * 8]);
      mma_bf16_16816(c[j], a0, bf[0], bf[1]);
      mma_bf16_16816(c[j], a1, bf[2], bf[3]);
    }
  }
}

// acc += P Y for one warp: P is 16 x kN, held as A fragments (k-step t
// covers Y rows 16t .. 16t + 15), Y is kN x kD in padded shared memory.
// One ldmatrix.x4.trans gives the B fragments of two 8-wide n-tiles of Y
// over one 16-row k-step.
template <int kN, int kD>
__device__ __forceinline__ void mma_py(float (&acc)[kD / 8][4], const uint32_t (&pa)[kN / 16][4],
                                       __nv_bfloat16 (*ys)[kD + 8], int lane) {
#pragma unroll
  for (int jp = 0; jp < kD / 16; ++jp) {
#pragma unroll
    for (int t = 0; t < kN / 16; ++t) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf,
                        &ys[t * 16 + (lane % 8) + ((lane / 8) & 1) * 8][(2 * jp + lane / 16) * 8]);
      mma_bf16_16816(acc[2 * jp], pa[t], vf[0], vf[1]);
      mma_bf16_16816(acc[2 * jp + 1], pa[t], vf[2], vf[3]);
    }
  }
}

// Pack a 16 x kN fp32 accumulator tile into bf16 A fragments of a product
// over its kN columns (k-step t covers n-tiles 2t and 2t + 1).
template <int kN>
__device__ __forceinline__ void pack_a(const float (&s)[kN / 8][4], uint32_t (&pa)[kN / 16][4]) {
#pragma unroll
  for (int t = 0; t < kN / 16; ++t) {
    pa[t][0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
    pa[t][1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
    pa[t][2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
    pa[t][3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
  }
}

// Mask the logits of keys >= n_keys (the ragged last tile) to -inf; k0 is
// the tile's first key.
__device__ __forceinline__ void mask_tail(float (&s)[kBlockN / 8][4], int k0, int n_keys,
                                          int c2) {
  if (k0 + kBlockN <= n_keys) return;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + j * 8 + c2 + (e & 1) >= n_keys) s[j][e] = -INFINITY;
    }
  }
}

// One tile's softmax in the exp2 domain (q carries scale * log2(e)): with
// kBounded the exponent shift is the fixed `shift`, else the running row
// max m_row, with acc and l_row rescaled when it grows. P comes out in bf16
// laid out directly as the A fragments of P V (key k-step t covers n-tiles
// 2t and 2t+1), and its row sums are added to the lane's partial l_row.
// kAcc = head dim / 8.
template <bool kBounded, int kAcc>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 8][4], float (&acc)[kAcc][4],
                                             float (&m_row)[2], float (&l_row)[2], float shift,
                                             uint32_t (&pa)[kBlockN / 16][4]) {
  float sub0, sub1;
  if (kBounded) {
    sub0 = sub1 = shift;
  } else {
    float mx0 = m_row[0], mx1 = m_row[1];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
    }
    // the first tile always holds key 0, so mx is finite from here on
    const float alpha0 = exp2f(m_row[0] - mx0);
    const float alpha1 = exp2f(m_row[1] - mx1);
    m_row[0] = mx0;
    m_row[1] = mx1;
    l_row[0] *= alpha0;
    l_row[1] *= alpha1;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
    sub0 = mx0;
    sub1 = mx1;
  }
#pragma unroll
  for (int t = 0; t < kBlockN / 16; ++t) {
    pa[t][0] = pack_bf16(exp2f(s[2 * t][0] - sub0), exp2f(s[2 * t][1] - sub0));
    pa[t][1] = pack_bf16(exp2f(s[2 * t][2] - sub1), exp2f(s[2 * t][3] - sub1));
    pa[t][2] = pack_bf16(exp2f(s[2 * t + 1][0] - sub0), exp2f(s[2 * t + 1][1] - sub0));
    pa[t][3] = pack_bf16(exp2f(s[2 * t + 1][2] - sub1), exp2f(s[2 * t + 1][3] - sub1));
    l_row[0] += sum_bf16x2(pa[t][0]) + sum_bf16x2(pa[t][2]);
    l_row[1] += sum_bf16x2(pa[t][1]) + sum_bf16x2(pa[t][3]);
  }
}

// Write the warp's rows of acc * scale0 (row g) and acc * scale1 (row
// g + 8) as bf16. row0 / row1 point at the lane's column pair (head column
// offset + c2) of rows g and g + 8 of the output, or are null for a row
// past the end.
template <int kAcc>
__device__ __forceinline__ void store_scaled(const float (&acc)[kAcc][4], float scale0,
                                             float scale1, __nv_bfloat16* row0,
                                             __nv_bfloat16* row1) {
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    if (row0 != nullptr) {
      *reinterpret_cast<uint32_t*>(row0 + j * 8) = pack_bf16(acc[j][0] * scale0, acc[j][1] * scale0);
    }
    if (row1 != nullptr) {
      *reinterpret_cast<uint32_t*>(row1 + j * 8) = pack_bf16(acc[j][2] * scale1, acc[j][3] * scale1);
    }
  }
}

// Epilogue: reduce l over the lane quad (l_row then holds the full row
// sums in every lane of the quad), normalise, and write the warp's rows as
// bf16 (see store_scaled).
template <int kAcc>
__device__ __forceinline__ void store_rows(const float (&acc)[kAcc][4], float (&l_row)[2],
                                           __nv_bfloat16* row0, __nv_bfloat16* row1) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_row[0] += __shfl_xor_sync(kFull, l_row[0], o);
    l_row[1] += __shfl_xor_sync(kFull, l_row[1], o);
  }
  store_scaled(acc, 1.0f / fmaxf(l_row[0], 1e-30f), 1.0f / fmaxf(l_row[1], 1e-30f), row0, row1);
}

}  // namespace vitslam
