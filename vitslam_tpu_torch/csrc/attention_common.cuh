// Attention core shared by the port's Hopper kernels (fused_attention.cu,
// K1; flash_attention.cu, K2 and K3): bf16 mma.sync m16n8k16 with fp32
// accumulation, the exp2-domain softmax step over one 64-key tile, and the
// normalise-and-store epilogue. All of it works on the register fragments
// of one warp that owns 16 query rows: lane l holds rows g = l / 4 and
// g + 8, and the column pair c2 = 2 * (l % 4) of every 8-wide n-tile.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vitslam {

constexpr int kDh = 64;      // head dim the kernels are built for
constexpr int kBlockN = 64;  // keys per inner iteration
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
template <bool kBounded>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 8][4],
                                             float (&acc)[kDh / 8][4], float (&m_row)[2],
                                             float (&l_row)[2], float shift,
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
    for (int j = 0; j < kDh / 8; ++j) {
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

// Epilogue: reduce l over the lane quad, normalise, and write the warp's
// rows as bf16. row0 / row1 point at the lane's column pair (head column
// offset + c2) of rows g and g + 8 of the output, or are null for a row
// past the end.
__device__ __forceinline__ void store_rows(const float (&acc)[kDh / 8][4], float (&l_row)[2],
                                           __nv_bfloat16* row0, __nv_bfloat16* row1) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_row[0] += __shfl_xor_sync(kFull, l_row[0], o);
    l_row[1] += __shfl_xor_sync(kFull, l_row[1], o);
  }
  const float inv0 = 1.0f / fmaxf(l_row[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l_row[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    if (row0 != nullptr) {
      *reinterpret_cast<uint32_t*>(row0 + j * 8) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    }
    if (row1 != nullptr) {
      *reinterpret_cast<uint32_t*>(row1 + j * 8) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
}

}  // namespace vitslam
