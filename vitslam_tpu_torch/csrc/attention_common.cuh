// Warp-level mma.sync building blocks shared by the port's backward
// attention kernels (flash_attention_bwd.cu, K4) and the fused block tail
// (mlp_tail.cu, K5): bf16 mma.sync m16n8k16 with fp32 accumulation,
// cp.async tile loads into padded shared memory, ldmatrix, the two
// warp-level products X Y^T and P Y, re-packing an accumulator as A
// fragments, and the scaled bf16 store. All of it works on the register
// fragments of one warp that owns 16 rows: lane l holds rows g = l / 4 and
// g + 8, and the column pair c2 = 2 * (l % 4) of every 8-wide n-tile. The
// attention forward (K1-K3) is the wgmma + TMA core of
// attention_fwd_sm90.cuh instead.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vitslam {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

}  // namespace vitslam
