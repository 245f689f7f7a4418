// The attention forward core of the port for Hopper (sm_90a): one kernel
// body (attention_fwd) behind K1 (fused_attention.cu,
// fused_qkv_attention_kernel) and K2/K3 (flash_attention.cu,
// flash_attention_kernel).
//
// O = softmax2(Q K^T) V per (batch, head) in the exp2 domain: q carries
// scale * log2(e) (folded here, once, on the Q tile in shared memory, or by
// K1's prep kernel), the softmax shift is either fixed (qk-norm's logit
// bound, read from a device scalar and multiplied by log2(e) here) or the
// online row max; self or cross (Nq != Nk); head dim any multiple of 8 up
// to 128, computed by the instance of the next of 32, 64 and 128 (kD): the
// tensor maps keep the true head dim as their inner extent, so TMA's zero
// fill pads the head dim in shared memory (zero q and k columns add nothing
// to Q K^T, zero v columns give output columns that are not stored);
// optionally the fp32 log2 lse per query row that the backward (K4) reads.
//
// What bounds it on the H100: two Nq * Nk * D products per head against
// O((Nq + Nk) * D) bytes, so every main-path shape but the smallest is
// tensor-core bound. The design follows FA3's shape:
// - TMA with mbarriers for every tile load. Q is loaded once per CTA (128
//   rows); K and V tiles of 128 keys flow through a ring of kStages stages
//   (4 at D 32, 3 at D 64, 2 at D 128). Each box is 64 head-dim columns
//   (one 128-byte row of the 128-byte swizzle; D 128 is two boxes) by 128
//   rows; at D 32 a box is the 32 columns, one 64-byte row of the 64-byte
//   swizzle (the descriptors' layout type and SBO follow it). The
//   tensor maps are 4-D (head dim, token, head, batch) with the caller's
//   strides, so a ragged last tile zero-fills inside its own (batch, head)
//   and never reads the next one's rows (the Python mirror of this
//   geometry is ops/flash_attention.py::tma_geometry).
// - wgmma for both products, fp32 accumulation: S = Q K^T as
//   m64n128k16 with both operands K-major in shared memory; O += P V as
//   m64n64k16 (one per 64-column V box; m64n32k16 at D 32) with P from
//   registers, re-packed
//   from the S accumulator as bf16 (FA3's layout: the accumulator of an
//   n8 column pair is the A fragment of a k16 slice), and V as an MN-major
//   B operand (transpose bit).
// - Warp specialisation: warpgroups 0 and 1 are consumers, 64 query rows
//   each; warpgroup 2 is the producer, one thread of which issues the TMA
//   loads and waits on the "empty" barriers. setmaxnreg gives the
//   producer's registers to the consumers (40 / 232).
// - The softmax runs on the accumulator fragments. Keys >= Nk in the last
//   tile are masked to -inf (TMA's zero fill is not mass-free: a zero row
//   has logit 0). The row sum l adds the same bf16-rounded P values that
//   enter P V, as K4 rebuilds P from the lse on that basis.
//   At D 64 the exponentials (one MUFU op per logit) cost about as much as
//   the two products, so exp2 is the bare ex2.approx.ftz instruction (the
//   same outputs as exp2f on the measured shapes, and faster at D 64).
// - Epilogue: O / max(l, 1e-30) in bf16 through the output's strides, rows
//   >= Nq not stored; lse = shift + log2(l), or row max + log2(l).
// The maps, barriers, TMA and wgmma pieces are sm90_common.cuh's, shared
// with K4 and K5.
// Tried on the H100 and dropped (PERF.md, Findings): issuing the next tile's
// Q K^T before this tile's P V within a warpgroup (no faster at D 64, much
// slower at D 128), FA3's ping-pong barriers between the two consumer
// warpgroups and three consumer warpgroups at D 64 (both slower). Not done:
// a TMA store of O, a persistent schedule.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace vitslam {
namespace sm90 {

constexpr int kBlockM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;

struct FwdParams {
  CUtensorMap q_map, k_map, v_map;
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_sn;
  const float* static_max;  // natural-log logit bound (device scalar), or null: online max
  float* lse;               // (B, H, nq) fp32, or null
  int nq, nk;
  int dh;        // the operands' head dim (<= kD): output columns >= dh are not stored
  float q_fold;  // scale * log2(e), folded into the Q tile by the kFold instances
};

// ---- the kernel -----------------------------------------------------------------

template <int kD>
struct Smem {
  static_assert(kD == 32 || kD == 64 || kD == 128, "head dim 32, 64 or 128");
  static constexpr int kCols = kD < kBoxCols ? kD : kBoxCols;  // head-dim columns per box
  static constexpr int kRowBytes = 2 * kCols;  // one swizzle row: 128 bytes, 64 at D 32
  static constexpr int kBoxes = kD / kCols;
  static constexpr int kNb = kCols / 8;               // n8 column blocks of O per box
  static constexpr int kBoxBytes = kBlockN * kRowBytes;  // one 128-row box: 16 KB, 8 at D 32
  static constexpr int kStages = kD == 128 ? 2 : kD == 64 ? 3 : 4;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;             // one Q, K or V tile
  static constexpr int kBarOffset = (1 + 2 * kStages) * kTileBytes;  // q, k stages, v stages
  // + q_full, full[kStages], empty[kStages], and 1024 bytes to align the base
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// One consumer thread's share of the online softmax over one 128-key tile:
// s holds rows g and g + 8 of the warp's 16 (16 n8 column blocks), P comes
// out as the A fragments of P V (k16 slice t covers blocks 2t and 2t + 1).
template <bool kBounded, int kBoxes, int kNb>
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], float (&o)[kBoxes][kNb][4],
                                             float (&m_row)[2], float (&l_row)[2], float shift,
                                             uint32_t (&pa)[8][4]) {
  float sub0 = shift, sub1 = shift;
  if (!kBounded) {
    float mx0 = m_row[0], mx1 = m_row[1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // the first tile always holds key 0, so mx is finite from here on
    const float alpha0 = fast_exp2(m_row[0] - mx0);
    const float alpha1 = fast_exp2(m_row[1] - mx1);
    m_row[0] = mx0;
    m_row[1] = mx1;
    l_row[0] *= alpha0;
    l_row[1] *= alpha1;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        o[c][j][0] *= alpha0;
        o[c][j][1] *= alpha0;
        o[c][j][2] *= alpha1;
        o[c][j][3] *= alpha1;
      }
    }
    sub0 = mx0;
    sub1 = mx1;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    pa[t][0] = pack_bf16(fast_exp2(s[2 * t][0] - sub0), fast_exp2(s[2 * t][1] - sub0));
    pa[t][1] = pack_bf16(fast_exp2(s[2 * t][2] - sub1), fast_exp2(s[2 * t][3] - sub1));
    pa[t][2] = pack_bf16(fast_exp2(s[2 * t + 1][0] - sub0), fast_exp2(s[2 * t + 1][1] - sub0));
    pa[t][3] = pack_bf16(fast_exp2(s[2 * t + 1][2] - sub1), fast_exp2(s[2 * t + 1][3] - sub1));
    l_row[0] += sum_bf16x2(pa[t][0]) + sum_bf16x2(pa[t][2]);
    l_row[1] += sum_bf16x2(pa[t][1]) + sum_bf16x2(pa[t][3]);
  }
}

// The body of the kernel. Each source wraps it in a __global__ of its own
// name (fused_qkv_attention_kernel, flash_attention_kernel), launched with
// kThreads threads and __launch_bounds__(kThreads, 1), so that a profile
// tells K1 from K2/K3; p is that kernel's __grid_constant__ parameter (the
// tensor maps must stay in parameter space).
template <int kD, bool kBounded, bool kFold>
__device__ __forceinline__ void attention_fwd(const FwdParams& p) {
  using S = Smem<kD>;
  constexpr int kBoxes = S::kBoxes;
  constexpr int kNb = S::kNb;
  constexpr int kRowBytes = S::kRowBytes;
  constexpr int kBoxBytes = S::kBoxBytes;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-byte aligned: the swizzle atoms
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + S::kTileBytes;                       // + stage * kTileBytes
  const uint32_t v_s = base + (1 + kStages) * S::kTileBytes;       // + stage * kTileBytes
  const uint32_t bar = base + S::kBarOffset;
  const uint32_t q_full = bar;
  const uint32_t full = bar + 8;                    // + 8 * stage
  const uint32_t empty = bar + 8 * (1 + kStages);   // + 8 * stage

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.nk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, S::kTileBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(q_s + c * kBoxBytes, &p.q_map, q_full, c * S::kCols, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // round 0 passes at once: the ring starts empty
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * S::kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(k_s + s * S::kTileBytes + c * kBoxBytes, &p.k_map, full + 8 * s,
                      c * S::kCols, it * kBlockN, h, b);
          tma_load_4d(v_s + s * S::kTileBytes + c * kBoxBytes, &p.v_map, full + 8 * s,
                      c * S::kCols, it * kBlockN, h, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane >> 2;        // fragment row group
    const int c2 = (lane & 3) * 2;  // fragment column pair
    const uint32_t q_rows = wg * 64 * kRowBytes;  // byte offset of this warpgroup's rows in a box

    mbar_wait(q_full, 0);
    if (kFold) {
      // q * scale * log2(e) in fp32, one rounding to bf16: the same numbers
      // as (q.float() * fold).to(bfloat16). Every element takes the same
      // factor, so the swizzled rows are walked as flat 16-byte chunks.
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
        for (int i = 0; i < kRowBytes / 32; ++i) {  // 64 rows of kRowBytes, 16 bytes a thread
          uint4* chunk = reinterpret_cast<uint4*>(gbase + c * kBoxBytes + q_rows +
                                                  (i * 128 + t) * 16);
          uint4 v = *chunk;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&w[e]);
            w[e] = pack_bf16(__fmul_rn(__low2float(x), p.q_fold),
                             __fmul_rn(__high2float(x), p.q_fold));
          }
          *chunk = v;
        }
      }
      // generic-proxy writes, read next by wgmma through the async proxy
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    float o[kBoxes][kNb][4];
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < kNb; ++j) o[c][j][0] = o[c][j][1] = o[c][j][2] = o[c][j][3] = 0.f;
    }
    float m_row[2] = {-INFINITY, -INFINITY};
    float l_row[2] = {0.f, 0.f};
    const float shift = kBounded ? __fmul_rn(*p.static_max, kLog2e) : 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t k_tile = k_s + s * S::kTileBytes;
      const uint32_t v_tile = v_s + s * S::kTileBytes;

      // S = Q K^T: k16 slice kk of head dim lies in box kk / kPer at byte
      // 32 * (kk % kPer), kPer = kRowBytes / 32 slices a swizzle row
      constexpr int kPer = kRowBytes / 32;
      float sc[16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / kPer) * kBoxBytes + (kk % kPer) * 32;
        wgmma_ss_m64n128k16(sc, desc_sw<kRowBytes>(q_s + q_rows + off),
                            desc_sw<kRowBytes>(k_tile + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int valid = p.nk - it * kBlockN;
      if (valid < kBlockN) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + c2 + (e & 1) >= valid) sc[j][e] = -INFINITY;
          }
        }
      }
      uint32_t pa[8][4];
      softmax_tile<kBounded, kBoxes, kNb>(sc, o, m_row, l_row, shift, pa);

      // O += P V: k16 slice t of the keys is rows 16t.. of each V box
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int t16 = 0; t16 < 8; ++t16) {
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          const uint64_t db = desc_sw<kRowBytes>(v_tile + c * kBoxBytes + t16 * 16 * kRowBytes);
          if constexpr (kNb == 8) {
            wgmma_rs_m64n64k16(o[c], pa[t16], db);
          } else {
            wgmma_rs_m64n32k16(o[c], pa[t16], db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) fence_regs(o[c]);
      mbar_arrive(empty + 8 * s);  // this thread is done with the stage
    }

    // ---- epilogue ----
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_row[0] += __shfl_xor_sync(kFull, l_row[0], off);
      l_row[1] += __shfl_xor_sync(kFull, l_row[1], off);
    }
    const float inv0 = 1.0f / fmaxf(l_row[0], 1e-30f);
    const float inv1 = 1.0f / fmaxf(l_row[1], 1e-30f);
    const int n0 = q0 + wg * 64 + warp * 16 + g;
    const int n1 = n0 + 8;
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh + c2;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const int col = c * S::kCols + j * 8;
        if (col >= p.dh) continue;  // dh is a multiple of 8: a column block is in or out
        if (n0 < p.nq) {
          *reinterpret_cast<uint32_t*>(ob + n0 * p.o_sn + col) =
              pack_bf16(o[c][j][0] * inv0, o[c][j][1] * inv0);
        }
        if (n1 < p.nq) {
          *reinterpret_cast<uint32_t*>(ob + n1 * p.o_sn + col) =
              pack_bf16(o[c][j][2] * inv1, o[c][j][3] * inv1);
        }
      }
    }
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lb = p.lse + (static_cast<long long>(b) * gridDim.y + h) * p.nq;
      if (n0 < p.nq) lb[n0] = (kBounded ? shift : m_row[0]) + log2f(fmaxf(l_row[0], 1e-30f));
      if (n1 < p.nq) lb[n1] = (kBounded ? shift : m_row[1]) + log2f(fmaxf(l_row[1], 1e-30f));
    }
  }
}

// Encode the maps and launch `kernel` (a wrapper of attention_fwd<kD, ...>)
// on `stream`: q (B, H, nq, dh), k and v (B, H, nk, dh) and o (B, H, nq,
// dh), dh = p.dh a multiple of 8 no larger than kD (32, 64 or 128), each
// through element strides of (batch, head, token) with a contiguous head
// dim; the maps' inner extent is dh, their boxes kD's. Returns the launch's
// error (cudaErrorInvalidValue when a map cannot be encoded).
template <int kD>
cudaError_t launch_fwd(void (*kernel)(FwdParams), FwdParams p, const void* q, const void* k,
                       const void* v, int B, int H, const long long (&qs)[3],
                       const long long (&ks)[3], const long long (&vs)[3],
                       cudaStream_t stream) {
  constexpr int kCols = Smem<kD>::kCols;
  if (p.dh < 8 || p.dh > kD || p.dh % 8 != 0 ||
      !make_map(&p.q_map, q, p.dh, p.nq, H, B, qs[0], qs[1], qs[2], kBlockM, kCols) ||
      !make_map(&p.k_map, k, p.dh, p.nk, H, B, ks[0], ks[1], ks[2], kBlockN, kCols) ||
      !make_map(&p.v_map, v, p.dh, p.nk, H, B, vs[0], vs[1], vs[2], kBlockN, kCols)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<kD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kThreads, Smem<kD>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace vitslam
