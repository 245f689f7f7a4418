// Flash attention backward for Hopper (sm_90a), bf16 in, bf16 out: K4 of
// the port.
//
// Replaces:
//   vitslam_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:384) and
//   ::_flash_bwd_dkv_kernel (:421), launched by _flash_backward (:462):
//   the FA2 backward of softmax(Q K^T * scale) V from the saved output O
//   and the log2-domain row logsumexp (K3's lse output), self or cross
//   (Nq != Nk), any head dim that is a multiple of 8 up to 128: the
//   instances at 32, 64 and 128 (kD), any other head dim in the next of
//   them. At 32 a box is the 32 columns, one 64-byte row of the 64-byte
//   swizzle, as in the forward core: the k16 slices of S and dP sit 0 or
//   32 bytes into the row, dv, dk and dq are m64n32k16 products (dq's with
//   K as an MN-major B of one 32-column atom), and the dq accumulator's
//   tiles are 64 x 32. The maps of k, v and dO keep the true head dim as their inner
//   extent, so TMA zero-fills the rest of kD in shared memory, and the prep
//   writes qs's pad columns as zeros: zero columns leave S, dP, Dvec and P
//   unchanged and give zero columns of dq, dk and dv, which are not
//   stored. (The wrapper copies a head dim that is not a multiple of 8 into
//   a zero-padded one first, as _flash_backward pads D.)
// Math, per (batch, head), with qs = q * scale * log2(e) rounded to bf16
// (the forward's q, bit for bit) and Dvec = rowsum(dO * O) in fp32:
//   P  = exp2(qs K^T - lse)            rebuilt per tile, no max tracking
//   dP = dO V^T,  dS = P * (dP - Dvec)
//   dq = scale * dS K,  dk = dS^T qs / log2(e),  dv = P^T dO
// dS and P enter their products rounded to bf16 (the reference casts them
// to the input dtype); every product accumulates in fp32.
// Masks: keys >= Nk get P = 0 (TMA's zero fill is not mass-free: a zero
// key row has logit 0); query rows >= Nq get lse = +inf and Dvec = 0, so
// P = dS = 0 and they add nothing to dk, dv or dq. Rows past the end are
// never stored.
//
// What bounds it on the H100: five Nq x Nk x D products per head (S, dP,
// dv, dk, dq), 10 Nq Nk D H FLOP, against O((Nq + Nk) D) bytes, so it is
// tensor-core bound (the AlignmentHead's global attention at 10,738 tokens,
// 8 heads of 128: 1.19 ms at 989 TFLOP/s).
//
// Design, FA3's backward: three launches per call.
// 1. flash_bwd_prep_kernel, one warp per query row: Dvec = rowsum(dO * O)
//    in fp32; qs = bf16(q * scale * log2(e)) with the forward kernel's fp32
//    multiply; lse and Dvec copied into buffers padded to a multiple of 128
//    rows (+inf and 0 past Nq); the fp32 dq accumulator and its tiles'
//    counters zeroed.
// 2. flash_bwd_kernel: a CTA owns 128 keys (two consumer warpgroups of 64
//    keys each; one producer warp issues every load). K and V are loaded
//    once by TMA; (qs, dO) tiles of kBq queries (64 at D 128, 128 at D 64)
//    with their lse and Dvec stream through a 2-stage mbarrier ring (TMA
//    for the tiles, bulk copies for the rows). Per tile and warpgroup,
//    five wgmma products, S and dP computed once:
//      S^T = K qs^T and dP^T = V dO^T (both operands in shared memory);
//      P^T = exp2(S^T - lse), dS^T = P^T (dP^T - Dvec) in registers;
//      dv += P^T dO and dk += dS^T qs (A from registers);
//      dS^T goes to shared memory (double-buffered), the two warpgroups
//      meet at a named barrier, and each computes one 64 x 64 block of
//      this key block's dq contribution, dS K over all 128 keys (at D 128
//      each warpgroup takes one 64-column half, at D 64 one 64-query
//      half), and stages it in shared memory. A dq writer warp per
//      consumer warpgroup adds the staged block into the fp32 accumulator
//      by one TMA bulk reduce-add (cp.reduce.async.bulk .add.f32), in key
//      block order: it waits until the accumulator tile's counter equals
//      its key block, adds, waits for the add to land, and increments the
//      counter. So every dq element is summed over the key blocks in the
//      same order on every run, and dq is bit-reproducible. The consumers
//      go on with the next tile meanwhile; they wait only for the staging
//      buffer, which the writer frees once the add has read it.
//    dk and dv leave registers once, in the epilogue.
// The order relies on CTAs starting in the order of their linear index (key
// block fastest), so a CTA's predecessor is resident or done when it
// waits; a writer that waits ~10 s traps instead of hanging the card.
// 3. flash_bwd_dq_kernel: dq = scale * accumulator, bf16, through dq's
//    strides.
// The accumulator is laid out in 64 x 64 tiles (batch, head, 64-query
// block, 64-column box), each tile in the order the consumer's wgmma
// fragments leave the registers, so the staging writes are 16-byte and
// free of bank conflicts: within a tile, thread t's (t = warp * 32 + lane
// of the warpgroup) accumulator element e of n8 block j (row warp * 16 +
// lane / 4 + 8 * (e / 2), column j * 8 + 2 * (lane % 4) + e % 2) is at
// float (j * 128 + t) * 4 + e.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace vitslam::sm90;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 128;          // keys per CTA
constexpr int kThreads = 3 * 128;   // two consumer warpgroups + the producer's (loads, dq writers)
constexpr int kRowPad = 128;        // lse / Dvec / accumulator rows padded to a multiple of it
constexpr int kPrepThreads = 256;

template <int kD>
struct Bwd {
  static_assert(kD == 32 || kD == 64 || kD == 128, "head dim 32, 64 or 128");
  static constexpr int kCols = kD < kBoxCols ? kD : kBoxCols;  // head-dim columns per box
  static constexpr int kRowBytes = 2 * kCols;          // one swizzle row: 128 bytes, 64 at D 32
  static constexpr int kPer = kRowBytes / 32;          // k16 slices of a swizzle row
  static constexpr int kBoxes = kD / kCols;            // boxes of a row
  static constexpr int kNb = kCols / 8;                // n8 column blocks of a box
  static constexpr int kBq = kD == 128 ? 64 : 128;     // queries per streamed tile
  static constexpr int kQH = kBq / 64;                 // 64-query halves of a tile
  static constexpr int kStages = 2;
  static constexpr int kKvBox = kKeys * kRowBytes;     // bytes of a 128-row box
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kQBox = kBq * kRowBytes;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kLseBytes = kBq * 4;            // a tile's lse (or Dvec)
  static constexpr int kAccTile = 64 * kCols;          // floats of one accumulator tile
  static constexpr int kDsBytes = kQH * kKeys * 128;   // dS^T: kQH blocks of [128 keys][64 queries]
  // shared memory, every tile 1024-byte aligned: K, V, qs stages, dO
  // stages, dS^T double buffer, dq staging per consumer, lse/Dvec rows,
  // barriers (kv_full, full[kStages], empty[kStages], staged[2], freed[2])
  static constexpr int kK = 0;
  static constexpr int kV = kKvTile;
  static constexpr int kQ = 2 * kKvTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kDs = kDo + kStages * kQTile;
  static constexpr int kStaging = kDs + 2 * kDsBytes;
  static constexpr int kRows = kStaging + 2 * kAccTile * 4;
  static constexpr int kBar = kRows + kStages * 2 * kLseBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages + 4) + 1024;
};

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;  // qs (contiguous), k, v, dO
  const float* lse;   // (B, H, nq_pad): +inf past nq
  const float* dvec;  // (B, H, nq_pad): 0 past nq
  float* dq_acc;      // the accumulator tiles
  int* dq_lock;       // per accumulator tile: the key blocks added so far
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_sh, dk_sn, dv_sb, dv_sh, dv_sn;
  int nq, nk, nq_pad, H;
  int dh;  // the operands' head dim (<= kD): columns >= dh are not stored
};

// Wait until *lock == turn (acquire, GPU scope), then order the async
// proxy's next global accesses after it. Traps after ~10 s (a predecessor
// CTA that never ran) instead of hanging.
__device__ __forceinline__ void wait_turn(const int* lock, int turn) {
  const long long t0 = clock64();
  int v;
  while (true) {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(lock) : "memory");
    if (v == turn) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// After this thread's bulk operations have completed: order them before
// the release of the next turn.
__device__ __forceinline__ void pass_turn(int* lock) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(lock) : "memory");
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ BwdParams p) {
  using S = Bwd<kD>;
  constexpr int kBoxes = S::kBoxes;
  constexpr int kBq = S::kBq;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-byte aligned: the swizzle atom
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base + S::kK;
  const uint32_t v_s = base + S::kV;
  const uint32_t bar = base + S::kBar;
  const uint32_t kv_full = bar;
  const uint32_t full = bar + 8;                   // + 8 * stage
  const uint32_t empty = bar + 8 * (1 + kStages);  // + 8 * stage
  const uint32_t staged = bar + 8 * (1 + 2 * kStages);  // + 8 * warpgroup: a dq block is staged
  const uint32_t freed = staged + 16;                    // + 8 * warpgroup: its staging is free

  const int k0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.nq + kBq - 1) / kBq;
  const long long bh = static_cast<long long>(b) * p.H + h;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(staged + 8 * w, 128);
      mbar_init(freed + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a consumer warpgroup's dq block of tile it: a 64-query half (D 64) or
  // a 64-column box (D 128), as the accumulator tile of that block
  const auto acc_tile = [](int it, int wg) {
    return static_cast<long long>(it * S::kQH + (S::kQH == 2 ? wg : 0)) * kBoxes +
           (S::kQH == 2 ? 0 : wg);
  };
  const long long acc_tiles = static_cast<long long>(p.nq_pad / 64) * kBoxes;  // per (b, h)

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup: one thread issues every load; warps 1 and 2
    // write dq for consumer warpgroups 0 and 1 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int pw = (threadIdx.x - 2 * 128) / 32;
    if ((pw == 1 || pw == 2) && threadIdx.x % 32 == 0) {
      const int w = pw - 1;
      const uint32_t staging = base + S::kStaging + w * S::kAccTile * 4;
      float* const acc_b = p.dq_acc + bh * acc_tiles * S::kAccTile;
      int* const lock_b = p.dq_lock + bh * acc_tiles;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(staged + 8 * w, it & 1);
        const long long tile = acc_tile(it, w);
        wait_turn(lock_b + tile, blockIdx.x);  // the key blocks before this one have added
        bulk_reduce_add_f32(acc_b + tile * S::kAccTile, staging, S::kAccTile * 4);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(freed + 8 * w);
        bulk_wait();  // the add has landed
        pass_turn(lock_b + tile);
      }
    }
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(kv_full, 2 * S::kKvTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(k_s + c * S::kKvBox, &p.k_map, kv_full, c * S::kCols, k0, h, b);
        tma_load_4d(v_s + c * S::kKvBox, &p.v_map, kv_full, c * S::kCols, k0, h, b);
      }
      const float* lse_b = p.lse + bh * p.nq_pad;
      const float* dvec_b = p.dvec + bh * p.nq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // round 0 passes at once
        const uint32_t f = full + 8 * s;
        mbar_expect_tx(f, 2 * S::kQTile + 2 * S::kLseBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(base + S::kQ + s * S::kQTile + c * S::kQBox, &p.q_map, f, c * S::kCols,
                      it * kBq, h, b);
          tma_load_4d(base + S::kDo + s * S::kQTile + c * S::kQBox, &p.do_map, f, c * S::kCols,
                      it * kBq, h, b);
        }
        const uint32_t rows = base + S::kRows + s * 2 * S::kLseBytes;
        bulk_load(rows, lse_b + it * kBq, S::kLseBytes, f);
        bulk_load(rows + S::kLseBytes, dvec_b + it * kBq, S::kLseBytes, f);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;        // fragment row group
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int r0 = wg * 64 + warp * 16 + g;  // the CTA's key rows of this thread: r0, r0 + 8
  const bool key0 = k0 + r0 < p.nk;
  const bool key1 = k0 + r0 + 8 < p.nk;
  constexpr int kRowBytes = S::kRowBytes;
  constexpr int kPer = S::kPer;
  constexpr int kNb = S::kNb;
  // byte offset of this warpgroup's keys in a K/V box
  const uint32_t wg_rows = wg * 64 * kRowBytes;
  // this warpgroup's dq block of every tile: a 64-query half (D 32, 64) or
  // a 64-column box (D 128)
  const int q_half = S::kQH == 2 ? wg : 0;
  const int c_box = S::kQH == 2 ? 0 : wg;
  const uint32_t staging = base + S::kStaging + wg * S::kAccTile * 4;

  float dk[kBoxes][kNb][4], dv[kBoxes][kNb][4];
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][j][e] = dv[c][j][e] = 0.f;
    }
  }
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t q_tile = base + S::kQ + s * S::kQTile;
    const uint32_t do_tile = base + S::kDo + s * S::kQTile;
    const float* lse_s = reinterpret_cast<const float*>(gbase + S::kRows + s * 2 * S::kLseBytes);
    const float* dvec_s = lse_s + kBq;

    // S^T = K qs^T, dP^T = V dO^T: k16 slice kk of the head dim lies in box
    // kk / kPer at byte 32 * (kk % kPer)
    float st[kBq / 8][4], dpt[kBq / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t da =
          desc_sw<kRowBytes>(k_s + (kk / kPer) * S::kKvBox + wg_rows + (kk % kPer) * 32);
      const uint64_t db = desc_sw<kRowBytes>(q_tile + (kk / kPer) * S::kQBox + (kk % kPer) * 32);
      if constexpr (kBq == 64) {
        wgmma_ss_m64n64k16<0, 0>(st, da, db, kk > 0);
      } else {
        wgmma_ss_m64n128k16(st, da, db, kk > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t da =
          desc_sw<kRowBytes>(v_s + (kk / kPer) * S::kKvBox + wg_rows + (kk % kPer) * 32);
      const uint64_t db = desc_sw<kRowBytes>(do_tile + (kk / kPer) * S::kQBox + (kk % kPer) * 32);
      if constexpr (kBq == 64) {
        wgmma_ss_m64n64k16<0, 0>(dpt, da, db, kk > 0);
      } else {
        wgmma_ss_m64n128k16(dpt, da, db, kk > 0);
      }
    }
    wgmma_commit();

    // P^T while dP^T is in flight: rows are keys, columns queries
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = e < 2 ? key0 : key1;
        st[j][e] = valid ? fast_exp2(st[j][e] - lse_s[j * 8 + c2 + (e & 1)]) : 0.f;
      }
    }
    uint32_t pa[kBq / 16][4];
#pragma unroll
    for (int t16 = 0; t16 < kBq / 16; ++t16) {
      pa[t16][0] = pack_bf16(st[2 * t16][0], st[2 * t16][1]);
      pa[t16][1] = pack_bf16(st[2 * t16][2], st[2 * t16][3]);
      pa[t16][2] = pack_bf16(st[2 * t16 + 1][0], st[2 * t16 + 1][1]);
      pa[t16][3] = pack_bf16(st[2 * t16 + 1][2], st[2 * t16 + 1][3]);
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t dsa[kBq / 16][4];
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[j][e] = st[j][e] * (dpt[j][e] - dvec_s[j * 8 + c2 + (e & 1)]);
      }
    }
    // dS^T into shared memory as [key][query] rows of 64 queries, 128-byte
    // swizzled: the MN-major A operand of the dq product
    unsigned char* const ds = gbase + S::kDs + (it & 1) * S::kDsBytes;
#pragma unroll
    for (int t16 = 0; t16 < kBq / 16; ++t16) {
      dsa[t16][0] = pack_bf16(dpt[2 * t16][0], dpt[2 * t16][1]);
      dsa[t16][1] = pack_bf16(dpt[2 * t16][2], dpt[2 * t16][3]);
      dsa[t16][2] = pack_bf16(dpt[2 * t16 + 1][0], dpt[2 * t16 + 1][1]);
      dsa[t16][3] = pack_bf16(dpt[2 * t16 + 1][2], dpt[2 * t16 + 1][3]);
      unsigned char* const blk = ds + (t16 / 4) * kKeys * 128 + r0 * 128 + c2 * 2;
      const int chunk = 2 * (t16 % 4);
      const int sw = r0 & 7;  // rows r0 and r0 + 8 share their swizzle phase
      *reinterpret_cast<uint32_t*>(blk + ((chunk ^ sw) << 4)) = dsa[t16][0];
      *reinterpret_cast<uint32_t*>(blk + 8 * 128 + ((chunk ^ sw) << 4)) = dsa[t16][1];
      *reinterpret_cast<uint32_t*>(blk + (((chunk + 1) ^ sw) << 4)) = dsa[t16][2];
      *reinterpret_cast<uint32_t*>(blk + 8 * 128 + (((chunk + 1) ^ sw) << 4)) = dsa[t16][3];
    }
    fence_async_smem();

    // dv += P^T dO, dk += dS^T qs: k16 slice t16 of the queries is rows
    // 16 t16.. of each dO / qs box (MN-major B)
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int t16 = 0; t16 < kBq / 16; ++t16) {
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        const uint64_t db = desc_sw<kRowBytes>(do_tile + c * S::kQBox + t16 * 16 * kRowBytes);
        if constexpr (kNb == 8) {
          wgmma_rs_m64n64k16(dv[c], pa[t16], db);
        } else {
          wgmma_rs_m64n32k16(dv[c], pa[t16], db);
        }
      }
    }
#pragma unroll
    for (int t16 = 0; t16 < kBq / 16; ++t16) {
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        const uint64_t db = desc_sw<kRowBytes>(q_tile + c * S::kQBox + t16 * 16 * kRowBytes);
        if constexpr (kNb == 8) {
          wgmma_rs_m64n64k16(dk[c], dsa[t16], db);
        } else {
          wgmma_rs_m64n32k16(dk[c], dsa[t16], db);
        }
      }
    }
    wgmma_commit();

    // dq block = dS K over the CTA's 128 keys: both warpgroups' dS^T are
    // in shared memory past this barrier
    named_sync(1, 2 * 128);
    float dq[kNb][4];
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kKeys / 16; ++k16) {
      const uint64_t da = desc_sw128(smem_u32(ds) + q_half * kKeys * 128 + k16 * 2048);
      const uint64_t db = desc_sw<kRowBytes>(k_s + c_box * S::kKvBox + k16 * 16 * kRowBytes);
      if constexpr (kNb == 8) {
        wgmma_ss_m64n64k16<1, 1>(dq, da, db, k16 > 0);
      } else {
        wgmma_ss_m64n32k16<1, 1>(dq, da, db, k16 > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(dsa);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    mbar_arrive(empty + 8 * s);  // this thread is done with the stage

    // stage the dq block for this warpgroup's dq writer, once its last add
    // has read the staging
    if (it > 0) mbar_wait(freed + 8 * wg, (it - 1) & 1);
    float4* const st4 = reinterpret_cast<float4*>(gbase + (staging - base));
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      st4[j * 128 + t] = make_float4(dq[j][0], dq[j][1], dq[j][2], dq[j][3]);
    }
    fence_async_smem();
    mbar_arrive(staged + 8 * wg);
  }

  // ---- epilogue: dk (qs carries scale * log2(e): / log2(e) leaves scale), dv ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r0 + 8 * half;
    if (key >= p.nk) continue;
    bf16* dkr = p.dk + b * p.dk_sb + h * p.dk_sh + key * p.dk_sn + c2;
    bf16* dvr = p.dv + b * p.dv_sb + h * p.dv_sh + key * p.dv_sn + c2;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const int col = c * S::kCols + j * 8;
        if (col >= p.dh) continue;  // dh is a multiple of 8: a column block is in or out
        *reinterpret_cast<uint32_t*>(dkr + col) = pack_bf16(
            dk[c][j][2 * half] * (1.0f / kLog2e), dk[c][j][2 * half + 1] * (1.0f / kLog2e));
        *reinterpret_cast<uint32_t*>(dvr + col) =
            pack_bf16(dv[c][j][2 * half], dv[c][j][2 * half + 1]);
      }
    }
  }
}

struct PrepParams {
  const bf16* q;
  const bf16* out;
  const bf16* dout;
  const float* lse;  // (B, H, nq) contiguous
  bf16* qs;          // (B, H, nq, kD) contiguous
  float* lse_pad;
  float* dvec_pad;
  float* dq_acc;
  int* dq_lock;
  long long q_sb, q_sh, q_sn, o_sb, o_sh, o_sn, do_sb, do_sh, do_sn;
  long long rows;  // B * H * nq_pad
  int H, nq, nq_pad, dh;
  float fold;
};

// One warp per padded query row: zero its share of the accumulator (and,
// on the first row of a 64-row block, the block's tile counters), and for
// a real row fold q, take Dvec = rowsum(dO * O) and copy the lse. A lane
// whose columns lie past dh (all of them or none: dh is a multiple of 8)
// writes zeros to qs and adds nothing to Dvec.
template <int kD>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(const PrepParams p) {
  // columns per lane: 2 or 4 (at D 32 16 lanes of 2 columns)
  constexpr int kPer = kD < 64 ? 2 : kD / 32;
  constexpr int kBoxes = Bwd<kD>::kBoxes;
  const long long row = (static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const bool active = lane * kPer < kD;
  if (active) {
    float* acc = p.dq_acc + row * kD + lane * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  }
  if (row % 64 == 0 && lane < kBoxes) p.dq_lock[row / 64 * kBoxes + lane] = 0;
  const long long bh = row / p.nq_pad;
  const int n = static_cast<int>(row % p.nq_pad);
  if (n >= p.nq) {
    if (lane == 0) {
      p.lse_pad[row] = INFINITY;
      p.dvec_pad[row] = 0.f;
    }
    return;
  }
  const int b = static_cast<int>(bh / p.H);
  const int h = static_cast<int>(bh % p.H);
  const int col = lane * kPer;
  bf16* qs = p.qs + (bh * p.nq + n) * kD + col;
  float sum = 0.f;
  if (!active) {
  } else if (col < p.dh) {
    const bf16* q = p.q + b * p.q_sb + h * p.q_sh + n * p.q_sn + col;
    const bf16* o = p.out + b * p.o_sb + h * p.o_sh + n * p.o_sn + col;
    const bf16* d = p.dout + b * p.do_sb + h * p.do_sh + n * p.do_sn + col;
#pragma unroll
    for (int e = 0; e < kPer; e += 2) {
      const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + e));
      const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + e));
      const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + e));
      sum += dv.x * ov.x + dv.y * ov.y;
      *reinterpret_cast<uint32_t*>(qs + e) =
          pack_bf16(__fmul_rn(qv.x, p.fold), __fmul_rn(qv.y, p.fold));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; e += 2) *reinterpret_cast<uint32_t*>(qs + e) = 0u;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) {
    p.lse_pad[row] = p.lse[bh * p.nq + n];
    p.dvec_pad[row] = sum;
  }
}

struct DqParams {
  const float* dq_acc;
  bf16* dq;
  long long dq_sb, dq_sh, dq_sn;
  long long pairs;  // B * H * nq * dh / 2
  int H, nq, nq_pad, dh;
  float scale;
};

// dq = scale * accumulator in bf16, one column pair per thread, read from
// the accumulator's fragment-ordered tiles.
template <int kD>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_dq_kernel(const DqParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (i >= p.pairs) return;
  const int col = static_cast<int>(i % (p.dh / 2)) * 2;
  const long long rn = i / (p.dh / 2);
  const int n = static_cast<int>(rn % p.nq);
  const long long bh = rn / p.nq;
  const int b = static_cast<int>(bh / p.H);
  const int h = static_cast<int>(bh % p.H);
  using S = Bwd<kD>;
  const int r = n % 64;
  const int cc = col % S::kCols;
  const int tid = (r / 16) * 32 + (r % 8) * 4 + (cc % 8) / 2;  // the writer's thread
  const long long tile = (bh * (p.nq_pad / 64) + n / 64) * S::kBoxes + col / S::kCols;
  const float2 v = *reinterpret_cast<const float2*>(
      p.dq_acc + tile * S::kAccTile + ((cc / 8) * 128 + tid) * 4 + ((r % 16) / 8) * 2);
  *reinterpret_cast<uint32_t*>(p.dq + b * p.dq_sb + h * p.dq_sh + n * p.dq_sn + col) =
      pack_bf16(v.x * p.scale, v.y * p.scale);
}

template <int kD>
cudaError_t launch(const PrepParams& pp, BwdParams bp, const DqParams& dp, const void* k,
                   const void* v, int B, int H, int nk, const long long (&ks)[3],
                   const long long (&vs)[3], const long long (&dos)[3], cudaStream_t stream) {
  using S = Bwd<kD>;
  const long long qs_sn = kD, qs_sh = static_cast<long long>(pp.nq) * kD, qs_sb = qs_sh * H;
  const int dh = pp.dh;
  if (!make_map(&bp.q_map, pp.qs, kD, pp.nq, H, B, qs_sb, qs_sh, qs_sn, S::kBq, S::kCols) ||
      !make_map(&bp.do_map, pp.dout, dh, pp.nq, H, B, dos[0], dos[1], dos[2], S::kBq,
                S::kCols) ||
      !make_map(&bp.k_map, k, dh, nk, H, B, ks[0], ks[1], ks[2], kKeys, S::kCols) ||
      !make_map(&bp.v_map, v, dh, nk, H, B, vs[0], vs[1], vs[2], kKeys, S::kCols)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return err;
  const long long prep_blocks = (pp.rows * 32 + kPrepThreads - 1) / kPrepThreads;
  flash_bwd_prep_kernel<kD><<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0, stream>>>(pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((nk + kKeys - 1) / kKeys, H, B);
  flash_bwd_kernel<kD><<<grid, kThreads, S::kBytes, stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (dp.pairs + kPrepThreads - 1) / kPrepThreads;
  flash_bwd_dq_kernel<kD><<<static_cast<unsigned>(dq_blocks), kPrepThreads, 0, stream>>>(dp);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q, out, dout, dq: bf16 (B, H,
// Nq, dh); k, v, dk, dv: bf16 (B, H, Nk, dh); dh a multiple of 8 up to
// 128, kD the next of 32, 64 and 128; each addressed through the given
// element strides of (batch, head, token) with a contiguous head dim, rows
// and base 16-byte aligned. lse: fp32 (B, H, Nq) contiguous, log2 domain.
// Scratch the caller allocates: qs bf16 (B, H, Nq, kD) contiguous;
// lse_pad and dvec_pad fp32 (B, H, nq_pad), dq_acc fp32 (B, H, nq_pad, kD)
// and dq_lock int32 (B, H, nq_pad / 64, max(1, kD / 64)), nq_pad = Nq rounded up
// to a multiple of 128.
// fold = scale * log2(e) as the forward kernel takes it. Launches the prep,
// main and dq kernels on `stream`; allocates nothing; returns the first
// non-zero cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take or a map it cannot encode).
extern "C" int vitslam_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* qs, void* lse_pad, void* dvec_pad, void* dq_acc, void* dq_lock,
    void* dq, void* dk, void* dv, int B, int H, int nq, int nk, int dh, float fold, float scale, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long o_sb, long long o_sh,
    long long o_sn, long long do_sb, long long do_sh, long long do_sn, long long dq_sb,
    long long dq_sh, long long dq_sn, long long dk_sb, long long dk_sh, long long dk_sn,
    long long dv_sb, long long dv_sh, long long dv_sn, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 != 0 || B < 1 || H < 1 || nq < 1 || nk < 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq_pad = (nq + kRowPad - 1) / kRowPad * kRowPad;
  const long long rows = static_cast<long long>(B) * H * nq_pad;
  const PrepParams pp{static_cast<const bf16*>(q), static_cast<const bf16*>(out),
                      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                      static_cast<bf16*>(qs), static_cast<float*>(lse_pad),
                      static_cast<float*>(dvec_pad), static_cast<float*>(dq_acc),
                      static_cast<int*>(dq_lock), q_sb, q_sh, q_sn, o_sb, o_sh, o_sn, do_sb, do_sh, do_sn,
                      rows, H, nq, nq_pad, dh, fold};
  BwdParams bp{};
  bp.lse = static_cast<const float*>(lse_pad);
  bp.dvec = static_cast<const float*>(dvec_pad);
  bp.dq_acc = static_cast<float*>(dq_acc);
  bp.dq_lock = static_cast<int*>(dq_lock);
  bp.dk = static_cast<bf16*>(dk);
  bp.dv = static_cast<bf16*>(dv);
  bp.dk_sb = dk_sb;
  bp.dk_sh = dk_sh;
  bp.dk_sn = dk_sn;
  bp.dv_sb = dv_sb;
  bp.dv_sh = dv_sh;
  bp.dv_sn = dv_sn;
  bp.nq = nq;
  bp.nk = nk;
  bp.nq_pad = nq_pad;
  bp.H = H;
  bp.dh = dh;
  const DqParams dp{static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), dq_sb, dq_sh,
                    dq_sn, static_cast<long long>(B) * H * nq * (dh / 2), H, nq, nq_pad, dh,
                    scale};
  const long long ks[3] = {k_sb, k_sh, k_sn};
  const long long vs[3] = {v_sb, v_sh, v_sn};
  const long long dos[3] = {do_sb, do_sh, do_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh <= 32   ? launch<32>(pp, bp, dp, k, v, B, H, nk, ks, vs, dos, s)
                          : dh <= 64 ? launch<64>(pp, bp, dp, k, v, B, H, nk, ks, vs, dos, s)
                                     : launch<128>(pp, bp, dp, k, v, B, H, nk, ks, vs, dos, s);
  return static_cast<int>(err);
}
