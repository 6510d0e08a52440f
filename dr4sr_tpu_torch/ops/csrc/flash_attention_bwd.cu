// Flash-attention backward for Hopper (sm_90a) on tensor cores, with a plain
// C entry point that dr4sr_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces the Pallas TPU kernel dr4sr_tpu/ops/attention.py::_flash_bwd_kernel
// (:206). Given q [B,H,Lq,Dh], k/v [B,H,Lk,Dh], the forward's output o and
// the incoming gradient dO [B,H,Lq,Dh], a key-padding mask [B,Lk] (nonzero =
// pad) and the forward's row log-sum-exp lse [B,H,Lq], it computes
//
//     p  = softmax(q·kᵀ·scale, padded keys and (if causal) col > row masked)
//     dv = pᵀ·dO
//     ds = p ⊙ (dO·vᵀ − D),   D = rowsum(dO ⊙ o)
//     dq = ds·k·scale,   dk = dsᵀ·q·scale
//
// with the TPU kernel's semantics: p = exp(s − lse) over the full masked key
// row, and masked entries are forced to 0 by select after the exp (a fully
// masked row has lse = +inf and contributes nothing). Rows past Lq and keys
// past Lk are zero-filled in shared memory (0·garbage can be NaN) and their
// p is 0. Causal masks key column > query row with no offset, also when
// Lq != Lk. The gradients accumulate in f32 and are written in the input
// dtype. q, k (and dq, dk) may be wider than v, o and dO: MLA's Dqk 192 and
// Dv 128, instantiated in bf16 only; scale is the caller's, as the forward's.
//
// Arithmetic, as the TPU kernel rounds:
//   bf16: the five products in mma.m16n8k16 bf16 with f32 accumulation;
//         q·kᵀ is scaled after the product, in f32; p and ds are rounded to
//         bf16 only as the A operands of their products; D is f32.
//   f32:  3xTF32 (attention_mma.cuh) for all five products, never one TF32
//         pass: the forward's lse came from 3xTF32 scores, and p = exp(s −
//         lse) is only as good as s.
//   Both: e^x is exp2f(x·log2 e), one MUFU.EX2.
//
// What bounds it on an H100: at the train shape (B256 H2 L50 Dh32 f32) the
// bytes: q, k, v, o, dO, lse and the mask read once and dq, dk, dv written
// once, about 26 MB, 7.86 µs at 3.35 TB/s. At long sequences the products:
// 10·Dh FLOP per unmasked (query, key) pair and head. What the design does
// about it: at L = 50 one launch reads each input once, keeps every
// [query, key] intermediate on chip and runs each of the five products once,
// on tensor cores; f32 Dh=32 is held to 128 registers, so a train step's 512
// blocks fit the card in one wave.
//
// Design (FlashAttention-2's backward, one pass over the keys). The TPU
// kernel walks a (batch, head) grid in order with everything resident in
// VMEM. Here blocks run in parallel and carry nothing. The main kernel has
// one block of 4 warps per (64-key tile, head, batch); each warp owns 16
// keys, the rows of Sᵀ = K·Qᵀ. K and V stay in shared memory; the block
// loops over query tiles of 32 rows (64 for Dh=16 and bf16 Dh=64: Cfg),
// from the first that can see its keys when causal, with Q, dO, lse and D
// double-buffered by cp.async. Per query tile, in registers: Sᵀ and dPᵀ = V·dOᵀ, Pᵀ, dSᵀ =
// Pᵀ ⊙ (dPᵀ − D), then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ taken
// from their C-fragments as A operands; nothing of size [query, key] goes
// through shared memory for dk and dv. For dq, dSᵀ goes to shared memory
// once per tile and dQ_tile = dS·K runs on mma, each warp a 16-row slice.
//   Lk ≤ 64 (the key axis is one tile: L = 50, the whole train path): the
//   block owns all of dq for its (b, h); it computes D itself and writes dq
//   in the input dtype. One launch, no atomics, no scratch, deterministic.
//   Lk > 64, two launches, chosen by measurement (PERF.md):
//     f32:  a pre-pass writes D to a [B,H,Lq] scratch and zeroes dq; the main
//           kernel adds scale·dS·K into dq with float2 atomics. Sums land in
//           an order that varies from run to run: not bit-deterministic.
//     bf16: a dq kernel over query tiles (the mirror of the main kernel,
//           recomputing S and dP) writes dq and D first; the main kernel
//           then computes dk and dv only. Deterministic. In bf16 the
//           recomputed products cost less than the atomics; in 3xTF32 more.
// Fragments: bf16 operands by ldmatrix (.trans for Q, dO and K as the B
// operands of the accumulating products, and for dSᵀ as the A operand of
// dS·K); two adjacent n8 C-fragments form one k16 A-fragment. TF32: a
// C-fragment holds columns 2t, 2t+1 of each group where the A operand wants
// t, t+4, so the reduction index is permuted (split_c_as_a) and the B
// operand reads its rows 2t and 2t+1 (split_rows_2t). Shared rows are
// padded by 16 bytes, so ldmatrix and the TF32 loads hit distinct banks. A
// warp whose keys no row of the tile can see (causal, or past Lk) skips the
// tile's products.

#include "attention_mma.cuh"

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace dr4sr;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 16 * kWarps;  // keys per block of the main kernel, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// how the main kernel takes part in dq
enum DqMode {
  kDqDirect,    // Lk ≤ kBlockK: the block writes dq, and computes D itself
  kDqAtomic,    // f32: float2 atomics into dq, zeroed with D by the pre-pass
  kDqSeparate,  // bf16: dq by flash_bwd_dq_kernel, which ran first and wrote D
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A tf32 C-fragment c (columns 2t, 2t+1 of an n8 group) as the split A
// operand of the next product, its reduction index permuted: A column i is
// the group's column 2i and column i + 4 is 2i + 1. The B operand then
// reads its rows 2t and 2t + 1 for b0 and b1 (split_rows_2t).
__device__ __forceinline__ void split_c_as_a(const float (&c)[4], uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// that B operand: p points at row 2t, column g of the group's 8 rows
__device__ __forceinline__ void split_rows_2t(const float* p, int stride, uint32_t& b0_big,
                                              uint32_t& b1_big, uint32_t& b0_small,
                                              uint32_t& b1_small) {
  split_tf32(p[0], b0_big, b0_small);
  split_tf32(p[stride], b1_big, b1_small);
}

// two f32 values to two adjacent elements of T
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// DQK: the head size of q and k; DV: that of v, o and dO (equal but for
// MLA's 192/128, which only bf16 instantiates)
template <typename T, int DQK, int DV>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // query rows per tile: 32, which halves the Sᵀ and dPᵀ registers, except
  // where 64 measured faster (bf16 Dh=64) or dS·K needs it (Dh=16)
  static constexpr int kBlockQ = DQK == 16 || (kBf16 && DQK == 64) ? 64 : 32;
  // f32 Dh=32 (the train shape): 128 registers, so 4 blocks an SM and the
  // 512 blocks of a train step in one wave
  static constexpr int kMinBlocks = !kBf16 && DQK == 32 ? 4 : 1;
  static constexpr int kStride = DQK + 16 / sizeof(T);        // shared row of Q and K
  static constexpr int kVStride = DV + 16 / sizeof(T);        // shared row of dO and V
  static constexpr int kDsStride = kBlockQ + 16 / sizeof(T);  // shared row of dSᵀ
  static constexpr int kKElems = kBlockK * kStride;
  static constexpr int kVElems = kBlockK * kVStride;
  static constexpr int kQElems = kBlockQ * kStride;
  static constexpr int kOElems = kBlockQ * kVStride;  // one dO tile
  static constexpr int kDsElems = kBlockK * kDsStride;
  // lse and D of two stages (f32), K, V, dSᵀ, then `stages` × (Q, dO)
  static constexpr size_t smem_bytes(int stages) {
    return 4 * kBlockQ * sizeof(float) +
           (kKElems + kVElems + kDsElems + stages * (kQElems + kOElems)) * sizeof(T);
  }
};

// rows [0, Rows) of a [*, DH] slice into shared rows of `Stride` elements;
// rows at or past `valid` are zero-filled and read nothing
template <typename T, int DH, int Rows, int Stride>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int valid, int tid) {
  constexpr int kChunks = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kTotal = Rows * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if (kTotal % kThreads != 0 && c >= kTotal) break;
    const int r = c / kChunks;
    const int off = (c % kChunks) * kPerChunk;
    const bool ok = r < valid;
    cp_async_16(dst + r * Stride + off, ok ? src + static_cast<size_t>(r) * DH + off : src, ok);
  }
}

// D = rowsum(dO ⊙ o) of `row` in f32, taken by PARTS adjacent lanes (part =
// lane % PARTS) and summed across them; every lane of the warp must call it
// (rows past lq give 0)
template <typename T, int DH, int PARTS>
__device__ __forceinline__ float row_dot(const T* o, const T* dout, size_t row_off, bool valid,
                                         int part) {
  constexpr int kPer = DH / PARTS;
  float acc = 0.f;
  if (valid) {
    const size_t off = row_off + static_cast<size_t>(part) * kPer;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc = fmaf(to_f32(dout[off + i]), to_f32(o[off + i]), acc);
  }
#pragma unroll
  for (int m = 1; m < PARTS; m <<= 1) acc += __shfl_xor_sync(kFull, acc, m);
  return acc;
}

template <typename T, int DQK, int DV, int MODE>
__global__ void __launch_bounds__(kThreads, (Cfg<T, DQK, DV>::kMinBlocks))
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ drow,
                 const uint8_t* __restrict__ pad, T* __restrict__ dq, T* __restrict__ dk,
                 T* __restrict__ dv, int heads, int lq, int lk, int num_k_tiles, int causal,
                 float scale) {
  using C = Cfg<T, DQK, DV>;
  constexpr int kBQ = C::kBlockQ;
  constexpr int kStride = C::kStride;
  constexpr int kVStride = C::kVStride;
  constexpr int kDsStride = C::kDsStride;
  constexpr int kQGroups = kBQ / 8;   // n8 query groups of Sᵀ
  constexpr int kKGroups = DQK / 8;   // n8 column groups of dK (and dQ)
  constexpr int kVGroups = DV / 8;    // n8 column groups of dV
  constexpr int kTPR = kThreads / kBQ;  // threads a row when the block computes D
  static_assert(C::kBf16 || DQK == DV, "f32 takes one head size for q, k and v");

  extern __shared__ __align__(16) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem);  // stage s: lse·log2 e at 2s, D at 2s+1
  T* ks = reinterpret_cast<T*>(stats + 4 * kBQ);
  T* vs = ks + C::kKElems;
  T* dss = vs + C::kVElems;     // dSᵀ [kBlockK][kDsStride]
  T* qbuf = dss + C::kDsElems;  // stage s: Q, then dO

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kt = blockIdx.x % num_k_tiles;
  const int bh = blockIdx.x / num_k_tiles;
  const int b = bh / heads;
  const int k0 = kt * kBlockK;
  const size_t qoff = static_cast<size_t>(bh) * lq * DQK;   // q, dq
  const size_t ooff = static_cast<size_t>(bh) * lq * DV;    // o, dO
  const size_t koff = static_cast<size_t>(bh) * lk * DQK;   // k, dk
  const size_t voff = static_cast<size_t>(bh) * lk * DV;    // v, dv
  const size_t roff = static_cast<size_t>(bh) * lq;
  const int num_q_tiles = (lq + kBQ - 1) / kBQ;
  const int first = causal ? k0 / kBQ : 0;  // causal: rows before k0 see none of the keys

  auto load_q = [&](int tile) {
    const int q0 = tile * kBQ;
    T* dst = qbuf + ((tile - first) & 1) * (C::kQElems + C::kOElems);
    load_rows<T, DQK, kBQ, kStride>(dst, q + qoff + static_cast<size_t>(q0) * DQK, lq - q0, tid);
    load_rows<T, DV, kBQ, kVStride>(dst + C::kQElems, dout + ooff + static_cast<size_t>(q0) * DV,
                                    lq - q0, tid);
  };
  // lse of row `tid` (threads tid < kBQ) and D of row tid (tid / kTPR when
  // the block computes it) of query tile `tile`; stored after the compute
  float lse_v = 0.f, d_v = 0.f;
  auto fetch_stats = [&](int tile) {
    const int q0 = tile * kBQ;
    if (tid < kBQ) {
      const int row = q0 + tid;
      lse_v = row < lq ? lse[roff + row] * kLog2e : 0.f;
      if (MODE != kDqDirect) d_v = row < lq ? drow[roff + row] : 0.f;
    }
    if (MODE == kDqDirect) {
      const int row = q0 + tid / kTPR;
      d_v = row_dot<T, DV, kTPR>(o, dout, ooff + static_cast<size_t>(row) * DV, row < lq,
                                 tid % kTPR);
    }
  };
  auto store_stats = [&](int tile) {
    float* st = stats + 2 * ((tile - first) & 1) * kBQ;
    if (tid < kBQ) st[tid] = lse_v;
    if (MODE == kDqDirect) {
      if (tid % kTPR == 0) st[kBQ + tid / kTPR] = d_v;
    } else if (tid < kBQ) {
      st[kBQ + tid] = d_v;
    }
  };

  if (first < num_q_tiles) {  // else no row sees the keys: dk = dv = 0
    load_rows<T, DQK, kBlockK, kStride>(ks, k + koff + static_cast<size_t>(k0) * DQK, lk - k0,
                                        tid);
    load_rows<T, DV, kBlockK, kVStride>(vs, v + voff + static_cast<size_t>(k0) * DV, lk - k0,
                                        tid);
    load_q(first);
    cp_async_commit();
    fetch_stats(first);
    store_stats(first);
  }

  const int wkey = warp * 16;            // the warp's first key in the tile
  const int key_lo = k0 + wkey + g;      // this lane's keys: key_lo, key_lo + 8
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    key_ok[r] = key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
  }
  const float sl = scale * kLog2e;

  float dk_acc[kKGroups][4], dv_acc[kVGroups][4];
#pragma unroll
  for (int n = 0; n < kKGroups; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kVGroups; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = 0.f;
  }

  for (int tile = first; tile < num_q_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // the tile's Q, dO and stats are in; every warp is done with tile - 1
    const bool prefetch = tile + 1 < num_q_tiles;
    if (prefetch) {
      load_q(tile + 1);  // into tile - 1's buffers, while this tile computes
      cp_async_commit();
      fetch_stats(tile + 1);
    }
    const int q0 = tile * kBQ;
    const int buf = (tile - first) & 1;
    const T* qs = qbuf + buf * (C::kQElems + C::kOElems);
    const T* dos = qs + C::kQElems;
    const float* lse_s = stats + 2 * buf * kBQ;
    const float* d_s = lse_s + kBQ;
    const bool warp_live =
        k0 + wkey < lk && !(causal && k0 + wkey > min(q0 + kBQ, lq) - 1);  // warp-uniform

    float s[kQGroups][4], dp[kQGroups][4];  // Sᵀ then Pᵀ; dPᵀ then dSᵀ
    // bf16: Pᵀ and dSᵀ as pairs of bf16, the only form their products take
    uint32_t pk[kQGroups][2], dsk[kQGroups][2];
#pragma unroll
    for (int j = 0; j < kQGroups; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      pk[j][0] = pk[j][1] = dsk[j][0] = dsk[j][1] = 0u;
    }
    if (warp_live) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys and the tile's rows
      if constexpr (C::kBf16) {
        // the reduction runs over DQK for Sᵀ and over DV for dPᵀ
#pragma unroll
        for (int kk = 0; kk < (DQK > DV ? DQK : DV) / 16; ++kk) {
          const int a_row = wkey + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int a_col = kk * 16 + (lane >> 4) * 8;
          const int b_row = (lane & 7) + (lane >> 4) * 8;
          const int b_col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t ak[4], av[4];
          if (kk < DQK / 16) ldmatrix_x4(ak, ks + a_row * kStride + a_col);
          if (kk < DV / 16) ldmatrix_x4(av, vs + a_row * kVStride + a_col);
#pragma unroll
          for (int j2 = 0; j2 < kQGroups / 2; ++j2) {
            uint32_t bq[4], bo[4];  // b0, b1 of query groups 2·j2 and 2·j2 + 1
            if (kk < DQK / 16) {
              ldmatrix_x4(bq, qs + (j2 * 16 + b_row) * kStride + b_col);
              mma_bf16_16816(s[2 * j2], ak, bq[0], bq[1]);
              mma_bf16_16816(s[2 * j2 + 1], ak, bq[2], bq[3]);
            }
            if (kk < DV / 16) {
              ldmatrix_x4(bo, dos + (j2 * 16 + b_row) * kVStride + b_col);
              mma_bf16_16816(dp[2 * j2], av, bo[0], bo[1]);
              mma_bf16_16816(dp[2 * j2 + 1], av, bo[2], bo[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DQK / 8; ++kk) {
          const int a_off = (wkey + g) * kStride + kk * 8 + t;
          uint32_t akb[4], aks[4], avb[4], avs[4];
          split_tf32(ks[a_off], akb[0], aks[0]);
          split_tf32(ks[a_off + 8 * kStride], akb[1], aks[1]);
          split_tf32(ks[a_off + 4], akb[2], aks[2]);
          split_tf32(ks[a_off + 8 * kStride + 4], akb[3], aks[3]);
          split_tf32(vs[a_off], avb[0], avs[0]);
          split_tf32(vs[a_off + 8 * kStride], avb[1], avs[1]);
          split_tf32(vs[a_off + 4], avb[2], avs[2]);
          split_tf32(vs[a_off + 8 * kStride + 4], avb[3], avs[3]);
#pragma unroll
          for (int j = 0; j < kQGroups; ++j) {
            const int b_off = (j * 8 + g) * kStride + kk * 8 + t;  // B[t][g] = q[row g][d t]
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(qs[b_off], b0b, b0s);
            split_tf32(qs[b_off + 4], b1b, b1s);
            mma_3xtf32(s[j], akb, aks, b0b, b1b, b0s, b1s);
            split_tf32(dos[b_off], b0b, b0s);
            split_tf32(dos[b_off + 4], b1b, b1s);
            mma_3xtf32(dp[j], avb, avs, b0b, b1b, b0s, b1s);
          }
        }
      }

      // Pᵀ and dSᵀ; element e of group j is key key_lo + 8·(e >> 1) and
      // tile row 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < kQGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int row = q0 + col;
          const int r = e >> 1;
          const bool live = key_ok[r] && row < lq && !(causal && key_lo + 8 * r > row);
          const float p = live ? exp2f(fmaf(s[j][e], sl, -lse_s[col])) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - d_s[col]);
        }
        if constexpr (C::kBf16) {
          pk[j][0] = pack_bf16x2(s[j][0], s[j][1]);
          pk[j][1] = pack_bf16x2(s[j][2], s[j][3]);
          dsk[j][0] = pack_bf16x2(dp[j][0], dp[j][1]);
          dsk[j][1] = pack_bf16x2(dp[j][2], dp[j][3]);
        }
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q
      if constexpr (C::kBf16) {
#pragma unroll
        for (int kk = 0; kk < kQGroups / 2; ++kk) {
          const uint32_t ap[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                                  pk[2 * kk + 1][1]};
          const uint32_t ads[4] = {dsk[2 * kk][0], dsk[2 * kk][1], dsk[2 * kk + 1][0],
                                   dsk[2 * kk + 1][1]};
#pragma unroll
          for (int d2 = 0; d2 < (DQK > DV ? DQK : DV) / 16; ++d2) {
            const int b_row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int b_col = d2 * 16 + (lane >> 4) * 8;
            uint32_t bo[4], bq[4];  // b0, b1 of column groups 2·d2 and 2·d2 + 1
            if (d2 < DV / 16) {
              ldmatrix_x4_trans(bo, dos + b_row * kVStride + b_col);
              mma_bf16_16816(dv_acc[2 * d2], ap, bo[0], bo[1]);
              mma_bf16_16816(dv_acc[2 * d2 + 1], ap, bo[2], bo[3]);
            }
            if (d2 < DQK / 16) {
              ldmatrix_x4_trans(bq, qs + b_row * kStride + b_col);
              mma_bf16_16816(dk_acc[2 * d2], ads, bq[0], bq[1]);
              mma_bf16_16816(dk_acc[2 * d2 + 1], ads, bq[2], bq[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kQGroups; ++j) {
          uint32_t apb[4], aps[4], adb[4], ads[4];
          split_c_as_a(s[j], apb, aps);
          split_c_as_a(dp[j], adb, ads);
#pragma unroll
          for (int n = 0; n < kKGroups; ++n) {
            const int b_off = (j * 8 + 2 * t) * kStride + n * 8 + g;  // row 2t, column g
            uint32_t b0b, b0s, b1b, b1s;
            split_rows_2t(dos + b_off, kStride, b0b, b1b, b0s, b1s);
            mma_3xtf32(dv_acc[n], apb, aps, b0b, b1b, b0s, b1s);
            split_rows_2t(qs + b_off, kStride, b0b, b1b, b0s, b1s);
            mma_3xtf32(dk_acc[n], adb, ads, b0b, b1b, b0s, b1s);
          }
        }
      }
    }

    if constexpr (MODE != kDqSeparate) {
      // dSᵀ (zeros for a warp that skipped the tile) to shared memory, rounded
      // to T as the A operand of dS·K; then dQ_tile = dS·K
#pragma unroll
      for (int j = 0; j < kQGroups; ++j) {
        T* p = dss + (wkey + g) * kDsStride + 8 * j + 2 * t;
        if constexpr (C::kBf16) {
          *reinterpret_cast<uint32_t*>(p) = dsk[j][0];
          *reinterpret_cast<uint32_t*>(p + 8 * kDsStride) = dsk[j][1];
        } else {
          store_pair(p, dp[j][0], dp[j][1]);
          store_pair(p + 8 * kDsStride, dp[j][2], dp[j][3]);
        }
      }
      __syncthreads();

      constexpr int kRowGroups = kBQ / 16;
      constexpr int kWarpsPerRows = kWarps / kRowGroups;
      constexpr int kNG = kKGroups / kWarpsPerRows;  // column groups of dQ a warp owns
      static_assert(kWarps % kRowGroups == 0 && kKGroups % kWarpsPerRows == 0, "dq split");
      const int rg = warp / kWarpsPerRows;
      const int n0 = (warp % kWarpsPerRows) * kNG;
      float acc[kNG][4];
#pragma unroll
      for (int n = 0; n < kNG; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      if constexpr (C::kBf16) {
        static_assert(kNG % 2 == 0, "bf16 dq takes column groups in pairs");
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          uint32_t a[4];  // dS [16 rows][16 keys] from dSᵀ
          ldmatrix_x4_trans(a, dss + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kDsStride +
                                   rg * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int n2 = 0; n2 < kNG / 2; ++n2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                      (n0 + 2 * n2) * 8 + (lane >> 4) * 8);
            mma_bf16_16816(acc[2 * n2], a, bk[0], bk[1]);
            mma_bf16_16816(acc[2 * n2 + 1], a, bk[2], bk[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBlockK / 8; ++kk) {
          // A column i is key 2i of the group, column i + 4 key 2i + 1
          const float* dr = dss + (kk * 8 + 2 * t) * kDsStride + rg * 16 + g;
          uint32_t ab[4], as[4];
          split_tf32(dr[0], ab[0], as[0]);
          split_tf32(dr[8], ab[1], as[1]);
          split_tf32(dr[kDsStride], ab[2], as[2]);
          split_tf32(dr[kDsStride + 8], ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < kNG; ++n) {
            uint32_t b0b, b0s, b1b, b1s;
            split_rows_2t(ks + (kk * 8 + 2 * t) * kStride + (n0 + n) * 8 + g, kStride, b0b, b1b,
                          b0s, b1s);
            mma_3xtf32(acc[n], ab, as, b0b, b1b, b0s, b1s);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rg * 16 + g + 8 * r;
        if (row >= lq) continue;
        const size_t off = qoff + static_cast<size_t>(row) * DQK + 2 * t;
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          const int col = (n0 + n) * 8;
          if constexpr (MODE == kDqDirect) {
            store_pair(dq + off + col, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
          } else {  // f32 only
            atomicAdd(reinterpret_cast<float2*>(dq + off + col),
                      make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale));
          }
        }
      }
    }
    if (prefetch) store_stats(tile + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= lk) continue;
    const size_t off = koff + static_cast<size_t>(key) * DQK + 2 * t;
    const size_t v_off = voff + static_cast<size_t>(key) * DV + 2 * t;
#pragma unroll
    for (int n = 0; n < (kKGroups > kVGroups ? kKGroups : kVGroups); ++n) {
      if (n < kKGroups) {
        store_pair(dk + off + n * 8, dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      }
      if (n < kVGroups) store_pair(dv + v_off + n * 8, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// kDqAtomic's first pass (f32): D = rowsum(dO ⊙ o) of every row into drow,
// and dq zeroed; 8 rows a warp, 4 lanes a row
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                      float* __restrict__ drow, float* __restrict__ dq, long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 4;
  const bool valid = row < rows;
  const float d = row_dot<float, DH, 4>(o, dout, static_cast<size_t>(valid ? row : 0) * DH,
                                        valid, threadIdx.x % 4);
  if (!valid) return;
  if (threadIdx.x % 4 == 0) drow[row] = d;
  float* out = dq + static_cast<size_t>(row) * DH + (threadIdx.x % 4) * (DH / 4);
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) out[i] = 0.f;
}

// kDqSeparate's first pass (bf16): dq over query tiles, the mirror of the main
// kernel (and of the forward): one block of 4 warps per (64-row query tile,
// head, batch), a warp owns 16 rows; it loops over 32-key tiles of K and V,
// double-buffered by cp.async, forms S = Q·Kᵀ, dP = dO·Vᵀ, P and dS for its
// rows in registers and accumulates dQ += dS·K, with dS taken from its
// C-fragments as the A operand. It also writes D = rowsum(dO ⊙ o) for the
// main kernel.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, const uint8_t* __restrict__ pad,
                    T* __restrict__ dq, float* __restrict__ drow, int heads, int lq, int lk,
                    int num_q_tiles, int causal, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kBQ = 16 * kWarps;  // query rows per block
  constexpr int kBK = 32;           // keys per tile
  constexpr int kStride = DQK + 16 / sizeof(T);  // shared row of Q and K
  constexpr int kVStride = DV + 16 / sizeof(T);  // shared row of dO and V
  constexpr int kQElems = kBQ * kStride;
  constexpr int kOElems = kBQ * kVStride;
  constexpr int kKElems = kBK * kStride;
  constexpr int kStageElems = kKElems + kBK * kVStride;  // one stage: K, then V
  constexpr int kNGroups = kBK / 8;  // n8 key groups of a score tile
  constexpr int kDGroups = DQK / 8;  // n8 column groups of dQ
  constexpr int kTPR = kThreads / kBQ;
  static_assert(kBf16 || DQK == DV, "f32 takes one head size for q, k and v");

  extern __shared__ __align__(16) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem);  // lse·log2 e [kBQ], then D [kBQ]
  uint8_t* flags = reinterpret_cast<uint8_t*>(stats + 2 * kBQ);  // [2][kBK]: key valid
  T* qs = reinterpret_cast<T*>(flags + 2 * kBK);
  T* dos = qs + kQElems;
  T* kv = dos + kOElems;  // stage s: K, then V

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x % num_q_tiles);
  const int bh = blockIdx.x / num_q_tiles;
  const int b = bh / heads;
  const int q0 = qt * kBQ;
  const size_t qoff = (static_cast<size_t>(bh) * lq + q0) * DQK;  // q, dq
  const size_t ooff = (static_cast<size_t>(bh) * lq + q0) * DV;   // o, dO
  const T* kg = k + static_cast<size_t>(bh) * lk * DQK;
  const T* vg = v + static_cast<size_t>(bh) * lk * DV;

  int num_tiles = (lk + kBK - 1) / kBK;
  if (causal) num_tiles = min(num_tiles, (min(q0 + kBQ, lq) - 1) / kBK + 1);

  auto load_kv = [&](int tile) {
    const int k0 = tile * kBK;
    T* dst = kv + (tile & 1) * kStageElems;
    load_rows<T, DQK, kBK, kStride>(dst, kg + static_cast<size_t>(k0) * DQK, lk - k0, tid);
    load_rows<T, DV, kBK, kVStride>(dst + kKElems, vg + static_cast<size_t>(k0) * DV, lk - k0,
                                    tid);
  };
  auto key_flag = [&](int tile) -> uint8_t {  // threads tid < kBK
    const int key = tile * kBK + tid;
    return key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
  };

  load_rows<T, DQK, kBQ, kStride>(qs, q + qoff, lq - q0, tid);
  load_rows<T, DV, kBQ, kVStride>(dos, dout + ooff, lq - q0, tid);
  if (num_tiles > 0) {
    load_kv(0);
    if (tid < kBK) flags[tid] = key_flag(0);
  }
  cp_async_commit();
  {
    const int r = tid / kTPR;
    const int row = q0 + r;
    const float d = row_dot<T, DV, kTPR>(o, dout, ooff + static_cast<size_t>(r) * DV, row < lq,
                                         tid % kTPR);
    if (tid % kTPR == 0) {
      stats[kBQ + r] = d;
      if (row < lq) drow[static_cast<size_t>(bh) * lq + row] = d;
    }
    if (tid < kBQ) {
      stats[tid] = q0 + tid < lq ? lse[static_cast<size_t>(bh) * lq + q0 + tid] * kLog2e : 0.f;
    }
  }
  __syncthreads();

  const int wrow = warp * 16;        // the warp's first row in the tile
  const int row_lo = q0 + wrow + g;  // this lane's rows: row_lo, row_lo + 8
  const int warp_last = min(q0 + wrow + 15, lq - 1);
  const bool warp_live = q0 + wrow < lq;
  const float lse_r[2] = {stats[wrow + g], stats[wrow + g + 8]};
  const float d_r[2] = {stats[kBQ + wrow + g], stats[kBQ + wrow + g + 8]};
  const float sl = scale * kLog2e;

  float acc[kDGroups][4];
#pragma unroll
  for (int n = 0; n < kDGroups; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // tile's K/V and flags are in; every warp is done with tile - 1
    const bool prefetch = tile + 1 < num_tiles;
    uint8_t next_flag = 0;
    if (prefetch) {
      load_kv(tile + 1);
      cp_async_commit();
      if (tid < kBK) next_flag = key_flag(tile + 1);
    }
    const int k0 = tile * kBK;
    if (warp_live && !(causal && k0 > warp_last)) {  // warp-uniform
      const int buf = tile & 1;
      const T* ks = kv + buf * kStageElems;
      const T* vs = ks + kKElems;
      const uint8_t* fl = flags + buf * kBK;

      // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 rows and the tile's keys
      float s[kNGroups][4], dp[kNGroups][4];
#pragma unroll
      for (int j = 0; j < kNGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      if constexpr (kBf16) {
        // the reduction runs over DQK for S and over DV for dP
#pragma unroll
        for (int kk = 0; kk < (DQK > DV ? DQK : DV) / 16; ++kk) {
          const int a_row = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int a_col = kk * 16 + (lane >> 4) * 8;
          const int b_row = (lane & 7) + (lane >> 4) * 8;
          const int b_col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t aq[4], ao[4];
          if (kk < DQK / 16) ldmatrix_x4(aq, qs + a_row * kStride + a_col);
          if (kk < DV / 16) ldmatrix_x4(ao, dos + a_row * kVStride + a_col);
#pragma unroll
          for (int j2 = 0; j2 < kNGroups / 2; ++j2) {
            uint32_t bk[4], bv[4];
            if (kk < DQK / 16) {
              ldmatrix_x4(bk, ks + (j2 * 16 + b_row) * kStride + b_col);
              mma_bf16_16816(s[2 * j2], aq, bk[0], bk[1]);
              mma_bf16_16816(s[2 * j2 + 1], aq, bk[2], bk[3]);
            }
            if (kk < DV / 16) {
              ldmatrix_x4(bv, vs + (j2 * 16 + b_row) * kVStride + b_col);
              mma_bf16_16816(dp[2 * j2], ao, bv[0], bv[1]);
              mma_bf16_16816(dp[2 * j2 + 1], ao, bv[2], bv[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DQK / 8; ++kk) {
          const int a_off = (wrow + g) * kStride + kk * 8 + t;
          uint32_t aqb[4], aqs[4], aob[4], aos[4];
          split_tf32(qs[a_off], aqb[0], aqs[0]);
          split_tf32(qs[a_off + 8 * kStride], aqb[1], aqs[1]);
          split_tf32(qs[a_off + 4], aqb[2], aqs[2]);
          split_tf32(qs[a_off + 8 * kStride + 4], aqb[3], aqs[3]);
          split_tf32(dos[a_off], aob[0], aos[0]);
          split_tf32(dos[a_off + 8 * kStride], aob[1], aos[1]);
          split_tf32(dos[a_off + 4], aob[2], aos[2]);
          split_tf32(dos[a_off + 8 * kStride + 4], aob[3], aos[3]);
#pragma unroll
          for (int j = 0; j < kNGroups; ++j) {
            const int b_off = (j * 8 + g) * kStride + kk * 8 + t;  // B[t][g] = k[key g][d t]
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(ks[b_off], b0b, b0s);
            split_tf32(ks[b_off + 4], b1b, b1s);
            mma_3xtf32(s[j], aqb, aqs, b0b, b1b, b0s, b1s);
            split_tf32(vs[b_off], b0b, b0s);
            split_tf32(vs[b_off + 4], b1b, b1s);
            mma_3xtf32(dp[j], aob, aos, b0b, b1b, b0s, b1s);
          }
        }
      }

      // P and dS; element e of group j is key k0 + 8j + 2t + (e & 1) of row
      // row_lo + 8·(e >> 1)
#pragma unroll
      for (int j = 0; j < kNGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool live =
              fl[key] && row_lo + 8 * r < lq && !(causal && k0 + key > row_lo + 8 * r);
          const float p = live ? exp2f(fmaf(s[j][e], sl, -lse_r[r])) : 0.f;
          dp[j][e] = p * (dp[j][e] - d_r[r]);
        }
      }

      // dQ += dS·K
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kNGroups / 2; ++kk) {
          const uint32_t a[4] = {pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]),
                                 pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
                                 pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                 pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int d2 = 0; d2 < DQK / 16; ++d2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                      d2 * 16 + (lane >> 4) * 8);
            mma_bf16_16816(acc[2 * d2], a, bk[0], bk[1]);
            mma_bf16_16816(acc[2 * d2 + 1], a, bk[2], bk[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNGroups; ++j) {
          uint32_t ab[4], as[4];
          split_c_as_a(dp[j], ab, as);
#pragma unroll
          for (int n = 0; n < kDGroups; ++n) {
            uint32_t b0b, b0s, b1b, b1s;
            split_rows_2t(ks + (j * 8 + 2 * t) * kStride + n * 8 + g, kStride, b0b, b1b, b0s,
                          b1s);
            mma_3xtf32(acc[n], ab, as, b0b, b1b, b0s, b1s);
          }
        }
      }
    }
    if (prefetch && tid < kBK) flags[((tile + 1) & 1) * kBK + tid] = next_flag;
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= lq) continue;
    T* out = dq + (static_cast<size_t>(bh) * lq + row) * DQK + 2 * t;
#pragma unroll
    for (int n = 0; n < kDGroups; ++n) {
      store_pair(out + n * 8, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first; a
// launch that asks for more without it is refused and never runs.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q_, const void* k_, const void* v_, const void* o_,
                   const void* dout_, const float* lse, const void* pad_, void* dq_, void* dk_,
                   void* dv_, float* scratch, int batch, int heads, int lq, int lk, int causal,
                   float scale, cudaStream_t stream, int* launched) {
  using C = Cfg<T, DQK, DV>;
  const long long bh = static_cast<long long>(batch) * heads;
  if (bh == 0) return cudaSuccess;
  if (lq == 0 || lk == 0) {  // no rows, or no keys (every row fully masked): zeros
    const size_t q_bytes = static_cast<size_t>(bh) * lq * DQK * sizeof(T);
    const size_t k_bytes = static_cast<size_t>(bh) * lk * DQK * sizeof(T);
    const size_t v_bytes = static_cast<size_t>(bh) * lk * DV * sizeof(T);
    cudaError_t err = cudaMemsetAsync(dq_, 0, q_bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk_, 0, k_bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv_, 0, v_bytes, stream);
    return err;
  }
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* o = static_cast<const T*>(o_);
  const T* dout = static_cast<const T*>(dout_);
  const uint8_t* pad = static_cast<const uint8_t*>(pad_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);

  const int num_k_tiles = (lk + kBlockK - 1) / kBlockK;
  const int num_q_tiles = (lq + C::kBlockQ - 1) / C::kBlockQ;
  const long long blocks = bh * num_k_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = C::smem_bytes(num_q_tiles > 1 ? 2 : 1);
  cudaError_t err;
  if (num_k_tiles == 1) {
    auto kernel = flash_bwd_kernel<T, DQK, DV, kDqDirect>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        q, k, v, o, dout, lse, nullptr, pad, dq, dk, dv, heads, lq, lk, num_k_tiles, causal,
        scale);
    ++*launched;
    return cudaGetLastError();
  }

  float* drow = scratch;  // [B,H,Lq]
  if (drow == nullptr) return cudaErrorInvalidValue;
  if constexpr (!C::kBf16) {
    const long long rows = bh * lq;
    const long long prep_blocks = (rows * 4 + kThreads - 1) / kThreads;
    if (prep_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    static_assert(DQK == DV, "f32 takes one head size for q, k and v");
    auto prep = flash_bwd_prep_kernel<DQK>;
    prep<<<static_cast<unsigned>(prep_blocks), kThreads, 0, stream>>>(o, dout, drow, dq, rows);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto kernel = flash_bwd_kernel<T, DQK, DV, kDqAtomic>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        q, k, v, o, dout, lse, drow, pad, dq, dk, dv, heads, lq, lk, num_k_tiles, causal, scale);
    ++*launched;
    return cudaGetLastError();
  } else {
    constexpr int kDqBQ = 16 * kWarps, kDqBK = 32;
    constexpr int kDqStride = DQK + 16 / sizeof(T), kDqVStride = DV + 16 / sizeof(T);
    const int dq_tiles = (lq + kDqBQ - 1) / kDqBQ;
    const long long dq_blocks = bh * dq_tiles;
    if (dq_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    // lse and D, the key flags of two stages, Q, dO, then two stages of (K, V)
    const size_t dq_smem = 2 * kDqBQ * sizeof(float) + 2 * kDqBK +
                           (kDqBQ + 2 * kDqBK) * (kDqStride + kDqVStride) * sizeof(T);
    auto dq_kernel = flash_bwd_dq_kernel<T, DQK, DV>;
    if ((err = allow_smem(dq_kernel, dq_smem)) != cudaSuccess) return err;
    dq_kernel<<<static_cast<unsigned>(dq_blocks), kThreads, dq_smem, stream>>>(
        q, k, v, o, dout, lse, pad, dq, drow, heads, lq, lk, dq_tiles, causal, scale);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto kernel = flash_bwd_kernel<T, DQK, DV, kDqSeparate>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        q, k, v, o, dout, lse, drow, pad, nullptr, dk, dv, heads, lq, lk, num_k_tiles, causal,
        scale);
    ++*launched;
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_dim(int dqk, int dv, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse, const void* pad,
                         void* dq, void* dk, void* dv_, float* scratch, int batch, int heads,
                         int lq, int lk, int causal, float scale, cudaStream_t stream,
                         int* launched) {
  if (dqk == dv) {
    switch (dqk) {
      case 16:
        return launch<T, 16, 16>(q, k, v, o, dout, lse, pad, dq, dk, dv_, scratch, batch, heads,
                                 lq, lk, causal, scale, stream, launched);
      case 32:
        return launch<T, 32, 32>(q, k, v, o, dout, lse, pad, dq, dk, dv_, scratch, batch, heads,
                                 lq, lk, causal, scale, stream, launched);
      case 64:
        return launch<T, 64, 64>(q, k, v, o, dout, lse, pad, dq, dk, dv_, scratch, batch, heads,
                                 lq, lk, causal, scale, stream, launched);
      case 128:
        return launch<T, 128, 128>(q, k, v, o, dout, lse, pad, dq, dk, dv_, scratch, batch,
                                   heads, lq, lk, causal, scale, stream, launched);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if constexpr (sizeof(T) == 2) {  // MLA: q·kᵀ at 192 (128 + a 64-wide rope part), p·v at 128
    if (dqk == 192 && dv == 128) {
      return launch<T, 192, 128>(q, k, v, o, dout, lse, pad, dq, dk, dv_, scratch, batch, heads,
                                 lq, lk, causal, scale, stream, launched);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q/dq [B,H,Lq,Dqk], o/dout [B,H,Lq,Dv], k/dk [B,H,Lk,Dqk], v/dv [B,H,Lk,Dv],
// all contiguous and 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1); Dqk = Dv in {16, 32, 64, 128}, or (bf16 only) Dqk 192 and Dv 128; lse
// [B,H,Lq] f32 from the forward; key_padding_mask [B,Lk] bytes (nonzero =
// pad) or null; scratch [B,H,Lq] f32, which holds D when Lk > 64 (untouched,
// and may be null, otherwise); `scale` as the forward took it. Launches the
// kernels on `stream` without synchronising and returns how many kernels of
// this library it launched (0 when there is nothing to compute), or minus
// the first launch error (cudaError_t).
extern "C" int dr4sr_flash_attention_bwd_scaled(const void* q, const void* k, const void* v,
                                                const void* o, const void* dout, const void* lse,
                                                const void* key_padding_mask, void* dq, void* dk,
                                                void* dv, void* scratch, int batch, int heads,
                                                int lq, int lk, int head_dim_qk, int head_dim_v,
                                                float scale, int causal, int is_bf16,
                                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* scratch_f = static_cast<float*>(scratch);
  int launched = 0;
  const cudaError_t err =
      is_bf16 ? dispatch_dim<__nv_bfloat16>(head_dim_qk, head_dim_v, q, k, v, o, dout, lse_f,
                                             key_padding_mask, dq, dk, dv, scratch_f, batch,
                                             heads, lq, lk, causal, scale, s, &launched)
              : dispatch_dim<float>(head_dim_qk, head_dim_v, q, k, v, o, dout, lse_f,
                                    key_padding_mask, dq, dk, dv, scratch_f, batch, heads, lq, lk,
                                    causal, scale, s, &launched);
  return err == cudaSuccess ? launched : -static_cast<int>(err);
}

// The same for one head size Dh of q, k and v and the scale 1/√Dh, computed
// as the reference does: in double, rounded once to f32.
extern "C" int dr4sr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         const void* key_padding_mask, void* dq, void* dk,
                                         void* dv, void* scratch, int batch, int heads, int lq,
                                         int lk, int head_dim, int causal, int is_bf16,
                                         void* stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  return dr4sr_flash_attention_bwd_scaled(q, k, v, o, dout, lse, key_padding_mask, dq, dk, dv,
                                          scratch, batch, heads, lq, lk, head_dim, head_dim,
                                          scale, causal, is_bf16, stream);
}
