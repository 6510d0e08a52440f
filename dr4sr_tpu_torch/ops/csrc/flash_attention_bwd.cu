// Flash-attention backward for Hopper (sm_90a), with a plain C entry point
// that dr4sr_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces the Pallas TPU kernel dr4sr_tpu/ops/attention.py::_flash_bwd_kernel.
// Given q [B,H,Lq,Dh], k/v [B,H,Lk,Dh], the forward's output o and the
// incoming gradient dO [B,H,Lq,Dh], a key-padding mask [B,Lk] (nonzero =
// pad) and the forward's row log-sum-exp lse [B,H,Lq], it computes
//
//     p  = softmax(q·kᵀ·scale, padded keys and (if causal) col > row masked)
//     dv = pᵀ·dO
//     ds = p ⊙ (dO·vᵀ − rowsum(dO ⊙ o))
//     dq = ds·k·scale,   dk = dsᵀ·q·scale
//
// with the TPU kernel's semantics: p = exp(s − lse) over the full masked key
// row, and masked entries are forced to 0 after the exp (a fully masked row
// has lse = +inf here and contributes nothing). Causal masks key column >
// query row with no offset, also when Lq != Lk. f32 inputs use all-f32 math;
// bf16 inputs keep bf16 operand values (exact in f32), round p and ds to
// bf16 before their products, and accumulate in f32. rowsum(dO ⊙ o) is f32.
// The gradients accumulate in f32 and are written in the input dtype.
//
// Design. The TPU kernel walks a (batch, head) grid in order with Q, K, V,
// O and dO resident in VMEM. Here blocks run in parallel and carry nothing,
// so the work is split FA2-style into two kernels on one stream:
//   1. dq: one block of 4 warps per (query tile, head, batch). It computes
//      D = rowsum(dO ⊙ o) for its rows (written to a scratch [B,H,Lq] for
//      kernel 2), then loops over key tiles staged in shared memory,
//      forming p and ds for the (query tile, key tile) pair in shared
//      memory and accumulating dq in registers. A causal block stops at the
//      key tile holding its last row.
//   2. dk/dv: one block per (key tile, head, batch). K and V stay in shared
//      memory; the block loops over query tiles, starting (when causal) at
//      the first tile that can see its keys, and accumulates dk and dv in
//      registers.
// dq by a second kernel parallel over query tiles instead of f32 atomics:
// the result is deterministic and needs no zeroed f32 buffer and no cast
// pass, at the price of recomputing q·kᵀ and dO·vᵀ once more.
// Keys past Lk and rows past Lq are zeros in shared memory (0·garbage can be
// NaN) and their p is forced to 0. Each thread owns a fixed column d of the
// [tile][Dh] accumulators, so its dO/q (or K) reads in the accumulation loop
// are conflict-free and its p/ds reads are broadcasts. The K and V tiles'
// rows are padded by one float, so lanes scoring different keys hit
// different banks. Tiles are sized so that a thread owns at most 32 entries
// of each accumulator (Dh=128 uses 32-row / 32-key tiles).
//
// What bounds it on an H100: it must read q, k, v, o, dO, lse and the mask
// and write dq, dk, dv once (at the training shape B256 H2 L50 Dh32 in f32,
// about 26 MB, ~7.8 µs at 3.35 TB/s), or do 10·Dh FLOP per unmasked
// (query, key) pair and head for its five products; the bytes are the
// larger there, the FLOP at long sequences. What the design does about it:
// every input is read once per block that needs it and nothing of size
// [L, L] goes to device memory, so the bytes stay near the minimum; the
// FLOP run as f32 FMAs on CUDA cores (14·Dh per pair, with the
// recomputation), so at long sequences it is far from the bf16 tensor-core
// peak, and at L=50 one wave of 512 small blocks with serial FMA chains and
// barriers sets the time, not the bytes (PERF.md has the measurements).
// This is the simple, correct first kernel; mma.sync/wgmma and TMA come
// later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;  // query rows per register block when scoring
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Copies rows [r0, r0 + ROWS) of a [rows_total][DH] matrix into shared
// memory as f32 with row stride STRIDE; rows past rows_total are zeros.
template <typename T, int DH, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int r0,
                                          int rows_total) {
  for (int e = threadIdx.x; e < ROWS * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    float x = 0.f;
    if (r0 + r < rows_total) x = to_f32(src[static_cast<size_t>(r0) * DH + e]);
    dst[r * STRIDE + d] = x;
  }
}

// For ROWS query rows (qs, dos: [ROWS][DH]; lse_s, d_s: [ROWS]; first row
// q0) against KEYS keys (ks, vs: [KEYS][DH + 1]; valid: [KEYS]; first key
// k0), writes p to ps and ds to dss, both [ROWS][KEYS] (ps only if WRITE_P).
// Warps own ROWS / kWarps rows each, lanes own KEYS / 32 keys each.
template <bool BF16, bool WRITE_P, int DH, int ROWS, int KEYS>
__device__ __forceinline__ void probs_and_dscores(const float* qs, const float* dos,
                                                  const float* ks, const float* vs,
                                                  const float* lse_s, const float* d_s,
                                                  const int* valid, float* ps, float* dss,
                                                  int q0, int k0, int lq, int causal,
                                                  float scale) {
  constexpr int kKeysPerLane = KEYS / 32;
  constexpr int kRowsPerWarp = ROWS / kWarps;
  constexpr int kKStride = DH + 1;
  static_assert(KEYS % 32 == 0 && kRowsPerWarp % kChunk == 0, "tile shape");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

#pragma unroll 1
  for (int c = 0; c < kRowsPerWarp; c += kChunk) {
    const int rbase = warp * kRowsPerWarp + c;
    float s[kChunk][kKeysPerLane], dp[kChunk][kKeysPerLane];
#pragma unroll
    for (int rr = 0; rr < kChunk; ++rr) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        s[rr][j] = 0.f;
        dp[rr][j] = 0.f;
      }
    }
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float kd[kKeysPerLane], vd[kKeysPerLane];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        kd[j] = ks[(lane + 32 * j) * kKStride + d];
        vd[j] = vs[(lane + 32 * j) * kKStride + d];
      }
#pragma unroll
      for (int rr = 0; rr < kChunk; ++rr) {
        const float qd = qs[(rbase + rr) * DH + d];
        const float od = dos[(rbase + rr) * DH + d];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          s[rr][j] = fmaf(qd, kd[j], s[rr][j]);
          dp[rr][j] = fmaf(od, vd[j], dp[rr][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kChunk; ++rr) {
      const int r = rbase + rr;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int kl = lane + 32 * j;
        const int key = k0 + kl;
        const bool live = row < lq && valid[kl] && !(causal && key > row);
        // masked entries are 0 by select, as the TPU kernel forces them (:270)
        float p = live ? expf(s[rr][j] * scale - lse_s[r]) : 0.f;
        float ds = p * (dp[rr][j] - d_s[r]);
        if (BF16) {
          p = round_bf16(p);
          ds = round_bf16(ds);
        }
        if (WRITE_P) ps[r * KEYS + kl] = p;
        dss[r * KEYS + kl] = ds;
      }
    }
  }
}

// Kernel 1: dq, and D = rowsum(dO ⊙ o) into drow for kernel 2.
template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, const uint8_t* __restrict__ pad,
                    T* __restrict__ dq, float* __restrict__ drow, int heads, int lq, int lk,
                    int num_q_tiles, int causal, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKStride = DH + 1;
  constexpr int kPerThread = BQ * DH / kThreads;  // dq entries a thread owns
  constexpr int kRowStep = kThreads / DH;         // row stride between them
  static_assert(kThreads % DH == 0 && kPerThread >= 1, "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][DH]
  float* dos = qs + BQ * DH;               // [BQ][DH]
  float* ks = dos + BQ * DH;               // [BK][DH + 1]
  float* vs = ks + BK * kKStride;          // [BK][DH + 1]
  float* dss = vs + BK * kKStride;         // [BQ][BK]
  float* lse_s = dss + BQ * BK;            // [BQ]
  float* d_s = lse_s + BQ;                 // [BQ]
  int* valid = reinterpret_cast<int*>(d_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qt = blockIdx.x % num_q_tiles;
  const int bh = blockIdx.x / num_q_tiles;
  const int b = bh / heads;
  const int q0 = qt * BQ;
  const size_t q_base = static_cast<size_t>(bh) * lq * DH;
  const size_t k_base = static_cast<size_t>(bh) * lk * DH;
  const size_t row_base = static_cast<size_t>(bh) * lq;

  load_tile<T, DH, BQ, DH>(q + q_base, qs, q0, lq);
  load_tile<T, DH, BQ, DH>(dout + q_base, dos, q0, lq);
  // D = rowsum(dO ⊙ o) in f32: each warp takes rows, lanes stride over Dh
  for (int r = warp; r < BQ; r += kWarps) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < lq) {
      const size_t off = q_base + static_cast<size_t>(row) * DH;
      for (int d = lane; d < DH; d += 32) acc = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = row < lq ? lse[row_base + row] : 0.f;
      if (row < lq) drow[row_base + row] = acc;
    }
  }

  int num_tiles = (lk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, lq) - 1;
    num_tiles = min(num_tiles, last_row / BK + 1);
  }

  const int d = tid % DH;
  const int i0 = tid / DH;
  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    load_tile<T, DH, BK, kKStride>(k + k_base, ks, k0, lk);
    load_tile<T, DH, BK, kKStride>(v + k_base, vs, k0, lk);
    if (tid < BK) {
      const int key = k0 + tid;
      valid[tid] = key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
    }
    __syncthreads();
    probs_and_dscores<kBf16, false, DH, BQ, BK>(qs, dos, ks, vs, lse_s, d_s, valid, nullptr,
                                                 dss, q0, k0, lq, causal, scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float kd = ks[j * kKStride + d];
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        acc[e] = fmaf(dss[(i0 + e * kRowStep) * BK + j], kd, acc[e]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int row = q0 + i0 + e * kRowStep;
    if (row < lq) dq[q_base + static_cast<size_t>(row) * DH + d] = from_f32<T>(acc[e] * scale);
  }
}

// Kernel 2: dk and dv; reads D from kernel 1.
template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ drow,
                      const uint8_t* __restrict__ pad, T* __restrict__ dk, T* __restrict__ dv,
                      int heads, int lq, int lk, int num_k_tiles, int causal, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKStride = DH + 1;
  constexpr int kPerThread = BK * DH / kThreads;  // dk (and dv) entries a thread owns
  constexpr int kKeyStep = kThreads / DH;         // key stride between them
  static_assert(kThreads % DH == 0 && kPerThread >= 1, "tile shape");

  extern __shared__ float smem[];
  float* ks = smem;                        // [BK][DH + 1]
  float* vs = ks + BK * kKStride;          // [BK][DH + 1]
  float* qs = vs + BK * kKStride;          // [BQ][DH]
  float* dos = qs + BQ * DH;               // [BQ][DH]
  float* ps = dos + BQ * DH;               // [BQ][BK]
  float* dss = ps + BQ * BK;               // [BQ][BK]
  float* lse_s = dss + BQ * BK;            // [BQ]
  float* d_s = lse_s + BQ;                 // [BQ]
  int* valid = reinterpret_cast<int*>(d_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int kt = blockIdx.x % num_k_tiles;
  const int bh = blockIdx.x / num_k_tiles;
  const int b = bh / heads;
  const int k0 = kt * BK;
  const size_t q_base = static_cast<size_t>(bh) * lq * DH;
  const size_t k_base = static_cast<size_t>(bh) * lk * DH;
  const size_t row_base = static_cast<size_t>(bh) * lq;

  load_tile<T, DH, BK, kKStride>(k + k_base, ks, k0, lk);
  load_tile<T, DH, BK, kKStride>(v + k_base, vs, k0, lk);
  if (tid < BK) {
    const int key = k0 + tid;
    valid[tid] = key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
  }

  const int d = tid % DH;
  const int j0 = tid / DH;
  float dk_acc[kPerThread], dv_acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  const int num_q_tiles = (lq + BQ - 1) / BQ;
  // causal: rows before k0 see none of this tile's keys
  const int first = causal ? k0 / BQ : 0;
  for (int t = first; t < num_q_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile is consumed (and the K/V tile written)
    load_tile<T, DH, BQ, DH>(q + q_base, qs, q0, lq);
    load_tile<T, DH, BQ, DH>(dout + q_base, dos, q0, lq);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < lq ? lse[row_base + row] : 0.f;
      d_s[tid] = row < lq ? drow[row_base + row] : 0.f;
    }
    __syncthreads();
    probs_and_dscores<kBf16, true, DH, BQ, BK>(qs, dos, ks, vs, lse_s, d_s, valid, ps, dss,
                                                q0, k0, lq, causal, scale);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float od = dos[i * DH + d];
      const float qd = qs[i * DH + d];
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        const int j = j0 + e * kKeyStep;
        dv_acc[e] = fmaf(ps[i * BK + j], od, dv_acc[e]);
        dk_acc[e] = fmaf(dss[i * BK + j], qd, dk_acc[e]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int key = k0 + j0 + e * kKeyStep;
    if (key < lk) {
      const size_t off = k_base + static_cast<size_t>(key) * DH + d;
      dk[off] = from_f32<T>(dk_acc[e] * scale);
      dv[off] = from_f32<T>(dv_acc[e]);
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

template <typename T, int DH>
cudaError_t launch(const void* q_, const void* k_, const void* v_, const void* o_,
                   const void* dout_, const float* lse, const void* pad_, void* dq_, void* dk_,
                   void* dv_, float* drow, int batch, int heads, int lq, int lk, int causal,
                   float scale, cudaStream_t stream) {
  // Dh = 128 halves the tiles so a thread owns at most 32 accumulator entries
  constexpr int kBQ1 = DH >= 128 ? 32 : 64;  // dq kernel: query rows per block
  constexpr int kBK1 = 32;                   // dq kernel: keys per tile
  constexpr int kBQ2 = 32;                   // dk/dv kernel: query rows per tile
  constexpr int kBK2 = DH >= 128 ? 32 : 64;  // dk/dv kernel: keys per block
  const long long bh = static_cast<long long>(batch) * heads;
  if (bh == 0 || lq == 0) return cudaSuccess;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  const uint8_t* pad = static_cast<const uint8_t*>(pad_);

  const int num_q_tiles = (lq + kBQ1 - 1) / kBQ1;
  const long long blocks1 = bh * num_q_tiles;
  if (blocks1 > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem1 = (2 * kBQ1 * DH + 2 * kBK1 * (DH + 1) + kBQ1 * kBK1 + 2 * kBQ1) *
                           sizeof(float) + kBK1 * sizeof(int);
  auto dq_kernel = flash_bwd_dq_kernel<T, DH, kBQ1, kBK1>;
  cudaError_t err = allow_smem(dq_kernel, smem1);
  if (err != cudaSuccess) return err;
  dq_kernel<<<static_cast<unsigned>(blocks1), kThreads, smem1, stream>>>(
      q, k, v, static_cast<const T*>(o_), dout, lse, pad, static_cast<T*>(dq_), drow, heads, lq,
      lk, num_q_tiles, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || lk == 0) return err;

  const int num_k_tiles = (lk + kBK2 - 1) / kBK2;
  const long long blocks2 = bh * num_k_tiles;
  if (blocks2 > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem2 = (2 * kBK2 * (DH + 1) + 2 * kBQ2 * DH + 2 * kBQ2 * kBK2 + 2 * kBQ2) *
                           sizeof(float) + kBK2 * sizeof(int);
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DH, kBQ2, kBK2>;
  err = allow_smem(dkdv_kernel, smem2);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<static_cast<unsigned>(blocks2), kThreads, smem2, stream>>>(
      q, k, v, dout, lse, drow, pad, static_cast<T*>(dk_), static_cast<T*>(dv_), heads, lq, lk,
      num_k_tiles, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse, const void* pad,
                         void* dq, void* dk, void* dv, float* drow, int batch, int heads, int lq,
                         int lk, int causal, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, pad, dq, dk, dv, drow, batch, heads, lq, lk,
                           causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, pad, dq, dk, dv, drow, batch, heads, lq, lk,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, pad, dq, dk, dv, drow, batch, heads, lq, lk,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, pad, dq, dk, dv, drow, batch, heads, lq, lk,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o/dout/dq [B,H,Lq,Dh], k/v/dk/dv [B,H,Lk,Dh], all contiguous, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); lse [B,H,Lq] f32 from the forward;
// key_padding_mask [B,Lk] bytes (nonzero = pad) or null; drow [B,H,Lq] f32
// scratch. Launches two kernels (dq, then dk/dv) on `stream`, does not
// synchronise, and returns the first launch error (cudaError_t), or 0.
extern "C" int dr4sr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         const void* key_padding_mask, void* dq, void* dk,
                                         void* dv, void* drow, int batch, int heads, int lq,
                                         int lk, int head_dim, int causal, int is_bf16,
                                         void* stream) {
  // the reference computes 1/√Dh in double and rounds it once to f32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* drow_f = static_cast<float*>(drow);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, dout, lse_f, key_padding_mask, dq,
                                       dk, dv, drow_f, batch, heads, lq, lk, causal, scale, s);
  }
  return dispatch_dim<float>(head_dim, q, k, v, o, dout, lse_f, key_padding_mask, dq, dk, dv,
                             drow_f, batch, heads, lq, lk, causal, scale, s);
}
