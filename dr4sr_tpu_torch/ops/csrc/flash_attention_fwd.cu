// Flash-attention forward for Hopper (sm_90a), with a plain C entry point
// that dr4sr_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces the Pallas TPU kernel dr4sr_tpu/ops/attention.py::_flash_kernel.
// Computes, for q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] and a key-padding mask
// [B,Lk] (nonzero = pad):
//
//     o = softmax(q·kᵀ/√Dh, padded keys and (if causal) col > row masked)·v
//
// with the TPU kernel's semantics: masked scores are -1e30, the softmax is
// an online one over key tiles (running max m, rescale α, denominator l),
// and the output is acc / max(l, 1e-30), so a fully masked row gives 0.
// f32 inputs use all-f32 math with q pre-scaled; bf16 inputs keep bf16
// operand values (exact in f32), accumulate in f32, scale the f32 scores,
// round p to bf16 before p·v and write bf16.
//
// Design. The TPU kernel keeps a (batch, head)'s whole K/V resident in VMEM
// and walks its grid in order. Here blocks run in parallel and carry
// nothing: one block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 query rows. Key tiles of 64 rows are staged in shared memory as
// f32 (the K rows padded by one float so lanes reading k[lane][d] hit
// distinct banks). Each lane scores two keys of the tile; max and sum go
// through warp shuffles; the per-row state (m, l, acc[Dh] spread over the
// lanes) stays in registers across tiles. A causal block stops at the key
// tile holding its last row, and a row skips tiles wholly above it.
//
// What bounds it on an H100: at the serving shape (B256 H2 L50 Dh32) the
// bytes of q, k, v and o (~13 MB, ~4 µs at 3.35 TB/s) and the launch; at
// long sequences the f32 FMAs on CUDA cores. No tensor cores yet: this is
// the simple, correct first kernel; wgmma/TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ pad, T* __restrict__ o, int heads, int lq,
                 int lk, int num_q_tiles, int causal, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKStride = DH + 1;              // padded K row (bank-conflict free)
  constexpr int kDimsPerLane = DH >= 32 ? DH / 32 : 1;

  extern __shared__ float smem[];
  float* qs = smem;                             // [kBlockQ][DH]
  float* ks = qs + kBlockQ * DH;                // [kBlockK][kKStride]
  float* vs = ks + kBlockK * kKStride;          // [kBlockK][DH]
  int* valid = reinterpret_cast<int*>(vs + kBlockK * DH);  // [kBlockK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qt = blockIdx.x % num_q_tiles;
  const int bh = blockIdx.x / num_q_tiles;
  const int b = bh / heads;
  const int q0 = qt * kBlockQ;
  const size_t q_base = static_cast<size_t>(bh) * lq * DH;
  const size_t k_base = static_cast<size_t>(bh) * lk * DH;
  // for Dh < 32 the upper lanes mirror the lower ones and do not write
  const int d_lane = DH >= 32 ? lane : (lane % DH);

  for (int e = tid; e < kBlockQ * DH; e += kWarps * 32) {
    const int r = e / DH;
    float x = 0.f;
    if (q0 + r < lq) x = to_f32(q[q_base + static_cast<size_t>(q0) * DH + e]);
    qs[e] = kBf16 ? x : x * scale;
  }

  int num_tiles = (lk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, lq) - 1;
    num_tiles = min(num_tiles, last_row / kBlockK + 1);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] = 0.f;
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    for (int e = tid; e < kBlockK * DH; e += kWarps * 32) {
      const int r = e / DH;
      const int d = e % DH;
      float kx = 0.f, vx = 0.f;  // zeros past Lk: p is 0 there, and 0·v must stay finite
      if (k0 + r < lk) {
        const size_t off = k_base + static_cast<size_t>(k0) * DH + e;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * kKStride + d] = kx;
      vs[e] = vx;
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      valid[tid] = key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = q0 + r;
      if (row >= lq) break;                 // warp-uniform
      if (causal && k0 > row) continue;     // tile wholly above this row's diagonal

      const float* qr = qs + r * DH;
      const float* ka = ks + lane * kKStride;
      const float* kb = ks + (lane + 32) * kKStride;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float qd = qr[d];
        s0 = fmaf(qd, ka[d], s0);
        s1 = fmaf(qd, kb[d], s1);
      }
      if (kBf16) {
        s0 *= scale;
        s1 *= scale;
      }
      const bool inv0 = !valid[lane] || (causal && k0 + lane > row);
      const bool inv1 = !valid[lane + 32] || (causal && k0 + lane + 32 > row);
      s0 = inv0 ? kNegInf : s0;
      s1 = inv1 ? kNegInf : s1;

      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[rr] - m_new);
      float p0 = inv0 ? 0.f : expf(s0 - m_new);
      float p1 = inv1 ? 0.f : expf(s1 - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
      if (kBf16) {
        p0 = __bfloat162float(__float2bfloat16(p0));
        p1 = __bfloat162float(__float2bfloat16(p1));
      }

#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pa = __shfl_sync(kFull, p0, j);
        const float pb = __shfl_sync(kFull, p1, j);
        const float* va = vs + j * DH;
        const float* vb = vs + (j + 32) * DH;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = d_lane + 32 * i;
          acc[rr][i] = fmaf(pb, vb[d], fmaf(pa, va[d], acc[rr][i]));
        }
      }
    }
  }

  if (DH < 32 && lane >= DH) return;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= lq) break;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + q_base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) orow[d_lane + 32 * i] = from_f32<T>(acc[rr][i] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad, void* o,
                   int batch, int heads, int lq, int lk, int causal, float scale,
                   cudaStream_t stream) {
  const int num_q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  const long long blocks = static_cast<long long>(batch) * heads * num_q_tiles;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem =
      (kBlockQ * DH + kBlockK * (DH + 1) + kBlockK * DH) * sizeof(float) + kBlockK * sizeof(int);
  auto kernel = flash_fwd_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(o), heads, lq, lk, num_q_tiles, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                         const void* pad, void* o, int batch, int heads, int lq, int lk,
                         int causal, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, pad, o, batch, heads, lq, lk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, pad, o, batch, heads, lq, lk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pad, o, batch, heads, lq, lk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pad, o, batch, heads, lq, lk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Lq,Dh], k/v [B,H,Lk,Dh], o [B,H,Lq,Dh], all contiguous, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); key_padding_mask [B,Lk] bytes
// (nonzero = pad) or null. Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t.
extern "C" int dr4sr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* key_padding_mask, void* o, int batch,
                                         int heads, int lq, int lk, int head_dim, int causal,
                                         int is_bf16, void* stream) {
  // the reference computes 1/√Dh in double and rounds it once to f32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, key_padding_mask, o, batch, heads,
                                       lq, lk, causal, scale, s);
  }
  return dispatch_dim<float>(head_dim, q, k, v, key_padding_mask, o, batch, heads, lq, lk,
                             causal, scale, s);
}
