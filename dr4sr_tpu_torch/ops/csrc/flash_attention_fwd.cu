// Flash-attention forward for Hopper (sm_90a) on tensor cores, with a plain
// C entry point that dr4sr_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces the Pallas TPU kernel dr4sr_tpu/ops/attention.py::_flash_kernel.
// Computes, for q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] and a key-padding mask
// [B,Lk] (nonzero = pad):
//
//     o = softmax(q·kᵀ/√Dh, padded keys and (if causal) col > row masked)·v
//
// with the TPU kernel's semantics: masked scores are -1e30 and masked p is
// forced to 0 after the exp; the softmax is an online one over key tiles
// (running max m, rescale α, denominator l); the output is acc / max(l,
// 1e-30), so a fully masked row gives 0. Causal masks key column > query
// row with no offset, also when Lq != Lk. When asked (training), it also
// writes each row's log-sum-exp m + log(l) in f32 (+inf for a fully masked
// row) for the backward kernel, flash_attention_bwd.cu.
//
// Arithmetic, as the TPU kernel rounds:
//   bf16: q·kᵀ in mma.m16n8k16 bf16 with f32 accumulation; the f32 scores
//         are scaled after the product; m and l come from the unrounded p;
//         p is rounded to bf16 only as the A operand of p·v; o is bf16.
//   f32:  3xTF32 (attention_mma.cuh): each operand splits into big + small
//         TF32 values and a·b ≈ big·big + big·small + small·big in
//         mma.m16n8k8 tf32, f32 accumulation, for q·kᵀ (q pre-scaled in f32)
//         and for p·v. One TF32 pass keeps about three decimal digits, far
//         from the all-f32 contract, so it is never used for f32 inputs.
//   Both: e^x is exp2f(x·log2 e), one MUFU.EX2; m, l, α and the output
//   division are f32.
//
// What bounds it on an H100: the bytes of q, k, v and o at the train and
// serve shape (B256 H2 L50 Dh32, ~13 MB f32, 3.9 µs at 3.35 TB/s); the
// products at long sequences. What holds it above that: at L=50 all blocks
// run in one wave, so the time each SM spends executing instructions (the
// f32 operand splits are about a quarter of them) adds to the time of the
// loads instead of hiding under it.
//
// Design. The TPU kernel keeps a (batch, head)'s whole K/V in VMEM and walks
// its grid in order. Here blocks run in parallel and carry nothing: one
// block of 4 warps per (64-row q tile, head, batch), the heaviest causal
// q tiles first. Each warp owns 16 query rows and keeps its scores, its
// output accumulator and its rows' m and l in mma C-fragments, so the
// softmax needs only a 4-lane shuffle per row and tile. Key tiles are 32
// wide: at L=50 the second tile loads while the first computes, and the
// scores take 16 registers, so an f32 Dh=32 thread holds 87 (5 blocks an
// SM). Q and the K/V tiles arrive by 16-byte cp.async, K/V double-buffered
// (one buffer when Lk fits one tile); rows past Lq or Lk are zero-filled
// (0·NaN would be NaN). Shared-memory rows are padded by 16 bytes, so
// ldmatrix and the 32-bit TF32 loads hit distinct banks.
//   bf16 operands come by ldmatrix (.trans for V as p·v's B operand), and
//   two adjacent n8 C-fragments of S form one k16 A-fragment of p in
//   registers (the FlashAttention-2 trick).
//   tf32: a C-fragment holds keys 2t, 2t+1 of each 8-key group, where the
//   A operand wants t, t+4. The reduction index of p·v is permuted instead:
//   A column i is key 2i and column i+4 is key 2i+1, and the B operand reads
//   V's rows in the same order (rows 2t and 2t+1 for b0 and b1).
// A causal block stops at the key tile holding its last row, and a warp
// skips tiles wholly above its rows.

#include "attention_mma.cuh"

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace dr4sr;

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // e^x = 2^(x·log2 e), one MUFU.EX2

template <typename T, int DH>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kBlockK = 32;                    // keys per tile
  static constexpr int kStride = DH + 16 / sizeof(T);  // shared row, in elements
  static constexpr int kQElems = kBlockQ * kStride;
  static constexpr int kKVElems = kBlockK * kStride;   // one K or V buffer
  // Q, the key flags of two stages, then `stages` × (K, V)
  static constexpr size_t smem_bytes(int stages) {
    return kQElems * sizeof(T) + 2 * kBlockK + stages * 2 * kKVElems * sizeof(T);
  }
};

// rows [0, rows) of a [*, DH] slice into shared rows of `Stride` elements;
// rows at or past `valid` are zero-filled and read nothing
template <typename T, int DH, int Rows, int Stride>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int valid, int tid) {
  constexpr int kChunks = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kTotal = Rows * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kWarps * 32 - 1) / (kWarps * 32); ++i) {
    const int c = tid + i * kWarps * 32;
    if (kTotal % (kWarps * 32) != 0 && c >= kTotal) break;
    const int r = c / kChunks;
    const int off = (c % kChunks) * kPerChunk;
    const bool ok = r < valid;
    cp_async_16(dst + r * Stride + off, ok ? src + static_cast<size_t>(r) * DH + off : src, ok);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ pad, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int lq, int lk, int num_q_tiles, int causal, float scale) {
  using C = Cfg<T, DH>;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kStride = C::kStride;
  constexpr int kNGroups = kBlockK / 8;  // n8 key groups of a score tile
  constexpr int kDGroups = DH / 8;       // n8 column groups of the output

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  uint8_t* flags = smem + C::kQElems * sizeof(T);  // [2][kBlockK]: key valid
  T* kv = reinterpret_cast<T*>(flags + 2 * kBlockK);  // stage s: K at 2s, V at 2s+1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x % num_q_tiles);
  const int bh = blockIdx.x / num_q_tiles;
  const int b = bh / heads;
  const int q0 = qt * kBlockQ;
  const T* kg = k + static_cast<size_t>(bh) * lk * DH;
  const T* vg = v + static_cast<size_t>(bh) * lk * DH;

  int num_tiles = (lk + kBlockK - 1) / kBlockK;
  if (causal) num_tiles = min(num_tiles, (min(q0 + kBlockQ, lq) - 1) / kBlockK + 1);

  // K/V of key tile `tile` (< num_tiles, so its first key is < lk) into its buffer
  auto load_kv = [&](int tile) {
    const int k0 = tile * kBlockK;
    const size_t off = static_cast<size_t>(k0) * DH;
    T* dst = kv + 2 * (tile & 1) * C::kKVElems;
    load_rows<T, DH, kBlockK, kStride>(dst, kg + off, lk - k0, tid);
    load_rows<T, DH, kBlockK, kStride>(dst + C::kKVElems, vg + off, lk - k0, tid);
  };
  // whether key `tid` of tile `tile` takes part (threads tid < kBlockK)
  auto key_flag = [&](int tile) -> uint8_t {
    const int key = tile * kBlockK + tid;
    return key < lk && (pad == nullptr || pad[static_cast<size_t>(b) * lk + key] == 0);
  };

  load_rows<T, DH, kBlockQ, kStride>(qs, q + (static_cast<size_t>(bh) * lq + q0) * DH, lq - q0,
                                     tid);
  if (num_tiles > 0) {
    load_kv(0);
    if (tid < kBlockK) flags[tid] = key_flag(0);
  }
  cp_async_commit();

  const int wrow = warp * 16;                 // the warp's first row in the tile
  const int row_lo = q0 + wrow + g;           // this lane's rows: row_lo, row_lo + 8
  const int warp_last = min(q0 + wrow + 15, lq - 1);
  const bool warp_live = q0 + wrow < lq;

  float acc[kDGroups][4];
#pragma unroll
  for (int n = 0; n < kDGroups; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums (the quad's sum at the end)

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // tile's K/V and flags are in; every warp is done with tile - 1
    const bool prefetch = tile + 1 < num_tiles;
    uint8_t next_flag = 0;
    if (prefetch) {
      load_kv(tile + 1);  // into tile - 1's buffer, while this tile computes
      cp_async_commit();
      if (tid < kBlockK) next_flag = key_flag(tile + 1);  // stored after the compute
    }
    const int k0 = tile * kBlockK;
    if (warp_live && !(causal && k0 > warp_last)) {  // warp-uniform
      const int buf = tile & 1;
      const T* ks = kv + (2 * buf) * C::kKVElems;
      const T* vs = kv + (2 * buf + 1) * C::kKVElems;
      const uint8_t* fl = flags + buf * kBlockK;

      // S = q·kᵀ for the warp's 16 rows and the tile's keys
      float s[kNGroups][4];
#pragma unroll
      for (int j = 0; j < kNGroups; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (C::kBf16) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, qs + (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + kk * 16 +
                             (lane >> 4) * 8);
#pragma unroll
          for (int j2 = 0; j2 < kNGroups / 2; ++j2) {
            uint32_t bk[4];  // b0, b1 of key groups 2·j2 and 2·j2 + 1
            ldmatrix_x4(bk, ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16_16816(s[2 * j2], a, bk[0], bk[1]);
            mma_bf16_16816(s[2 * j2 + 1], a, bk[2], bk[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 8; ++kk) {
          const float* qr = qs + (wrow + g) * kStride + kk * 8 + t;
          uint32_t ab[4], as[4];  // q pre-scaled in f32, as the TPU kernel
          split_tf32(qr[0] * scale, ab[0], as[0]);
          split_tf32(qr[8 * kStride] * scale, ab[1], as[1]);
          split_tf32(qr[4] * scale, ab[2], as[2]);
          split_tf32(qr[8 * kStride + 4] * scale, ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < kNGroups; ++j) {
            const float* kr = ks + (j * 8 + g) * kStride + kk * 8 + t;  // B[t][g] = k[key g][d t]
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(kr[0], b0b, b0s);
            split_tf32(kr[4], b1b, b1s);
            mma_3xtf32(s[j], ab, as, b0b, b1b, b0s, b1s);
          }
        }
      }

      // mask, then the online softmax; element e of group j is key
      // k0 + 8j + 2t + (e & 1) of row row_lo + 8·(e >> 1)
      auto masked = [&](int j, int e) {
        const int key = 8 * j + 2 * t + (e & 1);
        return !fl[key] || (causal && k0 + key > row_lo + 8 * (e >> 1));
      };
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kNGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = C::kBf16 ? s[j][e] * scale : s[j][e];
          s[j][e] = masked(j, e) ? kNegInf : x;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kNGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = masked(j, e) ? 0.f : exp2f((s[j][e] - m[e >> 1]) * kLog2e);
          l[e >> 1] += p;  // from the unrounded p
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int n = 0; n < kDGroups; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // acc += p·v
      if constexpr (C::kBf16) {
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int d2 = 0; d2 < DH / 16; ++d2) {
            uint32_t bv[4];  // b0, b1 of column groups 2·d2 and 2·d2 + 1
            ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                      d2 * 16 + (lane >> 4) * 8);
            mma_bf16_16816(acc[2 * d2], a, bv[0], bv[1]);
            mma_bf16_16816(acc[2 * d2 + 1], a, bv[2], bv[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNGroups; ++j) {
          // A column t is key 2t of the group, column t + 4 is key 2t + 1
          uint32_t ab[4], as[4];
          split_tf32(s[j][0], ab[0], as[0]);
          split_tf32(s[j][2], ab[1], as[1]);
          split_tf32(s[j][1], ab[2], as[2]);
          split_tf32(s[j][3], ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < kDGroups; ++n) {
            const float* vr = vs + (j * 8 + 2 * t) * kStride + n * 8 + g;  // v[key 2t][d g]
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(vr[0], b0b, b0s);
            split_tf32(vr[kStride], b1b, b1s);
            mma_3xtf32(acc[n], ab, as, b0b, b1b, b0s, b1s);
          }
        }
      }
    }
    if (prefetch && tid < kBlockK) flags[((tile + 1) & 1) * kBlockK + tid] = next_flag;
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + 8 * r;
    if (row >= lq) continue;
    if (lse != nullptr && t == 0) {
      lse[static_cast<size_t>(bh) * lq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * lq + row) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < kDGroups; ++n) {
      const float x0 = acc[n][2 * r] / denom;
      const float x1 = acc[n][2 * r + 1] / denom;
      if constexpr (C::kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad, void* o,
                   float* lse, int batch, int heads, int lq, int lk, int causal, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T, DH>;
  const int num_q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  const long long blocks = static_cast<long long>(batch) * heads * num_q_tiles;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int key_tiles = (lk + C::kBlockK - 1) / C::kBlockK;
  const size_t smem = C::smem_bytes(key_tiles > 1 ? 2 : 1);
  auto kernel = flash_fwd_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(o), lse, heads, lq, lk, num_q_tiles,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                         const void* pad, void* o, float* lse, int batch, int heads, int lq,
                         int lk, int causal, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, pad, o, lse, batch, heads, lq, lk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, pad, o, lse, batch, heads, lq, lk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pad, o, lse, batch, heads, lq, lk, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pad, o, lse, batch, heads, lq, lk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Lq,Dh], k/v [B,H,Lk,Dh], o [B,H,Lq,Dh], all contiguous and 16-byte
// aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); key_padding_mask [B,Lk]
// bytes (nonzero = pad) or null; lse [B,H,Lq] f32, or null when not wanted
// (serving). Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t.
extern "C" int dr4sr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* key_padding_mask, void* o, void* lse,
                                         int batch, int heads, int lq, int lk, int head_dim,
                                         int causal, int is_bf16, void* stream) {
  // the reference computes 1/√Dh in double and rounds it once to f32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, key_padding_mask, o, lse_f, batch,
                                       heads, lq, lk, causal, scale, s);
  }
  return dispatch_dim<float>(head_dim, q, k, v, key_padding_mask, o, lse_f, batch, heads, lq,
                             lk, causal, scale, s);
}
