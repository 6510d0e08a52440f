// The MoE layer's row movement between token order and expert-group order
// (dr4sr_tpu_torch/modules/moe.py::DeepSeekMoE), for Hopper (sm_90a), with
// plain C entry points that dr4sr_tpu_torch/ops/moe_permute.py loads with
// ctypes.
//
// It replaces no TPU kernel: the JAX package has no MoE layer. It was added
// because PyTorch's chain for the same rows (index_select, a where that
// zeroes the rows past the last group, index_select by the inverse
// permutation, a k-sum, and their backwards: two index_add_s of bf16 atomics
// into zero-filled buffers) walked all N·k rows of the buffer several times
// a layer, pads included, and took 17% of the device time of a training step
// of DeepSeek-V2-Lite's block (N = 368 × 200 tokens, k 6, D 2,048), more
// than the held experts' grouped products.
//
// The layer sorts its N·k (token, slot) assignments by held expert; the
// assignment a = t·k + j sits in row back[a] of the sorted buffer, and the
// rows from `live` = ends[-1] on belong to no group (pads, experts held
// elsewhere). Two kernels, each the other's adjoint:
//
//   scatter_rows: out[back[t·k + j]] = in[t] for every live slot j of token
//                 t, cast to out's type; rows from `live` on are not written.
//                 The dispatch's forward (x → xs) and the combine's
//                 backward (dy → dys).
//   sum_rows:     out[t] = Σ_j in[back[t·k + j]] over the live slots of
//                 token t, in f32 and in the order j = 0 .. k-1, 0 for a
//                 token with none; rows of `in` from `live` on are never
//                 read. The combine's forward (ys → y, f32) and the
//                 dispatch's backward (dxs → dx, in x's type).
//
// Every output element is written by one thread, once, in a fixed order: no
// atomics, no zero-fill, no mask, and the same bits on every run.
//
// What bounds them on an H100: bytes. At the training cell's shape (N 73,600
// tokens of which about 39,400 are real, about 236,000 live rows of 2,048)
// each moves the live rows once in bf16 (live × D × 2, 0.97 GB) and the
// token rows once in f32 (scatter: the real tokens' rows read, 0.32 GB;
// sum: all N rows written, 0.60 GB), 0.39 ms and 0.47 ms at 3.35 TB/s.
//
// Design. Both walk tokens, not rows, so that each token row of the f32
// side is touched once and each live row of the bf16 side once: the scatter
// reads a token's row once and writes it to each of its live rows (reading
// by rows would read each token row k times), and a token with no live slot
// (a pad) reads nothing. A token's row is cut into chunks of 8 elements (16
// bytes of bf16, 32 of f32: one or two vector loads a thread, which is why
// D must be a multiple of 8); `tpr` threads (a power of two, at most the
// block's 256) share a token, so a block takes 256 / tpr tokens at a time
// (one at D 2,048, eight at D 256), and a grid of a few blocks an SM strides
// over the tokens. `live` is read on the device: no host synchronisation,
// and the launch is the same at any load, so it can be captured in a CUDA
// graph. The sum starts the loads of up to 8 slots before it adds any, so a
// thread keeps up to 8 × 16 bytes in flight, and adds in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;    // elements of a chunk
constexpr int kBatch = 8;  // slots whose loads the sum starts together

// 8 elements as they lie in memory
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  float4 lo, hi;
};
template <>
struct Pack<__nv_bfloat16> {
  uint4 raw;
};

template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const Pack<T>& v) {
  *reinterpret_cast<Pack<T>*>(p) = v;
}

__device__ __forceinline__ void to_float(const Pack<float>& p, float (&v)[kVec]) {
  v[0] = p.lo.x, v[1] = p.lo.y, v[2] = p.lo.z, v[3] = p.lo.w;
  v[4] = p.hi.x, v[5] = p.hi.y, v[6] = p.hi.z, v[7] = p.hi.w;
}

__device__ __forceinline__ void to_float(const Pack<__nv_bfloat16>& p, float (&v)[kVec]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&p.raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __bfloat162float(h[i]);
}

template <typename T>
__device__ __forceinline__ Pack<T> from_float(const float (&v)[kVec]);

template <>
__device__ __forceinline__ Pack<float> from_float<float>(const float (&v)[kVec]) {
  Pack<float> p;
  p.lo = make_float4(v[0], v[1], v[2], v[3]);
  p.hi = make_float4(v[4], v[5], v[6], v[7]);
  return p;
}

template <>
__device__ __forceinline__ Pack<__nv_bfloat16> from_float<__nv_bfloat16>(
    const float (&v)[kVec]) {
  Pack<__nv_bfloat16> p;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&p.raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) h[i] = __float2bfloat16(v[i]);  // round to nearest even
  return p;
}

template <typename TIn, typename TOut>
__device__ __forceinline__ Pack<TOut> convert(const Pack<TIn>& p) {
  float v[kVec];
  to_float(p, v);
  return from_float<TOut>(v);
}

template <>
__device__ __forceinline__ Pack<float> convert<float, float>(const Pack<float>& p) {
  return p;
}

template <>
__device__ __forceinline__ Pack<__nv_bfloat16> convert<__nv_bfloat16, __nv_bfloat16>(
    const Pack<__nv_bfloat16>& p) {
  return p;
}

// in [tokens, D], out [rows, D]; back [tokens·k]; *last_end = live
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const TIn* __restrict__ in, const int64_t* __restrict__ back,
                        const int* __restrict__ last_end, TOut* __restrict__ out, int tokens,
                        int k, int chunks, int tpr) {
  const int64_t live = *last_end;
  const int lane = threadIdx.x % tpr, per_block = kThreads / tpr;
  for (int t = blockIdx.x * per_block + threadIdx.x / tpr; t < tokens;
       t += gridDim.x * per_block) {
    const int64_t* slots = back + static_cast<int64_t>(t) * k;
    bool any = false;
    for (int j = 0; j < k; ++j) any |= slots[j] < live;
    if (!any) continue;  // no row takes this token: nothing to read
    for (int c = lane; c < chunks; c += tpr) {
      const Pack<TOut> v =
          convert<TIn, TOut>(load_pack(in + (static_cast<int64_t>(t) * chunks + c) * kVec));
      for (int j = 0; j < k; ++j) {
        const int64_t row = slots[j];
        if (row < live) store_pack(out + (row * chunks + c) * kVec, v);
      }
    }
  }
}

// in [rows, D], out [tokens, D]; back [tokens·k]; *last_end = live
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    sum_rows_kernel(const TIn* __restrict__ in, const int64_t* __restrict__ back,
                    const int* __restrict__ last_end, TOut* __restrict__ out, int tokens, int k,
                    int chunks, int tpr) {
  const int64_t live = *last_end;
  const int lane = threadIdx.x % tpr, per_block = kThreads / tpr;
  for (int t = blockIdx.x * per_block + threadIdx.x / tpr; t < tokens;
       t += gridDim.x * per_block) {
    const int64_t* slots = back + static_cast<int64_t>(t) * k;
    for (int c = lane; c < chunks; c += tpr) {
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
      for (int j0 = 0; j0 < k; j0 += kBatch) {
        Pack<TIn> raw[kBatch];
        bool taken[kBatch];
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          const int64_t row = j0 + jj < k ? slots[j0 + jj] : live;
          taken[jj] = row < live;
          if (taken[jj]) raw[jj] = load_pack(in + (row * chunks + c) * kVec);
        }
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          if (!taken[jj]) continue;
          float v[kVec];
          to_float(raw[jj], v);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += v[i];
        }
      }
      store_pack(out + (static_cast<int64_t>(t) * chunks + c) * kVec, from_float<TOut>(acc));
    }
  }
}

// threads a token, a power of two: the chunks of a row, at most the block
int threads_per_token(int chunks) {
  int tpr = 1;
  while (tpr < chunks && tpr < kThreads) tpr *= 2;
  return tpr;
}

template <bool kScatter, typename TIn, typename TOut>
cudaError_t launch(const void* in, const void* back, const void* last_end, void* out, int tokens,
                   int k, int dim, int max_blocks, cudaStream_t stream) {
  const int chunks = dim / kVec, tpr = threads_per_token(chunks), per_block = kThreads / tpr;
  const int needed = (tokens + per_block - 1) / per_block;
  const int blocks = needed < max_blocks ? needed : max_blocks;
  auto kernel = kScatter ? scatter_rows_kernel<TIn, TOut> : sum_rows_kernel<TIn, TOut>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<const int64_t*>(back),
      static_cast<const int*>(last_end), static_cast<TOut*>(out), tokens, k, chunks, tpr);
  return cudaGetLastError();
}

template <bool kScatter>
int dispatch_types(const void* in, int in_bf16, const void* back, const void* last_end,
                   void* out, int out_bf16, int tokens, int k, int dim, int max_blocks,
                   void* stream) {
  if (tokens <= 0 || k <= 0 || dim <= 0 || dim % kVec != 0 || max_blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16) {
    return out_bf16 ? launch<kScatter, bf16, bf16>(in, back, last_end, out, tokens, k, dim,
                                                   max_blocks, s)
                    : launch<kScatter, bf16, float>(in, back, last_end, out, tokens, k, dim,
                                                    max_blocks, s);
  }
  return out_bf16
             ? launch<kScatter, float, bf16>(in, back, last_end, out, tokens, k, dim, max_blocks,
                                             s)
             : launch<kScatter, float, float>(in, back, last_end, out, tokens, k, dim, max_blocks,
                                              s);
}

}  // namespace

// in [tokens, dim] and out [tokens·k, dim], contiguous and 16-byte aligned,
// f32 (is_bf16 = 0) or bf16 (1) each, dim a multiple of 8; back [tokens·k]
// int64, a permutation of 0 .. tokens·k - 1; last_end points at the int32
// `live`. At most max_blocks blocks of 256 threads. Launches on `stream`,
// does not synchronise, and returns the launch's cudaError_t.
extern "C" int dr4sr_moe_scatter_rows(const void* in, int in_bf16, const void* back,
                                      const void* last_end, void* out, int out_bf16, int tokens,
                                      int k, int dim, int max_blocks, void* stream) {
  return dispatch_types<true>(in, in_bf16, back, last_end, out, out_bf16, tokens, k, dim,
                              max_blocks, stream);
}

// in [tokens·k, dim] and out [tokens, dim]; the rest as above.
extern "C" int dr4sr_moe_sum_rows(const void* in, int in_bf16, const void* back,
                                  const void* last_end, void* out, int out_bf16, int tokens,
                                  int k, int dim, int max_blocks, void* stream) {
  return dispatch_types<false>(in, in_bf16, back, last_end, out, out_bf16, tokens, k, dim,
                               max_blocks, stream);
}
