"""The forward kernel's CUDA source (``csrc/flash_attention_fwd.cu``) run on
the CPU, against ``mha_reference`` and against the JAX package's Pallas
kernel in interpret mode, whose rounding points the bf16 route keeps.

There is no card and no ``nvcc`` here, so the source is compiled by ``g++``
against an emulation of what it uses from CUDA: one ``std::thread`` per CUDA
thread, a barrier per block, and warp-wide shuffles, ``ldmatrix`` and
``mma.sync`` assembled from the fragment layouts of the PTX ISA (the
emulated ``attention_mma.cuh`` below takes the real one's place). This holds
the kernel's indexing on the CPU: its fragments, the permuted key order of
the TF32 p·v, masks, tiles, zero-filled rows and the row log-sum-exp. The
card's own arithmetic and speed are ``chip_smoke.py``'s to check.

Tolerances are the kernel's (``chip_smoke.py``): f32 atol 2e-5, bf16 3e-2;
against the JAX kernel, bf16 is held to one bf16 step of each element.
"""

import ctypes
import math
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.ops.attention import flash_attention as jax_flash
from dr4sr_tpu_torch.ops import _build, attention
from dr4sr_tpu_torch.ops.attention import mha_reference

ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

# the CUDA features the kernel uses, for g++ -std=c++20 -pthread
EMULATED_MMA_HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
using std::max;
using std::min;

inline float __uint_as_float(uint32_t x) { float f; std::memcpy(&f, &x, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t x; std::memcpy(&x, &f, 4); return x; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline uint16_t bf16_bits(float f) {  // round to nearest even
  const uint32_t u = __float_as_uint(f);
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline float bf16_value(uint16_t b) { return __uint_as_float(static_cast<uint32_t>(b) << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {{bf16_bits(a)}, {bf16_bits(b)}};
}

// a block runs as one std::thread per CUDA thread; warp collectives meet in
// their warp's exchange slots between two barriers of the warp
struct Warp {
  std::barrier<>* bar;
  uint32_t a[32][4];
  uint32_t b[32][2];
  const unsigned char* addr[32];
  float f[32];
};
inline std::barrier<>* g_block_bar;
inline Warp g_warps[32];
alignas(16) inline unsigned char g_smem[1 << 18];
inline unsigned char* emulated_smem() { return g_smem; }
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline Warp& this_warp() { return g_warps[threadIdx.x / 32]; }
inline int this_lane() { return threadIdx.x & 31; }

inline float __shfl_xor_sync(unsigned, float x, int mask) {
  Warp& w = this_warp();
  w.f[this_lane()] = x;
  w.bar->arrive_and_wait();
  const float r = w.f[this_lane() ^ mask];
  w.bar->arrive_and_wait();
  return r;
}

template <class K, class... Args>
void emulated_launch(K kernel, unsigned grid, unsigned block, size_t smem, cudaStream_t,
                     Args... args) {
  if (smem > sizeof(g_smem) || block % 32 != 0) abort();
  for (unsigned blk = 0; blk < grid; ++blk) {
    std::memset(g_smem, 0xCD, sizeof(g_smem));  // shared memory starts as garbage
    std::barrier<> block_bar(block);
    g_block_bar = &block_bar;
    std::vector<std::barrier<>*> warp_bars;
    for (unsigned w = 0; w < block / 32; ++w) {
      warp_bars.push_back(new std::barrier<>(32));
      g_warps[w].bar = warp_bars.back();
    }
    std::vector<std::thread> threads;
    for (unsigned i = 0; i < block; ++i) {
      threads.emplace_back([=]() {
        threadIdx.x = i;
        blockIdx.x = blk;
        kernel(args...);
      });
    }
    for (auto& t : threads) t.join();
    for (auto* b : warp_bars) delete b;
  }
}

namespace dr4sr {

inline void cp_async_16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

// lane 8i + r gives row r of matrix i; lane 4g + t receives row g, b16
// columns 2t and 2t + 1 of each matrix (.trans: column g, rows 2t and 2t + 1)
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  Warp& w = this_warp();
  const int lane = this_lane();
  w.addr[lane] = static_cast<const unsigned char*>(p);
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) std::memcpy(&r[i], w.addr[8 * i + lane / 4] + (lane % 4) * 4, 4);
  w.bar->arrive_and_wait();
}

inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  Warp& w = this_warp();
  const int lane = this_lane();
  w.addr[lane] = static_cast<const unsigned char*>(p);
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    std::memcpy(&lo, w.addr[8 * i + 2 * (lane % 4)] + (lane / 4) * 2, 2);
    std::memcpy(&hi, w.addr[8 * i + 2 * (lane % 4) + 1] + (lane / 4) * 2, 2);
    r[i] = lo | (static_cast<uint32_t>(hi) << 16);
  }
  w.bar->arrive_and_wait();
}

// c += a·b for the warp: gather every lane's fragments into A [16][K] and
// B [K][8], then each lane computes its own C elements
template <int K, class Unpack>
inline void warp_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                     Unpack unpack) {
  Warp& w = this_warp();
  const int lane = this_lane();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar->arrive_and_wait();
  float A[16][K], B[K][8];
  for (int l = 0; l < 32; ++l) unpack(A, B, l / 4, l % 4, w.a[l], w.b[l]);
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float sum = c[e];
    for (int k = 0; k < K; ++k) sum += A[row][k] * B[k][col];
    c[e] = sum;
  }
  w.bar->arrive_and_wait();
}

inline void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  warp_mma<16>(c, a, b0, b1, [](float (&A)[16][16], float (&B)[16][8], int g, int t,
                                const uint32_t* x, const uint32_t* y) {
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = bf16_value(x[0] >> (16 * h));
      A[g + 8][2 * t + h] = bf16_value(x[1] >> (16 * h));
      A[g][2 * t + 8 + h] = bf16_value(x[2] >> (16 * h));
      A[g + 8][2 * t + 8 + h] = bf16_value(x[3] >> (16 * h));
      B[2 * t + h][g] = bf16_value(y[0] >> (16 * h));
      B[2 * t + 8 + h][g] = bf16_value(y[1] >> (16 * h));
    }
  });
}

inline void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  warp_mma<8>(c, a, b0, b1, [](float (&A)[16][8], float (&B)[8][8], int g, int t,
                               const uint32_t* x, const uint32_t* y) {
    if ((x[0] | x[1] | x[2] | x[3] | y[0] | y[1]) & 0x1fffu) {
      fprintf(stderr, "an operand of a tf32 mma is not rounded to TF32\n");
      abort();
    }
    A[g][t] = __uint_as_float(x[0]);
    A[g + 8][t] = __uint_as_float(x[1]);
    A[g][t + 4] = __uint_as_float(x[2]);
    A[g + 8][t + 4] = __uint_as_float(x[3]);
    B[t][g] = __uint_as_float(y[0]);
    B[t + 4][g] = __uint_as_float(y[1]);
  });
}

inline uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

inline void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

inline void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                       uint32_t b0_big, uint32_t b1_big, uint32_t b0_small, uint32_t b1_small) {
  mma_tf32_1688(c, a_small, b0_big, b1_big);
  mma_tf32_1688(c, a_big, b0_small, b1_small);
  mma_tf32_1688(c, a_big, b0_big, b1_big);
}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return bf16_bits(lo) | (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

}  // namespace dr4sr
"""


@pytest.fixture(scope="module")
def emulated_fwd(tmp_path_factory):
    """The kernel's C entry point, built from the package's source."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernel")
    d = tmp_path_factory.mktemp("emulated_fwd")
    with open(_build.source_path("flash_attention_fwd")) as f:
        src = f.read()
    shared = "extern __shared__ __align__(16) unsigned char smem[];"
    assert shared in src and "<<<" in src
    src = src.replace(shared, "unsigned char* smem = emulated_smem();")
    src = re.sub(r"kernel<<<(.*?)>>>\(", r"emulated_launch(kernel, \1, ", src, flags=re.S)
    (d / "attention_mma.cuh").write_text(EMULATED_MMA_HEADER)  # found first: beside the source
    (d / "flash_attention_fwd.cpp").write_text(src)
    so = d / "flash_attention_fwd.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o", str(so),
         str(d / "flash_attention_fwd.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(so)).dr4sr_flash_attention_fwd
    fn.argtypes = list(attention._FWD_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _run(fn, q, k, v, pad, causal):
    b, h, lq, dh = q.shape
    o = torch.full_like(q, float("nan"))  # every element must be written
    lse = torch.full((b, h, lq), float("nan"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pad is None else pad.data_ptr(),
             o.data_ptr(), lse.data_ptr(), b, h, lq, k.shape[2], dh, int(causal),
             int(q.dtype == torch.bfloat16), None)
    assert err == 0
    return o, lse


def _lse_reference(q, k, pad, causal):
    """Row log-sum-exp of the masked scores in float64; +inf on a fully masked row."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = q.double() @ k.double().transpose(-1, -2) / math.sqrt(dh)
    invalid = torch.zeros(1, 1, lq, lk, dtype=torch.bool)
    if causal:
        invalid = invalid | (torch.arange(lk)[None, :] > torch.arange(lq)[:, None])
    if pad is not None:
        invalid = invalid | pad[:, None, None, :]
    out = torch.logsumexp(s.masked_fill(invalid, float("-inf")), dim=-1)
    return out.masked_fill(torch.isneginf(out), float("inf")).float()


# (dtype, B, H, Lq, Lk, Dh, causal): every head dim in both dtypes; one and
# several q tiles (64 rows) and key tiles (32 keys, double-buffered); ragged
# ends; Lq != Lk; the main path's L=50
CASES = [
    (torch.float32, 2, 2, 50, 50, 32, True),
    (torch.bfloat16, 2, 2, 50, 50, 32, True),
    (torch.float32, 2, 1, 100, 100, 16, True),
    (torch.bfloat16, 2, 1, 100, 100, 16, True),
    (torch.float32, 2, 1, 20, 50, 64, False),
    (torch.bfloat16, 2, 1, 130, 130, 64, True),
    (torch.float32, 2, 1, 70, 70, 128, True),
    (torch.bfloat16, 2, 1, 40, 70, 128, False),
]


def _case_id(case):
    dtype, *dims, causal = case
    return f"{str(dtype)[6:]}-{'x'.join(map(str, dims))}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_the_plain_version(emulated_fwd, case):
    dtype, b, h, lq, lk, dh, causal = case
    gen = torch.Generator().manual_seed(lq * dh)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(dtype) for n in (lq, lk, lk))
    pad = torch.arange(lk)[None, :] >= torch.tensor([0, lk - 7])[:, None]  # row 0 fully masked
    for mask in (pad, None):
        o, lse = _run(emulated_fwd, q, k, v, mask, causal)
        ref = mha_reference(q, k, v, mask, causal)
        assert (o.float() - ref.float()).abs().max().item() <= ATOL[dtype]
        want = _lse_reference(q.float(), k.float(), mask, causal)
        finite = torch.isfinite(want)
        assert (lse[~finite] == float("inf")).all()
        assert (lse[finite] - want[finite]).abs().max().item() <= 1e-5
    o, _ = _run(emulated_fwd, q, k, v, pad, causal)
    assert (o[0] == 0).all()  # the fully masked batch row is exactly 0


def _bf16_step(x):
    """One bf16 step (unit in the last place) at each element of ``x``."""
    x = np.abs(x.astype(np.float64))
    return np.where(x > 0, np.exp2(np.floor(np.log2(np.where(x > 0, x, 1.0))) - 7), 0.0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_the_jax_kernel(emulated_fwd, case):
    """The kernel against the Pallas kernel it replaces, run in interpret mode
    with the same key tile (32), so that the running maximum, and with it p's
    rounding to bf16, is taken at the same points. In bf16 each output element
    is then within one bf16 step of the JAX kernel's; scaling q before the
    product in bf16, or rounding p anywhere else, moves elements by many
    steps. f32 is held at its atol, 2e-5."""
    dtype, b, h, lq, lk, dh, causal = case
    rng = np.random.default_rng(lq * dh + 1)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (lq, lk, lk))
    pad = np.arange(lk)[None, :] >= np.array([0, lk - 5])[:, None]  # row 0 fully masked
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(
        jax_flash(*(jnp.asarray(x, jax_dtype) for x in (q, k, v)), jnp.asarray(pad),
                  causal=causal, block_k=32, interpret=True),
        np.float32,
    )
    o, _ = _run(emulated_fwd, *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                torch.from_numpy(pad), causal)
    err = np.abs(o.float().numpy() - want)
    if dtype == torch.bfloat16:
        assert (err <= _bf16_step(want)).all()
    else:
        assert err.max() <= ATOL[dtype]


def test_misaligned_views_are_refused():
    """The kernel copies 16-byte chunks, so a view that starts off a 16-byte
    boundary is refused before any launch."""
    base = torch.zeros(1, 1, 4, 33)
    view = base.flatten()[1:129].view(1, 1, 4, 32)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention._check_aligned((view,), "flash_attention_fwd")
    attention._check_aligned((base[..., :32].contiguous(),), "flash_attention_fwd")
