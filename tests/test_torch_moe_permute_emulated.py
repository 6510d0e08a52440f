"""The MoE row kernels' CUDA source (``csrc/moe_permute.cu``) run on the CPU.

There is no card and no ``nvcc`` here, so the source is compiled by ``g++``
against stub ``cuda_runtime.h`` and ``cuda_bf16.h`` headers: the kernels
share nothing between threads, so a launch runs its blocks and their
threads one after another. This holds the kernels' indexing on the CPU
(threads a token, the grid's stride over the tokens, the live rows, the
casts) against the plain chain of ``ops/moe_permute.py``:

* ``scatter_rows`` writes each live row as the plain dispatch does, bit for
  bit, and leaves every row past the last group as it was;
* ``sum_rows`` is the f32 sum of each token's live rows in slot order, bit
  for bit, with NaN planted in every row past the last group;
* both refuse a width that is not a multiple of 8.

The card's own speed and the autograd wrappers are
``tests/test_torch_moe_permute_card.py``'s to check.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch
from torch_moe_rows import routing

from dr4sr_tpu_torch.ops import _build, moe_permute

CUDA_RUNTIME = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct dim3 { unsigned x = 0, y = 1, z = 1; };
// internal linkage: an inline variable is a process-wide (GNU unique) symbol,
// which would bind to another emulation's threadIdx loaded in this process
static dim3 threadIdx, blockIdx, gridDim, blockDim;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

// the threads of a launch share nothing: each runs to its end in turn
template <class K, class... Args>
void emulated_launch(K kernel, unsigned grid, unsigned block, size_t, cudaStream_t,
                     Args... args) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    for (unsigned t = 0; t < block; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel(args...);
    }
  }
}
"""

CUDA_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return {static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """The two C entry points, built by g++ from the package's source."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    d = tmp_path_factory.mktemp("emulated_moe_permute")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (d / "cuda_bf16.h").write_text(CUDA_BF16)
    with open(_build.source_path("moe_permute")) as f:
        src = f.read()
    assert "<<<" in src
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emulated_launch(\1, \2, ", src, flags=re.S)
    (d / "kernel.cpp").write_text(src)
    so = d / "kernel.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o",
                           str(so), str(d / "kernel.cpp")], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    out = {}
    for name in ("scatter_rows", "sum_rows"):
        fn = getattr(lib, f"dr4sr_moe_{name}")
        fn.argtypes = list(moe_permute._ARGTYPES)
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _call(fn, src, back, k, ends, out, max_blocks):
    return fn(src.data_ptr(), int(src.dtype == torch.bfloat16), back.data_ptr(),
              ends.data_ptr() + 4 * (ends.numel() - 1), out.data_ptr(),
              int(out.dtype == torch.bfloat16), back.numel() // k, k, src.shape[1], max_blocks,
              None)


DTYPES = (torch.float32, torch.bfloat16)
# (tokens, k, D, held experts, blocks at most): one and several tokens a
# block (threads a token 1, 4, 32, 256), a grid that strides, k past the
# sum's batch of 8 loads, an expert left empty
CASES = [(13, 6, 8, 4, 2), (29, 6, 24, 8, 3), (40, 6, 256, 8, 4), (9, 10, 64, 3, 1),
         (7, 1, 2048, 2, 2), (5, 6, 2048, 8, 64)]


@pytest.mark.parametrize("src_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,d,held,max_blocks", CASES)
def test_scatter_rows_writes_the_live_rows_as_the_plain_dispatch(kernels, n, k, d, held,
                                                                  max_blocks, src_dtype, dtype):
    order, back, ends = routing(n, k, held, seed=n + d)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(1)).to(src_dtype)
    out = torch.full((n * k, d), 7.0, dtype=dtype)  # a row left alone keeps it
    assert _call(kernels["scatter_rows"], x, back, k, ends, out, max_blocks) == 0
    live = int(ends[-1])
    want = moe_permute.dispatch_rows_plain(x, order, k, ends, dtype)
    assert torch.equal(out[:live], want[:live])
    assert (out[live:] == 7.0).all()


@pytest.mark.parametrize("src_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,d,held,max_blocks", CASES)
def test_sum_rows_is_the_f32_slot_order_sum_of_the_live_rows(kernels, n, k, d, held,
                                                              max_blocks, src_dtype, dtype):
    order, back, ends = routing(n, k, held, seed=n + d + 1)
    live = int(ends[-1])
    rows = torch.randn(n * k, d, generator=torch.Generator().manual_seed(2)).to(src_dtype)
    rows[live:] = float("nan")  # never read
    out = torch.full((n, d), float("nan"), dtype=dtype)  # every row written
    assert _call(kernels["sum_rows"], rows, back, k, ends, out, max_blocks) == 0
    padded = torch.cat([rows.float(), torch.zeros(1, d)])  # a dead slot reads the zero row
    acc = torch.zeros(n, d)
    for j in range(k):
        slot = back[j::k]
        acc = acc + padded[torch.where(slot < live, slot, n * k)]
    assert torch.equal(out, acc.to(dtype))
    plain = moe_permute.combine_rows_plain(rows.nan_to_num(0.0), back, k, ends)
    torch.testing.assert_close(out.float(), plain, rtol=1e-6 if dtype == torch.float32 else 8e-3,
                               atol=1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("name", ["scatter_rows", "sum_rows"])
def test_a_width_off_the_vector_is_refused(kernels, name):
    order, back, ends = routing(4, 2, 2, seed=0)
    rows = torch.zeros(8, 12)
    assert _call(kernels[name], rows, back, 2, ends, torch.zeros(8, 12), 1) == 1



# what a call breaks: the error it raises, and what the message says
REFUSALS = {"a width off the vector": (ValueError, "multiple of 8"),
            "int rows": (TypeError, "float32 or bfloat16"),
            "a half output": (TypeError, "float32 or bfloat16"),
            "int32 back": (ValueError, "back must be int64"),
            "int64 ends": (ValueError, "ends must be"),
            "k 0": (ValueError, "k ≥ 1"),
            "rows for another N": (ValueError, "a token, got"),
            "strided rows": (ValueError, "must be contiguous"),
            "rows off a 16-byte boundary": (ValueError, "16-byte boundary"),
            "CPU tensors": (ValueError, "takes CUDA tensors")}


def _refused(name, what):
    """Arguments of ``scatter_rows`` or ``sum_rows`` that break ``what``."""
    _, back, ends = routing(4, 2, 2, seed=0)
    n = 4 if name == "scatter_rows" else 8  # the rows a call takes: a token's, or a slot's
    rows, k, dtype = torch.zeros(n, 16), 2, torch.float32
    if what == "a width off the vector":
        rows = torch.zeros(n, 12)
    elif what == "int rows":
        rows = rows.long()
    elif what == "a half output":
        dtype = torch.float16
    elif what == "int32 back":
        back = back.int()
    elif what == "int64 ends":
        ends = ends.long()
    elif what == "k 0":
        k = 0
    elif what == "rows for another N":
        rows = torch.zeros(n + 1, 16)
    elif what == "strided rows":
        rows = torch.zeros(16, n).t()
    elif what == "rows off a 16-byte boundary":
        rows = torch.zeros(n * 16 + 1)[1:].view(n, 16)
    return rows, back, k, ends, dtype


@pytest.mark.parametrize("what", list(REFUSALS))
@pytest.mark.parametrize("name", ["scatter_rows", "sum_rows"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, name, what):
    """The kernels' wrappers raise, before any build, on what the kernels do
    not take; with none of it broken, on CPU tensors."""

    def no_build(lib):
        raise AssertionError(f"built {lib}")

    monkeypatch.setattr(_build, "load", no_build)
    error, says = REFUSALS[what]
    with pytest.raises(error, match=says):
        getattr(moe_permute, name)(*_refused(name, what))
