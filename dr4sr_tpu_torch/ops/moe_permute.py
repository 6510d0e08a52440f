"""The MoE layer's rows between token order and expert-group order: the plain
PyTorch chain and the CUDA kernels' wrappers.

``modules/moe.py::DeepSeekMoE`` sorts its N·k (token, slot) assignments by
held expert: row i of the sorted buffer [N·k, D] is assignment ``order[i]``
(token ``order[i] // k``), assignment a sits in row ``back[a]`` (the
inverse permutation), and the rows from ``ends[-1]`` on belong to no group
(pads, experts held elsewhere).

* :func:`dispatch_rows` — xs [N·k, D] in the compute dtype, xs[i] =
  x[order[i] // k] for i < ``ends[-1]``.
* :func:`combine_rows` — y [N, D] f32, y[t] = Σ_j ys[back[t·k + j]] over
  the token's slots in rows before ``ends[-1]``, summed in f32.

A CPU tensor takes the plain chain (:func:`dispatch_rows_plain`,
:func:`combine_rows_plain`: index_select, a where that zeroes the rows past
the last group, the inverse gather and the k-sum) under plain autograd. A
CUDA tensor takes the kernels (``csrc/moe_permute.cu``) through an
``autograd.Function`` each, or the call raises: the dispatch's forward and
the combine's backward scatter each token's row to its live rows
(``scatter_rows``), the combine's forward and the dispatch's backward sum
each token's live rows in f32 (``sum_rows``). There the rows from
``ends[-1]`` on are neither written (xs and the combine's gradient come
from ``torch.empty``) nor read, so no value of them reaches an output or a
gradient; the gradient of x is summed in f32 in a fixed order, with no
atomics. ``dispatch_rows.launches`` and ``combine_rows.launches`` count
each wrapper's kernel launches, forward and backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dr4sr_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int]  # in, in_bf16
    + [ctypes.c_void_p] * 2  # back, last_end
    + [ctypes.c_void_p, ctypes.c_int]  # out, out_bf16
    + [ctypes.c_int] * 4  # tokens, k, dim, max_blocks
    + [ctypes.c_void_p]  # stream
)
BLOCKS_PER_SM = 8  # 8 blocks of 256 threads fill an SM's 2,048


def _live(ends: torch.Tensor, rows: int) -> torch.Tensor:
    return (torch.arange(rows, device=ends.device) < ends[-1])[:, None]


def dispatch_rows_plain(x: torch.Tensor, order: torch.Tensor, k: int, ends: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """x [N, D] → xs [N·k, D] in ``dtype``: row i is x[order[i] // k] below
    ``ends[-1]``, 0 from there on."""
    return torch.where(_live(ends, order.numel()), x.to(dtype).index_select(0, order // k), 0)


def combine_rows_plain(ys: torch.Tensor, back: torch.Tensor, k: int,
                       ends: torch.Tensor) -> torch.Tensor:
    """ys [N·k, D] → y [N, D] f32: each token's k rows (0 from ``ends[-1]``
    on), back in (token, slot) order, summed in f32."""
    ys = torch.where(_live(ends, ys.shape[0]), ys, 0).index_select(0, back)
    return ys.view(-1, k, ys.shape[-1]).sum(dim=1, dtype=torch.float32)


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("moe_permute"), symbol)
    fn.argtypes = list(_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_blocks(device: torch.device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _checked(src: torch.Tensor, back: torch.Tensor, k: int, ends: torch.Tensor,
             dtype: torch.dtype, name: str, src_rows_per_token: int) -> int:
    """Validate what the kernels take (``src`` of ``src_rows_per_token``
    rows a token); return the token count N."""
    if src.dtype not in DTYPES or dtype not in DTYPES:
        raise TypeError(f"{name} takes and gives float32 or bfloat16, got {src.dtype} → {dtype}")
    if src.dim() != 2 or src.shape[1] % 8:
        raise ValueError(f"{name} takes rows [rows, D] with D a multiple of 8, got "
                         f"{tuple(src.shape)}")
    if k < 1 or back.dtype != torch.int64 or back.dim() != 1 or back.numel() % k:
        raise ValueError(f"back must be int64 [N·k] with k ≥ 1, got {back.dtype} "
                         f"{tuple(back.shape)} at k {k}")
    if ends.dtype != torch.int32 or ends.dim() != 1 or ends.numel() == 0:
        raise ValueError(f"ends must be a non-empty int32 vector, got {ends.dtype} "
                         f"{tuple(ends.shape)}")
    if back.numel() >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 rows, got {back.numel()}")
    tokens = back.numel() // k
    if src.shape[0] != tokens * src_rows_per_token:
        raise ValueError(f"{name} takes {src_rows_per_token} row(s) a token, got "
                         f"{src.shape[0]} rows for back of {tokens}·{k}")
    for t, what in ((src, "the rows"), (back, "back"), (ends, "ends")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if src.data_ptr() % 16:
        raise ValueError(f"{name}: the rows must start on a 16-byte boundary")
    if src.device.type != "cuda" or back.device != src.device or ends.device != src.device:
        raise ValueError(f"{name} takes CUDA tensors on one device, got the rows on "
                         f"{src.device}, back on {back.device}, ends on {ends.device}")
    return tokens


def _launch(symbol: str, src: torch.Tensor, back: torch.Tensor, k: int, ends: torch.Tensor,
            out: torch.Tensor, tokens: int) -> None:
    with torch.cuda.device(src.device):
        err = _entry(symbol)(
            src.data_ptr(), int(src.dtype == torch.bfloat16), back.data_ptr(),
            ends.data_ptr() + 4 * (ends.numel() - 1), out.data_ptr(),
            int(out.dtype == torch.bfloat16), tokens, k, src.shape[1], _max_blocks(src.device),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")


def scatter_rows(src: torch.Tensor, back: torch.Tensor, k: int, ends: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The kernel ``scatter_rows``, no autograd: out [N·k, D] in ``dtype``,
    out[back[t·k + j]] = src[t] (src [N, D]) for rows before ``ends[-1]``;
    rows from there on are left as ``torch.empty`` made them. One launch,
    none for N 0."""
    tokens = _checked(src, back, k, ends, dtype, "scatter_rows", 1)
    out = torch.empty(back.numel(), src.shape[1], dtype=dtype, device=src.device)
    if tokens:
        _launch("dr4sr_moe_scatter_rows", src, back, k, ends, out, tokens)
    return out


def sum_rows(src: torch.Tensor, back: torch.Tensor, k: int, ends: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The kernel ``sum_rows``, no autograd: out [N, D] in ``dtype``, out[t]
    = Σ_j src[back[t·k + j]] (src [N·k, D]) over rows before ``ends[-1]``,
    in f32 in the order of j; rows from there on are never read. One
    launch, none for N 0."""
    tokens = _checked(src, back, k, ends, dtype, "sum_rows", k)
    out = torch.empty(tokens, src.shape[1], dtype=dtype, device=src.device)
    if tokens:
        _launch("dr4sr_moe_sum_rows", src, back, k, ends, out, tokens)
    return out


def _grad(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return g.to(dtype).contiguous()


class _DispatchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, back, k, ends, dtype):
        ctx.save_for_backward(back, ends)
        ctx.k, ctx.x_dtype, ctx.dtype = k, x.dtype, dtype
        xs = scatter_rows(x, back, k, ends, dtype)
        dispatch_rows.launches += int(x.shape[0] > 0)
        return xs

    @staticmethod
    def backward(ctx, dxs):
        back, ends = ctx.saved_tensors
        dx = sum_rows(_grad(dxs, ctx.dtype), back, ctx.k, ends, ctx.x_dtype)
        dispatch_rows.launches += int(dx.shape[0] > 0)
        return dx, None, None, None, None


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ys, back, k, ends):
        ctx.save_for_backward(back, ends)
        ctx.k, ctx.ys_dtype = k, ys.dtype
        y = sum_rows(ys, back, k, ends, torch.float32)
        combine_rows.launches += int(y.shape[0] > 0)
        return y

    @staticmethod
    def backward(ctx, dy):
        back, ends = ctx.saved_tensors
        dys = scatter_rows(_grad(dy, torch.float32), back, ctx.k, ends, ctx.ys_dtype)
        combine_rows.launches += int(back.numel() > 0)
        return dys, None, None, None


def dispatch_rows(x: torch.Tensor, order: torch.Tensor, back: torch.Tensor, k: int,
                  ends: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [N, D] → xs [N·k, D] in ``dtype``: row i is x[order[i] // k] for i <
    ``ends[-1]``. ``back`` is ``order``'s inverse permutation. CPU: the
    plain chain (rows from ``ends[-1]`` on are 0); CUDA: the kernels (those
    rows are undefined and take no gradient); else raises."""
    if x.device.type == "cpu":
        return dispatch_rows_plain(x, order, k, ends, dtype)
    return _DispatchRows.apply(x, back, k, ends, dtype)


dispatch_rows.launches = 0  # kernel launches, forward and backward, since the last reset


def combine_rows(ys: torch.Tensor, back: torch.Tensor, k: int,
                 ends: torch.Tensor) -> torch.Tensor:
    """ys [N·k, D] → y [N, D] f32: y[t] = Σ_j ys[back[t·k + j]] over the
    rows before ``ends[-1]``, in f32. CPU: the plain chain; CUDA: the
    kernels (rows from ``ends[-1]`` on are never read); else raises."""
    if ys.device.type == "cpu":
        return combine_rows_plain(ys, back, k, ends)
    return _CombineRows.apply(ys, back, k, ends)


combine_rows.launches = 0  # kernel launches, forward and backward, since the last reset
