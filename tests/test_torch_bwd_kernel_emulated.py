"""The backward kernel's CUDA source (``csrc/flash_attention_bwd.cu``) run on
the CPU, against ``flash_attention_bwd_reference`` and against the JAX
package's Pallas backward in interpret mode.

The source is compiled by ``g++`` against the emulation of
``tests/test_torch_fwd_kernel_emulated.py`` (one ``std::thread`` per CUDA
thread, warp shuffles, ``ldmatrix`` and ``mma.sync`` from the PTX fragment
layouts, f32 atomics). This holds the kernels' indexing on the CPU: the
fragments of all five products, the permuted reduction index of the TF32
products, the dSᵀ round trip through shared memory, masks, causal tile
skipping, zero-filled rows and keys, the one-tile route of the train path
and the multi-tile route. The card's own arithmetic and speed are
``chip_smoke.py``'s to check.

Tolerances: against the plain version, the kernel's own (``chip_smoke.py``):
f32 atol 3e-4, bf16 8e-2; against the Pallas backward, those of
``tests/test_torch_attention_bwd.py``: f32 1e-5, bf16 2e-2.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from dr4sr_tpu_torch.ops import _build, attention
from dr4sr_tpu_torch.ops.attention import flash_attention_bwd_reference, mha_reference
from test_torch_fwd_kernel_emulated import _lse_reference, emulated_library

ATOL = {torch.float32: 3e-4, torch.bfloat16: 8e-2}
VS_PALLAS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def emulated_bwd(tmp_path_factory):
    """The entry point of the kernel library built from the package's source."""
    lib = emulated_library(_build.source_path("flash_attention_bwd"),
                           tmp_path_factory.mktemp("emulated_bwd"))
    fn = lib.dr4sr_flash_attention_bwd
    fn.argtypes = list(attention._BWD_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _call(fn, q, k, v, o, do, lse, pad, causal):
    """(dq, dk, dv) from the emulated kernels, and what the entry point
    returned: the kernels it launched, or minus an error."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    # every output element must be written, and no scratch read before it is
    scratch = torch.full((b, h, lq), float("nan"))
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    ret = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), None if pad is None else pad.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, h, lq, lk, dh, int(causal),
             int(q.dtype == torch.bfloat16), None)
    return (dq, dk, dv), ret


def _run(fn, q, k, v, o, do, lse, pad, causal):
    """(dq, dk, dv) from the emulated kernels, and the number they launched."""
    grads, kernels = _call(fn, q, k, v, o, do, lse, pad, causal)
    assert kernels >= 0, f"cudaError_t {-kernels}"
    return grads, kernels


# (dtype, B, H, Lq, Lk, Dh, causal): the train shape cut in batch (one key
# tile); several key and query tiles, causal; Lq != Lk with one and with
# several key tiles; Dh 16 and 128 (32-row query tiles) in one and several
# key tiles. Each with a key-padding mask; the train shape also without.
CASES = [
    (torch.float32, 2, 2, 50, 50, 32, True),
    (torch.bfloat16, 2, 2, 50, 50, 32, True),
    (torch.float32, 1, 1, 150, 150, 16, True),
    (torch.bfloat16, 1, 1, 150, 150, 64, True),
    (torch.float32, 2, 1, 20, 50, 32, False),
    (torch.bfloat16, 2, 1, 40, 100, 32, False),
    (torch.bfloat16, 2, 1, 100, 100, 16, True),
    (torch.float32, 1, 1, 40, 70, 128, False),
    (torch.bfloat16, 2, 1, 40, 40, 128, True),
]


def _case_id(case):
    dtype, *dims, causal = case
    return f"{str(dtype)[6:]}-{'x'.join(map(str, dims))}-{'causal' if causal else 'full'}"


def _inputs(case, seed):
    """q, k, v, dO (numpy-seeded) in the case's dtype and a key-padding
    mask whose first batch row, when there are two, is fully masked."""
    dtype, b, h, lq, lk, dh, causal = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, n, dh)).astype(np.float32))
                   .to(dtype) for n in (lq, lk, lk, lq))
    seqlen = np.array([0, lk - 7] if b > 1 else [lk - 7])
    pad = torch.from_numpy(np.arange(lk)[None, :] >= seqlen[:, None])
    return q, k, v, do, pad


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_the_plain_version(emulated_bwd, case):
    dtype, b, h, lq, lk, dh, causal = case
    q, k, v, do, pad = _inputs(case, lq * dh)
    for mask in (pad, None) if lq == lk == 50 else (pad,):
        o = mha_reference(q, k, v, mask, causal)
        lse = _lse_reference(q.float(), k.float(), mask, causal)
        got, kernels = _run(emulated_bwd, q, k, v, o, do, lse, mask, causal)
        want = flash_attention_bwd_reference(q, k, v, o, do, mask, causal)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            assert (g.float() - w.float()).abs().max().item() <= ATOL[dtype]
        if mask is pad and b > 1:  # the fully masked batch row has no gradient at all
            assert all((g[0] == 0).all() for g in got)
        assert kernels == (1 if lk <= 64 else 2)


def test_one_key_tile_is_one_launch(emulated_bwd):
    """The entry point returns the kernels it launched: one when the key axis
    fits one 64-key tile (the train path's L = 50, also under a longer query
    axis), two for a longer key axis, none without rows or keys (zeros); a
    head dim it does not take is an error. The scratch is read only in the
    two-kernel route, so a NaN there fails the one-kernel cases."""
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk, dh, want in ((50, 50, 16, 1), (50, 50, 128, 1), (80, 64, 32, 1),
                                 (20, 65, 32, 2)):
            case = (dtype, 1, 1, lq, lk, dh, True)
            q, k, v, do, pad = _inputs(case, lq + lk)
            o = mha_reference(q, k, v, pad, True)
            lse = _lse_reference(q.float(), k.float(), pad, True)
            got, kernels = _run(emulated_bwd, q, k, v, o, do, lse, pad, True)
            assert kernels == want
            want_grads = flash_attention_bwd_reference(q, k, v, o, do, pad, True)
            for g, w in zip(got, want_grads):
                assert (g.float() - w.float()).abs().max().item() <= ATOL[dtype]
        for lq, lk in ((50, 0), (0, 50)):
            q, k, v, o, do = (torch.ones(1, 1, n, 32, dtype=dtype) for n in (lq, lk, lk, lq, lq))
            lse = torch.full((1, 1, lq), float("inf"))
            got, kernels = _run(emulated_bwd, q, k, v, o, do, lse, None, True)
            assert kernels == 0 and all((g == 0).all() for g in got)
    q = torch.ones(1, 1, 50, 48)
    _, ret = _call(emulated_bwd, q, q, q, q, q, torch.zeros(1, 1, 50), None, True)
    assert ret < 0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_the_jax_kernel(emulated_bwd, case):
    """The kernel against the Pallas backward it replaces, on the same
    numpy-seeded q, k, v, o, dO and mask; the kernel's lse is a float64
    log-sum-exp of the masked scores."""
    dtype, b, h, lq, lk, dh, causal = case
    q, k, v, do, pad = _inputs(case, lq * dh + 1)
    o = mha_reference(q.float(), k.float(), v.float(), pad, causal).to(dtype)
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_flash_bwd(*(jnp.asarray(x.float().numpy(), jax_dtype) for x in (q, k, v, o, do)),
                         jnp.asarray(pad.numpy()), causal=causal, interpret=True)
    lse = _lse_reference(q.float(), k.float(), pad, causal)
    got, _ = _run(emulated_bwd, q, k, v, o, do, lse, pad, causal)
    for g, w in zip(got, want):
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()
        assert err <= VS_PALLAS[dtype]
