"""The port's ring attention (``dr4sr_tpu_torch/ops/ring_attention.py``) on
n = 2 and 4 gloo ranks of the CPU, where each block runs the kernels' plain
forms (``flash_attention_fwd_reference`` and ``flash_attention_bwd_reference``
with the global LSE), held against:

* the JAX package's ``ring_attention`` on a CPU mesh of n virtual devices,
  and ``mha_reference`` (forward atol 2e-5, as tests/test_ring_attention.py);
* autograd through the port's ``mha_reference`` for dq, dk and dv (atol 1e-5);
* a fully padded row, whose output and gradients are 0.

The collective counter shows what travels: K, V and the padding mask go by
point-to-point sends (3 · (n − 1) a forward), the only all-gather of the
forward is the output's, and the backward's are dq, dk and dv. Leaving out
the backward's last send (dK and dV back to their owner) is caught.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from dr4sr_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from dr4sr_tpu.parallel.mesh import create_mesh
from dr4sr_tpu_torch.ops.attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
    mha_reference,
)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

B, H, L, DH = 3, 2, 16, 16


def _inputs(seed):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, H, L, DH)).astype(np.float32) for _ in range(4))
    pad = np.zeros((B, L), bool)
    pad[0, 11:] = True  # right padding, as SASRec's rows
    pad[1, :] = True  # a fully padded row
    pad[2, :3] = True  # left padding: a query chunk whose own block is all pad
    return q, k, v, pad, do


def _autograd_reference(q, k, v, pad, causal, do):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = mha_reference(qt, kt, vt, torch.tensor(pad), causal)
    o.backward(torch.tensor(do))
    return o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_autograd(tmp_path, n, causal):
    q, k, v, pad, do = _inputs(n)
    outs = w.run_ranks(w.ring, n, tmp_path, n, q, k, v, pad, causal, do)
    want = _autograd_reference(q, k, v, pad, causal, do)
    mesh = create_mesh(data=1, model=n, devices=jax.devices()[:n])
    jax_o = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pad), causal, mesh=mesh,
                                          axis_name="model"))
    for o, dq, dk, dv, fwd, bwd in outs:
        np.testing.assert_allclose(o, jax_o, atol=2e-5)
        np.testing.assert_allclose(o, want[0], atol=2e-5)
        for got, ref in zip((dq, dk, dv), want[1:]):
            np.testing.assert_allclose(got, ref, atol=1e-5)
        # the fully padded row: 0 out, 0 gradients
        assert not o[1].any() and not dq[1].any()
        # what travels: K, V and the mask by sends; one all-gather, of o
        o_bytes = B * H * L * DH * 4
        assert fwd["send:model"]["calls"] == 3 * (n - 1)
        assert fwd["all_gather:model"] == {"calls": 1, "bytes": o_bytes}
        # backward: 5 sends a rotation, 2 home, and all-gathers of dq, dk, dv
        assert bwd["send:model"]["calls"] == 5 * (n - 1) + 2
        assert bwd["all_gather:model"] == {"calls": 3, "bytes": 3 * o_bytes}
    for got in outs[1:]:  # every rank holds the same output and gradients
        for a, b in zip(got[:4], outs[0][:4]):
            np.testing.assert_array_equal(a, b)


def test_ring_without_its_last_send_is_caught(tmp_path):
    q, k, v, pad, do = _inputs(5)
    outs = w.run_ranks(w.ring_fault_last_rotation, 2, tmp_path, 2, q, k, v, pad, True, do)
    want = _autograd_reference(q, k, v, pad, True, do)
    np.testing.assert_allclose(outs[0][0], want[0], atol=2e-5)  # the forward is untouched
    assert np.abs(outs[0][2] - want[2]).max() > 1e-2  # dK went to the wrong rank


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_forms_with_the_lse(causal):
    """The forward's plain form returns mha_reference's output and the
    row LSE (+inf on a fully masked row); the backward's, given the LSE of
    the whole row, gives each block of keys its share of the gradients."""
    q, k, v, pad, do = _inputs(7)
    qt, kt, vt, padt, dot = (torch.tensor(x) for x in (q, k, v, pad, do))
    o, lse = flash_attention_fwd_reference(qt, kt, vt, padt, causal)
    np.testing.assert_array_equal(o.numpy(), mha_reference(qt, kt, vt, padt, causal).numpy())
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) / DH ** 0.5
    invalid = padt[:, None, None, :].expand(B, H, L, L)
    if causal:
        invalid = invalid | torch.ones(L, L, dtype=torch.bool).triu(1)
    want = torch.logsumexp(s.masked_fill(invalid, -torch.inf), dim=-1)
    want = torch.where(torch.isneginf(want), torch.inf, want)  # no key: +inf
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)
    assert torch.isposinf(lse[1]).all()
    whole = flash_attention_bwd_reference(qt, kt, vt, o, dot, padt, causal)
    with_lse = flash_attention_bwd_reference(qt, kt, vt, o, dot, padt, causal, lse=lse)
    for a, b in zip(whole, with_lse):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # two key blocks of the non-causal row, each with the whole row's LSE:
    # dq sums over them, dk and dv are each block's own rows
    if not causal:
        half = L // 2
        parts = [flash_attention_bwd_reference(qt, kt[:, :, sl].contiguous(),
                                               vt[:, :, sl].contiguous(), o, dot,
                                               padt[:, sl].contiguous(), False, lse=lse)
                 for sl in (slice(0, half), slice(half, L))]
        np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(), whole[0].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(torch.cat([parts[0][1], parts[1][1]], 2).numpy(),
                                   whole[1].numpy(), atol=1e-5)
