"""``decode_dataset``'s CUDA graphs (``regen/decode.py::_DecodeGraphs``,
through ``ops/graphs.py``) against the eager batch function on the card, to
the bit.

The graphed path runs only on a CUDA device, so these tests are marked
``card`` and skip without one. They import no JAX and read no fixture of
``conftest.py``; on a card's machine, which has no JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graphs.py -q

The eager reference is :func:`eager_decode`: ``decode_dataset``'s loop
with :func:`greedy_decode_batch_cached` called batch by batch, the same
draws from a generator seeded alike. The graphs replay the same kernels
in the same order, so every token must be equal.
"""

import copy
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.ops.graphs import CudaGraphs
from dr4sr_tpu_torch.regen import decode
from dr4sr_tpu_torch.regen.generator import Generator
from dr4sr_tpu_torch.utils.spans import SPANS

pytestmark = pytest.mark.card

NUM_ITEMS, K, MAX_LEN, MAX_SRC, BATCH = 3000, 3, 25, 52, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def generator(card):
    return Generator(NUM_ITEMS, k=K, embed_dim=64, num_heads=2, num_layers=2, ffn_dim=256,
                     dropout=0.5, generator=torch.Generator().manual_seed(0)).to(card)


def sequences(n, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, NUM_ITEMS + 1, size=int(rng.integers(1, 60))))
            for _ in range(n)]


def eager_decode(generator, seqs, gamma=0.0, seed=0, precision="fp32"):
    """``decode_dataset`` batch by batch through the eager function."""
    if precision == "bf16":
        generator = copy.deepcopy(generator).to(torch.bfloat16)
    device = generator.item_embedding.weight.device
    rng = torch.Generator(device=device).manual_seed(seed)
    src_all = decode.frame_sources(seqs, generator, MAX_SRC)
    out = []
    for cond in range(K):
        for start in range(0, len(seqs), BATCH):
            chunk = src_all[start:start + BATCH]
            real = len(chunk)
            chunk = np.concatenate([chunk, np.zeros((BATCH - real, MAX_SRC), np.int64)])
            src = torch.from_numpy(chunk).to(device)
            condition = torch.full((BATCH,), cond, dtype=torch.long, device=device)
            draws = decode._lane_draws(gamma, None, rng, MAX_LEN - 1, BATCH, device)
            buf = decode.greedy_decode_batch_cached(generator, src, condition, MAX_LEN, gamma,
                                                    draws=draws)
            body = buf[:real, 1:].cpu().numpy()
            stop = (body == generator.eos) | (body == 0)
            first = np.where(stop.any(1), stop.argmax(1), body.shape[1])
            out.extend(body[i, :first[i]].tolist() for i in range(real))
    return out


def graphed(generator, seqs, gamma=0.0, seed=0, precision="fp32"):
    return decode.decode_dataset(generator, seqs, K, batch_size=BATCH, max_len=MAX_LEN,
                                 max_src=MAX_SRC, gamma=gamma, seed=seed, precision=precision)


@pytest.fixture
def captures(monkeypatch):
    """The number of captures made, as a one-element list."""
    count = [0]
    capture = CudaGraphs.capture

    def counted(self, *args):
        count[0] += 1
        return capture(self, *args)

    monkeypatch.setattr(CudaGraphs, "capture", counted)
    return count


def launches(fn):
    """``fn()`` and the attention kernels' (forward, backward) launches it
    counted."""
    before = attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches
    out = fn()
    return out, (attention.flash_attention_fwd.launches - before[0],
                 attention.flash_attention_bwd.launches - before[1])


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_graphed_tokens_and_launches_equal_eager(generator, captures, gamma):
    """Two and a half batches under each of K conditions: the first eager,
    the second captured, the rest replayed, the last one padded; the
    tokens and the forward kernel's launch count are the eager path's."""
    seqs = sequences(BATCH * 2 + 100, seed=1)
    want, want_launches = launches(lambda: eager_decode(generator, seqs, gamma, seed=7))
    got, got_launches = launches(lambda: graphed(generator, seqs, gamma, seed=7))
    assert got == want
    assert got_launches == want_launches == (3 * K * 2, 0)  # two encoder layers a batch
    assert captures[0] == 1


def test_two_calls_replay_one_capture(generator, captures):
    """The graphs outlive a call: a second call on the same generator
    replays every batch, recording ``regen.replay`` and ``regen.collect``
    a batch and no eager span."""
    seqs = sequences(BATCH, seed=2)
    assert graphed(generator, seqs) == eager_decode(generator, seqs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = graphed(generator, seqs)
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.name in SPANS]
    assert names == ["regen.replay", "regen.collect"] * K
    assert got == eager_decode(generator, seqs)
    assert captures[0] == 1


def test_in_place_weight_change_is_seen(generator, captures):
    seqs = sequences(BATCH * 2, seed=3)
    graphed(generator, seqs)
    with torch.no_grad():
        generator.item_embedding.weight.mul_(-1.5)
        generator.decoder.layers[0].ffn1.weight.add_(0.05)
    assert graphed(generator, seqs) == eager_decode(generator, seqs)
    assert captures[0] == 1


def test_rebound_parameter_recaptures(generator, captures):
    seqs = sequences(BATCH * 2, seed=4)
    graphed(generator, seqs)
    layer = generator.encoder.layers[1].ffn2
    layer.weight = torch.nn.Parameter(layer.weight.detach() * 3.0)
    assert graphed(generator, seqs) == eager_decode(generator, seqs)
    assert captures[0] == 2


def test_bf16_copy_is_graphed(generator, captures):
    """``precision='bf16'`` decodes a fresh copy each call: it captures
    once a call, at the copy's second batch, and keeps no graph alive
    after the call."""
    seqs = sequences(BATCH * 2, seed=5)
    for _ in range(2):
        assert graphed(generator, seqs, precision="bf16") == eager_decode(generator, seqs,
                                                                          precision="bf16")
    assert captures[0] == 2
    gc.collect()
    assert all(g.item_embedding.weight.dtype == torch.float32 for g in decode._GRAPHS.keys())
