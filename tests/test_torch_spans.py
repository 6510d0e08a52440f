"""The port's spans (``dr4sr_tpu_torch/utils/spans.py``) on the CPU.

* With no profiler ``span()`` is one shared null context.
* Under ``torch.profiler`` each loop records its spans with the counts its
  docstring states, in order, and never nested in each other: the
  trainer's epoch (``train.load``, ``train.stage``), ``Recommender.recommend``
  (``serve.batch``, ``serve.score``, ``serve.fetch`` a chunk) and
  ``decode_dataset`` on each decode path (``regen.encode``,
  ``regen.position`` a position, ``regen.collect`` a batch).
* Every ``span("...")`` in the package names a key of ``SPANS``, every key
  is used, and ``PERF.md`` names each key.
"""

import copy
import glob
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

from dr4sr_tpu_torch import serve
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.regen import decode
from dr4sr_tpu_torch.regen.generator import Generator
from dr4sr_tpu_torch.train.trainer import Trainer
from dr4sr_tpu_torch.utils import spans
from dr4sr_tpu_torch.utils.spans import SPANS, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "dr4sr_tpu_torch")
LITERAL = re.compile(r"\bspan\(\s*\"([^\"]*)\"\s*\)")
CALL = re.compile(r"\bspan\(")


def recorded(fn):
    """The names of the spans ``fn`` recorded under a CPU profiler, by start,
    after checking that no two of them overlap."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.name in SPANS))
    for (_, end, name), (start, _, after) in zip(events, events[1:]):
        assert end <= start, f"{name} overlaps {after}"
    return [name for _, _, name in events]


def _literals():
    """{path: [span names]} and {path: calls of span()} over the package."""
    found, calls = {}, {}
    for path in glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True):
        if path.endswith(os.path.join("utils", "spans.py")):
            continue
        with open(path) as f:
            text = f.read()
        if CALL.search(text):
            found[os.path.relpath(path, REPO)] = LITERAL.findall(text)
            calls[os.path.relpath(path, REPO)] = len(CALL.findall(text))
    return found, calls


FOUND, CALLS = _literals()


# ------------------------------------------------------------------- helper
@pytest.mark.parametrize("name", sorted(SPANS))
def test_no_profiler_is_the_shared_null_context(name):
    assert not torch.autograd._profiler_enabled()
    context = span(name)
    assert context is spans._OFF
    with context:
        pass
    assert span(name) is context


def test_a_span_under_a_profiler_is_recorded():
    def body():
        assert span("serve.batch") is not spans._OFF
        with span("serve.batch"):
            torch.ones(2).sum()
    assert recorded(body) == ["serve.batch"]


# ------------------------------------------------------------------ training
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans_data"))
    write_synthetic_dataset(path, num_users=150, num_items=40, seed=4)
    return path


@pytest.mark.parametrize("steps_per_dispatch", [1, 2, 3])
def test_training_epoch_spans(root, steps_per_dispatch):
    """``train.load`` G + 1 times for G groups; ``train.stage`` once for a
    group of one batch and twice for a longer one; each group's fetch before
    its stage."""
    cfg = synthetic_config()
    cfg["model"].update(embed_dim=16, hidden_size=32)
    cfg["train"].update(batch_size=32, steps_per_dispatch=steps_per_dispatch)
    trainer = Trainer(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu")
    trainer.init_state()
    n_batches = len(trainer.train_data.get_loader())
    assert n_batches >= 4 and n_batches % 2 == 1  # a leftover group of one at N = 2
    names = recorded(lambda: trainer.training_epoch(0))
    sizes = [min(steps_per_dispatch, n_batches - s) for s in range(0, n_batches,
                                                                    steps_per_dispatch)]
    want = []
    for size in sizes:
        want += ["train.load"] + ["train.stage"] * (1 if size == 1 else 2)
    assert names == want + ["train.load"]
    assert trainer.step == n_batches


# ------------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def server():
    cfg = synthetic_config(max_seq_len=10)
    cfg["model"].update(embed_dim=16, hidden_size=32)
    torch.manual_seed(0)
    module = SASRec.build(cfg, 30)
    return serve.Recommender(RecModel(cfg, module, 30, 1), module.state_dict(), batch_size=4,
                             device="cpu")


@pytest.mark.parametrize("n_histories", [1, 4, 9])
def test_recommend_spans(server, n_histories):
    rng = np.random.default_rng(n_histories)
    histories = [list(rng.integers(1, 30, size=int(rng.integers(1, 14))))
                 for _ in range(n_histories)]
    names = recorded(lambda: server.recommend(histories, k=5))
    chunks = -(-n_histories // 4)
    assert names == ["serve.batch", "serve.score", "serve.fetch"] * chunks


# ------------------------------------------------------------------ decoding
@pytest.fixture(scope="module")
def generator():
    torch.manual_seed(1)
    return Generator(40, k=2, embed_dim=16, num_heads=2, num_layers=2, ffn_dim=32,
                     dropout=0.0)


@pytest.mark.parametrize("path", [dict(), dict(use_kv_cache=False), dict(beam_width=3)],
                         ids=["cached", "uncached", "beam"])
def test_decode_dataset_spans(generator, path):
    """Per batch: ``regen.encode``, ``max_len - 1`` ``regen.position``s, then
    ``regen.collect``; 6 sources in batches of 4 under 2 conditions are 4
    batches."""
    rng = np.random.default_rng(2)
    sequences = [list(rng.integers(1, 40, size=int(rng.integers(1, 7)))) for _ in range(6)]
    max_len = 6
    names = recorded(lambda: decode.decode_dataset(generator, sequences, 2, batch_size=4,
                                                   max_len=max_len, max_src=10, **path))
    batch = ["regen.encode"] + ["regen.position"] * (max_len - 1) + ["regen.collect"]
    assert names == batch * 4
    assert names.count("regen.position") == 4 * (max_len - 1)


# --------------------------------------------------------------------- names
@pytest.mark.parametrize("path", sorted(FOUND))
def test_every_span_names_a_key(path):
    assert FOUND[path] and len(FOUND[path]) == CALLS[path], "span() takes a literal name"
    assert set(FOUND[path]) <= set(SPANS)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_every_key_is_used_and_in_perf_md(name):
    assert any(name in names for names in FOUND.values())
    with open(os.path.join(REPO, "PERF.md")) as f:
        assert f"`{name}`" in f.read()
