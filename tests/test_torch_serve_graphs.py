"""``Recommender.recommend``'s CUDA graphs (``serve.py``, through
``ops/graphs.py``) against the eager chain, to the bit, on the card; and on
the CPU, the eager path, which builds no graph.

The graphed path runs only on a CUDA device, so those tests are marked
``card`` and skip without one. The file imports no JAX and reads no
fixture of ``conftest.py``; on a card's machine, which has no JAX, run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_graphs.py -q

The eager reference is :func:`eager_recommend`: the chunk loop as it ran
before the graphs, fresh tensors a chunk through ``RecModel.topk`` on the
default stream. A replay runs the same kernels in the same order, so every
item and score must be equal.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dr4sr_tpu_torch import serve
from dr4sr_tpu_torch.data.synthetic import synthetic_config
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.fmlp import pre_pad_batch
from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.ops.graphs import CudaGraphs
from dr4sr_tpu_torch.utils.spans import SPANS

# every registered model that serves (GNN encodes through the graph, MetaModel is a trainer)
MODELS = ["SASRec", "FMLP", "GRU4Rec", "CL4SRec", "CL4SRec2", "ICLRec", "SGL", "SimGCL", "NCL",
          "DeepSeekV2Rec"]
ROPE = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
# DeepSeek-V2-Lite's block at its head sizes (the kernels' 192/128 in bf16), small elsewhere
MLA_MOE = dict(hidden_size=256, num_hidden_layers=3, first_k_dense_replace=1,
               intermediate_size=512, num_attention_heads=2, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128, kv_lora_rank=64, rms_norm_eps=1e-6,
               rope_theta=10000, rope_scaling=ROPE, n_routed_experts=16,
               n_routed_experts_held=4, expert_offset=4, num_experts_per_tok=6,
               moe_intermediate_size=128, n_shared_experts=2, norm_topk_prob=False,
               routed_scaling_factor=1.0)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
# the card's sizes: Toys' serving shape over a smaller catalog
NUM_ITEMS, L, BATCH, K = 3000, 50, 256, 20


def make_server(model, device, num_items=NUM_ITEMS, max_seq_len=L, batch_size=BATCH, seed=0):
    cfg = synthetic_config(max_seq_len=max_seq_len, model_name=model)
    if model == "DeepSeekV2Rec":
        cfg["model"].update(MLA_MOE)
        cfg["train"]["precision"] = "bf16"
    module = get_model_class(model).build(cfg, num_items,
                                          generator=torch.Generator().manual_seed(seed))
    return serve.Recommender(RecModel(cfg, module, num_items, 1), module.state_dict(),
                             batch_size=batch_size, device=device)


def histories(n, num_items=NUM_ITEMS, max_seq_len=L, seed=0):
    """``n`` histories of 0 to ``max_seq_len`` + 10 items: empty ones, and
    some longer than the model reads."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, num_items, size=int(rng.integers(0, max_seq_len + 11))).tolist()
            for _ in range(n)]


@torch.inference_mode()
def eager_recommend(server, hists, k, exclude_seen=True):
    """The chunk loop before the graphs: each chunk padded into fresh
    arrays, copied to the device and scored by ``RecModel.topk``."""
    b, max_len, device = server.batch_size, server.max_seq_len, server.device
    k = min(k, server.rec.num_items)
    items, scores = [], []
    for start in range(0, len(hists), b):
        chunk = hists[start:start + b]
        seq = np.zeros((b, max_len), np.int64)
        seqlen = np.ones(b, np.int64)
        for i, h in enumerate(chunk):
            h = list(h)[-max_len:]
            seq[i, :len(h)] = h
            seqlen[i] = max(len(h), 1)
        seq_t = torch.from_numpy(seq).to(device)
        batch = {"in_item_id": seq_t, "seqlen": torch.from_numpy(seqlen).to(device),
                 "user_hist": seq_t if exclude_seen
                 else torch.zeros((b, 1), dtype=torch.int64, device=device)}
        if server.pre_padding:
            pre = pre_pad_batch({"in_item_id": seq, "seqlen": seqlen})["in_item_id"]
            batch["in_item_id"] = torch.from_numpy(pre).to(device)
        s, i = server.rec.topk(batch, k, item_keep_mask=server.keep_mask)
        items.append(i[:len(chunk)].cpu().numpy())
        scores.append(s[:len(chunk)].cpu().numpy())
    return np.concatenate(items), np.concatenate(scores)


def assert_bitwise(got, want):
    (got_i, got_s), (want_i, want_s) = got, want
    assert got_i.dtype == np.int64 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))


def serve_spans(fn):
    """The ``serve.*`` spans ``fn()`` records, in order (a MoE encoder's
    ``moe.*`` spans lie inside ``serve.score``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.name in SPANS and e.name.startswith("serve.")]


# ----------------------------------------------------------------------- CPU
@pytest.mark.parametrize("model", MODELS)
def test_cpu_serves_eagerly_and_builds_no_graph(model, monkeypatch):
    """On the CPU every chunk of every call runs eagerly, as before the
    graphs, whatever the key and however often it is seen, and records
    ``serve.batch``, ``serve.score``, ``serve.fetch`` a chunk."""

    def refused(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refused)
    monkeypatch.setattr(serve, "CudaGraphs", refused)
    server = make_server(model, "cpu", num_items=40, max_seq_len=10, batch_size=4)
    hists = histories(9, num_items=40, max_seq_len=10, seed=1)  # three chunks, the last of one
    for k, exclude_seen in [(5, True), (5, True), (50, False), (5, True)]:
        got = {}
        names = serve_spans(lambda: got.update(out=server.recommend(hists, k, exclude_seen)))
        assert names == ["serve.batch", "serve.score", "serve.fetch"] * 3
        assert_bitwise(got["out"], eager_recommend(server, hists, k, exclude_seen))
    assert got["out"][0].shape == (9, 5)


# ---------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


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


@pytest.mark.card
@pytest.mark.parametrize("model", MODELS)
def test_graphed_equals_eager(card, captures, model):
    """Two and a half chunks: the first eager, the second captured, the
    last, partial, replayed; a second call replays all three. Every item
    and score is the eager loop's, for every model that serves: FMLP
    pre-padded, GRU4Rec through cuDNN, DeepSeekV2Rec in bf16 through the
    MLA kernels and the grouped expert products."""
    server = make_server(model, card)
    hists = histories(2 * BATCH + 100, seed=1)
    want = eager_recommend(server, hists, K)
    assert_bitwise(server.recommend(hists, K), want)
    assert captures[0] == 1
    assert_bitwise(server.recommend(hists, K), want)
    assert captures[0] == 1


@pytest.mark.card
def test_each_key_captures_once(card, captures):
    """``exclude_seen=False`` and another k are keys of their own: each
    runs one chunk eagerly, captures on its second, and replays after; a
    k past the catalog is the catalog's key."""
    server = make_server("SASRec", card)
    hists = histories(3 * BATCH, seed=2)
    keys = [(K, False), (5, True), (NUM_ITEMS + 7, True), (NUM_ITEMS, True)]
    for n, (k, exclude_seen) in enumerate(keys, start=1):
        want = eager_recommend(server, hists, k, exclude_seen)
        assert_bitwise(server.recommend(hists, k, exclude_seen), want)
        assert captures[0] == min(n, 3)
    assert sorted(server._graphs.graphs) == [(5, True), (K, False), (NUM_ITEMS, True)]


@pytest.mark.card
def test_one_shot_call_captures_nothing(card, captures):
    """A call of one chunk of a new key runs it eagerly, with no graph,
    as the MoE cell's check calls ``recommend`` once."""
    server = make_server("SASRec", card)
    hists = histories(BATCH - 3, seed=3)
    assert_bitwise(server.recommend(hists, K), eager_recommend(server, hists, K))
    assert captures[0] == 0 and not server._graphs.graphs


@pytest.mark.card
def test_in_place_weight_change_is_seen(card, captures):
    server = make_server("SASRec", card)
    hists = histories(2 * BATCH, seed=4)
    server.recommend(hists, K)
    module = server.rec.module
    with torch.no_grad():
        module.item_embedding.weight.mul_(-1.5)
        module.position_emb.weight.add_(0.05)
    assert_bitwise(server.recommend(hists, K), eager_recommend(server, hists, K))
    state = {name: t * 0.5 for name, t in module.state_dict().items()}
    module.load_state_dict(state)
    assert_bitwise(server.recommend(hists, K), eager_recommend(server, hists, K))
    assert captures[0] == 1


@pytest.mark.card
def test_rebound_parameter_recaptures(card, captures):
    server = make_server("SASRec", card)
    hists = histories(2 * BATCH, seed=5)
    server.recommend(hists, K)
    emb = server.rec.module.item_embedding
    emb.weight = torch.nn.Parameter(emb.weight.detach() * 3.0)
    assert_bitwise(server.recommend(hists, K), eager_recommend(server, hists, K))
    assert captures[0] == 2


@pytest.mark.card
def test_one_graph_launch_a_replayed_chunk(card, captures):
    """Once a key is captured, a chunk is one ``cudaGraphLaunch`` and no
    other launch; the attention kernel's counter still counts a launch a
    layer and chunk."""
    server = make_server("SASRec", card)
    hists = histories(3 * BATCH - 50, seed=6)
    server.recommend(hists, K)
    torch.cuda.synchronize()
    before = attention.flash_attention_fwd.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = server.recommend(hists, K)
        torch.cuda.synchronize()
    launches = [e.name for e in prof.events() if e.name in LAUNCH_CALLS]
    assert launches == ["cudaGraphLaunch"] * 3
    layers = int(server.rec.config["model"]["layer_num"])
    assert attention.flash_attention_fwd.launches - before == layers * 3
    assert_bitwise(got, eager_recommend(server, hists, K))
    assert captures[0] == 1
