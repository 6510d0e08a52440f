"""``ops/graphs.py::CudaGraphs``, the CUDA-graph protocol that training,
decoding and serving share, on the CPU with fakes for torch's CUDA graph,
its capture and the stream calls:

* a capture registers the given generators, runs with garbage collection
  off (on again after it) and errors on this thread's unsafe calls only;
  what it counted (the attention and MoE row kernels' launches, the
  collectives' calls and bytes) is taken back out, and every replay adds
  it once;
* each key runs eagerly on the side stream, then is captured, then
  replayed; keys that share a warm key (a trainer's kind at every group
  length) capture at once;
* ``watch`` keeps the graphs when a weight changes in place and drops them
  when a parameter, buffer or submodule is rebound, and holds its module
  weakly.
"""

import contextlib
import gc
import glob
import os
import weakref

import pytest
import torch

from dr4sr_tpu_torch.ops import attention, graphs
from dr4sr_tpu_torch.ops.graphs import LAUNCH_COUNTED, CudaGraphs
from dr4sr_tpu_torch.ops.moe_permute import combine_rows, dispatch_rows
from dr4sr_tpu_torch.parallel.collectives import COUNTER, Axis


class FakeStream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append(f"{self.name} waits on {other.name}")


@pytest.fixture
def cuda_fakes(monkeypatch):
    """The stream calls, the pool, torch's CUDA graph and its capture
    replaced by fakes that log what they are asked; the log."""
    log = []
    current = FakeStream("current", log)

    class FakeGraph:
        def register_generator_state(self, generator):
            log.append("registered")

        def replay(self):
            log.append("replay")

    @contextlib.contextmanager
    def on_stream(stream):
        log.append(f"on {stream.name}")
        yield

    @contextlib.contextmanager
    def fake_capture(graph, pool=None, stream=None, capture_error_mode="global"):
        log.append(f"capture on {stream.name}")
        yield

    monkeypatch.setattr(torch.cuda, "Stream", lambda device: FakeStream("side", log))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current)
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    return log


def test_capture_without_garbage_collection_and_its_counts_taken_back(cuda_fakes, monkeypatch):
    """``CudaGraphs.capture`` with torch's CUDA graph replaced by a fake:
    the trainer's generator is registered before the capture; no garbage
    collection runs during it (one that frees a graph left in a reference
    cycle invalidates the capture) and collection is back on after it; the
    attention counters lose what the captured steps counted, which the
    replays add instead."""
    seen = {}

    class FakeGraph:
        def register_generator_state(self, generator):
            seen["registered"] = generator

    @contextlib.contextmanager
    def fake_capture(graph, pool=None, stream=None, capture_error_mode="global"):
        seen["capture_error_mode"] = capture_error_mode
        seen["collecting during capture"] = gc.isenabled()
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    runner = CudaGraphs("cpu", generators=(torch.Generator(),))
    before = (attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches)

    def step(batch):  # counts as the kernels' wrappers count
        attention.flash_attention_fwd.launches += 2
        attention.flash_attention_bwd.launches += 2
        return batch["x"].sum()

    batches = [{"x": torch.full((2,), float(i))} for i in range(3)]
    runner.capture("group", lambda: torch.stack([step(b) for b in batches]))
    captured = runner.graphs["group"]
    assert seen == {"registered": runner.generators[0], "collecting during capture": False,
                    "capture_error_mode": "thread_local"}
    assert gc.isenabled()
    assert (attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches) == before
    assert captured.launches == {"flash_attention_fwd": 6, "flash_attention_bwd": 6}
    assert captured.outputs.tolist() == [0.0, 2.0, 4.0]


def test_collectives_counted_at_each_replay(cuda_fakes):
    """``CudaGraphs.capture`` and ``replay`` with torch's CUDA graph
    replaced by a fake: what the captured steps' collectives counted is
    taken back out of ``COUNTER``, and every replay adds it once."""
    runner = CudaGraphs("cpu", generators=(torch.Generator(),))
    data, model = Axis("data", None, 2, 0, (0, 1)), Axis("model", None, 2, 0, (0, 2))

    def step(batch):  # counts as the collectives count
        COUNTER.add("all_reduce", data, 40)
        COUNTER.add("send", model, 8)
        return batch["x"].sum()

    batches = [{"x": torch.full((2,), float(i))} for i in range(3)]
    COUNTER.reset()
    COUNTER.add("all_reduce", data, 4)  # before the capture: stays
    runner.capture("group", lambda: torch.stack([step(b) for b in batches]))
    captured = runner.graphs["group"]
    assert COUNTER.snapshot() == {"all_reduce:data": {"calls": 1, "bytes": 4}}
    assert captured.collectives == ({("all_reduce", "data"): 3, ("send", "model"): 3},
                                    {("all_reduce", "data"): 120, ("send", "model"): 24})
    for _ in range(2):
        assert runner.replay("group").tolist() == [0.0, 2.0, 4.0]
    assert cuda_fakes.count("replay") == 2
    assert COUNTER.snapshot() == {"all_reduce:data": {"calls": 7, "bytes": 244},
                                  "send:model": {"calls": 6, "bytes": 48}}
    COUNTER.reset()


def test_forward_only_capture_restores_every_counter(cuda_fakes):
    """Serving's case: a capture that counts forward launches only leaves
    the forward counter, the backward counter and ``COUNTER`` as they were;
    each replay adds its forward launches and nothing else."""
    runner = CudaGraphs("cpu")
    data = Axis("data", None, 2, 0, (0, 1))
    COUNTER.reset()
    COUNTER.add("all_reduce", data, 4)
    attention.flash_attention_bwd.launches += 3  # an earlier training step's
    before = (attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches)

    def score():
        attention.flash_attention_fwd.launches += 2
        return torch.ones(4), torch.arange(4)

    runner.capture((20, True), score)
    assert (attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches) == before
    assert COUNTER.snapshot() == {"all_reduce:data": {"calls": 1, "bytes": 4}}
    assert runner.graphs[(20, True)].launches == {"flash_attention_fwd": 2}
    assert runner.graphs[(20, True)].collectives == ({}, {})
    for _ in range(3):
        scores, items = runner.replay((20, True))
    assert (attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches) == (
        before[0] + 6, before[1])
    assert COUNTER.snapshot() == {"all_reduce:data": {"calls": 1, "bytes": 4}}
    assert items.tolist() == [0, 1, 2, 3]
    COUNTER.reset()


def test_moe_row_launches_counted_at_each_replay(cuda_fakes):
    """The MoE layer's row kernels (``ops/moe_permute.py``) as the attention
    kernels: what a capture counted is taken back out of
    ``dispatch_rows.launches`` and ``combine_rows.launches``, and each
    replay adds it once."""
    runner = CudaGraphs("cpu")
    dispatch_rows.launches += 5  # an earlier eager step's
    before = {name: f.launches for name, f in LAUNCH_COUNTED.items()}

    def layer():  # forward and backward, as the wrappers count them
        dispatch_rows.launches += 2
        combine_rows.launches += 2
        return torch.ones(2)

    runner.capture("step", layer)
    assert {name: f.launches for name, f in LAUNCH_COUNTED.items()} == before
    assert runner.graphs["step"].launches == {"dispatch_rows": 2, "combine_rows": 2}
    for _ in range(3):
        runner.replay("step")
    assert {name: f.launches for name, f in LAUNCH_COUNTED.items()} == {
        **before, "dispatch_rows": before["dispatch_rows"] + 6,
        "combine_rows": before["combine_rows"] + 6}


def test_each_key_warms_then_captures_then_replays(cuda_fakes):
    """A key's first call runs ``fn`` on the side stream, ordered after the
    current stream and before it; its second captures on the side stream
    and replays; later calls only replay, returning the captured outputs.
    Under a shared warm key the second group length of a warmed kind
    captures at its first call."""
    runner = CudaGraphs("cpu", generators=(torch.Generator(),))
    ran = []

    def fn(tag):
        def call():
            ran.append(tag)
            return torch.tensor(float(len(ran)))
        return call

    eager = runner.run("a", fn("a"))
    assert cuda_fakes == ["side waits on current", "on side", "current waits on side"]
    assert ran == ["a"] and eager.item() == 1.0 and not runner.graphs
    cuda_fakes.clear()
    captured = runner.run("a", fn("a"))
    assert cuda_fakes == ["registered", "capture on side", "replay"]
    cuda_fakes.clear()
    assert runner.run("a", fn("a")) is captured
    assert cuda_fakes == ["replay"] and ran == ["a", "a"]

    cuda_fakes.clear()
    runner.run(("train", 4), fn("train 4"), warm_key="train")
    runner.run(("train", 4), fn("train 4"), warm_key="train")
    runner.run(("train", 3), fn("train 3"), warm_key="train")
    runner.run(("train", 3), fn("train 3"), warm_key="train")
    assert ran[2:] == ["train 4", "train 4", "train 3"]
    assert cuda_fakes.count("on side") == 1 and cuda_fakes.count("replay") == 3
    assert cuda_fakes.count("capture on side") == 2
    assert set(runner.graphs) == {"a", ("train", 4), ("train", 3)}
    assert runner.warm == {"a", "train"}


def _module():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.BatchNorm1d(3))


def _in_place(m):
    with torch.no_grad():
        m[0].weight.mul_(-1.5)
        m[1].running_mean.add_(0.25)
    m.load_state_dict({k: v * 0.5 for k, v in m.state_dict().items()})


def _parameter(m):
    m[0].weight = torch.nn.Parameter(m[0].weight.detach() * 3.0)


def _buffer(m):
    m[1].running_var = m[1].running_var.clone()


def _submodule(m):
    m[0] = torch.nn.Linear(3, 3)


@pytest.mark.parametrize("change,drops", [(_in_place, False), (_parameter, True),
                                          (_buffer, True), (_submodule, True)],
                         ids=["in_place", "parameter", "buffer", "submodule"])
def test_watch_drops_the_graphs_only_on_a_rebinding(cuda_fakes, change, drops):
    """A weight changed in place keeps the graphs, which read it by
    address; a parameter, buffer or submodule rebound drops them all, and
    the next capture is watched against the new bindings. The warmed keys
    stay warm."""
    runner = CudaGraphs("cpu")
    module = _module()
    runner.watch(module)
    for key in ("a", "b"):
        runner.warm.add(key)
        runner.run(key, lambda: torch.zeros(1))
    change(module)
    runner.watch(module)
    assert set(runner.graphs) == (set() if drops else {"a", "b"})
    assert runner.warm == {"a", "b"}
    runner.run("a", lambda: torch.zeros(1))
    runner.watch(module)
    assert "a" in runner.graphs


def test_watch_another_module_drops_and_holds_it_weakly(cuda_fakes):
    """Watching another module drops the graphs; a watched module that is
    let go is collected (decoding keeps a generator's graphs in a weak
    dictionary keyed by the generator)."""
    runner = CudaGraphs("cpu")
    first, second = _module(), _module()
    runner.watch(first)
    runner.warm.add("a")
    runner.run("a", lambda: torch.zeros(1))
    runner.watch(second)
    assert not runner.graphs
    gone = weakref.ref(second)
    del second
    gc.collect()
    assert gone() is None
    runner.run("a", lambda: torch.zeros(1))
    runner.watch(first)
    assert not runner.graphs


def test_only_the_shared_module_captures():
    """Training, decoding and serving hold their graphs through
    ``CudaGraphs``: no other module of the package makes a graph, a pool or
    a capture, or turns garbage collection off."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(graphs.__file__)))
    found = []
    for path in sorted(glob.glob(os.path.join(package, "**", "*.py"), recursive=True)):
        if os.path.samefile(path, graphs.__file__):
            continue
        with open(path) as f:
            source = f.read()
        found += [(os.path.relpath(path, package), call) for call in
                  ("torch.cuda.graph(", "torch.cuda.CUDAGraph(", "graph_pool_handle(",
                   "gc.disable(") if call in source]
    assert found == []
    from dr4sr_tpu_torch import serve
    from dr4sr_tpu_torch.regen import decode
    from dr4sr_tpu_torch.train import fused

    assert serve.CudaGraphs is decode.CudaGraphs is fused.CudaGraphs is CudaGraphs
