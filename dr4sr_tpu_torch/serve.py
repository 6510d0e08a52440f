"""Serving: batched top-k recommendation on the card.

Port of ``dr4sr_tpu/serve.py::Recommender``: pad the histories into fixed
batches, encode them, score the whole catalog, mask PAD/seen items, top-k.
Any registered model serves but GNN, whose encoder reads the
item-transition graph (refused; SGL, SimGCL and NCL use the graph only in
their training loss and serve). For a ``pre_padding`` model (FMLP, whose query
is the last position) the histories are pre-padded, as its trainer's eval
batches are; the JAX ``Recommender`` right-pads them for every model, so it
serves FMLP from a padding position for any history shorter than
``max_seq_len``.

    rec = RecModel(config, SASRec.build(config, num_items), num_items, 0)
    server = Recommender(rec, rec.module.state_dict())          # on "cuda"
    items, scores = server.recommend([[12, 880, 43], [7, 7, 301]], k=10)

``params`` is a state_dict for ``rec.module`` (``convert.py`` makes one from
a JAX param tree). ``Recommender.from_checkpoint(path)`` rebuilds the model
from a checkpoint of this package or of the JAX package (flax msgpack, read
without the msgpack package) and its ``.json`` sidecar's config. An item
table with more rows than the module's (saved padded to a multiple of the
``model`` axis by an EP run) keeps its first rows, as ``convert.py`` keeps
a JAX one's; a table with fewer rows is refused by ``load_state_dict``.

Every chunk of a request is ``batch_size`` histories of ``max_seq_len``
items, the last one padded with empty histories. On a CUDA device a chunk
is scored by one replay of a CUDA graph that holds the whole chain: the
encoder's forward through the attention kernel, the catalog product, the
keep and seen masks and the top-k (:class:`_ChunkGraphs`). A graph's key is
(k', ``exclude_seen``); a key's first chunk runs eagerly, its second is
captured, and every later one replays the same kernels in the same order,
so the items and scores are the eager path's to the bit. A one-chunk call
of a new key captures nothing. On the CPU every chunk runs eagerly.

Under a ``torch.profiler`` session each chunk of a request carries three
spans (``utils/spans.py``): ``serve.batch`` (padding the histories into the
host buffers and copying them to the device), ``serve.score`` (the encoder's
forward and the masked top-k, or the graph's launch, enqueued) and
``serve.fetch`` (the copies back to numpy, which wait for the device).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.fmlp import pre_pad_batch
from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.train import checkpoint
from dr4sr_tpu_torch.utils.spans import span


def _unpadded(params: Mapping[str, torch.Tensor],
              module: torch.nn.Module) -> Mapping[str, torch.Tensor]:
    """``params`` with an item table padded by EP cut to the module's rows:
    no id reaches the padding."""
    rows = {k: v.shape[0] for k, v in module.state_dict().items()
            if k.endswith("item_embedding.weight")}
    return {k: v[: rows[k]] if k in rows and v.shape[0] > rows[k] else v
            for k, v in params.items()}


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    scores: torch.Tensor  # [batch_size, k'], rewritten by every replay
    items: torch.Tensor
    launches: int  # forward-kernel launches in one replay


class _ChunkGraphs:
    """CUDA graphs of one ``Recommender``'s chunks, a chunk one replay, as
    ``regen/decode.py::_DecodeGraphs`` holds a generator's batches:

    * a graph's key is (k', ``exclude_seen``): a chunk's rows and length are
      the ``Recommender``'s ``batch_size`` and ``max_seq_len``, and its
      device and ``pre_padding`` are fixed;
    * every graph reads the ``Recommender``'s static inputs, which
      ``serve.batch`` rewrites before each chunk;
    * a key's first chunk runs eagerly on the capture stream, which loads
      the kernels and makes cuBLAS's workspace there; its next chunk is
      captured once (nothing runs during capture) into the pool the keys
      share, and replayed, as is every later chunk of the key;
    * a graph reads the weights by address: in-place updates are seen, and
      a parameter, buffer or submodule rebound since the last call drops
      every graph (:meth:`watch`, a few µs a call);
    * the attention kernel's launch counter is what ran: capture's
      increments are taken back out, and each replay adds them once."""

    def __init__(self, module: torch.nn.Module, device: torch.device) -> None:
        self.module = module
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Captured] = {}
        self.warm: set = set()
        self._bind()

    def _bind(self) -> None:
        """Where each parameter, buffer and submodule of the module is held,
        and what is held there now."""
        mods = list(self.module.modules())
        self.tensor_slots = [(d, name) for m in mods for d in (m._parameters, m._buffers)
                             for name, t in d.items() if t is not None]
        self.module_slots = [(m._modules, name) for m in mods for name in m._modules]
        self.bound = self._bindings()

    def _bindings(self) -> tuple:
        return (tuple(d[name].data_ptr() for d, name in self.tensor_slots),
                tuple(d[name] for d, name in self.module_slots))

    def watch(self) -> None:
        if self._bindings() != self.bound:
            self.graphs.clear()
            self._bind()

    def topk(self, key: tuple,
             score: Callable[[], Tuple[torch.Tensor, torch.Tensor]]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``score()``'s (scores, items) for the chunk in the static inputs."""
        captured = self.graphs.get(key)
        if captured is None:
            if key not in self.warm:
                return self._warm_up(key, score)
            captured = self.graphs[key] = self._capture(score)
        captured.graph.replay()
        attention.flash_attention_fwd.launches += captured.launches
        return captured.scores, captured.items

    def _warm_up(self, key: tuple, score) -> Tuple[torch.Tensor, torch.Tensor]:
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = score()
        current.wait_stream(self.stream)
        self.warm.add(key)
        return out

    def _capture(self, score) -> _Captured:
        graph = torch.cuda.CUDAGraph()
        before = attention.flash_attention_fwd.launches
        # no garbage collection during capture: freeing a CUDA graph left in
        # a reference cycle calls the CUDA runtime, which invalidates the
        # capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        # errors on unsafe calls from this thread only: another thread of the
        # process (NCCL's watchdog under a mesh) may query events meanwhile
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                scores, items = score()
        finally:
            if collecting:
                gc.enable()
        launches = attention.flash_attention_fwd.launches - before
        attention.flash_attention_fwd.launches = before
        return _Captured(graph, scores, items, launches)


class Recommender:
    def __init__(
        self,
        rec: RecModel,
        params: Mapping[str, torch.Tensor],
        item_keep_mask: Optional[np.ndarray] = None,
        batch_size: int = 256,
        device="cuda",
    ) -> None:
        if getattr(rec.module, "reads_graph", False):
            raise NotImplementedError(
                f"{rec.config['model']['model']} encodes through the item-transition graph, "
                f"which serving does not build (nor does the JAX Recommender, which cannot "
                f"serve GNN either); evaluate it with Trainer.evaluate()")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but CUDA is not available")
        module = copy.deepcopy(rec.module)  # the caller's module stays where it is
        module.load_state_dict(_unpadded(params, module))
        module.to(self.device).eval()
        self.rec = dataclasses.replace(rec, module=module)
        self.pre_padding = bool(getattr(get_model_class(rec.config["model"]["model"]),
                                        "pre_padding", False))
        self.max_seq_len = rec.max_seq_len
        self.batch_size = batch_size
        keep = (
            np.ones(rec.num_items, bool)
            if item_keep_mask is None
            else np.array(item_keep_mask, bool)  # copy: never mutate caller's mask
        )
        keep[0] = False
        self.keep_mask = torch.from_numpy(keep).to(self.device)
        # a chunk's histories: padded on the host (pinned on the card, so one
        # copy each reaches the device inputs without a wait), read by the
        # eager path and by every graph
        on_card = self.device.type == "cuda"
        shapes = {"seq": (batch_size, self.max_seq_len), "seqlen": (batch_size,)}
        if self.pre_padding:
            shapes["pre"] = shapes["seq"]
        self._host = {name: torch.zeros(shape, dtype=torch.int64, pin_memory=on_card)
                      for name, shape in shapes.items()}
        self._inputs = ({name: torch.zeros_like(t, device=self.device)
                         for name, t in self._host.items()} if on_card else self._host)
        self._no_hist = torch.zeros((batch_size, 1), dtype=torch.int64, device=self.device)
        self._graphs = _ChunkGraphs(module, self.device) if on_card else None

    @classmethod
    def from_checkpoint(cls, path: str, root: Optional[str] = None, **kwargs) -> "Recommender":
        """Rebuild the model from a checkpoint and its config, and load its
        params. ``root`` is the dataset root holding the config's dataset
        (its ``meta.npz`` sizes the catalog); ``kwargs`` go to the
        constructor (``device``, ``batch_size``, ``item_keep_mask``)."""
        from dr4sr_tpu_torch.convert import params_from_jax
        from dr4sr_tpu_torch.data.dataset import DATASET_ROOT, _load_meta

        if checkpoint.is_jax_checkpoint(path):
            config = checkpoint.read_sidecar(path)["config"]
            params = None
        else:
            params, meta = checkpoint.load_checkpoint(path)
            config = meta["config"]
        ds_meta = _load_meta(root or DATASET_ROOT, config["data"]["dataset"],
                             config["data"]["domain_name_list"])
        module = get_model_class(config["model"]["model"]).build(config, ds_meta["num_items"])
        if params is None:
            params = params_from_jax(checkpoint.load_jax_checkpoint(path), module)
        rec = RecModel(config, module, ds_meta["num_items"], ds_meta["num_users"])
        return cls(rec, params, **kwargs)

    def _stage(self, chunk: Sequence[Sequence[int]],
               exclude_seen: bool) -> Dict[str, torch.Tensor]:
        """The chunk's histories padded into the host buffers and copied to
        the device inputs, as the batch the encoder reads. The buffers are
        rewritten only after the previous chunk's ``serve.fetch``, which
        waits for the device and so for the copies out of them."""
        L = self.max_seq_len
        seq, seqlen = self._host["seq"].numpy(), self._host["seqlen"].numpy()
        seq.fill(0)
        seqlen.fill(1)
        for i, h in enumerate(chunk):
            h = list(h)[-L:]
            seq[i, : len(h)] = h
            seqlen[i] = max(len(h), 1)
        if self.pre_padding:  # the seen items stay as they are in user_hist
            self._host["pre"].numpy()[:] = pre_pad_batch(
                {"in_item_id": seq, "seqlen": seqlen})["in_item_id"]
        if self._inputs is not self._host:
            for name, host in self._host.items():
                self._inputs[name].copy_(host, non_blocking=True)
        inputs = self._inputs
        return {"in_item_id": inputs["pre" if self.pre_padding else "seq"],
                "seqlen": inputs["seqlen"],
                "user_hist": inputs["seq"] if exclude_seen else self._no_hist}

    @torch.inference_mode()
    def recommend(
        self, histories: Sequence[Sequence[int]], k: int = 10,
        exclude_seen: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (items [N, k'] int64, scores [N, k'] float32) for each
        history, k' = min(k, num_items). (The JAX version sizes them by k and
        fails when k exceeds the catalog.) Each chunk of ``batch_size``
        histories records ``serve.batch``, ``serve.score`` and
        ``serve.fetch``, in that order, under a profiler.

        On a CUDA device a chunk replays the graph of its key (k',
        ``exclude_seen``) once the key has run one chunk eagerly and been
        captured on the next; the first chunk of a key, and every chunk on
        the CPU, runs eagerly. A weight changed in place is seen; a
        parameter, buffer or submodule rebound drops the graphs."""
        k = min(k, self.rec.num_items)
        n = len(histories)
        b = self.batch_size
        out_items = np.zeros((n, k), np.int64)
        out_scores = np.zeros((n, k), np.float32)
        if self._graphs is not None:
            self._graphs.watch()
        for start in range(0, n, b):
            chunk = histories[start : start + b]
            with span("serve.batch"):
                batch = self._stage(chunk, exclude_seen)
            with span("serve.score"):
                score = functools.partial(self.rec.topk, batch, k, item_keep_mask=self.keep_mask)
                if self._graphs is None:
                    scores, items = score()
                else:
                    scores, items = self._graphs.topk((k, exclude_seen), score)
            m = len(chunk)
            with span("serve.fetch"):
                out_items[start : start + m] = items[:m].cpu().numpy()
                out_scores[start : start + m] = scores[:m].cpu().numpy()
        return out_items, out_scores
