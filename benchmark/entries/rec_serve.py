"""Serving top-k through the port's ``serve.Recommender``: one caller in a
closed loop, each request the histories of ``histories_per_request`` users
drawn from the seed, ``k`` items each, the seen ones excluded.

A request is timed on the host's clock from the call until its numpy
answer is back. A uniform sample of the window's requests, drawn from the
seed, plus the request that holds the longest history, is kept and
judged against the plain reference (``reference/sasrec.py``) once the
window has closed: ``rank_gap`` is the widest gap by which the program's
j-th item scores below the reference's j-th best (a seen item or PAD
served reads about 1e30), ``score_gap`` the widest gap between the scores
served and the reference's scores of the same items.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import checks
import harness
import inputs
from reference import plain
from reference import sasrec as ref_sasrec


class ServeCell:
    unit_name = "recommend"

    def __init__(self, ctx) -> None:
        from dr4sr_tpu_torch.models import get_model_class
        from dr4sr_tpu_torch.models.base import RecModel
        from dr4sr_tpu_torch.serve import Recommender

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        phases = harness.Phases()
        seqs = inputs.markov_sequences(ctx.seed, cfg["num_users"], cfg["num_items"],
                                       cfg["num_interactions"])
        self.histories = [s.tolist() for s in seqs]
        lens = np.array([len(s) for s in seqs])
        rng = np.random.default_rng([ctx.seed, 2])
        self.requests = rng.integers(0, len(seqs), size=(tr["request_pool"],
                                                         tr["histories_per_request"]))
        longest = lens[self.requests].max(axis=1)
        self.longest = int(np.argmax(longest == longest.max()))
        self.sample = checks.Reservoir(tr["checked_requests"],
                                       np.random.default_rng([ctx.seed, 3]))
        phases.done("data")
        run_cfg = {"data": dict(cfg["data"]), "model": dict(cfg["model"])}
        module = get_model_class(cfg["model"]["model"]).build(
            run_cfg, cfg["num_items"], generator=torch.Generator().manual_seed(ctx.seed))
        rec = RecModel(run_cfg, module, cfg["num_items"], cfg["num_users"] + 1)
        self.server = Recommender(rec, module.state_dict(),
                                  batch_size=tr["histories_per_request"], device=ctx.device)
        self.k = tr["k"]
        phases.done("model")
        for r in range(tr["warmup_requests"]):
            self._request(r)
        phases.done("warm-up requests")
        self.next = 0
        self.latency_ms = []
        self.kept_longest = None
        self.attempted = self.failed = 0

    def _request(self, r: int):
        batch = [self.histories[i] for i in self.requests[r % len(self.requests)]]
        t0 = time.perf_counter()
        items, scores = self.server.recommend(batch, k=self.k)
        return items, scores, (time.perf_counter() - t0) * 1e3

    def unit(self) -> None:
        r = self.next
        self.next += 1
        self.attempted += 1
        items, scores, ms = self._request(r)
        self.latency_ms.append(ms)
        self.sample.offer(lambda: (r, items, scores))
        if r % len(self.requests) == self.longest and self.kept_longest is None:
            self.kept_longest = (r, items, scores)

    def end_to_end(self, window_s: float) -> dict:
        return {"serve_ms_p95": float(np.percentile(self.latency_ms, 95))}

    def trace_units(self) -> int:
        return int(self.ctx.traffic["trace_requests"])

    def trace_work(self) -> dict:
        return {"requests": self.next}

    def _judged(self):
        kept = list(self.sample.items)
        if self.kept_longest is not None and all(r != self.kept_longest[0] for r, _, _ in kept):
            kept.append(self.kept_longest)
        return kept

    def _reference_scores(self, r: int, tf32: bool) -> torch.Tensor:
        cfg = self.ctx.config
        max_len = cfg["data"]["max_seq_len"]
        hist = [self.histories[i][-max_len:] for i in self.requests[r % len(self.requests)]]
        seq = np.zeros((len(hist), max_len), np.int64)
        for i, h in enumerate(hist):
            seq[i, : len(h)] = h
        dev = self.ctx.device
        with plain.precision(tf32):
            return ref_sasrec.serve_scores(self.ref_params, torch.from_numpy(seq).to(dev),
                                           torch.tensor([len(h) for h in hist], device=dev), cfg)

    def check(self) -> dict:
        del self.server
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
        self.ref_params = plain.on(ref_sasrec.init_params(self.ctx.config, self.ctx.seed),
                                   self.ctx.device)
        rank_gap = score_gap = 0.0
        self.ref_cache = {}
        for r, items, scores in self._judged():
            ref = self._reference_scores(r, False)
            self.ref_cache[r] = ref
            served = ref.gather(1, torch.from_numpy(items).to(ref.device)).double().cpu()
            best = ref.topk(items.shape[1], dim=1).values.double().cpu()
            rank_gap = max(rank_gap, float((best - served).max()))
            gap = (torch.from_numpy(scores).double() - served).abs().max()
            score_gap = max(score_gap, float(gap))
        return {"rank_gap": checks.finite(rank_gap), "score_gap": checks.finite(score_gap)}

    def control(self) -> dict:
        """The control: the reference in TF32 serves the same requests, and
        its answers are judged as the program's are."""
        rank_gap = score_gap = 0.0
        for r, items, _ in self._judged():
            ref = self.ref_cache[r]
            low = self._reference_scores(r, True)
            top = low.topk(items.shape[1], dim=1)
            served = ref.gather(1, top.indices).double().cpu()
            best = ref.topk(items.shape[1], dim=1).values.double().cpu()
            rank_gap = max(rank_gap, float((best - served).max()))
            score_gap = max(score_gap, float((top.values.double().cpu() - served).abs().max()))
        return {"control_tf32": {"rank_gap": rank_gap, "score_gap": score_gap}}


def setup(ctx) -> ServeCell:
    return ServeCell(ctx)
