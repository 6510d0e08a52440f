"""Stage 3 of DR4SR through the port's ``regen.decode.decode_dataset``:
greedy KV-cached decoding of successive chunks of the data's sources, each
under every one of the K conditions, ``batch_size`` lanes a batch.

A unit is one call over ``batch_size`` sources (the data's sources in
order, wrapping around), so K batches of lanes. Of each call's lanes,
``checked_lanes_per_call`` drawn from the seed are kept (and the lane of
the longest source of the first call): only they, not every lane's list,
stay alive through the window. Once it has closed they are judged
against the plain reference
(``reference/regenerator.py``), teacher-forced on the served tokens:
``token_gap`` is the widest gap by which a served token's logit lies
below the best allowed one (a token that breaks the decoding rules reads
1e9).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

import checks
import harness
import inputs
from reference import plain
from reference import regenerator as ref_regen


class DecodeCell:
    unit_name = "decode_dataset"

    def __init__(self, ctx) -> None:
        from dr4sr_tpu_torch.regen.generator import Generator

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        phases = harness.Phases()
        m = cfg["model"]
        seqs = inputs.markov_sequences(ctx.seed, cfg["num_users"], cfg["num_items"],
                                       cfg["num_interactions"])
        self.sources = inputs.regen_sources(seqs)
        self.batch = tr["batch_size"]
        phases.done("data")
        self.gen = Generator(cfg["num_items"], k=m["k"], embed_dim=m["embed_dim"],
                             num_heads=m["num_heads"], num_layers=m["num_layers"],
                             ffn_dim=m["ffn_dim"], dropout=m["dropout"], max_len=m["max_len"],
                             generator=torch.Generator().manual_seed(ctx.seed)).to(ctx.device)
        self.kept = []  # (source, condition, served tokens) of the lanes to judge
        self.pick = np.random.default_rng([ctx.seed, 4])
        self.next = self.calls = 0
        phases.done("model")
        self._decode()  # warm-up: the same call at the same shapes
        phases.done("warm-up call")
        self.kept.clear()
        self.calls = 0
        self.attempted = self.failed = 0

    def _chunk(self, start: int):
        n = len(self.sources)
        return [self.sources[(start + i) % n] for i in range(self.batch)]

    def _decode(self) -> None:
        from dr4sr_tpu_torch.regen.decode import decode_dataset

        d = self.ctx.config["decode"]
        start = self.next
        chunk = self._chunk(start)
        out = decode_dataset(self.gen, chunk, self.ctx.config["model"]["k"],
                             batch_size=self.batch, max_len=d["max_len"], max_src=d["max_src"],
                             gamma=d["gamma"], seed=self.ctx.seed)
        lanes = self.pick.choice(len(out), size=self.ctx.traffic["checked_lanes_per_call"],
                                 replace=False).tolist()
        if self.calls == 0:  # the longest source's lane under condition 0
            lanes.append(int(np.argmax([len(s) for s in chunk])))
        for i in lanes:
            cond, j = divmod(i, self.batch)
            self.kept.append((chunk[j], cond, out[i]))
        self.calls += 1
        self.next = (start + self.batch) % len(self.sources)

    def unit(self) -> None:
        self.attempted += self.batch * self.ctx.config["model"]["k"]
        self._decode()

    def end_to_end(self, window_s: float) -> dict:
        lanes = self.calls * self.batch * self.ctx.config["model"]["k"]
        return {"regen_seq_per_s": lanes / window_s}

    def trace_units(self) -> int:
        return int(self.ctx.traffic["trace_calls"])

    def trace_work(self) -> dict:
        d = self.ctx.config["decode"]
        batches = self.calls * self.ctx.config["model"]["k"]
        return {"decode_positions": batches * (d["max_len"] - 1)}

    def _logits(self, sample, tf32: bool):
        cfg, dev = self.ctx.config, self.ctx.device
        d = cfg["decode"]
        sos, eos = cfg["num_items"], cfg["num_items"] + 1
        src = np.stack([inputs.frame(np.array([s]), np.array([len(s)]), d["max_src"], sos, eos)[0]
                        for s, _, _ in sample])
        buf = ref_regen.served_buffers([t for _, _, t in sample], sos, eos, d["max_len"])
        cond = torch.tensor([c for _, c, _ in sample], device=dev)
        src_t, buf_t = torch.from_numpy(src).to(dev), torch.from_numpy(buf).to(dev)
        with plain.precision(tf32):
            logits = ref_regen.forced_logits(self.ref_params, src_t, cond, buf_t, cfg)
        return src_t, logits[:, :-1]

    def _blocks(self, sample):
        step = self.ctx.traffic["check_block"]
        return [sample[i:i + step] for i in range(0, len(sample), step)]

    def check(self) -> dict:
        del self.gen
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
        self.ref_params = plain.on(ref_regen.init_params(self.ctx.config, self.ctx.seed),
                                   self.ctx.device)
        eos = self.ctx.config["num_items"] + 1
        self.judged = self.kept
        gap = 0.0
        for block in self._blocks(self.judged):
            src, logits = self._logits(block, False)
            gap = max(gap, float(ref_regen.judge_lanes(logits, src, [t for _, _, t in block],
                                                       eos).max()))
        return {"token_gap": checks.finite(gap)}

    def control(self) -> dict:
        """The control: at each judged position of the same lanes and
        tokens, the gap of the token that the reference in TF32 puts first."""
        eos = self.ctx.config["num_items"] + 1
        gaps = []
        for block in self._blocks(self.judged):
            src, ref = self._logits(block, False)
            _, low = self._logits(block, True)
            gaps.append(ref_regen.control_gaps(ref, low, src, [t for _, _, t in block], eos))
        gaps = np.concatenate(gaps)
        harness.log(f"control_tf32: {int((gaps > 0).sum())} of {len(gaps)} lanes judged pick "
                    f"another token somewhere; the largest gaps {np.sort(gaps)[-5:].tolist()}")
        return {"control_tf32": {"token_gap": float(gaps.max())}}


def setup(ctx) -> DecodeCell:
    return DecodeCell(ctx)
