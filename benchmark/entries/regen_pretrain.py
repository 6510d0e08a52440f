"""Stage 2 of DR4SR through the port's ``regen.pipeline.pretrain_step``:
the regenerator trained on (sequence, pattern) pairs, ``batch_size`` pairs
a step, in the order of the port's ``batch_order``, with the optimizer and
cosine schedule of ``regen_optimizer`` over the configuration's epochs and
the gumbel temperature ×0.995 a step down to 0.1, as
``pretrain_regenerator`` loops.

Set-up builds the generator from the seed and takes the first steps (the
warm-up); its first three are checked against the plain reference
(``reference/regenerator.py``), which takes them from the seed too.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

import arith
import checks
import harness
import inputs
import probes
from reference import regenerator as ref_regen


def _clone(named):
    return {k: p.detach().clone() for k, p in named.items()}


class PretrainCell:
    unit_name = "pretrain_step"

    def __init__(self, ctx) -> None:
        from dr4sr_tpu_torch.regen.generator import Generator
        from dr4sr_tpu_torch.regen.pipeline import batch_order, regen_optimizer

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        phases = harness.Phases()
        m, t = cfg["model"], cfg["train"]
        seqs = inputs.markov_sequences(ctx.seed, cfg["num_users"], cfg["num_items"],
                                       cfg["num_interactions"])
        pairs = inputs.pretraining_pairs(seqs, ctx.seed, cfg["num_items"], cfg["num_pairs"],
                                         cfg["decode"]["max_src"], cfg["max_tgt"])
        self.pairs = pairs
        self.arrays = {k: torch.from_numpy(v).long() for k, v in pairs.items()}
        n, self.bs = len(pairs["src"]), t["batch_size"]
        phases.done("data")
        self.total_steps = t["epochs"] * -(-n // self.bs)
        self.module = Generator(cfg["num_items"], k=m["k"], embed_dim=m["embed_dim"],
                                num_heads=m["num_heads"], num_layers=m["num_layers"],
                                ffn_dim=m["ffn_dim"], dropout=m["dropout"], max_len=m["max_len"],
                                generator=torch.Generator().manual_seed(ctx.seed)).to(ctx.device)
        self.optimizer, self.scheduler = regen_optimizer(self.module, t["learning_rate"],
                                                         self.total_steps)
        self.gumbel = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
        torch.manual_seed(ctx.seed + 1)
        self.order = batch_order(n, self.bs, t["epochs"], ctx.seed)
        self.tau = 1.0
        named = dict(self.module.named_parameters())
        phases.done("model")
        self.prog = {"init": _clone(named), "losses": []}
        self.fed = []  # the batch indices of every step since set-up
        for i in range(tr["warmup_steps"]):
            out = self._step()
            if i < 3:
                self.prog["losses"].append(float(out["loss"]))
            if i == 0:
                self.prog["moment1"] = checks.first_moments(self.optimizer, named)
            if i == 2:
                self.prog["after3"] = _clone(named)
            phases.done(f"step {i + 1}")
        self.fed.clear()
        self.attempted = self.failed = 0

    def _step(self):
        from dr4sr_tpu_torch.regen.pipeline import TAU_DECAY, TAU_FLOOR, pretrain_step

        idx = torch.from_numpy(next(self.order))
        batch = [self.arrays[key][idx].to(self.ctx.device) for key in ("src", "tgt", "tgt_len")]
        out = pretrain_step(self.module, self.optimizer, self.scheduler, *batch, self.tau,
                            self.ctx.config["train"]["entropy_weight"], generator=self.gumbel)
        self.tau = max(self.tau * TAU_DECAY, TAU_FLOOR)
        self.fed.append(idx.numpy())
        return out

    def unit(self) -> None:
        self.attempted += 1
        self._step()

    def end_to_end(self, window_s: float) -> dict:
        return {"pretrain_seq_per_s": len(self.fed) * self.bs / window_s}

    def trace_units(self) -> int:
        return int(self.ctx.traffic["trace_steps"])

    def trace_work(self) -> dict:
        """Optimizer steps, the model FLOPs of the real positions, and the
        least time of each attention call that the batches' masks need."""
        cfg = self.ctx.config
        m = cfg["model"]
        d, h, dh = m["embed_dim"], m["num_heads"], m["embed_dim"] // m["num_heads"]
        flops = fwd = bwd = 0.0
        for idx in self.fed:
            src = self.pairs["src"][idx]
            tgt_in = self.pairs["tgt"][idx][:, :-1]
            src_keys, tgt_keys = src != 0, tgt_in != 0
            flops += arith.regenerator_step_flops(src_keys.sum(1), tgt_keys.sum(1), d,
                                                  m["ffn_dim"], m["num_layers"], m["k"],
                                                  cfg["num_items"] + 2)
            b, ls, lt = src.shape[0], src.shape[1], tgt_in.shape[1]
            calls = ([(ls, ls, src_keys, True)] * m["num_layers"]  # encoder
                     + [(lt, lt, tgt_keys, True)] * 2  # condition encoder
                     + [(lt, lt, tgt_keys, True), (lt, ls, src_keys, False)] * m["num_layers"])
            for lq, lk, keys, causal in calls:
                fwd += arith.attention_fwd_bound_s(b, h, lq, lk, dh, keys, causal)
                bwd += arith.attention_bwd_bound_s(b, h, lq, lk, dh, keys, causal)
        return {"train_steps": len(self.fed), "flops": flops, "attn_fwd_bound_s": fwd,
                "attn_bwd_bound_s": bwd}

    def probes(self) -> dict:
        """The port's attention op at the regenerator's shapes (the encoders'
        and the decoder's causal self-attention, the decoder's
        cross-attention), for a traced run to learn which kernels it
        launches (``probes.py``)."""
        m = self.ctx.config["model"]
        h, dh = m["num_heads"], m["embed_dim"] // m["num_heads"]
        ls, lt = self.pairs["src"].shape[1], self.pairs["tgt"].shape[1] - 1
        return probes.attention(self.ctx.device, [(self.bs, h, ls, ls, dh, True),
                                                  (self.bs, h, lt, lt, dh, True),
                                                  (self.bs, h, lt, ls, dh, False)], self.ctx.seed)

    def _reference(self, **kw):
        run = ref_regen.Run(self.ctx.config, self.ctx.seed, self.ctx.device, self.total_steps, **kw)
        order = np.random.default_rng(self.ctx.seed).permutation(len(self.pairs["src"]))
        for s in range(3):
            idx = order[s * self.bs:(s + 1) * self.bs]
            run.step(*(torch.from_numpy(self.pairs[k][idx]).to(self.ctx.device)
                       for k in ("src", "tgt", "tgt_len")))
        return run

    def check(self) -> dict:
        del self.module, self.optimizer, self.scheduler
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
        self.ref = self._reference()
        self.leaves = checks.counted_leaves(self.ref.moment1)
        return checks.training_numbers(self.prog, self.ref, self.leaves)

    def control(self) -> dict:
        """The control (the reference in TF32) and the half-batch fault,
        each judged as the program is."""
        out = {}
        for name, kw in (("control_tf32", {"tf32": True}), ("fault_half_batch",
                                                            {"half_batch": True})):
            run = self._reference(**kw)
            prog = {"init": run.init, "losses": run.losses, "moment1": run.moment1,
                    "after3": run.after3}
            out[name] = checks.training_numbers(prog, self.ref, self.leaves)
        return out


def setup(ctx) -> PretrainCell:
    return PretrainCell(ctx)
