"""Training a sequential recommender through the port's ``Trainer``:
``training_epoch`` epoch after epoch, at the traffic's
``steps_per_dispatch`` (16: each group of 16 steps one CUDA graph replay).

Set-up writes the seed's dataset, builds one ``Trainer`` and runs its epoch
0 (the first group eagerly, then each graph captured and replayed): the
warm-up. Two stretches are checked against the plain reference
(``reference/sasrec.py``):

- epoch 0 from the seed: its first three steps (observed as they pass
  through ``Trainer._update``), its mean loss and the state it leaves;
  the reference takes the same 76 steps from the seed;
- the window's first epoch, all graph replays: its mean loss and the
  change it makes. The reference starts it from the program's weights and
  Adam state before it (after 76 steps the two runs differ by rounding
  that Adam spreads, so its own state would compare that drift, not the
  epoch), with its generators where its own epoch 0 left them.
"""

from __future__ import annotations

import copy
import gc

import torch

import arith
import checks
import harness
import inputs
import probes
from reference import sasrec as ref_sasrec


def _clone(named):
    return {k: p.detach().clone() for k, p in named.items()}


class TrainCell:
    unit_name = "training_epoch"

    def __init__(self, ctx) -> None:
        from dr4sr_tpu_torch.data.dataset import prepare_datasets
        from dr4sr_tpu_torch.train.trainer import Trainer

        self.ctx, cfg = ctx, ctx.config
        phases = harness.Phases()
        self.max_len = cfg["data"]["max_seq_len"]
        seqs = inputs.markov_sequences(ctx.seed, cfg["num_users"], cfg["num_items"],
                                     cfg["num_interactions"])
        self.rows = inputs.split_rows(seqs, self.max_len)["train"]
        run_cfg = {k: copy.deepcopy(cfg[k]) for k in ("data", "model", "train", "eval")}
        run_cfg["train"].update(seed=ctx.seed, steps_per_dispatch=ctx.traffic["steps_per_dispatch"])
        run_cfg["eval"]["save_path"] = ctx.workdir
        inputs.write_dataset(ctx.workdir, cfg["data"]["dataset"],
                             cfg["data"]["domain_name_list"][0], seqs, self.max_len,
                             cfg["num_items"])
        phases.done("data")
        t = self.trainer = Trainer(run_cfg, prepare_datasets(run_cfg, root=ctx.workdir),
                                   workdir=ctx.workdir, device=ctx.device)
        t.init_state()
        self.named = named = dict(t.rec.module.named_parameters())
        self.prog = {"init": _clone(named), "losses": []}
        update = t._update

        def observed(*args, **kwargs):
            loss = update(*args, **kwargs)
            n = len(self.prog["losses"])
            if n < 3:
                self.prog["losses"].append(loss.detach().clone())
                if n == 0:
                    self.prog["moment1"] = checks.first_moments(t.optimizer, named)
                if n == 2:
                    self.prog["after3"] = _clone(named)
            return loss

        phases.done("trainer")
        t._update = observed
        mean0 = t.training_epoch(0)
        del t._update
        self.prog["losses"] = [float(x) for x in self.prog["losses"]] + [mean0]
        self.prog["after_epoch"] = self.prog["before_window"] = _clone(named)
        self.prog["adam_before_window"] = {
            k: {s: v.detach().clone() for s, v in t.optimizer.state[p].items()}
            for k, p in named.items()}
        phases.done("epoch 0: eager group, captures, replays")
        self.steps_per_epoch = -(-len(self.rows["seqlen"]) // cfg["train"]["batch_size"])
        self.epoch = 1
        self.attempted = self.failed = 0

    def unit(self) -> None:
        loss = self.trainer.training_epoch(self.epoch)
        if self.epoch == 1:  # the window's first epoch, kept for the check
            self.prog["window_loss"] = loss
            self.prog["after_window"] = _clone(self.named)
        self.epoch += 1
        self.attempted += self.steps_per_epoch

    def end_to_end(self, window_s: float) -> dict:
        rows = (self.epoch - 1) * len(self.rows["seqlen"])
        return {"train_seq_per_s": rows / window_s}

    def trace_units(self) -> int:
        return int(self.ctx.traffic["trace_epochs"])

    def trace_work(self) -> dict:
        """The work of the epochs run since set-up: optimizer steps, the
        model FLOPs of the real positions, and the least time of each
        attention call that the batches' masks need."""
        cfg = self.ctx.config
        m, bs = cfg["model"], cfg["train"]["batch_size"]
        d, h = m["embed_dim"], m["head_num"]
        epochs = range(1, self.epoch)
        flops = arith.sasrec_step_flops(self.rows["seqlen"], d, m["hidden_size"],
                                        m["layer_num"], cfg["train"]["num_neg"])
        fwd = bwd = 0.0
        for e in epochs:
            for batch in ref_sasrec.epoch_batches(self.rows, bs, e):
                keys = batch["in_item_id"] != 0
                args = (bs, h, self.max_len, self.max_len, d // h, keys, True)
                fwd += m["layer_num"] * arith.attention_fwd_bound_s(*args)
                bwd += m["layer_num"] * arith.attention_bwd_bound_s(*args)
        return {"train_steps": len(epochs) * self.steps_per_epoch, "flops": flops * len(epochs),
                "attn_fwd_bound_s": fwd, "attn_bwd_bound_s": bwd}

    def probes(self) -> dict:
        """The port's attention op at the encoder's shape, for a traced run
        to learn which kernels it launches (``probes.py``)."""
        m = self.ctx.config["model"]
        h, bs = m["head_num"], self.ctx.config["train"]["batch_size"]
        return probes.attention(self.ctx.device, [(bs, h, self.max_len, self.max_len,
                                                   m["embed_dim"] // h, True)], self.ctx.seed)

    def _reference(self, **kw):
        """The reference's epoch 0 from the seed, then the window's first
        epoch from the program's state before it."""
        run = ref_sasrec.Run(self.ctx.config, self.ctx.seed, self.ctx.device, **kw)
        run.epoch(self.rows, 0)
        if "after_window" in self.prog:
            run.load(self.prog["before_window"], self.prog["adam_before_window"])
            run.window_loss = run.epoch(self.rows, 1)
            run.after_window = {k: p.detach().clone() for k, p in run.params.items()}
        return run

    def check(self) -> dict:
        del self.trainer, self.named
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()
        self.ref = self._reference()
        self.leaves = checks.counted_leaves(self.ref.moment1)
        return checks.training_numbers(self.prog, self.ref, self.leaves)

    def control(self) -> dict:
        """The control (the reference in TF32) and the half-batch fault
        (the reference with the second half of every batch left out), each
        judged as the program is."""
        out = {}
        for name, kw in (("control_tf32", {"tf32": True}), ("fault_half_batch",
                                                            {"half_batch": True})):
            run = self._reference(**kw)
            prog = {"init": run.init, "losses": run.losses, "moment1": run.moment1,
                    "after3": run.after3, "after_epoch": run.after_epoch}
            if "after_window" in self.prog:
                prog.update(before_window=self.prog["before_window"],
                            window_loss=run.window_loss, after_window=run.after_window)
            out[name] = checks.training_numbers(prog, self.ref, self.leaves)
        return out


def setup(ctx) -> TrainCell:
    return TrainCell(ctx)

