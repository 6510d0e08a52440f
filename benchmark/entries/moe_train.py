"""Training a large MoE sequential recommender through the port's
``Trainer``: DeepSeekV2Rec (DeepSeek-V2-Lite's decoder, this card's share
of an expert-parallel layer) at ``train.precision: bf16`` with
``model.remat``, one optimizer step (``Trainer.train_step``) a unit, fed by
the Trainer's own loader (``Trainer.train_batches``, epoch after epoch).

Set-up makes the seed's histories (``inputs_long``), writes them, builds
one ``Trainer`` (the weights drawn from the seed) and runs its first three
steps: the warm-up, and what the check compares. The check, after the
window, against the plain f32 reference (``reference/deepseek_v2_rec.py``,
which draws its own weights from the seed and takes the same batches and
negatives, each step's batch in blocks of ``reference_chunk`` rows so that
it fits beside its weights, gradients and Adam's state):

- the first three steps as ``checks.training_numbers`` compares them: each
  loss, the first gradient (Adam's first moment after step 1) by the worst
  leaf, and the change after three steps by the median leaf, from each
  leaf's norm (a full copy of 2.9 billion values on either side would not
  fit); the worst leaf of the change goes to standard error, with its
  experts' norms on both sides where it is an expert leaf;
- serving: ``serve.Recommender``'s top-k scores of ``checked_histories``
  validation histories under the window's last weights, against the
  reference's full forward with the same weights (``serve_gap``: the
  largest gap over the largest score).

The control is the reference with every product's operands rounded to fp8
(e4m3), below the stated bf16; the faults are the reference with top-5 for
top-6, without the shared experts, with the top-k weights renormalised,
without the rope on q_pe, and with the second half of every batch left
out. On the CPU (the tests) the model takes the
configuration's ``cpu_test_sizes`` in f32; the card runs the published
widths.
"""

from __future__ import annotations

import copy
import gc
import itertools
import statistics
from typing import Dict, List

import numpy as np
import torch

import arith_moe
import checks
import harness
import inputs
import inputs_long
from reference import deepseek_v2_rec as ref
from reference.sasrec import epoch_batches, on_device

# the keys of the configuration that the port's model reads, at the top level as published
MODEL_KEYS = ("hidden_size", "num_hidden_layers", "first_k_dense_replace", "intermediate_size",
              "num_attention_heads", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
              "kv_lora_rank", "rms_norm_eps", "rope_theta", "rope_scaling", "n_routed_experts",
              "n_routed_experts_held", "expert_offset", "fold_foreign_experts",
              "num_experts_per_tok",
              "moe_intermediate_size", "n_shared_experts", "norm_topk_prob",
              "routed_scaling_factor")
CHECKED_STEPS = 3


def model_config(cfg: dict, device: str) -> dict:
    m = {k: copy.deepcopy(cfg[k]) for k in MODEL_KEYS}
    m.update(copy.deepcopy(cfg["model"]))
    if device == "cpu":
        m.update({k: v for k, v in cfg["cpu_test_sizes"].items() if k != "why"})
    return m


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 (saturating at its largest finite value, 448)."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


# name: (the reference's options, whether the second half of every batch is left out)
VARIANTS = {"control_fp8": (ref.Options(operand=fp8_operand), False),
            "fault_top5": (ref.Options(top_k=5), False),
            "fault_no_shared": (ref.Options(shared=False), False),
            "fault_renormalised": (ref.Options(renormalise=True), False),
            "fault_no_rope_q": (ref.Options(rope_q=False), False),
            "fault_half_batch": (ref.PLAIN, True)}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def _expert_norms(t: torch.Tensor) -> List[float]:
    """An expert leaf's [E, out, in] norms, expert by expert."""
    return torch.linalg.vector_norm(t.detach(), dim=(1, 2), dtype=torch.float64).tolist()


def _change_norms(named: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor]):
    """Each leaf's ‖after − init‖, leaf by leaf on the leaf's device, and
    each expert leaf's per expert."""
    whole, experts = {}, {}
    for k, p in named.items():
        d = p.detach() - init[k].to(p.device)
        whole[k] = _norm(d)
        if d.dim() == 3:
            experts[k] = _expert_norms(d)
    return whole, experts


def _moment_norms(optimizer, named: Dict[str, torch.Tensor]):
    """Adam's first moment after step 1, by leaf and, for an expert leaf,
    by expert: its norms, and the share of its coordinates whose gradient
    is under Adam's eps (where a step's size follows the gradient's)."""
    whole, experts = {}, {}
    eps = optimizer.param_groups[0]["eps"]
    for k, p in named.items():
        state = optimizer.state[p]
        m = state.get("exp_avg", torch.zeros(()))
        whole[k] = _norm(m)
        if m.dim() == 3:
            # after step 1 exp_avg_sq is (1 - β2)·g², so √ of it over √(1 - β2) is |g|
            g = state["exp_avg_sq"].sqrt() / (1 - optimizer.param_groups[0]["betas"][1]) ** 0.5
            small = (g < eps).double().mean(dim=(1, 2))
            experts[k] = [_expert_norms(m), small.tolist()]
    return whole, experts


class RefRun:
    """The reference's first steps from the seed's weights, with its own
    Adam (torch's, per tensor), negatives from a device generator seeded
    ``seed + 1`` as the port's trainer draws them, each batch in blocks."""

    def __init__(self, m: dict, num_items: int, init, seed: int, device, chunk: int,
                 lr: float, opts: ref.Options = ref.PLAIN, half_batch: bool = False) -> None:
        self.m, self.num_items, self.chunk, self.opts, self.init = m, num_items, chunk, opts, init
        self.half_batch = half_batch
        self.params = {k: v.to(device, copy=True).requires_grad_() for k, v in init.items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr, foreach=False)
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.losses: List[float] = []
        self.moment1: Dict[str, float] = {}
        self.update: Dict[str, float] = {}
        self.moment1_experts: Dict[str, List[float]] = {}
        self.update_experts: Dict[str, List[float]] = {}

    def step(self, batch: Dict[str, torch.Tensor]) -> None:
        b, l = batch["in_item_id"].shape
        self.opt.zero_grad(set_to_none=True)
        neg = torch.randint(1, self.num_items, (b, l, 1), generator=self.gen,
                            device=batch["in_item_id"].device)
        if self.half_batch:  # the fault: the second half of the rows left out
            b //= 2
            batch, neg = {k: v[:b] for k, v in batch.items()}, neg[:b]
        count = ((batch["item_id"] != 0) & batch["valid"][:, None]).sum().clamp_min(1)
        total = 0.0
        with ref.full_f32():
            for i in range(0, b, self.chunk):
                part = {k: v[i:i + self.chunk] for k, v in batch.items()}
                x = ref.encode(self.params, part["in_item_id"], self.m, self.opts)
                s, _ = ref.bce_sum(self.params, x, part["seqlen"], part["item_id"],
                                   neg[i:i + self.chunk], part["valid"])
                (s / count).backward()
                total += float(s.detach())
        self.opt.step()
        self.losses.append(total / float(count))
        if len(self.losses) == 1:
            self.moment1, self.moment1_experts = _moment_norms(self.opt, self.params)

    def run(self, batches) -> "RefRun":
        for batch in batches:
            self.step(batch)
        self.update, self.update_experts = _change_norms(self.params, self.init)
        return self

    def serve(self, state, seq: torch.Tensor, seqlen: torch.Tensor, k: int) -> torch.Tensor:
        """Top-k scores of the histories under ``state``'s weights."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(state[name])
        out = []
        for i in range(0, seq.shape[0], self.chunk):
            scores = ref.serve_scores(self.params, seq[i:i + self.chunk],
                                      seqlen[i:i + self.chunk], self.m, self.opts)
            out.append(scores.topk(k, dim=1).values.cpu())
        return torch.cat(out)

    def free(self) -> None:
        del self.params, self.opt


def _gaps(prog: Dict[str, float], ref_norms: Dict[str, float], leaves) -> Dict[str, float]:
    med = statistics.median(ref_norms[k] for k in leaves)
    return {k: abs(prog[k] - ref_norms[k]) / max(ref_norms[k], med, 1e-30) for k in leaves}


def numbers(prog: dict, reference: dict, leaves) -> Dict[str, float]:
    """The compared numbers: ``checks.training_numbers``' loss, gradient
    (worst leaf) and three-step change (median leaf) gaps, from norms, and
    the serving gap."""
    grad = _gaps(prog["moment1"], reference["moment1"], leaves)
    update = _gaps(prog["update"], reference["update"], leaves)
    worst, worst_update = max(grad, key=grad.get), max(update, key=update.get)
    harness.log(f"grad_gap: worst leaf {worst} {grad[worst]!r}; update_gap: median leaf "
                f"{statistics.median(update.values())!r}, worst leaf {worst_update} "
                f"{update[worst_update]!r}")
    # an expert leaf at worst, expert by expert: the change's norms, the
    # first moment's norms and the share of coordinates whose first gradient
    # is under Adam's eps, on both sides
    if worst_update in prog.get("update_experts", {}):
        for what in ("update_experts", "moment1_experts"):
            harness.log(f"{worst_update} {what} (program, reference): "
                        f"{prog[what][worst_update]!r} {reference[what][worst_update]!r}")
    # scores the reference masked (PAD, seen items) are left out: a top-k
    # longer than a tiny catalog's unseen items reaches them
    ps, rs = prog["serve"].double(), reference["serve"].double()
    shown = rs > ref.NEG / 2
    ps, rs = ps[shown], rs[shown]
    out = {"loss_gap": checks.loss_gap(prog["losses"], reference["losses"]),
           "grad_gap": grad[worst],
           "update_gap": statistics.median(update.values()),
           "serve_gap": float((ps - rs).abs().max() / rs.abs().max().clamp_min(1e-30))
           if rs.numel() else 1e30}
    return {k: checks.finite(v) for k, v in out.items()}


class MoETrainCell:
    unit_name = "train_step"

    def __init__(self, ctx) -> None:
        from dr4sr_tpu_torch.data.dataset import prepare_datasets
        from dr4sr_tpu_torch.train.trainer import Trainer

        self.ctx, cfg = ctx, ctx.config
        if ctx.device == "cuda":
            # a run after another in one process (control.py) starts from an
            # empty cache: the steps peak within 8 GB of the card's memory
            torch.cuda.empty_cache()
        phases = harness.Phases()
        self.m = model_config(cfg, ctx.device)
        self.num_items, self.max_len = cfg["num_items"], cfg["data"]["max_seq_len"]
        seqs = inputs_long.zipf_sequences(ctx.seed, cfg["num_users"], self.num_items,
                                          cfg["num_interactions"], cfg["zipf_exponent"])
        inputs.write_dataset(ctx.workdir, cfg["data"]["dataset"],
                             cfg["data"]["domain_name_list"][0], seqs, self.max_len,
                             self.num_items)
        self.rows = inputs.split_rows(seqs, self.max_len)
        del seqs
        run_cfg = {k: copy.deepcopy(cfg[k]) for k in ("data", "train", "eval")}
        run_cfg["model"] = dict(self.m)
        run_cfg["train"]["seed"] = ctx.seed
        if ctx.device == "cpu":
            run_cfg["train"]["precision"] = "fp32"
        run_cfg["eval"]["save_path"] = ctx.workdir
        self.run_cfg = run_cfg
        self.batch_size = run_cfg["train"]["batch_size"]
        phases.done("data")
        t = self.trainer = Trainer(run_cfg, prepare_datasets(run_cfg, root=ctx.workdir),
                                   workdir=ctx.workdir, device=ctx.device)
        t.init_state()
        named = dict(t.rec.module.named_parameters())
        self.init = {k: p.detach().to("cpu", copy=True) for k, p in named.items()}
        phases.done("trainer: the weights from the seed")
        self.batches = self._batches()
        self.prog, self._losses = {}, []
        for i in range(CHECKED_STEPS):
            self._step()
            if i == 0:
                self.prog["moment1"], self.prog["moment1_experts"] = _moment_norms(
                    t.optimizer, named)
        self.prog["losses"] = [float(x) for x in self._losses]
        self.prog["update"], self.prog["update_experts"] = _change_norms(named, self.init)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        phases.done("warm-up: the three checked steps")
        self.attempted = self.failed = 0
        self.window_rows = 0
        self.window_seqlens: List[np.ndarray] = []

    def _batches(self):
        for epoch in itertools.count():
            yield from self.trainer.train_batches(epoch)

    def _step(self):
        from dr4sr_tpu_torch.utils.spans import span

        with span("train.load"):
            host = next(self.batches)
        with span("train.stage"):
            batch = self.trainer.device_batch(host, is_train=True)
        loss = self.trainer.train_step(batch)
        if len(self._losses) < CHECKED_STEPS:
            self._losses.append(loss.detach())
        return host

    def unit(self) -> None:
        host = self._step()
        valid = np.asarray(host["valid"], bool)
        self.window_rows += int(valid.sum())
        self.window_seqlens.append(np.where(valid, host["seqlen"], 0))
        self.attempted += 1

    def end_to_end(self, window_s: float) -> dict:
        return {"train_seq_per_s": self.window_rows / window_s}

    def trace_units(self) -> int:
        return int(self.ctx.traffic["trace_steps"])

    def trace_work(self) -> dict:
        """The traced steps' work: the step count, the model FLOPs of the
        real positions (the held experts' share from the program's load
        counter), the least time of the attention calls that the batches'
        masks need (once each: remat's recomputation is not counted) and of
        the held experts' grouped products, and the counter itself."""
        from dr4sr_tpu_torch.utils import spans

        m = self.m
        counts = spans.read_counts() if hasattr(spans, "read_counts") else {}
        assignments = counts.get("moe.assignments")
        held = int(assignments.sum()) if assignments is not None else 0
        layers, h = m["num_hidden_layers"], m["num_attention_heads"]
        dqk, dv = m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"]
        fwd = bwd = 0.0
        for seqlen in self.window_seqlens:
            keys = np.arange(self.max_len)[None, :] < seqlen[:, None]
            args = (len(seqlen), h, self.max_len, self.max_len, dqk, dv, keys, True)
            fwd += layers * arith_moe.attention_fwd_bound_s(*args)
            bwd += layers * arith_moe.attention_bwd_bound_s(*args)
        seqlens = np.concatenate(self.window_seqlens) if self.window_seqlens else np.zeros(0)
        work = {"train_steps": len(self.window_seqlens),
                "flops": arith_moe.step_flops(seqlens, m, held),
                "attn_fwd_bound_s": fwd, "attn_bwd_bound_s": bwd}
        if assignments is not None:
            moe_passes = (layers - m["first_k_dense_replace"]) * len(self.window_seqlens)
            work.update(expert_gemm_bound_s=arith_moe.expert_gemm_bound_s(m, held, moe_passes),
                        expert_assignments=assignments.tolist(),
                        moe_tokens=int(counts["moe.tokens"]))
            harness.log(f"moe: {held} assignments on the held experts {assignments.tolist()} "
                        f"of {int(counts['moe.tokens'])} tokens routed x top-"
                        f"{m['num_experts_per_tok']}: held share "
                        f"{held / max(1, int(counts['moe.tokens']) * m['num_experts_per_tok'])!r}")
        return work

    def probes(self) -> dict:
        """The port's attention op at the cell's shape (bf16, Dqk 192 / Dv 128,
        MLA's scale) and the held experts' grouped products at a step's rows
        (the mean real positions of a batch × top-k, the held share of them
        unless folded), for a traced run to learn which kernels each
        launches."""
        from dr4sr_tpu_torch.modules.mla import yarn_mscale
        from dr4sr_tpu_torch.modules.moe import grouped_swiglu
        from dr4sr_tpu_torch.ops.attention import multihead_attention

        m, dev, b, l = self.m, self.ctx.device, self.batch_size, self.max_len
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        h, dqk = m["num_attention_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
        scale = dqk ** -0.5 * yarn_mscale(m["rope_scaling"]["factor"],
                                          m["rope_scaling"]["mscale_all_dim"]) ** 2

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).bfloat16().requires_grad_()

        q, k, v = randn(b, h, l, dqk), randn(b, h, l, dqk), randn(b, h, l, m["v_head_dim"])
        pad = torch.zeros(b, l, dtype=torch.bool, device=dev)
        pad[::2, l // 2:] = True
        att = multihead_attention(q, k, v, pad, True, scale)
        d, f, e = m["hidden_size"], m["moe_intermediate_size"], m["n_routed_experts_held"]
        real = float(np.minimum(self.rows["train"]["seqlen"], l).mean())
        rows = int(real * b) * m["num_experts_per_tok"]
        if not m["fold_foreign_experts"]:
            rows = rows * e // m["n_routed_experts"]
        xs, row_w = randn(rows, d), torch.ones(rows, device=dev)
        ws = [randn(e, f, d), randn(e, f, d), randn(e, d, f)]
        ends = torch.linspace(rows / e, rows, e, device=dev).to(torch.int32)
        # the incoming gradients made here, so that no fill kernel runs in a probe
        att_grad, ys_grad = torch.ones_like(att), torch.ones(rows, d, device=dev).bfloat16()

        def experts():
            out = grouped_swiglu(xs, row_w, *ws, ends)
            torch.autograd.grad(out, [xs, *ws], ys_grad)

        return {"attention_fwd": lambda: multihead_attention(q, k, v, pad, True, scale),
                "attention_bwd": lambda: torch.autograd.grad(att, (q, k, v), att_grad,
                                                             retain_graph=True),
                "moe_experts": experts}

    # ----------------------------------------------------------------- check
    def _checked_batches(self) -> List[Dict[str, torch.Tensor]]:
        batches = epoch_batches(self.rows["train"], self.batch_size, 0)
        return [on_device(b, self.ctx.device) for b in itertools.islice(batches, CHECKED_STEPS)]

    def _serve_program(self) -> None:
        """The window's last weights to the host, the optimizer's state
        freed, and ``Recommender``'s top-k scores of the checked histories."""
        from dr4sr_tpu_torch.serve import Recommender

        t = self.trainer
        self.state = {k: v.detach().to("cpu", copy=True)
                      for k, v in t.rec.module.state_dict().items()}
        t.optimizer = None
        t.rec.module.zero_grad(set_to_none=True)
        self._free()
        n, k = int(self.ctx.traffic["checked_histories"]), int(self.ctx.traffic["k"])
        val = self.rows["val"]
        self.serve_seq = torch.from_numpy(val["in_item_id"][:n].astype(np.int64))
        self.serve_len = torch.from_numpy(val["seqlen"][:n].astype(np.int64))
        histories = [row[:ln].tolist() for row, ln in zip(self.serve_seq.numpy(),
                                                           self.serve_len.numpy())]
        server = Recommender(t.rec, self.state, batch_size=n, device=self.ctx.device)
        _, scores = server.recommend(histories, k=k)
        self.prog["serve"] = torch.from_numpy(scores)
        self.batches.close()  # the loader's generator holds the trainer
        del server, self.trainer, self.batches, t
        self._free()

    def _free(self) -> None:
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, opts: ref.Options, init, half_batch: bool = False) -> dict:
        tr = self.run_cfg["train"]
        chunk = int(self.ctx.traffic["reference_chunk"])
        if opts.operand is not None:
            # every product's rounded operands, the weights' too, are kept
            # for the backward besides the originals: half the rows fit
            chunk = max(1, chunk // 2)
        run = RefRun(self.m, self.num_items, init, self.ctx.seed, self.ctx.device, chunk,
                     float(tr["learning_rate"]), opts, half_batch)
        run.run(self._checked_batches())
        dev = self.ctx.device
        served = run.serve(self.state, self.serve_seq.to(dev), self.serve_len.to(dev),
                           int(self.ctx.traffic["k"]))
        out = {"losses": run.losses, "moment1": run.moment1, "update": run.update,
               "moment1_experts": run.moment1_experts, "update_experts": run.update_experts,
               "serve": served}
        run.free()
        self._free()
        return out

    def check(self) -> dict:
        self._serve_program()
        init = ref.init_params(self.m, self.num_items, self.ctx.seed)
        if any(not torch.equal(init[k], self.init[k]) for k in init):
            harness.log("the reference's weights from the seed differ from the program's")
        self.ref_init = init
        self.ref = self._reference(ref.PLAIN, init)
        counted = checks.counted_leaves({k: torch.tensor(v) for k, v in
                                         self.ref["moment1"].items()})
        self.leaves = counted
        return numbers(self.prog, self.ref, self.leaves)

    def control(self) -> dict:
        out = {}
        for name, (opts, half_batch) in VARIANTS.items():
            out[name] = numbers(self._reference(opts, self.ref_init, half_batch), self.ref,
                                self.leaves)
            harness.log(f"{name}: {out[name]}")
        return out


def setup(ctx) -> MoETrainCell:
    return MoETrainCell(ctx)
