"""Each cell, run by the harness on the CPU at a tiny size, agrees with its
plain reference (the port's CPU route takes the reference's arithmetic, so
every compared number is exactly 0); and each fault that a cell can have,
planted under the timed path, turns ``correct`` false."""

import pytest
import torch

import harness
from conftest import tiny

SEED = 2**31 + 12345
CELLS = ["sasrec-toys.train", "regenerator-toys.decode", "sasrec-toys.serve",
         "regenerator-toys.pretrain"]


def run(cell, bench_path):
    return harness.run_cell(tiny(harness.load_spec(cell, bench_path)), SEED, 0.5, False,
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_agrees_with_reference(cell, bench_path):
    result = run(cell, bench_path)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0.0 for c in result["checks"].values()), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s"} < set(result["metrics"])


def _frozen_step(optimizer):
    optimizer.step = lambda closure=None: None
    return optimizer


def _state_unchanged_train(monkeypatch):
    from dr4sr_tpu_torch.train import trainer

    make = trainer.make_optimizer
    monkeypatch.setattr(trainer, "make_optimizer", lambda *a, **k: _frozen_step(make(*a, **k)))


def _state_unchanged_pretrain(monkeypatch):
    from dr4sr_tpu_torch.regen import pipeline

    make = pipeline.regen_optimizer

    def frozen(*args, **kwargs):
        optimizer, scheduler = make(*args, **kwargs)
        return _frozen_step(optimizer), scheduler

    monkeypatch.setattr(pipeline, "regen_optimizer", frozen)


def _half_batch_train(monkeypatch):
    from dr4sr_tpu_torch.models import base

    scores = base.pos_neg_scores

    def half(*args):
        pos, neg, mask = scores(*args)
        keep = torch.arange(mask.shape[0]) < mask.shape[0] // 2
        return pos, neg, mask & keep[:, None]

    monkeypatch.setattr(base, "pos_neg_scores", half)


def _epoch_order_stuck_train(monkeypatch):
    """A fault of the window alone: every epoch after the first replays the
    first's batches (a per-epoch shuffle lost)."""
    from dr4sr_tpu_torch.train.trainer import Trainer

    batches = Trainer.train_batches
    monkeypatch.setattr(Trainer, "train_batches", lambda self, nepoch: batches(self, 0))


def _half_batch_pretrain(monkeypatch):
    from dr4sr_tpu_torch.regen import pipeline

    loss = pipeline.generator_loss

    def half(logits, targets, cond, entropy_weight=1.0):
        keep = torch.arange(targets.shape[0], device=targets.device) < targets.shape[0] // 2
        return loss(logits, torch.where(keep[:, None], targets, 0), cond, entropy_weight)

    monkeypatch.setattr(pipeline, "generator_loss", half)


def _answer_altered_serve(monkeypatch):
    from dr4sr_tpu_torch.models import base

    topk = base.masked_topk_scores

    def altered(*args, **kwargs):
        scores, items = topk(*args, **kwargs)
        return scores, items.roll(1, dims=1)  # the ranks served out of order

    monkeypatch.setattr(base, "masked_topk_scores", altered)


def _token_altered_decode(monkeypatch):
    from dr4sr_tpu_torch.regen import decode

    pick = decode._greedy_pick

    def altered(logits, allowed, done, eos):
        worst = torch.where(allowed, -logits, -1e30).argmax(dim=-1)  # the least likely item
        return torch.where(allowed.sum(-1) > 1, worst, pick(logits, allowed, done, eos))

    monkeypatch.setattr(decode, "_greedy_pick", altered)


FAULTS = [("sasrec-toys.train", _state_unchanged_train),
          ("sasrec-toys.train", _half_batch_train),
          ("sasrec-toys.train", _epoch_order_stuck_train),
          ("regenerator-toys.pretrain", _state_unchanged_pretrain),
          ("regenerator-toys.pretrain", _half_batch_pretrain),
          ("sasrec-toys.serve", _answer_altered_serve),
          ("regenerator-toys.decode", _token_altered_decode)]


@pytest.mark.parametrize("cell,plant", FAULTS, ids=[f"{c}-{p.__name__}" for c, p in FAULTS])
def test_fault_turns_correct_false(cell, plant, monkeypatch, bench_path):
    plant(monkeypatch)
    result = run(cell, bench_path)
    assert not result["correct"], result["checks"]
