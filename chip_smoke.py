#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dr4sr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the package, from ``dr4sr_tpu_torch/ops/csrc``;
   the machine code (``cuobjdump -sass``) of both attention libraries must
   hold tensor-core ``HMMA`` instructions in every instantiation of every
   kernel that does products, bf16 and f32;
3. kernels: the attention forward against its plain PyTorch version on the
   card, at the serving (and training) shape, the eval batch and a stress
   shape, with and without a key-padding mask (one fully masked row per
   batch), with its device time per call beside the plain version's, one
   PyTorch library call's and the least time the card could take;
3b. the attention backward likewise, against
   ``flash_attention_bwd_reference``, and the whole ``FlashAttention`` path
   against autograd through ``mha_reference``;
4. serve: ``Recommender(device="cuda")`` answers three requests of 1,000
   histories on SASRec at the amazon-toys width (random weights from seed 0),
   through the kernels, and agrees with the same weights on the CPU route;
   then times one-batch requests, and profiles one more pass with
   ``torch.profiler`` (device time by kernel, host time by op, busy share);
5. train: ``Trainer(device="cuda").fit()`` for 3 epochs, then ``evaluate()``,
   on SASRec at the amazon-toys width over a synthetic dataset of
   amazon-toys' size (19,412 users, 11,925 items), through both kernels:
   launch counts, a falling loss, validation recall@20 above 5x random; the
   first step's gradients and 3 Adam steps' losses against the CPU route
   from the same weights and negatives; a few bf16 steps; timed steps; and
   a profile of a few steps;
6. regen: the regeneration pipeline at the amazon-toys width on the same
   synthetic data: stage 1 mines patterns (α 5, β 2) and pairs, with the
   JAX package's counts; stage 2 ``pretrain_regenerator(device="cuda")``
   for 60 steps of 256 pairs (a falling CE, 8 forward and 8 backward
   attention launches a step), card-vs-CPU gradients and 3 Adam steps from
   the committed trained regenerator; stage 3 ``hybrid_inference`` of every
   training sequence under K = 5 conditions from that regenerator (2
   forward launches a batch, none backward), its tokens against the CPU
   route's and beam width 1 against greedy (equal but for near ties), one
   bf16 batch; stage 4 one epoch of SASRec on the assembled ``train_regen``;
7. zoo: on the same data, each of GRU4Rec, FMLP and CL4SRec at the
   amazon-toys width with its ``configs/<model>.yaml`` widths: the first
   step's gradients and 3 Adam steps' losses against the CPU route (the
   same weights, negatives and views, dropout 0, TF32 off), a bounded run
   of ``Trainer.train_step`` (a falling loss, attention launches 6 forward
   and 6 backward a CL4SRec step, none for GRU4Rec and FMLP) and one
   validation pass (recall@20 above 5x random), timed steps, a few bf16
   steps, the GRU's and the FFT filter's device time, a profile of 5 steps;
   CL4SRec2 on stage 4's ``train_regen`` with views of the original rows;
   the ``condense``, ``split`` and ``selection`` dataset classes (their row
   counts against the JAX package's, 10 SASRec steps each);
8. graph: on the same data, each of GNN, SGL, SimGCL, NCL and ICLRec at the
   amazon-toys width with its ``configs/<model>.yaml``: both item-transition
   graphs' edge counts against the JAX package's; the first step's
   gradients and 3 Adam steps' losses against the CPU route (the same
   weights, negatives and aux draws; NCL's and ICLRec's refreshed state
   from the card in both); a bounded run through the epoch hook (so
   NCL's and ICLRec's ``refresh_state`` runs on the card) and one
   validation pass (recall@20 above 5x random), with launch counts; the
   k-means of NCL's and ICLRec's refresh, Lloyd step by Lloyd step, card
   against CPU; timed steps, a few bf16 steps, the propagation's and the
   k-means' device time, the refresh's wall time and a profile of 5 steps;
9. meta: on the same data, DR4SR+ (``MetaTrainer``, configs/metamodel.yaml's
   meta keys with warm-up 0) around SASRec at the amazon-toys width: one
   outer step's hypergradient and meta update, and the weighted steps'
   gradients and losses, card against CPU (the same weights, batches,
   negatives and Gumbel noise; dropout 0); ``fit()`` for 2 epochs (epoch 0
   warm, epoch 1 weighted, outer steps every 30 steps) through both kernels,
   with launch counts (none inside an outer step, which takes the plain
   attention route), the weight statistics, moved meta parameters and
   validation recall@20 above 5x random; timed weighted and outer steps and
   their profiles (the plain attention's share of an outer step's device
   time); around FMLP, the shipped sub-model, the same card-vs-CPU checks
   and a few warm, weighted and outer steps (no attention); around GRU4Rec
   one outer step card against CPU (cuDNN off: its RNN has no double
   backward); around SGL 3 warm steps (with SGL's aux term and its edge
   masks), an outer step and 3 weighted steps (without the term) card
   against CPU, with launch counts;
10. fused: on the same data, ``train.steps_per_dispatch = 16``, each group
   of 16 steps one replay of a CUDA graph that holds both attention
   kernels: a group through the graph against the same steps eagerly
   (twice, from one state: parameters, Adam's moments, losses and both
   generators' states, launches and collectives) for SASRec, DR4SR+'s
   weighted steps around SASRec, FMLP, bf16 SASRec and the rest of the zoo
   (CL4SRec, CL4SRec2 and ICLRec under the shipped ``item_random``, its
   pick on the device); ``fit()`` of SASRec for 3 epochs (graphs of 16 and
   12 steps) and of DR4SR+ for 2 (groups cut at every ``interval``
   boundary, the outer steps eager between them) with phase 5's and phase
   9's launch counts; one profiled replay (32 forward and 32 backward
   kernels, one ``cudaGraphLaunch``); groups and DR4SR+ intervals timed
   through the graphs and eagerly; CL4SRec's picks over 48 replays of a
   group of 4 read back against the same steps' eager picks (every branch
   taken); SASRec with ``model.remat`` at dropout 0.5: the graph against
   eager with remat, and eager without remat against eager with it;
11. dist: on the same data, SASRec at the amazon-toys width (dropout 0)
   over ``torch.distributed``: NCCL at world size 1 (a ``Trainer`` over a
   1 × 1 mesh with ``shard_embedding``, 3 steps and a validation pass,
   bitwise equal to a plain one, and an epoch of each at N = 16 through
   graphs, bitwise); then ranks spawned on the one card over
   gloo (NCCL takes no two ranks of a communicator on one card; gloo sends
   are staged through pinned host memory): DP 2 × 1, EP 1 × 2 (table
   11,925 → 11,926 rows), CP 1 × 2 (L 50 → 25 a rank) and one step of 2 × 2
   (EP and CP) on four processes, each from one rank's weights, batches
   and negatives (one batch's halves hold unequal valid rows) against one
   rank on the card: 3 Adam losses (atol 1e-5) and the first step's
   gradients (each parameter's error over its largest ≤ 1e-5), replicas
   bitwise equal across ranks, the sharded eval of one rank's final
   weights against its unsharded eval (metrics atol 1e-5; top-k ids equal
   but at near ties), attention launches as predicted, a step's
   collectives by kind and axis (EP: only the gathered embeddings' all-
   reduces; CP: the ring's sends and the all-gathers of o, dq, dk, dv, none
   of K or V); the ring through both kernels against one rank's
   ``FlashAttention`` at [256, 2, 50, 32], f32 and bf16, causal and not,
   with a fully padded row; the artifact's decode of 4,096 sequences under
   K = 5 on 2 ranks, token for token as one rank's; step times of each run
   beside one rank's (host-staged gloo on one card: not a multi-GPU
   speed; N = 16 on the DP mesh is refused by name: gloo stages CUDA
   tensors through the host). Then the zoo and DR4SR+ on a mesh
   (``dist_more``): CL4SRec,
   ICLRec and SGL over DP 2 × 1, NCL and CL4SRec over 2 × 2 (DP × EP), GNN
   and SimGCL over EP 1 × 2, CL4SRec over CP 1 × 2 (2 steps each), and
   DR4SR+ around SASRec over DP 2 × 1 and EP 1 × 2 (a weighted, an outer
   and a weighted step), each at its config's widths from one rank's
   weights, batches, negatives, views, aux draws and per-epoch state
   against one rank on the card: losses, first-step gradients, replicas,
   NCL's and ICLRec's own refreshed state and DR4SR+'s meta parameters
   bitwise across ranks, the hypergradient, launches and each step's
   collectives as predicted. The mesh runs of one world size share one
   spawn of ranks (a process start and a data load each, not one a run);
12. tools: on the same data, the trainer's tooling: the dataset rebuilt
   from its ``seq2pat_data.npz`` by ``python -m
   dr4sr_tpu_torch.scripts.preprocess --from-seq2pat`` (a subprocess);
   ``quickstart.run(device="cuda")`` of SASRec for 3 epochs with
   ``train.tensorboard_dir`` and epoch 1 profiled: the log file's config,
   epoch and test lines, the event file read back by a reader here (every
   record's masked CRC-32C) equal to ``metrics.jsonl`` at f32, the
   profiled epoch's trace holding as many forward and backward attention
   kernel rows as the counters grew in it (2 a step each), launches of the
   run and of every epoch, validation recall@20 above 5x random, the
   analyzer's figure (or none without matplotlib); ``quickstart.tune``
   over two learning rates, each run through both kernels and the best by
   ``val_best``; the run's best checkpoint served by
   ``Recommender.from_checkpoint``, then again with its item table padded
   by a row as EP saves it (the same ids); a run at
   ``train.steps_per_dispatch = 16`` whose profiled epoch holds the
   kernels the graphs replay; each epoch's wall time with and without the
   profiler.
13. suite: on the same data, the experiment harness
   (``dr4sr_tpu_torch/scripts/``): the evidence matrix's stage-1 jobs on
   amazon-toys (SASRec base and ``_regen`` at seeds 2023 and 7, 2 epochs)
   through ``run_chunk.run_jobs`` in this process, each job's attention
   launches counted and its validation recall@20 above 5x random; the same
   jobs through ``run_suite``'s subprocesses (``python -m
   dr4sr_tpu_torch.run`` on the card), their test metrics bit for bit the
   in-process ones, and a second ``run_suite`` on the same file that runs
   no job; ``regen_sweep`` of three trials (two sharing stages 1 and 2),
   its stage runs counted and every stage 3 reading this sweep's own
   checkpoint; ``summarize_r3``'s DR4SR row against the paired Δ and wins
   of the records. No job or trial may leave an error record. The first
   ``run_suite`` and the sweep (processes of their own) run beside the
   in-process jobs, whose launches only this process counts.

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX. Kernel times
are device time per call (:func:`device_ms`).

    python3 chip_smoke.py --controls

runs only the card-vs-CPU gradient checks of phases 5, 6, 7 (CL4SRec) and 9
(SASRec's weighted step),
once with each of a few deliberate faults patched into the backward route,
phase 10's graph-against-eager check of SASRec with the trainer's
generator left unregistered and with a group's batches not copied into the
graph's inputs, and phase 11's checks against one rank with the EP
gather's backward summing over ``model``, the ring's backward without its
last send, the loss's denominator left per rank, CL4SRec's views gathered
with ``gather_seq``'s backward (each rank's own chunk of the cotangent),
and DR4SR+'s Hessian-vector products left out of the all-reduce over
``data``, and phase 10's pick and remat checks with a captured step's
pick a host constant and with remat's recompute drawing fresh dropout
masks, and phase 13's checks with a job naming an unknown model (an error
record) and with a sweep whose domain holds the JAX sweep's checkpoint and
decode cache for its tags read under the JAX names; it prints whether the
check caught each (a ``control {...}`` line per path and fault).

    python3 chip_smoke.py --nccl              # on NCCL_CARDS (4) cards

runs phase 11 over NCCL, rank r on card r (it raises when fewer cards are
visible), then the fused runs on a mesh (``dist_fused``): SASRec at N = 16
over DP 2 × 1, EP 1 × 2, CP 1 × 2 and 2 × 2, CL4SRec over DP 2 × 1 under
``item_random`` and DR4SR+'s weighted groups over DP 2 × 1, each rank's
group of 16 through its CUDA graph, the collectives inside it, against the
same steps eagerly (phase 10's rule), replicas bitwise, attention launches
and collectives of the group by kind and axis as predicted, and groups
timed against an N = 1 trainer on the same mesh; it ends with the same
``{"ok": true, ...}`` line. ``--nccl --controls`` checks that a replay
that does not count its collectives is caught.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import importlib.util
import itertools
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dr4sr_tpu_torch import quickstart
from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import markov_sequences, write_synthetic_dataset
from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.cl4srec import augment_views
from dr4sr_tpu_torch.models.gnn import batch_graph, build_transition_graph
from dr4sr_tpu_torch.models.iclrec import ICLRec
from dr4sr_tpu_torch.models.sasrec import SASRec
from dr4sr_tpu_torch.modules.graph_augmentation import (
    edge_dropout,
    kmeans,
    kmeans_init,
    lloyd_update,
    propagate_layers,
    propagate_mean,
    squared_distances,
)
from dr4sr_tpu_torch.ops import _build, attention
from dr4sr_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    mha_reference,
)
from dr4sr_tpu_torch.ops.graphs import CudaGraphs
from dr4sr_tpu_torch.regen.decode import (
    beam_decode_batch_cached,
    decode_dataset,
    frame_sources,
    greedy_decode_batch_cached,
)
from dr4sr_tpu_torch.regen.generator import NEG, Generator, frame_pairs, gumbel_noise
from dr4sr_tpu_torch.regen.miner import match_pairs, mine_patterns
from dr4sr_tpu_torch.regen.pipeline import (
    assemble_train_regen,
    hybrid_inference,
    pattern_rows,
    pretrain_regenerator,
    pretrain_step,
    regen_optimizer,
    train_sequences_from_rows,
)
from dr4sr_tpu_torch.serve import Recommender
from dr4sr_tpu_torch.train.checkpoint import load_jax_checkpoint, load_regenerator
from dr4sr_tpu_torch.train.fused import StepGraphs
from dr4sr_tpu_torch.train.meta_trainer import MetaTrainer
from dr4sr_tpu_torch.train.trainer import Trainer

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# tensor-core FLOP/s. A bound is the least time the card could take for the
# work, whatever route a kernel takes, so f32 products count at the faster
# of the card's two f32-accurate routes: 3xTF32 on tensor cores (495
# TFLOP/s of TF32, three products each: 165 TFLOP/s), not FMA on CUDA cores
# (67 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # as tests/test_attention.py
ATOL_BWD = {torch.float32: 3e-4, torch.bfloat16: 8e-2}  # as tests/test_attention.py
PATH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}  # one bf16 step, relative
BWD_KEY_TILE = 64  # the backward is one kernel a call when Lk fits this tile, else two

# amazon-toys SASRec: configs/{amazon-toys,basemodel,sasrec}.yaml, written out
NUM_ITEMS = 11925
CONFIG = {
    "data": {"dataset": "amazon-toys", "domain_name_list": ["toy"], "max_seq_len": 50},
    "model": {"model": "SASRec", "embed_dim": 64, "head_num": 2, "layer_num": 2,
              "hidden_size": 128, "dropout_rate": 0.5, "activation": "gelu",
              "layer_norm_eps": 1e-12},
}
BATCH = 256
TOPK = 20
SERVE_PASSES = 9  # 9 x 12 one-batch requests: p90 has 10 samples above it

# training at the amazon-toys width: configs/{amazon-toys,basemodel,sasrec}.yaml
# written out, on a synthetic dataset of amazon-toys' size (19,412 users)
NUM_USERS = 19412
TRAIN_CONFIG = {
    "data": {"dataset": "amazon-toys", "domain_name_list": ["toy"], "max_seq_len": 50,
             "dataset_class": "general", "train_file": ""},
    "model": {**CONFIG["model"], "loss_fn": "bce"},
    "train": {"batch_size": BATCH, "epochs": 3, "optimizer": "adam", "learning_rate": 1e-3,
              "weight_decay": 0.0, "num_neg": 1, "seed": 2023, "early_stop_mode": "max",
              "early_stop_patience": 20, "precision": "fp32"},
    "eval": {"batch_size": 2048, "cutoff": [20, 10], "val_metrics": ["ndcg", "recall"],
             "test_metrics": ["ndcg", "recall"], "topk": 100},
}
# card vs CPU from the same weights and negatives, dropout 0, TF32 off: f32
# sums run in another order (cuBLAS, the kernels, LayerNorm's reductions).
# Each parameter's error is taken relative to its largest gradient.
GRAD_RTOL = 1e-5
LOSS_ATOL = 1e-5

# (name, B, H, Lq, Lk, Dh, causal, dtype): the serving shape first; every
# head dim the kernel is built for, ragged tiles, and Lq != Lk
ATTENTION_CASES = [
    ("serve_f32", 256, 2, 50, 50, 32, True, torch.float32),
    ("serve_bf16", 256, 2, 50, 50, 32, True, torch.bfloat16),
    ("stress_f32", 128, 4, 512, 512, 64, True, torch.float32),
    ("stress_bf16", 128, 4, 512, 512, 64, True, torch.bfloat16),
    ("cross_f32", 64, 2, 20, 50, 32, False, torch.float32),
    ("dh16_bf16", 16, 2, 100, 100, 16, True, torch.bfloat16),
    ("dh128_f32", 16, 2, 130, 130, 128, True, torch.float32),
    # the regenerator's pretrain step: its encoder over 52-token sources,
    # the condition encoder and decoder self-attention over 26-token
    # targets, the decoder's cross-attention from targets to sources
    ("regen_src_f32", 256, 2, 52, 52, 32, True, torch.float32),
    ("regen_tgt_f32", 256, 2, 26, 26, 32, True, torch.float32),
    ("regen_cross_f32", 256, 2, 26, 52, 32, False, torch.float32),
    # a block of phase 11's ring at context parallelism 2: L = 50 in two
    # chunks of 25, the rank's own block causal and an earlier one not
    ("ring_block_causal_f32", 256, 2, 25, 25, 32, True, torch.float32),
    ("ring_block_full_f32", 256, 2, 25, 25, 32, False, torch.float32),
]
# forward only: the eval batch of the train path and the regenerator's
# encoder at decode (non-causal); neither takes a gradient
FWD_ONLY_CASES = [("eval_f32", 2048, 2, 50, 50, 32, True, torch.float32),
                  ("regen_decode_f32", 1024, 2, 52, 52, 32, False, torch.float32)]

# the regenerator as scripts/pretrain_regenerator.py trains it and the
# committed artifact holds it (trained on amazon-toys: K = 5, D = 64, 2
# heads, 2 encoder and 2 decoder layers, FFN 256, 11,925 items)
ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                        "regenerator_toys_a5b2K5ew1p0.msgpack")
REGEN_K = 5
# stage 1 with α = 5, β = 2 on the 19,412 Markov sequences: the JAX
# package's miner (dr4sr_tpu.regen.miner, CPU) finds these many patterns,
# and (sequence, pattern) pairs at 10 matches a sequence, seed 2024
JAX_MINER_COUNTS = (179381, 192497)
PRETRAIN_STEPS = 60  # one epoch over the first 60 batches of 256 pairs
# attention calls of a pretrain step: encoder 2, condition encoder 2, decoder
# self 2 and cross 2; each backward is one kernel (every Lk <= 64)
PRETRAIN_ATTENTION = 8
DECODE_BATCH = 1024
DECODE_MAX_LEN = 25
DECODE_CHECKED = 1024  # sequences decoded on both routes under every condition
# tokens of two routes may differ in a lane only where the first differing
# step had its two best allowed logits within NEAR_TIE, and in at most
# NEAR_TIE_SHARE of the lanes
NEAR_TIE = 1e-4
NEAR_TIE_SHARE = 0.01
# the regenerator's card-vs-CPU check runs at gumbel temperature 3, not the
# pipeline's starting 1: the artifact's condition logits lie far apart, so
# at τ = 1 its condition probabilities are 1.0000 and the condition layer's
# gradients are residues of cancellation, which f32 alone gets 7.1e-4 (of
# their largest) wrong on the CPU route against float64; at τ = 3 (largest
# probability about 0.99) no parameter's f32 error there exceeds 2.5e-6
REGEN_PARITY_TAU = 3.0

# phase 7, the zoo: configs/basemodel.yaml's model section and each model's
# configs/<model>.yaml, written out as (model section, train section)
ZOO_MODELS = {
    "GRU4Rec": ({"hidden_size": 256, "layer_num": 2, "dropout_rate": 0.2},
                {"learning_rate": 1e-3, "weight_decay": 1e-4}),
    "FMLP": ({"layer_num": 2, "dropout_rate": 0.5}, {}),
    "CL4SRec": ({**{k: v for k, v in CONFIG["model"].items() if k != "model"},
                 "augment_type": "item_random", "temperature": 1.0, "cl_weight": 0.1,
                 "tau": 0.2, "gamma": 0.7, "beta": 0.2}, {}),
}
ZOO_MODELS["CL4SRec2"] = ZOO_MODELS["CL4SRec"]
# train steps on the card. FMLP trains on per-prefix rows with one target
# each (279,880 rows from the 19,412 train rows, 1,094 steps an epoch), where
# the others' rows carry 14.4 targets on average, so it takes 300 steps.
# GRU4Rec takes 600 (8 epochs), without weight decay (ZOO_RUN_TRAIN)
ZOO_STEPS = {"GRU4Rec": 600, "FMLP": 300, "CL4SRec": 60, "CL4SRec2": 60}
# train-section changes for the bounded runs only (the card-vs-CPU checks
# keep each config as it is): under configs/gru4rec.yaml's coupled weight
# decay 1e-4, Adam moves every item row that a batch misses by about the
# learning rate toward 0 (its whole gradient is the decay term), so on an
# 11,925-item catalog GRU4Rec's loss barely falls and its recall stays near
# random; the same run with the shipped decay is reported beside it
# (``shipped_train_config`` on the zoo line), not checked
ZOO_RUN_TRAIN = {"GRU4Rec": {"weight_decay": 0.0}}
# attention calls of a CL4SRec step: 3 encodes (the batch, two views) x 2 layers
CL_ATTENTION = 3 * 2
# train rows of each ablation dataset class on the synthetic data: the JAX
# package's dr4sr_tpu.data.dataset (CPU) builds these many
JAX_CLASS_ROWS = {"condense": 6721, "split": 20865, "selection": 9706}
CLASS_STEPS = 10

# phase 8, the graph and intent models: configs/basemodel.yaml's model
# section and each configs/<model>.yaml, written out
_SASREC_WIDTHS = {k: v for k, v in CONFIG["model"].items() if k != "model"}
GRAPH_MODELS = {
    "GNN": {**_SASREC_WIDTHS, "graph": "old", "gnn_layer": 3, "window": 2},
    "SGL": {**_SASREC_WIDTHS, "graph": "new", "gnn_layer": 2, "window": 2, "ssl_ratio": 0.1,
            "ssl_weight": 0.1, "ssl_temperature": 0.2},
    "SimGCL": {**_SASREC_WIDTHS, "graph": "new", "gnn_layer": 2, "window": 2, "noise_eps": 0.1,
               "ssl_weight": 0.1, "ssl_temperature": 0.2},
    "NCL": {**_SASREC_WIDTHS, "graph": "new", "hyper_layers": 1, "window": 2,
            "num_clusters": 64, "ssl_weight": 0.1, "proto_weight": 0.1, "ssl_temperature": 0.2},
    "ICLRec": {**_SASREC_WIDTHS, "augment_type": "item_random", "temperature": 1.0,
               "instance_weight": 0.1, "intent_weight": 0.1, "num_intent_clusters": 32},
}
# edges of the 'old' (val rows without their last item) and 'new' (train
# rows) graphs, window 2, on the synthetic data: the JAX package's
# dr4sr_tpu.models.gnn.build_transition_graph (CPU) builds these many
JAX_GRAPH_EDGES = {"old": 202779, "new": 202779}
GRAPH_STEPS = 60
# SASRec encodes a step, (forward, with gradient): ICLRec's are the batch,
# the pooled encode that picks the intents (no gradient) and two views
GRAPH_ENCODES = {"GNN": (1, 1), "SGL": (1, 1), "SimGCL": (1, 1), "NCL": (1, 1),
                 "ICLRec": (4, 3)}
# k-means, card against CPU from the same centroids at every Lloyd step: an
# assignment may differ only where the CPU's two smallest squared distances
# lie within KMEANS_NEAR_TIE; the updated centroids within KMEANS_ATOL
KMEANS_NEAR_TIE = 1e-4
KMEANS_ATOL = 1e-5

# phase 9, DR4SR+: configs/metamodel.yaml's meta keys, written out (the sub-
# model's own config is phase 5's or 7's), with warm-up cut from 10 epochs
# to 0 so that two epochs run one warm and one weighted
META_MODEL = {"model": "MetaModel", "tau_min": 1.0}
META_TRAIN = {"interval": 30, "meta_optimizer": "sgd", "meta_learning_rate": 1e-3,
              "hpo_learning_rate": 1e-3, "meta_weight_decay": 1e-3, "warmup_epoch": 0}
META_EPOCHS = 2
# the hypergradient card vs CPU (same weights, batches, negatives and Gumbel
# noise; dropout 0, TF32 off), each meta parameter's error over its largest
# element; the meta parameters after the SGD step within HYPER_RTOL of the
# step's largest change, plus META_ULPS f32 roundings of the parameter (an
# update far below one ulp, as τ's at 10, rounds either way)
HYPER_RTOL = 1e-4
META_ULPS = 4
META_TIMED = 10  # outer steps timed on fixed batches, and weighted steps 3x as many


def log(msg: str) -> None:
    print(msg, flush=True)


TIMING = "device time per call: torch.profiler's kernel time over 50 calls, summed, / 50"


def device_ms(fn, calls: int = 50) -> float:
    """Device time per call of ``fn``: the duration of every device activity
    that ``calls`` calls launch, as ``torch.profiler`` reads it, summed and
    divided by ``calls``, after one warm-up call. The host's enqueue time and
    the gaps between launches are not in it (a CUDA-event window over a few
    calls at small shapes measures them instead). Now and then a profiling
    session records no device activity at all (once in about 200 sessions
    over three runs); that session is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in _device_rows(prof.key_averages()))
        if us > 0:
            return us / calls / 1e3
        log(f"device_ms: the profiler saw no device time (session {attempt} of 3)")
    raise AssertionError("the profiler saw no device time in 3 sessions")


def _unmasked_pairs(pad, lq, lk, causal):
    """(batch, query, key) triples that this mask leaves unmasked."""
    pairs = (~pad)[:, None, :].expand(pad.shape[0], lq, lk)
    if causal:
        pairs = pairs & torch.ones(lq, lk, dtype=torch.bool, device=pad.device).tril()
    return int(pairs.sum())


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bound_ms(q, k, v, pad, causal):
    """The least time for this call: each input read once and the output
    written once at the HBM rate, or the products that this data needs
    (q·kᵀ and p·v over unmasked pairs) at the dtype's peak."""
    b, h, lq, dh = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + pad.numel()
    flops = 4 * dh * h * _unmasked_pairs(pad, lq, k.shape[2], causal)
    return _bound(nbytes, flops, q.dtype)


def attention_bwd_bound_ms(q, k, pad, causal):
    """The backward's least time: q, k, v, o, dO, the row statistics and the
    mask read once and dq, dk, dv written once, or 10·Dh FLOP per unmasked
    pair and head for the five products (q·kᵀ, dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q)."""
    b, h, lq, dh = q.shape
    es = q.element_size()
    nbytes = es * 4 * (q.numel() + k.numel()) + 4 * b * h * lq + pad.numel()
    flops = 10 * dh * h * _unmasked_pairs(pad, lq, k.shape[2], causal)
    return _bound(nbytes, flops, q.dtype)


def check_attention(seed, name, b, h, lq, lk, dh, causal, dtype):
    """The forward kernel against ``mha_reference``, with a key-padding mask
    (one fully masked row, which must be exactly 0) and without; then its
    device time beside the plain version's and SDPA's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    seqlen = torch.randint(0, lk + 1, (b,), generator=gen, device="cuda")
    seqlen[0] = 0  # one fully masked row in every batch
    pad = torch.arange(lk, device="cuda")[None, :] >= seqlen[:, None]
    with torch.no_grad():
        out = flash_attention_fwd(q, k, v, pad, causal)[0]
        out_nomask = flash_attention_fwd(q, k, v, None, causal)[0]
        torch.cuda.synchronize()
        ref = mha_reference(q, k, v, pad, causal)
        ref_nomask = mha_reference(q, k, v, None, causal)
    if not (torch.isfinite(out).all() and torch.isfinite(out_nomask).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if (out[0] != 0).any():
        raise AssertionError(f"{name}: the fully masked row is not 0")
    err = max((out.float() - ref.float()).abs().max().item(),
              (out_nomask.float() - ref_nomask.float()).abs().max().item())
    if err > ATOL[dtype]:
        raise AssertionError(f"{name}: max |kernel - plain| {err} > {ATOL[dtype]}")
    # SDPA gives NaN on fully masked rows, so its yardstick inputs have none
    lib_len = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
    attend = (torch.arange(lk, device="cuda")[None, :] < lib_len[:, None])[:, None, None, :]
    if causal:
        attend = attend & torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()
    with torch.no_grad():
        ms = device_ms(lambda: flash_attention_fwd(q, k, v, pad, causal))
        plain_ms = device_ms(lambda: mha_reference(q, k, v, pad, causal))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attend))
    bound_ms, bound_by = attention_bound_ms(q, k, v, pad, causal)
    case = {"case": name, "shape": [b, h, lq, lk, dh], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "atol": ATOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "timing": TIMING}
    log(f"kernel case {json.dumps(case)}")
    return case


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def check_attention_bwd(seed, name, b, h, lq, lk, dh, causal, dtype):
    """The backward against ``flash_attention_bwd_reference`` on the same o,
    with a key-padding mask (one fully masked row) and without; the whole
    ``FlashAttention`` path against autograd through ``mha_reference``."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    do = torch.randn(b, h, lq, dh, generator=gen, device="cuda").to(dtype)
    seqlen = torch.randint(0, lk + 1, (b,), generator=gen, device="cuda")
    seqlen[0] = 0  # one fully masked row in every batch
    pad = torch.arange(lk, device="cuda")[None, :] >= seqlen[:, None]
    err = 0.0
    with torch.no_grad():
        for mask in (pad, None):
            o, lse = flash_attention_fwd(q, k, v, mask, causal, want_lse=True)
            before = flash_attention_bwd.launches
            got = flash_attention_bwd(q, k, v, o, do, lse, mask, causal)
            kernels_per_call = flash_attention_bwd.launches - before
            torch.cuda.synchronize()
            if kernels_per_call != (1 if lk <= BWD_KEY_TILE else 2):
                raise AssertionError(f"{name}: the backward launched {kernels_per_call} kernels")
            want = flash_attention_bwd_reference(q, k, v, o, do, mask, causal)
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{name}: non-finite backward output")
            if mask is pad and any((g[0] != 0).any() for g in got):
                raise AssertionError(f"{name}: the fully masked batch row has gradients")
            err = max(err, _max_err(got, want))
    if err > ATOL_BWD[dtype]:
        raise AssertionError(f"{name}: max |bwd kernel - plain| {err} > {ATOL_BWD[dtype]}")

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves, pad, causal), leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_reference(*ref_leaves, pad, causal), ref_leaves, do)
    # autograd of mha_reference rounds neither p nor ds to bf16, so in bf16
    # the two may differ by one bf16 step of the gradient's own size as well
    rtol = PATH_RTOL[dtype]
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    path_err = max(d.max().item() for d in diffs)
    # the size of the gradient where the path's error is largest
    i = max(range(len(diffs)), key=lambda i: diffs[i].max().item())
    path_grad_at_err = want[i].flatten()[diffs[i].argmax()].abs().item()
    excess = max((d - rtol * w.float().abs()).max().item() for d, w in zip(diffs, want))
    if excess > ATOL_BWD[dtype]:
        raise AssertionError(f"{name}: FlashAttention grads vs autograd of mha_reference "
                             f"{path_err} > {ATOL_BWD[dtype]} + {rtol}·|grad|")

    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, pad, causal, want_lse=True)
        ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, pad, causal))
        plain_ms = device_ms(lambda: flash_attention_bwd_reference(q, k, v, o, do, pad, causal))
    # SDPA gives NaN on fully masked rows, so its yardstick inputs have none;
    # its graph is built once and only the backward is timed
    lib_len = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
    attend = (torch.arange(lk, device="cuda")[None, :] < lib_len[:, None])[:, None, None, :]
    if causal:
        attend = attend & torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=attend)
    library_ms = device_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del out, leaves
    bound_ms, bound_by = attention_bwd_bound_ms(q, k, pad, causal)
    case = {"case": name, "shape": [b, h, lq, lk, dh], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""),
            "kernels_per_call": kernels_per_call,
            "max_abs_err": err,
            "path_max_abs_err": path_err, "path_grad_at_err": path_grad_at_err,
            "atol": ATOL_BWD[dtype], "path_rtol": rtol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "timing": TIMING}
    log(f"kernel case bwd {json.dumps(case)}")
    return case


def serve(requests, card):
    """Serve ``requests`` on the card; check the answers; time them."""
    module = SASRec.build(CONFIG, NUM_ITEMS, generator=torch.Generator().manual_seed(0))
    rec = RecModel(CONFIG, module, NUM_ITEMS, 0)
    gpu = Recommender(rec, module.state_dict(), batch_size=BATCH, device="cuda")
    gpu.recommend(requests[0][:BATCH], k=TOPK)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    answers = [gpu.recommend(r, k=TOPK) for r in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    bwd_launches = flash_attention_bwd.launches

    L = CONFIG["data"]["max_seq_len"]
    batches = sum(-(-len(r) // BATCH) for r in requests)
    want = CONFIG["model"]["layer_num"] * batches
    if launches != want or bwd_launches != 0:
        raise AssertionError(f"serving launched the forward {launches} times (want {want}) "
                             f"and the backward {bwd_launches} times (want 0)")
    for hist, (items, scores) in zip(requests, answers):
        if items.shape != (len(hist), TOPK) or not np.isfinite(scores).all():
            raise AssertionError("bad shape or non-finite scores")
        if (items == 0).any():
            raise AssertionError("PAD recommended")
        for h, row in zip(hist, items):
            if len(set(row.tolist())) != TOPK or set(row.tolist()) & set(h[-L:]):
                raise AssertionError("repeated or already seen item recommended")

    cpu = Recommender(rec, module.state_dict(), batch_size=BATCH, device="cpu")
    tol = 1e-4
    for hist, (items, scores) in zip(requests, answers):
        want_i, want_s = cpu.recommend(hist, k=TOPK)
        err = np.abs(scores - want_s).max()
        if err > tol:
            raise AssertionError(f"card vs CPU scores differ by {err} > {tol}")
        gap = np.abs(np.diff(want_s, axis=1)) > tol
        sep = np.ones(want_s.shape, bool)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        sep[:, -1] = False
        if (items[sep] != want_i[sep]).any():
            raise AssertionError("card vs CPU ranking differs where scores are apart")

    # steady state, uncounted: one-batch requests, each timed to its answer
    flat = [h for r in requests for h in r]
    chunks = [flat[i : i + BATCH] for i in range(0, len(flat), BATCH)]
    lat_ms = []
    for _ in range(SERVE_PASSES):
        for chunk in chunks:
            t0 = time.perf_counter()
            gpu.recommend(chunk, k=TOPK)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    result = {"histories": len(flat), "batches": batches, "batch_size": BATCH, "k": TOPK,
              "checked_pass_s": wall, "batch_ms_p50": float(np.percentile(lat_ms, 50)),
              "batch_ms_p90": float(np.percentile(lat_ms, 90)), "batch_samples": len(lat_ms),
              "histories_per_s": SERVE_PASSES * len(flat) / (sum(lat_ms) / 1e3),
              "attention_launches": launches, "attention_bwd_launches": bwd_launches,
              "card": card}
    log(f"serve {json.dumps(result)}")
    profiled(f"one serving pass, {batches} batches",
             lambda: [gpu.recommend(r, k=TOPK) for r in requests])
    return launches, bwd_launches


def profiled(label, fn):
    """``fn()`` under ``torch.profiler``: device time by kernel, host time by
    op, and the device's busy share of the wall time (:func:`_log_profile`).
    Returns (device µs, wall µs)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"profile: {label}")
    return _log_profile(prof, wall_us), wall_us


def _device_rows(events):
    """The device's own activity: kernels, copies and sets. A user annotation
    (``Optimizer.step#Adam.step``) also has a device row, which spans the
    kernels launched inside it and would count them twice."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _log_profile(prof, wall_us):
    """Device time by kernel (kernel rows only: an op's row repeats the
    device time of its kernels), host time by op, and the busy share."""
    events = prof.key_averages()
    kernels = _device_rows(events)
    device_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile wall_us {wall_us:.1f} device_busy_us {device_us:.1f} "
        f"busy_share {device_us / wall_us:.4f} (profiler on)")
    # the top 12 by device time, and the attention kernels wherever they rank
    for rank, e in enumerate(sorted(kernels, key=lambda e: -e.self_device_time_total), 1):
        if rank <= 12 or "flash_" in e.key:
            log(f"  rank {rank:3d} device_us {e.self_device_time_total:10.1f} "
                f"calls {e.count:6d} {e.key[:90]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  host_us {e.self_cpu_time_total:10.1f} calls {e.count:6d} {e.key[:90]}")
    return device_us


def _train_cfg(workdir, **train):
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["eval"]["save_path"] = workdir
    cfg["train"].update(train)
    return cfg


def card_vs_cpu(datasets, workdir):
    """SASRec from the same initial weights, with dropout 0 and the same fed
    negatives: the first step's gradients and 3 Adam steps' losses, card
    against CPU. Returns the errors; :func:`check_card_vs_cpu` judges them."""
    cfg = _train_cfg(workdir)
    cfg["model"]["dropout_rate"] = 0.0
    rng = np.random.default_rng(0)
    batches = []
    for batch in datasets[0].get_loader(seed=0):
        batches.append((batch, rng.integers(1, NUM_ITEMS, size=(BATCH, 50, 1))))
        if len(batches) == 3:
            break
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, datasets, workdir=workdir, device=device)
        trainer.init_state()
        losses, grads = [], None
        for batch, neg in batches:
            trainer.optimizer.zero_grad(set_to_none=True)
            loss = trainer.rec.training_loss(trainer.device_batch(batch), None,
                                             neg_id=torch.from_numpy(neg).to(trainer.device))
            loss.backward()
            if grads is None:
                grads = {k: p.grad.detach().cpu() for k, p in trainer.rec.module.named_parameters()}
            trainer.optimizer.step()
            losses.append(loss.item())
        runs[device] = (losses, grads)
    return _parity(runs)


def _parity(runs):
    """{device: (losses, first-step grads by parameter)} -> the errors of
    the card against the CPU, each parameter's relative to its largest
    gradient."""
    abs_err = {k: (runs["cuda"][1][k] - g).abs().max().item() for k, g in runs["cpu"][1].items()}
    rel_err = {k: abs_err[k] / max(g.abs().max().item(), 1e-30)
               for k, g in runs["cpu"][1].items()}
    worst = max(rel_err, key=rel_err.get)
    return {"grad_max_rel_err": rel_err[worst], "grad_worst_param": worst,
            "grad_worst_param_absmax": runs["cpu"][1][worst].abs().max().item(),
            "grad_max_abs_err": max(abs_err.values()), "grad_rtol": GRAD_RTOL,
            "loss_max_abs_err": max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0])),
            "loss_atol": LOSS_ATOL, "losses_card": runs["cuda"][0], "losses_cpu": runs["cpu"][0]}


def check_card_vs_cpu(parity):
    if not (parity["grad_max_rel_err"] <= GRAD_RTOL and parity["loss_max_abs_err"] <= LOSS_ATOL):
        raise AssertionError(f"card vs CPU: grads {parity['grad_max_rel_err']} of the largest "
                             f"({parity['grad_worst_param']}; rtol {GRAD_RTOL}), "
                             f"losses {parity['loss_max_abs_err']} (atol {LOSS_ATOL})")


def bf16_steps(datasets, workdir, steps=5):
    """A few steps with ``train.precision: bf16`` (autocast): finite losses,
    through the backward kernel, f32 master weights."""
    trainer = Trainer(_train_cfg(workdir, precision="bf16"), datasets, workdir=workdir)
    trainer.init_state()
    flash_attention_bwd.launches = 0
    losses = []
    for batch, _ in zip(trainer.train_data.get_loader(seed=0), range(steps)):
        losses.append(trainer.train_step(trainer.device_batch(batch)).item())
    if not np.isfinite(losses).all() or flash_attention_bwd.launches == 0:
        raise AssertionError(f"bf16 steps: losses {losses}, "
                             f"backward launches {flash_attention_bwd.launches}")
    if any(p.dtype != torch.float32 for p in trainer.rec.module.parameters()):
        raise AssertionError("bf16 steps: master weights are not f32")
    return losses


def train(card):
    """Phase 5: the train path through ``Trainer.fit`` and ``evaluate``, on a
    dataset written to a temporary directory that is removed afterwards."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        return _train(card, workdir)


def _datasets(workdir):
    write_synthetic_dataset(workdir, name="amazon-toys", domain="toy", num_users=NUM_USERS,
                            num_items=NUM_ITEMS, seed=0)
    return prepare_datasets(TRAIN_CONFIG, root=workdir)


def _train(card, workdir):
    t0 = time.perf_counter()
    datasets = _datasets(workdir)
    data_s = time.perf_counter() - t0
    steps_per_epoch = len(datasets[0].get_loader())
    eval_batches = len(datasets[1].get_loader())
    layers = TRAIN_CONFIG["model"]["layer_num"]
    epochs = TRAIN_CONFIG["train"]["epochs"]

    trainer = Trainer(_train_cfg(workdir), datasets, workdir=workdir, device="cuda")
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    test = trainer.evaluate()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd_launches = flash_attention_fwd.launches
    bwd_launches = flash_attention_bwd.launches

    steps = epochs * steps_per_epoch
    want_fwd = layers * (steps + (epochs + 1) * eval_batches)  # val every epoch, then test
    # L = 50 keys fit one tile: one backward kernel a layer and step
    assert TRAIN_CONFIG["data"]["max_seq_len"] <= BWD_KEY_TILE
    want_bwd = layers * steps
    if fwd_launches != want_fwd or bwd_launches != want_bwd:
        raise AssertionError(f"launches: forward {fwd_launches} (want {want_fwd}), "
                             f"backward {bwd_launches} (want {want_bwd})")
    with open(f"{trainer.run_dir()}/metrics.jsonl") as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    if not (np.isfinite(losses).all() and losses[-1] < 2 * np.log(2)):
        raise AssertionError(f"the train loss did not fall below 2·ln 2: {losses}")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"validation recall@20 {val['recall@20']} is not above "
                             f"5 x random ({random_recall})")

    parity = card_vs_cpu(datasets, workdir)
    check_card_vs_cpu(parity)
    bf16 = bf16_steps(datasets, workdir)

    # timed steps (uncounted): one epoch, each step from host batch to done
    lat_ms, seqs = [], 0
    for i, batch in enumerate(trainer.train_data.get_loader(seed=epochs)):
        t0 = time.perf_counter()
        trainer.train_step(trainer.device_batch(batch))
        torch.cuda.synchronize()
        if i > 0:  # the first step is the warm-up
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            seqs += int(batch["valid"].sum())
    result = {
        "users": NUM_USERS, "items": NUM_ITEMS, "steps_per_epoch": steps_per_epoch,
        "epochs": epochs, "eval_batches_per_pass": eval_batches, "data_build_s": data_s,
        "fit_and_evaluate_s": fit_s, "epoch_train_s": trainer.training_time / epochs,
        "epoch_eval_s": trainer.inference_time / epochs,
        "steps_per_s": len(lat_ms) / (sum(lat_ms) / 1e3),
        "sequences_per_s": seqs / (sum(lat_ms) / 1e3),
        "step_ms_p50": float(np.percentile(lat_ms, 50)),
        "step_ms_p90": float(np.percentile(lat_ms, 90)), "timed_steps": len(lat_ms),
        "train_losses": losses, "val": val, "test": test,
        "attention_fwd_launches": fwd_launches, "attention_bwd_launches": bwd_launches,
        "card_vs_cpu": parity, "bf16_losses": bf16, "card": card,
    }
    log(f"train {json.dumps(result)}")
    batches = [b for b, _ in zip(trainer.train_data.get_loader(seed=0), range(10))]
    profiled("10 train steps",
             lambda: [trainer.train_step(trainer.device_batch(b)) for b in batches])
    return fwd_launches, bwd_launches


def mine(sequences):
    """Stage 1 on the raw sequences: (patterns, pairs, seconds mining,
    seconds matching), checked against the JAX package's counts."""
    t0 = time.perf_counter()
    patterns, _ = mine_patterns(sequences, max_span=5, min_frequency=2)
    mine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    matches = match_pairs(sequences, patterns, max_matches=10, seed=2024)
    pairs = [(seq, patterns[p]) for seq, idxs in zip(sequences, matches) for p in idxs]
    match_s = time.perf_counter() - t0
    if (len(patterns), len(pairs)) != JAX_MINER_COUNTS:
        raise AssertionError(f"mined {len(patterns)} patterns and {len(pairs)} pairs; the JAX "
                             f"package's miner finds {JAX_MINER_COUNTS}")
    return patterns, pairs, mine_s, match_s


def regen_card_vs_cpu(pairs):
    """The regenerator from the committed artifact's weights, dropout 0, the
    same gumbel draws, τ from REGEN_PARITY_TAU: the first step's gradients
    and 3 Adam steps' losses (``pipeline.pretrain_step``), card against CPU."""
    params = load_jax_checkpoint(ARTIFACT)["params"]
    data = frame_pairs(pairs[: 3 * BATCH], NUM_ITEMS)
    noise = gumbel_noise((3, BATCH, REGEN_K), torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        module = Generator(NUM_ITEMS, k=REGEN_K, dropout=0.0)
        module.load_state_dict(generator_params_from_jax(params, module))
        module.to(device)
        optimizer, scheduler = regen_optimizer(module, 1e-3, 3)
        losses, grads = [], None
        for step in range(3):
            rows = slice(step * BATCH, (step + 1) * BATCH)
            batch = [torch.from_numpy(data[k][rows]).long().to(device)
                     for k in ("src", "tgt", "tgt_len")]
            out = pretrain_step(module, optimizer, scheduler, *batch, REGEN_PARITY_TAU,
                                gumbel=noise[step].to(device))
            if grads is None:  # this step's gradients stay until the next step
                grads = {k: p.grad.detach().cpu() for k, p in module.named_parameters()}
            losses.append(out["loss"].item())
        runs[device] = (losses, grads)
    return _parity(runs)


def decode_margins(module, src, condition, buf):
    """Fed back the tokens ``buf`` [B, T] that ``module`` chose, the gap
    between its two largest allowed (restrictive) logits at every step:
    [B, T - 1]. Where two routes first differ in a lane, this gap says
    whether the step was a near tie."""
    b, t = buf.shape
    mem_k, mem_v = module.decode_state(src, condition)
    allowed = torch.zeros(b, module.num_items + 2, dtype=torch.bool, device=src.device)
    allowed.scatter_(1, src, True)
    allowed[:, [0, module.sos]] = False  # PAD never; SOS already emitted
    shape = (module.num_layers, b, t, module.embed_dim)
    cache_k = torch.zeros(shape, device=src.device)
    cache_v = torch.zeros(shape, device=src.device)
    lanes = torch.arange(b, device=src.device)
    gaps = []
    with torch.no_grad():
        for i in range(t - 1):
            logits = module.cached_decode_step(buf[:, i], i, cache_k, cache_v, mem_k, mem_v,
                                               src != 0)
            top = torch.where(allowed, logits, NEG).topk(2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            allowed[lanes, buf[:, i + 1]] = False
    return torch.stack(gaps, 1).cpu()


def differing_lanes(got, want, gaps):
    """(lanes whose tokens differ, those whose first difference is not at a
    near tie of ``want``'s route)."""
    diff = (got.cpu() != want.cpu())[:, 1:]
    lanes = diff.any(1)
    at = gaps[torch.arange(len(lanes)), diff.float().argmax(1)]
    return int(lanes.sum()), int((lanes & (at >= NEAR_TIE)).sum())


def check_decodes(card_gen, sequences):
    """The first DECODE_CHECKED sequences under every condition: the card's
    cached greedy tokens against the CPU route's, and the card's beam search
    of width 1 against its greedy; then one bf16 batch against f32."""
    cpu_gen = load_regenerator(ARTIFACT, device="cpu")
    src = torch.from_numpy(frame_sources(sequences[:DECODE_CHECKED], cpu_gen)).long()
    counts = {"card_vs_cpu": [0, 0], "beam1_vs_greedy": [0, 0]}
    for cond in range(REGEN_K):
        c = torch.full((len(src),), cond, dtype=torch.long)
        card = greedy_decode_batch_cached(card_gen, src.cuda(), c.cuda(), DECODE_MAX_LEN)
        cpu = greedy_decode_batch_cached(cpu_gen, src, c, DECODE_MAX_LEN)
        beam = beam_decode_batch_cached(card_gen, src.cuda(), c.cuda(), DECODE_MAX_LEN,
                                        beam_width=1)
        for key, got, want, gaps in (
                ("card_vs_cpu", card, cpu, decode_margins(cpu_gen, src, c, cpu)),
                ("beam1_vs_greedy", beam, card,
                 decode_margins(card_gen, src.cuda(), c.cuda(), card))):
            n, apart = differing_lanes(got, want, gaps)
            counts[key][0] += n
            counts[key][1] += apart
    lanes = REGEN_K * len(src)
    result = {key: {"lanes": lanes, "differing": n, "differing_not_near_tie": apart,
                    "near_tie": NEAR_TIE} for key, (n, apart) in counts.items()}
    for key, (n, apart) in counts.items():
        if apart or n > NEAR_TIE_SHARE * lanes:
            raise AssertionError(f"decode {key}: {n} of {lanes} lanes differ, {apart} of them "
                                 f"not at a near tie ({NEAR_TIE})")

    seqs = sequences[:DECODE_BATCH]
    f32 = decode_dataset(card_gen, seqs, 1, batch_size=DECODE_BATCH, max_len=DECODE_MAX_LEN)
    bf16 = decode_dataset(card_gen, seqs, 1, batch_size=DECODE_BATCH, max_len=DECODE_MAX_LEN,
                          precision="bf16")
    for seq, out in zip(seqs, bf16):
        if not (set(out) <= set(seq) and len(out) == len(set(out))):
            raise AssertionError(f"bf16 decode broke the restrictive mask: {out} from {seq}")
    result["bf16_vs_f32"] = {"lanes": len(seqs),
                             "equal": sum(a == b for a, b in zip(f32, bf16))}
    return result


def regen(card, workdir):
    """Phase 6: the regeneration pipeline, on a dataset written to
    ``workdir``. The ``regen`` line holds what the stages read, also when
    one of them fails."""
    result = {"card": card}
    try:
        return _regen(workdir, result)
    finally:
        log(f"regen {json.dumps(result)}")


def _regen(workdir, result):
    datasets = _datasets(workdir)
    train_rows = datasets[0].rows()
    sequences = markov_sequences(num_users=NUM_USERS, num_items=NUM_ITEMS, seed=0)  # the dataset's

    # stage 1: mine
    patterns, pairs, result["mine_s"], result["match_s"] = mine(sequences)
    result.update(patterns=len(patterns), pairs=len(pairs))

    # stage 2: pretrain a fresh regenerator, counted
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    module, history = pretrain_regenerator(pairs[: PRETRAIN_STEPS * BATCH], NUM_ITEMS, k=REGEN_K,
                                           epochs=1, batch_size=BATCH, device="cuda")
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    pre_fwd, pre_bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    want = PRETRAIN_ATTENTION * PRETRAIN_STEPS
    if (pre_fwd, pre_bwd) != (want, want):
        raise AssertionError(f"pretrain launches: forward {pre_fwd}, backward {pre_bwd} "
                             f"(want {want} each)")
    ce = history["ce"]
    if not (np.isfinite(ce).all() and np.mean(ce[-10:]) < np.mean(ce[:10])):
        raise AssertionError(f"the pretrain CE did not fall: {ce}")
    # timed steps (uncounted), each from host batch to done
    data = frame_pairs(pairs[: 31 * BATCH], NUM_ITEMS)
    optimizer, scheduler = regen_optimizer(module, 1e-3, 31)
    lat_ms = []
    for step in range(31):
        rows = slice(step * BATCH, (step + 1) * BATCH)
        t0 = time.perf_counter()
        pretrain_step(module, optimizer, scheduler,
                      *(torch.from_numpy(data[k][rows]).long().cuda()
                        for k in ("src", "tgt", "tgt_len")), 0.5)
        torch.cuda.synchronize()
        if step > 0:  # the first step is the warm-up
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    result["pretrain"] = {
        "steps": PRETRAIN_STEPS, "batch": BATCH, "run_s": pretrain_s,
        "ce_first10": float(np.mean(ce[:10])), "ce_last10": float(np.mean(ce[-10:])),
        "step_ms_p50": float(np.percentile(lat_ms, 50)),
        "step_ms_p90": float(np.percentile(lat_ms, 90)), "timed_steps": len(lat_ms),
        "steps_per_s": len(lat_ms) / (sum(lat_ms) / 1e3),
        "pairs_per_s": BATCH * len(lat_ms) / (sum(lat_ms) / 1e3),
        "attention_fwd_launches": pre_fwd, "attention_bwd_launches": pre_bwd}
    result["card_vs_cpu"] = regen_card_vs_cpu(pairs)
    check_card_vs_cpu(result["card_vs_cpu"])
    optimizer, scheduler = regen_optimizer(module, 1e-3, 5)
    batches = [[torch.from_numpy(data[k][i * BATCH : (i + 1) * BATCH]).long().cuda()
                for k in ("src", "tgt", "tgt_len")] for i in range(5)]
    profiled("5 regenerator pretrain steps",
             lambda: [pretrain_step(module, optimizer, scheduler, *b, 0.5) for b in batches])
    del module, optimizer

    # stage 3: decode every training sequence with the trained artifact, counted
    gen = load_regenerator(ARTIFACT, device="cuda")
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    regen_rows, stats = hybrid_inference(gen, train_rows, k_conditions=REGEN_K,
                                         batch_size=DECODE_BATCH, max_len=DECODE_MAX_LEN,
                                         device="cuda")
    torch.cuda.synchronize()
    dec_fwd, dec_bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    sequences_train = train_sequences_from_rows(train_rows)
    batches = REGEN_K * -(-len(sequences_train) // DECODE_BATCH)
    if (dec_fwd, dec_bwd) != (2 * batches, 0):
        raise AssertionError(f"decode launches: forward {dec_fwd} (want {2 * batches}), "
                             f"backward {dec_bwd} (want 0)")
    src = torch.from_numpy(frame_sources(sequences_train[:DECODE_BATCH], gen)).long().cuda()
    cond = torch.zeros(DECODE_BATCH, dtype=torch.long, device="cuda")
    lat_ms = []
    for _ in range(11):
        t0 = time.perf_counter()
        greedy_decode_batch_cached(gen, src, cond, DECODE_MAX_LEN)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    lat_ms = lat_ms[1:]  # the first batch is the warm-up
    result["decode"] = {
        "lanes": stats["sequences_decoded"], "batches": batches, "batch": DECODE_BATCH,
        "max_len": DECODE_MAX_LEN, "run_s": stats["seconds"], "lanes_per_s": stats["seqs_per_sec"],
        "batch_ms_p50": float(np.percentile(lat_ms, 50)),
        "batch_ms_p90": float(np.percentile(lat_ms, 90)), "timed_batches": len(lat_ms),
        "unique_regenerated": stats["unique_regenerated"],
        "attention_fwd_launches": dec_fwd, "attention_bwd_launches": dec_bwd}
    result["tokens"] = check_decodes(gen, sequences_train)
    profiled(f"one decode batch of {DECODE_BATCH} lanes",
             lambda: greedy_decode_batch_cached(gen, src, cond, DECODE_MAX_LEN))

    # stage 4: one epoch of SASRec on the assembled train_regen, counted
    pat_rows = pattern_rows(patterns)
    combined = assemble_train_regen(train_rows, pat_rows, regen_rows)
    combined.save_npz(os.path.join(workdir, "amazon-toys", "toy", "train_regen.npz"))
    cfg = _train_cfg(workdir, epochs=1)
    cfg["data"]["train_file"] = "_regen"
    regen_sets = prepare_datasets(cfg, root=workdir)
    steps = len(regen_sets[0].get_loader())
    eval_batches = len(regen_sets[1].get_loader())
    trainer = Trainer(cfg, regen_sets, workdir=workdir, device="cuda")
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    test = trainer.evaluate()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tr_fwd, tr_bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    layers = TRAIN_CONFIG["model"]["layer_num"]
    want_fwd, want_bwd = layers * (steps + 2 * eval_batches), layers * steps
    if (tr_fwd, tr_bwd) != (want_fwd, want_bwd):
        raise AssertionError(f"train_regen launches: forward {tr_fwd} (want {want_fwd}), "
                             f"backward {tr_bwd} (want {want_bwd})")
    if not (np.isfinite(list(val.values())).all() and np.isfinite(list(test.values())).all()):
        raise AssertionError(f"train_regen metrics are not finite: {val} {test}")
    result["train_regen"] = {
        "rows": len(combined), "original": len(train_rows), "pattern_rows": len(pat_rows),
        "regenerated": len(regen_rows), "steps": steps, "fit_and_evaluate_s": fit_s,
        "val": val, "test": test, "attention_fwd_launches": tr_fwd,
        "attention_bwd_launches": tr_bwd}
    return ({"regen_pretrain": pre_fwd, "regen_decode": dec_fwd, "regen_train": tr_fwd},
            {"regen_pretrain": pre_bwd, "regen_decode": dec_bwd, "regen_train": tr_bwd})


def _zoo_cfg(workdir, model, **train):
    """The phase-5 config with ``model``'s sections of ZOO_MODELS."""
    model_cfg, train_cfg = ZOO_MODELS[model]
    cfg = _train_cfg(workdir, **{**train_cfg, **train})
    cfg["model"] = {"embed_dim": 64, "loss_fn": "bce", **model_cfg, "model": model}
    return cfg


def _train_steps(trainer, steps):
    """``steps`` steps of ``Trainer.train_step`` over the batches of epochs
    0, 1, ..., each epoch started as ``training_epoch`` starts it, with
    ``Trainer.refresh_state``; the losses as a list."""
    losses, nepoch = [], 0
    while len(losses) < steps:
        trainer.refresh_state(nepoch)
        losses += [trainer.train_step(trainer.device_batch(batch, is_train=True))
                   for batch, _ in zip(trainer.train_batches(nepoch), range(steps - len(losses)))]
        nepoch += 1
    return torch.stack(losses).tolist()


def _moved(x, device):
    """Tensors, and lists, tuples and dicts of them, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    return x


def zoo_card_vs_cpu(model, workdir, cfg=None):
    """``model`` from the same initial weights, with dropout 0 and the same
    fed negatives, (CL4SRec) views and (aux models) aux draws: the first
    step's gradients and 3 Adam steps' losses of ``Trainer.loss``, card
    against CPU. A model with per-epoch state refreshes it on the card, and
    the CPU trainer takes the card's (its k-means is checked on its own)."""
    cfg = copy.deepcopy(cfg or _zoo_cfg(workdir, model))
    cfg["model"]["dropout_rate"] = 0.0
    host = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cpu")
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    aux_draws = getattr(host.model_class, "aux_draws", None)
    steps = []
    for batch, _ in zip(host.train_batches(0), range(3)):
        cpu_batch = host.device_batch(batch, is_train=True)
        neg = rng.integers(1, NUM_ITEMS, size=cpu_batch["item_id"].shape + (1,))
        views = aux = None
        if host.contrastive:
            views = augment_views(gen, cpu_batch["in_item_id"], cpu_batch["seqlen"],
                                  cfg["model"], NUM_ITEMS)
        if aux_draws is not None:
            aux = aux_draws(gen, cpu_batch, cfg["model"], NUM_ITEMS)
        steps.append((batch, torch.from_numpy(neg), views, aux))
    runs, state = {}, {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir,
                          device=device)
        trainer.init_state()
        if device == "cuda":
            trainer.refresh_state(0)
            state = {k: v.cpu() for k, v in trainer.batch_extras.items()
                     if not k.startswith("edge_")}
        else:
            trainer.batch_extras.update(state)
        losses, grads = [], None
        for batch, neg, views, aux in steps:
            trainer.optimizer.zero_grad(set_to_none=True)
            loss = trainer.loss(trainer.device_batch(batch, is_train=True),
                                neg_id=neg.to(trainer.device),
                                views=_moved(views, trainer.device),
                                aux_draws=_moved(aux, trainer.device))
            loss.backward()
            if grads is None:
                grads = {k: p.grad.detach().cpu() for k, p in trainer.rec.module.named_parameters()}
            trainer.optimizer.step()
            losses.append(loss.item())
        runs[device] = (losses, grads)
    return _parity(runs)


def _library_ms(trainer):
    """Device ms a step of the slice's library calls at the train shape,
    forward and backward: the GRU stack (cuDNN) and the FFT filters
    (rfft → complex weight → irfft, once a layer)."""
    module = trainer.rec.module
    x = torch.randn(BATCH, 50, 64, device="cuda", requires_grad=True)
    if hasattr(module, "gru"):
        g = torch.randn(BATCH, 50, module.gru.hidden_size, device="cuda")
        return {"gru_ms": device_ms(lambda: module.gru(x)[0].backward(g), calls=20)}
    if hasattr(module, "encoder") and hasattr(module.encoder.layers[0], "filter"):
        w = module.encoder.layers[0].filter.complex_weight
        g = torch.randn(BATCH, 50, 64, device="cuda")

        def fft():
            fx = torch.fft.rfft(x, dim=1, norm="ortho") * torch.complex(w[..., 0], w[..., 1])
            torch.fft.irfft(fx, n=50, dim=1, norm="ortho").backward(g)

        return {"fft_ms": len(module.encoder.layers) * device_ms(fft, calls=20)}
    return {}


def _bounded_run(cfg, workdir, steps):
    """A fresh trainer on the card, ``steps`` steps and one validation pass:
    (trainer, losses, validation metrics, seconds)."""
    trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    trainer.init_state()
    t0 = time.perf_counter()
    losses = _train_steps(trainer, steps)
    val = trainer.validate()
    torch.cuda.synchronize()
    return trainer, losses, val, time.perf_counter() - t0


def zoo_model(model, workdir, card, result, train_file=""):
    """One model of the zoo on the card, into ``result``: ZOO_STEPS steps of
    ``Trainer.train_step`` and one validation pass, counted; then timed
    steps, bf16 steps, the library calls' device time and a profile."""
    cfg = _zoo_cfg(workdir, model, **ZOO_RUN_TRAIN.get(model, {}))
    cfg["data"]["train_file"] = train_file
    steps = ZOO_STEPS[model]
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    trainer, losses, val, run_s = _bounded_run(cfg, workdir, steps)
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    eval_batches = len(trainer.val_data.get_loader())
    want = ((CL_ATTENTION * steps + 2 * eval_batches, CL_ATTENTION * steps)
            if trainer.contrastive else (0, 0))
    result.update(model=model, train_rows=len(trainer.train_data), steps=steps, run_s=run_s,
                  loss_first10=float(np.mean(losses[:10])),
                  loss_last10=float(np.mean(losses[-10:])), val=val, eval_batches=eval_batches,
                  attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  want_launches=list(want), card=card)
    if (fwd, bwd) != want:
        raise AssertionError(f"{model} launches: forward {fwd}, backward {bwd} (want {want})")
    if not (np.isfinite(losses).all() and result["loss_last10"] < result["loss_first10"]):
        raise AssertionError(f"{model}: the train loss did not fall: {losses}")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"{model}: validation recall@20 {val['recall@20']} is not above "
                             f"5 x random ({random_recall})")
    if model in ZOO_RUN_TRAIN:  # the same run as the config ships it, reported
        _, shipped, shipped_val, _ = _bounded_run(_zoo_cfg(workdir, model), workdir, steps)
        result["shipped_train_config"] = {
            **ZOO_MODELS[model][1], "loss_first10": float(np.mean(shipped[:10])),
            "loss_last10": float(np.mean(shipped[-10:])), "recall@20": shipped_val["recall@20"]}

    # timed steps (uncounted), each from host batch to done
    lat_ms = []
    for i, (batch, _) in enumerate(zip(trainer.train_batches(1), range(31))):
        t0 = time.perf_counter()
        trainer.train_step(trainer.device_batch(batch, is_train=True))
        torch.cuda.synchronize()
        if i > 0:  # the first step is the warm-up
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    result.update(step_ms_p50=float(np.percentile(lat_ms, 50)),
                  step_ms_p90=float(np.percentile(lat_ms, 90)), timed_steps=len(lat_ms),
                  sequences_per_s=BATCH * len(lat_ms) / (sum(lat_ms) / 1e3))
    batches = [b for b, _ in zip(trainer.train_batches(2), range(5))]
    device_us, wall_us = profiled(
        f"5 {model} train steps",
        lambda: [trainer.train_step(trainer.device_batch(b, is_train=True)) for b in batches])
    result.update(profile_device_ms_per_step=device_us / 5e3,
                  profile_busy_share=device_us / wall_us, **_library_ms(trainer))

    bf16_cfg = copy.deepcopy(cfg)
    bf16_cfg["train"]["precision"] = "bf16"
    bf16 = Trainer(bf16_cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    bf16.init_state()
    result["bf16_losses"] = _train_steps(bf16, 3)
    if not np.isfinite(result["bf16_losses"]).all():
        raise AssertionError(f"{model} bf16 steps: losses {result['bf16_losses']}")
    if any(p.dtype != torch.float32 for p in bf16.rec.module.parameters()):
        raise AssertionError(f"{model} bf16 steps: master weights are not f32")


def dataset_class(key, workdir):
    """The ``key`` dataset class on the synthetic train rows: its row count
    against the JAX package's, and CLASS_STEPS SASRec steps on the card."""
    cfg = _train_cfg(workdir)
    cfg["data"]["dataset_class"] = key
    trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    trainer.init_state()
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    losses = _train_steps(trainer, CLASS_STEPS)
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    layers = TRAIN_CONFIG["model"]["layer_num"]
    result = {"rows": len(trainer.train_data), "jax_rows": JAX_CLASS_ROWS[key],
              "tokens": int(trainer.train_data.rows().seqlen.sum()), "losses": losses,
              "attention_fwd_launches": fwd, "attention_bwd_launches": bwd}
    if result["rows"] != JAX_CLASS_ROWS[key]:
        raise AssertionError(f"{key}: {result['rows']} train rows; the JAX package builds "
                             f"{JAX_CLASS_ROWS[key]}")
    if not np.isfinite(losses).all() or (fwd, bwd) != (layers * CLASS_STEPS,) * 2:
        raise AssertionError(f"{key}: losses {losses}, launches {fwd}/{bwd}")
    return result


def zoo(card, workdir):
    """Phase 7 on phase 6's dataset and ``train_regen``. The ``zoo`` line
    holds what each part read, also when one of them fails."""
    result = {"card": card}
    try:
        for model in ("GRU4Rec", "FMLP", "CL4SRec"):
            result[model] = {"card_vs_cpu": zoo_card_vs_cpu(model, workdir)}
            check_card_vs_cpu(result[model]["card_vs_cpu"])
            zoo_model(model, workdir, card, result[model])
        result["CL4SRec2"] = {}
        zoo_model("CL4SRec2", workdir, card, result["CL4SRec2"], train_file="_regen")
        result["dataset_classes"] = {}
        for key in JAX_CLASS_ROWS:
            result["dataset_classes"][key] = dataset_class(key, workdir)
    finally:
        log(f"zoo {json.dumps(result)}")
    paths = {f"zoo_{m.lower()}": m for m in ZOO_STEPS}
    return ({p: result[m]["attention_fwd_launches"] for p, m in paths.items()},
            {p: result[m]["attention_bwd_launches"] for p, m in paths.items()})


def _graph_cfg(workdir, model, **train):
    """The phase-5 config with ``model``'s section of GRAPH_MODELS."""
    cfg = _train_cfg(workdir, **train)
    cfg["model"] = {"embed_dim": 64, "loss_fn": "bce", **GRAPH_MODELS[model], "model": model}
    return cfg


def kmeans_card_vs_cpu(x, k, init_idx, iters=20):
    """The k-means of ``x`` (on the card) from its rows ``init_idx``, Lloyd
    step by Lloyd step: from the card's centroids of each step, the card's
    assignments against the CPU's (equal but where the CPU's two smallest
    squared distances lie within KMEANS_NEAR_TIE) and the card's updated
    centroids against the CPU's update from the same assignments (within
    KMEANS_ATOL). Checking each step from the same centroids keeps one
    near tie from moving every later step apart. Also reports how many
    final assignments the whole runs on the two devices disagree on."""
    x_cpu = x.cpu()
    cents = x[init_idx.to(x.device)]
    differ = apart = 0
    cent_err = 0.0
    for step in range(iters + 1):
        d2 = squared_distances(x_cpu, cents.cpu())
        got = squared_distances(x, cents).argmin(-1)
        diff = got.cpu() != d2.argmin(-1)
        two = d2.topk(2, dim=-1, largest=False).values
        differ += int(diff.sum())
        apart += int((diff & (two[:, 1] - two[:, 0] >= KMEANS_NEAR_TIE)).sum())
        if step == iters:
            break
        new = lloyd_update(x, got, cents)
        want = lloyd_update(x_cpu, got.cpu(), cents.cpu())
        cent_err = max(cent_err, (new.cpu() - want).abs().max().item())
        cents = new
    full = (kmeans(x, k, init_idx, iters)[1].cpu() != kmeans(x_cpu, k, init_idx, iters)[1])
    result = {"rows": x.shape[0], "k": k, "iters": iters, "assignments_checked": (iters + 1)
              * x.shape[0], "assign_differ": differ, "assign_differ_not_near_tie": apart,
              "near_tie": KMEANS_NEAR_TIE, "centroid_max_abs_err": cent_err,
              "centroid_atol": KMEANS_ATOL, "whole_run_final_assign_differ": int(full.sum())}
    if apart or cent_err > KMEANS_ATOL:
        raise AssertionError(f"k-means card vs CPU: {result}")
    return result


def _propagation(trainer, gen):
    """The propagation one train step of the trainer's graph model runs, as
    a function of the item table (its outputs, a list)."""
    m = trainer.config["model"]
    extras = trainer.batch_extras
    g = batch_graph(extras, NUM_ITEMS)
    if m["model"] == "GNN":
        return lambda t: [propagate_mean(g, t, int(m["gnn_layer"]))]
    if m["model"] == "NCL":
        return lambda t: propagate_layers(g, t, 2 * int(m["hyper_layers"]))[1:]
    draws = trainer.model_class.aux_draws(gen, extras, m, NUM_ITEMS)
    layers = int(m["gnn_layer"])
    if m["model"] == "SGL":
        return lambda t: [propagate_mean(edge_dropout(g, float(m["ssl_ratio"]), keep), t, layers)
                          for keep in draws]
    return lambda t: [propagate_mean(g, t, layers, noise=u, noise_eps=float(m["noise_eps"]))
                      for u in draws]


def graph_ms(trainer):
    """Device ms of a step's propagation of the item table, forward and
    backward (GNN's ``gnn_layer`` layers; SGL's and SimGCL's two views; NCL's
    2·``hyper_layers`` layers)."""
    fn = _propagation(trainer, torch.Generator(device="cuda").manual_seed(0))
    table = trainer.rec.module.item_embedding.weight.detach()[:NUM_ITEMS].clone()
    table.requires_grad_()
    grads = [torch.randn_like(o) for o in fn(table)]
    return device_ms(lambda: torch.autograd.grad(fn(table), table, grads), calls=20)


def propagation_repeats(trainer):
    """Whether two propagations of one table give the same bits. EP's
    ``model`` ranks each propagate the whole table and must stay replicas,
    so the forward must repeat; its backward's atomic adds land in the
    table's gradient, of which each rank keeps only its own rows."""
    fn = _propagation(trainer, torch.Generator(device="cuda").manual_seed(0))
    table = trainer.rec.module.item_embedding.weight.detach()[:NUM_ITEMS]
    return all(torch.equal(a, b) for a, b in zip(fn(table), fn(table)))


def graph_model(model, workdir, card, result):
    """One graph or intent model on the card, into ``result``: card vs CPU;
    GRAPH_STEPS steps through the epoch hook and one validation pass,
    counted; NCL's and ICLRec's k-means card vs CPU and their refresh's
    time; timed steps, a profile, the propagation's device time, bf16 steps."""
    cfg = _graph_cfg(workdir, model)
    layers = cfg["model"]["layer_num"]
    result["card_vs_cpu"] = zoo_card_vs_cpu(model, workdir, cfg)
    check_card_vs_cpu(result["card_vs_cpu"])

    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    trainer, losses, val, run_s = _bounded_run(cfg, workdir, GRAPH_STEPS)
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    steps_per_epoch = len(trainer.train_data.get_loader())
    eval_batches = len(trainer.val_data.get_loader())
    refreshes = -(-GRAPH_STEPS // steps_per_epoch)  # epochs started
    refresh_encodes = steps_per_epoch if model == "ICLRec" else 0  # a batch each
    encodes, grad_encodes = GRAPH_ENCODES[model]
    want = (layers * (encodes * GRAPH_STEPS + eval_batches + refreshes * refresh_encodes),
            layers * grad_encodes * GRAPH_STEPS)
    result.update(model=model, steps=GRAPH_STEPS, run_s=run_s,
                  loss_first10=float(np.mean(losses[:10])),
                  loss_last10=float(np.mean(losses[-10:])), val=val, eval_batches=eval_batches,
                  refreshes=refreshes, attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  want_launches=list(want), card=card)
    if getattr(trainer.model_class, "needs_graph", False):
        result["edges"] = int(trainer.batch_extras["edge_row"].shape[0])
        if result["edges"] != JAX_GRAPH_EDGES[cfg["model"]["graph"]]:
            raise AssertionError(f"{model}: {result['edges']} edges; the JAX package builds "
                                 f"{JAX_GRAPH_EDGES[cfg['model']['graph']]}")
    if (fwd, bwd) != want:
        raise AssertionError(f"{model} launches: forward {fwd}, backward {bwd} (want {want})")
    if not (np.isfinite(losses).all() and result["loss_last10"] < result["loss_first10"]):
        raise AssertionError(f"{model}: the train loss did not fall: {losses}")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"{model}: validation recall@20 {val['recall@20']} is not above "
                             f"5 x random ({random_recall})")

    if hasattr(trainer.model_class, "refresh_state"):
        if model == "NCL":  # the prototypes' fit: the item table past PAD
            x, k = (trainer.rec.module.item_embedding.weight.detach()[1:NUM_ITEMS],
                    cfg["model"]["num_clusters"])
        else:
            x, k = ICLRec.pooled_train_reps(trainer), cfg["model"]["num_intent_clusters"]
        init = kmeans_init(x.shape[0], k, 1)
        result["kmeans"] = kmeans_card_vs_cpu(x, k, init)
        result["kmeans_ms"] = device_ms(lambda: kmeans(x, k, init), calls=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.refresh_state(1)
        torch.cuda.synchronize()
        result["refresh_s"] = time.perf_counter() - t0

    # timed steps (uncounted), each from host batch to done
    lat_ms = []
    for i, (batch, _) in enumerate(zip(trainer.train_batches(1), range(31))):
        t0 = time.perf_counter()
        trainer.train_step(trainer.device_batch(batch, is_train=True))
        torch.cuda.synchronize()
        if i > 0:  # the first step is the warm-up
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    result.update(step_ms_p50=float(np.percentile(lat_ms, 50)),
                  step_ms_p90=float(np.percentile(lat_ms, 90)), timed_steps=len(lat_ms),
                  sequences_per_s=BATCH * len(lat_ms) / (sum(lat_ms) / 1e3))
    batches = [b for b, _ in zip(trainer.train_batches(2), range(5))]
    device_us, wall_us = profiled(
        f"5 {model} train steps",
        lambda: [trainer.train_step(trainer.device_batch(b, is_train=True)) for b in batches])
    result.update(profile_device_ms_per_step=device_us / 5e3,
                  profile_busy_share=device_us / wall_us)
    if getattr(trainer.model_class, "needs_graph", False):
        result["graph_ms"] = graph_ms(trainer)
        result["propagation_bitwise"] = propagation_repeats(trainer)
        if not result["propagation_bitwise"]:
            raise AssertionError(f"{model}: two propagations of one table differ")

    bf16 = Trainer(_graph_cfg(workdir, model, precision="bf16"),
                   prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    bf16.init_state()
    result["bf16_losses"] = _train_steps(bf16, 3)
    if not np.isfinite(result["bf16_losses"]).all():
        raise AssertionError(f"{model} bf16 steps: losses {result['bf16_losses']}")


def graph(card, workdir):
    """Phase 8 on phase 6's dataset. The ``graph`` line holds what each
    part read, also when one of them fails."""
    result = {"card": card}
    try:
        train_sets = prepare_datasets(_train_cfg(workdir), root=workdir)
        result["edges"] = {
            name: len(build_transition_graph(rows.in_item_id, rows.seqlen, NUM_ITEMS, 2,
                                             drop_last=name == "old")[0])
            for name, rows in (("old", train_sets[1].rows()), ("new", train_sets[0].rows()))}
        if result["edges"] != JAX_GRAPH_EDGES:
            raise AssertionError(f"graph edges {result['edges']}; the JAX package builds "
                                 f"{JAX_GRAPH_EDGES}")
        for model in GRAPH_MODELS:
            result[model] = {}
            graph_model(model, workdir, card, result[model])
    finally:
        log(f"graph {json.dumps(result)}")
    paths = {f"graph_{m.lower()}": m for m in GRAPH_MODELS}
    return ({p: result[m]["attention_fwd_launches"] for p, m in paths.items()},
            {p: result[m]["attention_bwd_launches"] for p, m in paths.items()})


def _meta_cfgs(workdir, sub_model, **sub_train):
    """(MetaModel config, the sub-model's config) for phase 9: the sub-model's
    as phase 5 (SASRec) or 7 writes it; the MetaModel config is the same with
    META_MODEL and META_TRAIN over it."""
    if sub_model == "SASRec":
        sub = _train_cfg(workdir, epochs=META_EPOCHS, **sub_train)
    elif sub_model in GRAPH_MODELS:
        sub = _graph_cfg(workdir, sub_model, epochs=META_EPOCHS, **sub_train)
    else:
        sub = _zoo_cfg(workdir, sub_model, epochs=META_EPOCHS, **sub_train)
    meta = copy.deepcopy(sub)
    meta["model"] = {**META_MODEL, "sub_model": sub_model}
    meta["train"].update(META_TRAIN)
    return meta, sub


def _meta_trainer(workdir, sub_model, device, dropout=None, **sub_train):
    meta, sub = _meta_cfgs(workdir, sub_model, **sub_train)
    if dropout is not None:
        sub["model"]["dropout_rate"] = dropout
    trainer = MetaTrainer(meta, prepare_datasets(meta, root=workdir), workdir=workdir,
                          device=device, sub_config=sub)
    trainer.init_state()
    return trainer


def _rel_errs(got, want):
    """{name: max |got − want| over max |want|}, on the CPU."""
    return {k: (got[k].detach().cpu() - w).abs().max().item()
            / max(w.abs().max().item(), 1e-30) for k, w in want.items()}


def meta_card_vs_cpu(sub_model, workdir, outer=True, weighted=True, warm=False):
    """The bilevel trainer around ``sub_model`` from the same initial weights,
    dropout 0, with the same batches, negatives and Gumbel noise, card
    against CPU: 3 warm steps, the plain step with the sub-model's aux term
    and its draws (``warm``; under ``warm``, the keys of :func:`_parity`),
    then one outer step's hypergradient and the meta update after it
    (``outer``), then the first weighted step's gradients and 3 weighted
    Adam steps' losses (``weighted``; under ``weighted``, the keys of
    :func:`_parity`). The weighted loss leaves an aux term out."""
    trainers = {d: _meta_trainer(workdir, sub_model, d, dropout=0.0) for d in ("cuda", "cpu")}
    host = trainers["cpu"]
    rng = np.random.default_rng(0)

    def draws(batch):  # negatives, Gumbel noise
        item = batch["item_id"]
        return (torch.from_numpy(rng.integers(1, NUM_ITEMS, size=item.shape + (1,))),
                torch.from_numpy(rng.gumbel(size=item.shape + (2,)).astype(np.float32)))

    result = {}
    if warm:  # on trainers of their own: the outer and weighted checks start fresh
        gen = torch.Generator().manual_seed(0)
        steps = []
        for b, _ in zip(host.train_data.get_loader(seed=0), range(3)):
            aux = host.model_class.aux_draws(gen, host.device_batch(b, is_train=True),
                                             host.config["model"], NUM_ITEMS)
            steps.append((b, draws(b)[0], aux))
        runs = {}
        for device in ("cuda", "cpu"):
            tr = _meta_trainer(workdir, sub_model, device, dropout=0.0)
            losses, grads = [], None
            for batch, neg, aux in steps:
                losses.append(tr.train_step(tr.device_batch(batch, is_train=True),
                                            neg.to(tr.device),
                                            aux_draws=_moved(aux, tr.device)).item())
                grads = grads or {k: p.grad.detach().cpu()
                                  for k, p in tr.rec.module.named_parameters()}
            runs[device] = (losses, grads)
        result["warm"] = _parity(runs)
    if outer:
        loader = host.train_data.get_loader(seed=4099)
        vb, tb = loader.sample_batch(), loader.sample_batch()
        (val_neg, _), (train_neg, noise) = draws(vb), draws(tb)
        before = {k: v.detach().cpu().clone() for k, v in host.meta_params.items()}
        hyper, after = {}, {}
        for device, tr in trainers.items():
            hyper[device] = {k: v.detach().cpu() for k, v in tr.outer_step(
                tr.device_batch(vb, is_train=True), tr.device_batch(tb, is_train=True),
                val_neg=val_neg.to(tr.device), train_neg=train_neg.to(tr.device),
                noise=noise.to(tr.device)).items()}
            after[device] = {k: v.detach().cpu() for k, v in tr.meta_params.items()}
        meta_err, meta_bound = {}, {}
        for k, want in after["cpu"].items():
            meta_err[k] = (after["cuda"][k] - want).abs().max().item()
            meta_bound[k] = (HYPER_RTOL * (want - before[k]).abs().max().item()
                             + META_ULPS * 2.0**-24 * want.abs().max().item())
        result.update(hyper_rel_err=_rel_errs(hyper["cuda"], hyper["cpu"]),
                      hyper_absmax={k: v.abs().max().item() for k, v in hyper["cpu"].items()},
                      hyper_rtol=HYPER_RTOL, meta_abs_err=meta_err, meta_bound=meta_bound)
    if weighted:
        steps = [(b, *draws(b)) for b, _ in zip(host.train_data.get_loader(seed=0), range(3))]
        runs = {}
        for device, tr in trainers.items():
            losses, grads = [], None
            meta = {k: v.detach() for k, v in tr.meta_params.items()}
            for batch, neg, noise in steps:
                tr.optimizer.zero_grad(set_to_none=True)
                loss = tr._weighted_loss(tr.device_batch(batch, is_train=True), meta,
                                         neg_id=neg.to(tr.device), noise=noise.to(tr.device))
                loss.backward()
                if grads is None:
                    grads = {k: p.grad.detach().cpu()
                             for k, p in tr.rec.module.named_parameters()}
                tr.optimizer.step()
                losses.append(loss.item())
            runs[device] = (losses, grads)
        result.update(_parity(runs))
    return result


def check_meta_card_vs_cpu(sub_model, parity):
    if "grad_max_rel_err" in parity:
        check_card_vs_cpu(parity)
    worst = max(parity["hyper_rel_err"].values())
    over = [k for k, err in parity["meta_abs_err"].items() if err > parity["meta_bound"][k]]
    if worst > HYPER_RTOL or over:
        raise AssertionError(f"{sub_model} outer step card vs CPU: hypergradient {worst} of the "
                             f"largest (rtol {HYPER_RTOL}); meta parameters over their bound: "
                             f"{over}: {parity}")


def _outer_step_counted(trainer):
    """Wrap ``trainer.outer_step`` to record the attention launches inside
    each call, with the step counter it fired at."""
    inner, calls = trainer.outer_step, []

    def counted(*args, **kwargs):
        fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
        out = inner(*args, **kwargs)
        calls.append((flash_attention_fwd.launches - fwd, flash_attention_bwd.launches - bwd,
                      trainer.step_counter))
        return out

    trainer.outer_step = counted
    return calls


def _attention_shaped(shape, b, h, lq, dh):
    """A tensor of the plain attention's own: [B, H, ·, ·] or [B·H, ·, ·]
    with both trailing dims in {L, Dh} (q, k, v, scores, probabilities)."""
    return (len(shape) >= 3 and int(np.prod(shape[:-2])) == b * h
            and {shape[-2], shape[-1]} <= {lq, dh})


def profiled_attention_share(label, fn, b, h, lq, dh):
    """``fn()`` under ``torch.profiler`` with input shapes: the profile as
    :func:`profiled` logs it, and the share of the device time launched by
    ops on attention-shaped tensors (the plain route's products, masks and
    softmax, forward and every derivative). Returns (device µs, wall µs,
    attention µs)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"profile: {label}")
    device_us = _log_profile(prof, wall_us)
    attn_us = sum(e.self_device_time_total
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and any(isinstance(s, (list, tuple)) and _attention_shaped(s, b, h, lq, dh)
                          for s in (e.input_shapes or [])))
    return device_us, wall_us, attn_us


def _timed(fn, n):
    """ms of ``n`` calls of ``fn``, each to its end on the card, after one
    warm-up call: (p50, p90)."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 90))


def meta_sasrec(workdir, card, result):
    """The bounded ``MetaTrainer.fit()`` around SASRec through the kernels
    (epoch 0 warm, epoch 1 weighted), counted, into ``result``; then timed
    weighted and outer steps and their profiles."""
    trainer = _meta_trainer(workdir, "SASRec", "cuda")
    layers = trainer.config["model"]["layer_num"]
    steps_per_epoch = len(trainer.train_data.get_loader())
    eval_batches = len(trainer.val_data.get_loader())
    meta0 = {k: v.detach().clone() for k, v in trainer.meta_params.items()}
    calls = _outer_step_counted(trainer)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches

    steps = META_EPOCHS * steps_per_epoch
    weighted_epochs = sum(e > META_TRAIN["warmup_epoch"] for e in range(META_EPOCHS))
    interval = META_TRAIN["interval"]
    want_outer = [(0, 0, c) for c in range(interval, steps + 1, interval)
                  if c > (META_TRAIN["warmup_epoch"] + 1) * steps_per_epoch]
    # every train step and each weighted epoch's probe encode once; the
    # outer steps take the plain route; validation once an epoch
    want = (layers * (steps + weighted_epochs + META_EPOCHS * eval_batches), layers * steps)
    with open(f"{trainer.run_dir()}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    stats = {k: trainer.logged_metrics.get(k) for k in
             ("weight_mean", "weight_std", "weight_frac_high", "weight_frac_low", "tau")}
    moved = {k: (v.detach() - meta0[k]).abs().max().item()
             for k, v in trainer.meta_params.items()}
    result.update(steps=steps, steps_per_epoch=steps_per_epoch, eval_batches=eval_batches,
                  fit_s=fit_s, attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  want_launches=list(want), outer_steps=[list(c) for c in calls],
                  want_outer_steps=[list(c) for c in want_outer],
                  train_losses=[r["train_loss"] for r in records], val=val, weight_stats=stats,
                  meta_moved=moved, card=card)
    if (fwd, bwd) != want or calls != want_outer:
        raise AssertionError(f"MetaModel(SASRec) launches: forward {fwd}, backward {bwd} (want "
                             f"{want}); outer steps {calls} (want {want_outer})")
    if not np.isfinite(result["train_losses"]).all() or len(records) != META_EPOCHS:
        raise AssertionError(f"MetaModel(SASRec) losses: {result['train_losses']}")
    if not all(v is not None and np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"MetaModel(SASRec) weight stats not logged or not finite: {stats}")
    if not max(moved.values()) > 0:
        raise AssertionError("MetaModel(SASRec): the outer steps did not move the meta parameters")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"MetaModel(SASRec): validation recall@20 {val['recall@20']} is "
                             f"not above 5 x random ({random_recall})")

    # timed (uncounted): weighted steps and outer steps on fixed batches
    del trainer.outer_step  # the class's own again
    loader = trainer.train_data.get_loader(seed=4099)
    vb, tb = (trainer.device_batch(loader.sample_batch(), is_train=True) for _ in range(2))
    batches = [trainer.device_batch(b, is_train=True)
               for b, _ in zip(trainer.train_data.get_loader(seed=5), range(5))]
    cycle = itertools.cycle(batches)
    weighted = lambda: trainer.weighted_train_step(next(cycle))  # noqa: E731
    outer = lambda: trainer.outer_step(vb, tb)  # noqa: E731
    w50, w90 = _timed(weighted, 3 * META_TIMED)
    o50, o90 = _timed(outer, META_TIMED)
    result.update(weighted_step_ms_p50=w50, weighted_step_ms_p90=w90,
                  outer_step_ms_p50=o50, outer_step_ms_p90=o90, timed_outer_steps=META_TIMED,
                  timed_weighted_steps=3 * META_TIMED)
    w_dev, w_wall = profiled("5 weighted SASRec steps", lambda: [weighted() for _ in range(5)])
    h, dh = CONFIG["model"]["head_num"], CONFIG["model"]["embed_dim"] // CONFIG["model"]["head_num"]
    o_dev, o_wall, attn = profiled_attention_share(
        "one outer step (SASRec)", outer, BATCH, h, CONFIG["data"]["max_seq_len"], dh)
    result.update(weighted_device_ms=w_dev / 5e3, weighted_busy_share=w_dev / w_wall,
                  outer_device_ms=o_dev / 1e3, outer_busy_share=o_dev / o_wall,
                  outer_plain_attention_device_ms=attn / 1e3,
                  outer_plain_attention_share=attn / o_dev if o_dev else None)
    return fwd, bwd


def meta_fmlp(workdir, card, result):
    """A few warm, weighted and outer steps and a probe of MetaModel around
    FMLP (the shipped sub-model) on the card, counted: no attention."""
    trainer = _meta_trainer(workdir, "FMLP", "cuda")
    batches = [trainer.device_batch(b, is_train=True)
               for b, _ in zip(trainer.train_data.get_loader(seed=0), range(6))]
    loader = trainer.train_data.get_loader(seed=4099)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    warm = [trainer.train_step(b) for b in batches[:3]]
    weighted = [trainer.weighted_train_step(b) for b in batches[3:]]
    hyper = [trainer.outer_step(*(trainer.device_batch(loader.sample_batch(), is_train=True)
                                  for _ in range(2))) for _ in range(2)]
    stats = trainer.weight_stats(trainer.device_batch(loader.sample_batch(), is_train=True))
    torch.cuda.synchronize()
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    losses = torch.stack(warm + weighted).tolist()
    result.update(losses=losses, attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  hyper_finite=all(bool(torch.isfinite(v).all()) for h in hyper
                                   for v in h.values()),
                  weight_stats={k: float(v) for k, v in stats.items()}, card=card)
    if (fwd, bwd) != (0, 0) or not np.isfinite(losses).all() or not result["hyper_finite"]:
        raise AssertionError(f"MetaModel(FMLP): {result}")
    return fwd, bwd


def meta(card, workdir):
    """Phase 9 on phase 6's dataset: card vs CPU around SASRec and FMLP
    (outer step and weighted steps) and GRU4Rec (outer step, cuDNN off);
    the bounded fit around SASRec; FMLP's steps. The ``meta`` line holds what
    each part read, also when one of them fails."""
    result = {"card": card}
    try:
        for sub_model in ("SASRec", "FMLP", "GRU4Rec"):
            result[sub_model] = {"card_vs_cpu": meta_card_vs_cpu(
                sub_model, workdir, weighted=sub_model != "GRU4Rec")}
            check_meta_card_vs_cpu(sub_model, result[sub_model]["card_vs_cpu"])
        if not torch.backends.cudnn.enabled:
            raise AssertionError("cuDNN was left off after an outer step")
        sgl = meta_sgl(workdir, result)
        sasrec = meta_sasrec(workdir, card, result["SASRec"])
        fmlp = meta_fmlp(workdir, card, result["FMLP"])
    finally:
        log(f"meta {json.dumps(result)}")
    return ({"meta_sasrec": sasrec[0], "meta_fmlp": fmlp[0], "meta_sgl": sgl[0]},
            {"meta_sasrec": sasrec[1], "meta_fmlp": fmlp[1], "meta_sgl": sgl[1]})


def meta_sgl(workdir, result):
    """DR4SR+ around SGL, card vs CPU: 3 warm steps with SGL's aux
    term (its edge masks fed), an outer step, 3 weighted steps without the
    term; the card's attention launches over them (per step 2 forward and
    2 backward, one a layer; none in the outer step, which attends plainly)."""
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    parity = meta_card_vs_cpu("SGL", workdir, warm=True)
    torch.cuda.synchronize()
    launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    layers = GRAPH_MODELS["SGL"]["layer_num"]
    want = (6 * layers, 6 * layers)
    result["SGL"] = {"card_vs_cpu": parity, "attention_launches": list(launches),
                     "want": list(want)}
    check_card_vs_cpu(parity["warm"])
    check_meta_card_vs_cpu("SGL", parity)
    if launches != want:
        raise AssertionError(f"MetaModel(SGL): launches {launches}, want {want}")
    return launches


# phase 10, fused dispatch (train.steps_per_dispatch): phase 5's SASRec at
# N = 16 on phase 6's data, 76 steps an epoch: groups of 16, 16, 16, 16, 12
FUSED_N = 16
# graph against eager from one state: where two eager runs agree to the bit
# in every tensor, the graph must too; where they do not (atomic sums in the
# graph models' propagation), each tensor of the graph's run may differ from
# the nearer eager run by this share of its largest element (f32; bf16 by
# phase 5's bf16 bound, one bf16 step), or by twice the two eager runs' own
# spread where that is larger. Adam turns the atomics' noise in a near-zero
# gradient (the key bias of qkv) into whole steps of the learning rate: two
# eager GNN runs on an H100 put that bias 1.10e-5 of its largest element apart
FUSED_RTOL = {torch.float32: 1e-5, torch.bfloat16: PATH_RTOL[torch.bfloat16]}
FUSED_SPREADS = 2
FUSED_TIMED_GROUPS = 12
# the other models of the zoo, with their phase-7 and phase-8 configs; the
# contrastive ones with the shipped configs' augment_type, item_random (one
# kind a batch, picked on the device)
FUSED_OTHERS = ("GRU4Rec", "CL4SRec", "CL4SRec2", "GNN", "SGL", "SimGCL", "NCL", "ICLRec")
FUSED_AUGMENT = "item_random"
# the pick's check: CL4SRec's group of FUSED_PICK_N steps replayed
# FUSED_PICK_REPLAYS times (2 picks a step), each replay's picks read back
FUSED_PICK_N = 4
FUSED_PICK_REPLAYS = 48


def _fused_cfg(workdir, model, **train):
    """Phase 5's, 7's or 8's config of ``model`` at N = FUSED_N."""
    train = {"steps_per_dispatch": FUSED_N, **train}
    if model == "SASRec":
        return _train_cfg(workdir, **train)
    cfg = _zoo_cfg(workdir, model, **train) if model in ZOO_MODELS else _graph_cfg(
        workdir, model, **train)
    if "augment_type" in cfg["model"]:
        cfg["model"]["augment_type"] = FUSED_AUGMENT
    return cfg


def _state_of(trainer):
    """Copies of what a group of steps moves: the parameters, the
    optimizer's state, both generators and the step count."""
    params = trainer.optimizer.param_groups[0]["params"]
    return {"params": {k: p.detach().clone() for k, p in trainer.rec.module.named_parameters()},
            "optimizer": {f"{i}.{k}": v.clone() for i, p in enumerate(params)
                          for k, v in trainer.optimizer.state[p].items() if torch.is_tensor(v)},
            "generator": trainer.generator.get_state(),
            "cuda_rng": torch.cuda.get_rng_state(trainer.device), "step": trainer.step}


@torch.no_grad()
def _restore(trainer, state):
    """``state`` back in place: a captured graph reads every tensor by address."""
    for k, p in trainer.rec.module.named_parameters():
        p.copy_(state["params"][k])
    for i, p in enumerate(trainer.optimizer.param_groups[0]["params"]):
        for k, v in trainer.optimizer.state[p].items():
            if torch.is_tensor(v):
                v.copy_(state["optimizer"][f"{i}.{k}"])
    trainer.generator.set_state(state["generator"])
    torch.cuda.set_rng_state(state["cuda_rng"], trainer.device)
    trainer.step = state["step"]


def _rel_err(got, want):
    got, want = got.double(), want.double()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def _versus(runs, name, dtype):
    """Run ``name`` against the runs ``eager`` and ``eager_again`` (the same
    steps from the same state): tensors equal to the bit, the others'
    errors beside the eager spread, those over the bound, the generators."""
    keys = [k for k in runs["eager"] if k not in ("generators", "step")]
    deterministic = all(torch.equal(runs["eager"][k], runs["eager_again"][k]) for k in keys)
    bitwise, other, over = [], {}, []
    for key in keys:
        got, eager, again = runs[name][key], runs["eager"][key], runs["eager_again"][key]
        if torch.equal(got, eager):
            bitwise.append(key)
        elif deterministic:
            over.append(key)
        else:
            other[key] = {"err": min(_rel_err(got, eager), _rel_err(got, again)),
                          "eager_spread": _rel_err(again, eager)}
            if other[key]["err"] > max(FUSED_RTOL[dtype],
                                       FUSED_SPREADS * other[key]["eager_spread"]):
                over.append(key)
    gens = [all(torch.equal(a, b) for a, b in zip(runs[name]["generators"], runs[e]["generators"]))
            for e in ("eager", "eager_again")]
    return {"eager_deterministic": deterministic, "tensors": len(keys),
            "bitwise": len(bitwise), "not_bitwise": other, "over_bound": over,
            "generators_equal": all(gens),
            "loss_max_abs_err": (runs[name]["losses"] - runs["eager"]["losses"]).abs()
            .max().item()}


def fused_vs_eager(trainer, kind="train", without_remat=False):
    """From one state, a group of FUSED_N steps eagerly, twice, and through
    the CUDA graph (last, so that the trainer ends in the graph's state).
    The trainer first takes one group through ``fused_steps`` (its eager
    warm-up, counted as the steps it is) and, for a model with per-epoch
    state, refreshes it. Returns the comparison (:func:`_versus`), the
    launches and collectives of each run and the capture ms;
    ``without_remat`` adds the same steps eagerly with the encoder's
    ``remat`` off (``without_remat``: that run against the eager ones)."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    update = trainer._update if kind == "train" else trainer._weighted_update
    step = trainer.train_step if kind == "train" else trainer.weighted_train_step
    trainer.refresh_state(0)
    batches = [b for b, _ in zip(trainer.train_batches(0), range(2 * FUSED_N))]
    trainer.fused_steps(batches[:FUSED_N], kind, update)
    group = batches[FUSED_N:]
    start = _state_of(trainer)
    runs, launches, collectives = {}, {}, {}
    names = ("eager", "eager_again", *(("eager_without_remat",) if without_remat else ()),
             "graph")
    encoder = trainer.rec.module.encoder if without_remat else None
    for name in names:
        _restore(trainer, start)
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        COUNTER.reset()
        if encoder is not None:
            encoder.remat = name != "eager_without_remat"
        if name == "graph":
            losses = trainer.fused_steps(group, kind, update).clone()
        else:
            losses = torch.stack([step(trainer.device_batch(b, is_train=True)) for b in group])
        torch.cuda.synchronize(trainer.device)
        launches[name] = (flash_attention_fwd.launches - before[0],
                          flash_attention_bwd.launches - before[1])
        collectives[name] = COUNTER.snapshot()
        state = _state_of(trainer)
        runs[name] = {"losses": losses, **{f"param {k}": v for k, v in state["params"].items()},
                      **{f"adam {k}": v for k, v in state["optimizer"].items()}}
        runs[name]["generators"] = (state["generator"], state["cuda_rng"])
        runs[name]["step"] = state["step"]
    dtype = trainer.compute_dtype or torch.float32
    result = {"kind": kind, "steps": FUSED_N, **_versus(runs, "graph", dtype),
              "rtol": FUSED_RTOL[dtype], "losses_graph": runs["graph"]["losses"].tolist(),
              "step": [runs[n]["step"] for n in runs],
              "launches": {k: list(v) for k, v in launches.items()},
              "collectives": collectives}
    if without_remat:
        result["without_remat"] = _versus(runs, "eager_without_remat", dtype)
    return result


def check_fused_vs_eager(model, result):
    same = ("eager", "eager_again", "graph")
    plain = result.get("without_remat")
    if (result["over_bound"] or not result["generators_equal"]
            or len({tuple(result["launches"][n]) for n in same}) != 1
            or len({json.dumps(result["collectives"][n], sort_keys=True) for n in same}) != 1
            or len(set(result["step"])) != 1
            or (plain is not None and (plain["over_bound"] or not plain["generators_equal"]))):
        raise AssertionError(f"{model}: the graph's group against eager: {result}")


def _profile(fn):
    """(profiler, wall µs) of ``fn()`` to its end on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def _rows_named(events, name, device):
    """Calls of the rows whose name holds ``name``: kernels on the device,
    runtime calls on the host."""
    want = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return sum(e.count for e in events if name in e.key and e.device_type == want)


def fused_sasrec(workdir, card, result):
    """SASRec at N = 16: graph against eager; ``fit()`` for 3 epochs and
    ``evaluate()`` with launch counts; one profiled replay; groups timed
    through the graph and eagerly."""
    cfg = _fused_cfg(workdir, "SASRec")
    datasets = prepare_datasets(cfg, root=workdir)
    trainer = Trainer(cfg, datasets, workdir=workdir, device="cuda")
    trainer.init_state()
    result["graph_vs_eager"] = fused_vs_eager(trainer)
    check_fused_vs_eager("SASRec", result["graph_vs_eager"])

    layers = cfg["model"]["layer_num"]
    epochs = cfg["train"]["epochs"]
    steps_per_epoch = len(datasets[0].get_loader())
    eval_batches = len(datasets[1].get_loader())
    # its own directory: the metrics of earlier phases' SASRec runs stay apart
    trainer = Trainer(cfg, datasets, workdir=os.path.join(workdir, "fused"), device="cuda")
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    test = trainer.evaluate()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    steps = epochs * steps_per_epoch
    want = (layers * (steps + (epochs + 1) * eval_batches), layers * steps)
    groups = sorted(n for _, n in trainer._graphs.cuda.graphs)
    with open(f"{trainer.run_dir()}/metrics.jsonl") as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    result.update(fit_s=fit_s, epoch_train_s=trainer.training_time / epochs,
                  epoch_eval_s=trainer.inference_time / epochs,
                  attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  want_launches=list(want), graphs=groups,
                  train_losses=losses, val=val, test=test, card=card)
    if (fwd, bwd) != want:
        raise AssertionError(f"fused SASRec launches: forward {fwd}, backward {bwd} (want {want})")
    want_groups = sorted({FUSED_N, steps_per_epoch % FUSED_N} - {0, 1})
    if groups != want_groups:
        raise AssertionError(f"fused SASRec: graphs of {groups} steps (want {want_groups})")
    if not (np.isfinite(losses).all() and losses[-1] < 2 * np.log(2)):
        raise AssertionError(f"fused SASRec: the train loss did not fall below 2·ln 2: {losses}")
    random_recall = 20 / (NUM_ITEMS - 1)
    if not val["recall@20"] > 5 * random_recall:
        raise AssertionError(f"fused SASRec: validation recall@20 {val['recall@20']} is not "
                             f"above 5 x random ({random_recall})")

    # one replay under the profiler: the kernels ran inside the graph
    group = [b for b, _ in zip(trainer.train_batches(epochs), range(FUSED_N))]
    trainer.train_group(group)  # the pinned buffers and the graph are warm
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    prof, wall_us = _profile(lambda: trainer.train_group(group))
    counted = (flash_attention_fwd.launches - before[0], flash_attention_bwd.launches - before[1])
    log(f"profile: one replay of {FUSED_N} SASRec steps")
    device_us = _log_profile(prof, wall_us)
    events = prof.key_averages()
    replay = {"fwd_kernels": _rows_named(events, "flash_fwd_kernel", True),
              "bwd_kernels": _rows_named(events, "flash_bwd_kernel", True),
              "counted": list(counted),
              "cudaGraphLaunch": _rows_named(events, "cudaGraphLaunch", False),
              "cudaLaunchKernel": _rows_named(events, "cudaLaunchKernel", False),
              "device_ms_a_step": device_us / FUSED_N / 1e3, "busy_share": device_us / wall_us}
    result["profiled_replay"] = replay
    # the steps launch nothing from the host: one graph, and before it the
    # seed and offset fills of the two generators the graph reads
    if ((replay["fwd_kernels"], replay["bwd_kernels"]) != (layers * FUSED_N,) * 2
            or list(counted) != [layers * FUSED_N] * 2 or replay["cudaGraphLaunch"] != 1
            or replay["cudaLaunchKernel"] > 2 * 2):
        raise AssertionError(f"fused SASRec: one replay's kernels {replay}")
    eager = Trainer(_train_cfg(workdir), datasets, workdir=workdir, device="cuda")
    eager.init_state()
    eager.train_step(eager.device_batch(group[0], is_train=True))
    prof, eager_wall = _profile(lambda: [eager.train_step(eager.device_batch(b, is_train=True))
                                         for b in group])
    log(f"profile: {FUSED_N} eager SASRec steps")
    eager_device = _log_profile(prof, eager_wall)
    result["profiled_eager"] = {
        "cudaLaunchKernel": _rows_named(prof.key_averages(), "cudaLaunchKernel", False),
        "device_ms_a_step": eager_device / FUSED_N / 1e3, "busy_share": eager_device / eager_wall}

    # timed (uncounted): groups of 16 from host batches to done, through the
    # graph and, on a trainer at N = 1 (Adam not capturable), step by step,
    # in turns
    loaders = itertools.chain.from_iterable(trainer.train_batches(e) for e in range(2, 6))
    timed = {"graph": [], "eager": []}
    for _ in range(FUSED_TIMED_GROUPS):
        group = list(itertools.islice(loaders, FUSED_N))
        for name in ("graph", "eager"):
            t0 = time.perf_counter()
            if name == "graph":
                trainer.train_group(group)
            else:
                for b in group:
                    eager.train_step(eager.device_batch(b, is_train=True))
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) * 1e3 / FUSED_N)
    for name, ms in timed.items():
        result[f"{name}_step_ms_p50"] = float(np.percentile(ms, 50))
        result[f"{name}_step_ms_p90"] = float(np.percentile(ms, 90))
    result["timed_groups"] = FUSED_TIMED_GROUPS
    # one more epoch each, its graphs and libraries warm: host batches to
    # done, the host preparing a group while the card runs the one before
    for name, tr in (("graph", trainer), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.training_epoch(epochs + 1)
        result[f"{name}_warm_epoch_s"] = time.perf_counter() - t0
    return fwd, bwd


def fused_meta(workdir, card, result):
    """DR4SR+ around SASRec at N = 16 (phase 9's configuration): a weighted
    group through the graph against eager; ``fit()`` for 2 epochs with the
    groups, the outer steps and the launches counted."""
    trainer = _meta_trainer(workdir, "SASRec", "cuda", steps_per_dispatch=FUSED_N)
    result["graph_vs_eager"] = fused_vs_eager(trainer, kind="weighted")
    check_fused_vs_eager("MetaModel(SASRec)", result["graph_vs_eager"])

    trainer = _meta_trainer(workdir, "SASRec", "cuda", steps_per_dispatch=FUSED_N)
    layers = trainer.config["model"]["layer_num"]
    steps_per_epoch = len(trainer.train_data.get_loader())
    eval_batches = len(trainer.val_data.get_loader())
    sizes, inner = [], trainer._group

    def recorded(batches, step, kind, update):
        sizes.append((kind, len(batches)))
        return inner(batches, step, kind, update)

    trainer._group = recorded
    calls = _outer_step_counted(trainer)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    val = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    steps = META_EPOCHS * steps_per_epoch
    weighted_epochs = sum(e > META_TRAIN["warmup_epoch"] for e in range(META_EPOCHS))
    interval = META_TRAIN["interval"]
    want = (layers * (steps + weighted_epochs + META_EPOCHS * eval_batches), layers * steps)
    want_outer = [(0, 0, c) for c in range(interval, steps + 1, interval)
                  if c > (META_TRAIN["warmup_epoch"] + 1) * steps_per_epoch]
    # the JAX trainer's groups: warm epochs in groups of N, weighted ones
    # cut at every interval boundary
    want_sizes, counter = [], 0
    for nepoch in range(META_EPOCHS):
        warm, left = nepoch <= META_TRAIN["warmup_epoch"], steps_per_epoch
        while left:
            take = min(FUSED_N, left) if warm else min(FUSED_N, left,
                                                      interval - counter % interval)
            want_sizes.append(("train" if warm else "weighted", take))
            left, counter = left - take, counter + take
    result.update(fit_s=fit_s, attention_fwd_launches=fwd, attention_bwd_launches=bwd,
                  want_launches=list(want), outer_steps=[list(c) for c in calls],
                  want_outer_steps=[list(c) for c in want_outer],
                  groups=[f"{k} {n}" for k, n in sizes],
                  graphs=sorted(f"{k} {n}" for k, n in trainer._graphs.cuda.graphs),
                  val_recall20=val["recall@20"], card=card)
    if (fwd, bwd) != want or calls != want_outer or sizes != want_sizes:
        raise AssertionError(f"fused MetaModel(SASRec): launches {fwd}, {bwd} (want {want}); "
                             f"outer steps {calls} (want {want_outer}); groups {sizes} "
                             f"(want {want_sizes})")
    if not val["recall@20"] > 5 * 20 / (NUM_ITEMS - 1):
        raise AssertionError(f"fused MetaModel(SASRec): recall@20 {val['recall@20']}")

    # timed (uncounted): one interval, ``interval`` weighted steps from host
    # batches and the outer step, to done: in groups of 16 and 14 through
    # the graphs, and step by step on a trainer at N = 1, in turns
    eager = _meta_trainer(workdir, "SASRec", "cuda")
    loaders = {name: itertools.chain.from_iterable(tr.train_data.get_loader(seed=s)
                                                   for s in itertools.count(7))
               for name, tr in (("graph", trainer), ("eager", eager))}
    timed = {"graph": [], "eager": []}
    for _ in range(1 + META_TIMED // 2):
        for name, tr in (("graph", trainer), ("eager", eager)):
            batches = list(itertools.islice(loaders[name], interval))
            tr.step_counter = 0
            meta_loader = tr.train_data.get_loader(seed=4099)
            t0 = time.perf_counter()
            while batches:
                take = min(tr.steps_per_dispatch, interval - tr.step_counter % interval)
                group, batches = batches[:take], batches[take:]
                tr.weighted_group(group)
                tr.step_counter += len(group)
                tr._maybe_outer_step(meta_loader, warm=False)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) * 1e3)
    for name, ms in timed.items():  # the first interval of each is the warm-up
        result[f"{name}_interval_ms_p50"] = float(np.percentile(ms[1:], 50))
        result[f"{name}_interval_ms_p90"] = float(np.percentile(ms[1:], 90))
    result["timed_intervals"] = len(timed["graph"]) - 1
    return fwd, bwd


def fused_model(model, workdir, result, **train):
    """``model`` at N = 16: a group through the graph against eager."""
    cfg = _fused_cfg(workdir, model, **train)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    trainer.init_state()
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    result.update(fused_vs_eager(trainer))
    check_fused_vs_eager(model, result)
    return flash_attention_fwd.launches, flash_attention_bwd.launches


def _recorded_picks():
    """``augmentation.sample_draws`` wrapped to keep, in order, the pick
    tensor of every ``item_random`` draw it makes: (the list, undo)."""
    from dr4sr_tpu_torch.modules import augmentation

    real, picks = augmentation.sample_draws, []

    def recorded(*args, **kwargs):
        draws = real(*args, **kwargs)
        if draws["kind"] == "item_random":
            picks.append(draws["pick"])
        return draws

    augmentation.sample_draws = recorded
    return picks, lambda: setattr(augmentation, "sample_draws", real)


def fused_picks(workdir, result):
    """CL4SRec under ``item_random`` at N = FUSED_PICK_N: after the eager
    warm-up group, FUSED_PICK_REPLAYS groups through one graph, each
    replay's picks read back from the pick tensors the capture made (a
    graph rewrites them at every replay), against the picks of the same
    steps run eagerly from the same state; every branch must be taken.
    A pick frozen into the graph at capture repeats itself replay after
    replay."""
    n = FUSED_PICK_N
    cfg = _fused_cfg(workdir, "CL4SRec", steps_per_dispatch=n)
    trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    trainer.init_state()
    batches = list(itertools.islice(itertools.chain.from_iterable(
        trainer.train_batches(e) for e in itertools.count()), n * (FUSED_PICK_REPLAYS + 1)))
    picks, undo = _recorded_picks()
    try:
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        trainer.fused_steps(batches[:n], "train", trainer._update)
        start = _state_of(trainer)
        picks.clear()
        graph = []
        for i in range(FUSED_PICK_REPLAYS):
            trainer.fused_steps(batches[n * (i + 1):n * (i + 2)], "train", trainer._update)
            if i == 0:
                captured = list(picks)  # the capture's pick tensors
            graph += torch.cat(captured).tolist()
        launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        _restore(trainer, start)
        picks.clear()
        for batch in batches[n:]:
            trainer.train_step(trainer.device_batch(batch, is_train=True))
        eager = torch.cat(picks).tolist()
    finally:
        undo()
    result.update(replays=FUSED_PICK_REPLAYS, steps_a_replay=n, picks=len(graph),
                  picks_a_replay=len(captured), taken={k: graph.count(k) for k in range(3)},
                  equal_to_eager=graph == eager,
                  graphs=sorted(map(list, trainer._graphs.cuda.graphs)), launches=list(launches))
    if graph != eager or set(graph) != {0, 1, 2} or len(captured) != 2 * n:
        raise AssertionError(f"fused CL4SRec picks: {result}; graph {graph[:64]}, "
                             f"eager {eager[:64]}")
    return launches


def fused_remat(workdir, result):
    """SASRec with ``model.remat`` at dropout 0.5 (phase 5's): a group
    through the graph against eager with remat, and eager without remat
    against eager with it, from the same state and draws."""
    cfg = _fused_cfg(workdir, "SASRec")
    cfg["model"]["remat"] = True
    trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir, device="cuda")
    trainer.init_state()
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    result.update(dropout=cfg["model"]["dropout_rate"],
                  **fused_vs_eager(trainer, without_remat=True))
    check_fused_vs_eager("SASRec remat", result)
    # per step and layer: the forward, its recompute in the backward, the backward
    layers = cfg["model"]["layer_num"]
    want = {"graph": [2 * layers * FUSED_N, layers * FUSED_N],
            "eager_without_remat": [layers * FUSED_N, layers * FUSED_N]}
    if any(result["launches"][k] != v for k, v in want.items()):
        raise AssertionError(f"fused SASRec remat: launches {result['launches']}, want {want}")
    return flash_attention_fwd.launches, flash_attention_bwd.launches


def fused(card, workdir):
    """Phase 10 on phase 6's dataset: SASRec, DR4SR+ around SASRec, FMLP,
    bf16 SASRec and the rest of the zoo at N = 16 (the contrastive models
    under ``item_random``), CL4SRec's picks over many replays, and SASRec
    with remat. The ``fused`` line holds what each part read, also when one
    of them fails."""
    result = {"card": card, "steps_per_dispatch": FUSED_N, "augment_type": FUSED_AUGMENT}
    fwd, bwd = {}, {}
    try:
        result["SASRec"] = {}
        fwd["fused_sasrec"], bwd["fused_sasrec"] = fused_sasrec(workdir, card, result["SASRec"])
        result["MetaModel(SASRec)"] = {}
        fwd["fused_meta_sasrec"], bwd["fused_meta_sasrec"] = fused_meta(
            workdir, card, result["MetaModel(SASRec)"])
        result["FMLP"] = {}
        fwd["fused_fmlp"], bwd["fused_fmlp"] = fused_model("FMLP", workdir, result["FMLP"])
        if (fwd["fused_fmlp"], bwd["fused_fmlp"]) != (0, 0):
            raise AssertionError(f"fused FMLP: attention launches {result['FMLP']}")
        result["SASRec bf16"] = {}
        fused_model("SASRec", workdir, result["SASRec bf16"], precision="bf16")
        for model in FUSED_OTHERS:
            result[model] = {}
            path = f"fused_{model.lower()}"
            fwd[path], bwd[path] = fused_model(model, workdir, result[model])
        result["CL4SRec picks"] = {}
        fwd["fused_cl4srec_picks"], bwd["fused_cl4srec_picks"] = fused_picks(
            workdir, result["CL4SRec picks"])
        result["SASRec remat"] = {}
        fwd["fused_sasrec_remat"], bwd["fused_sasrec_remat"] = fused_remat(
            workdir, result["SASRec remat"])
    finally:
        log(f"fused {json.dumps(result)}")
    return fwd, bwd


# phase 11, multi-GPU (dist): SASRec at the amazon-toys width (phase 5's
# config, dropout 0, f32) on phase 6's data. The ranks are spawned processes
# (``parallel.launch.run_ranks``, a ``FileStore``), rank r on card r mod the
# card count; on one card they share it over gloo, which stages CUDA tensors
# through the host, so every time is then host-staged gloo, not a multi-GPU
# speed, and NCCL runs at world size 1 only (NCCL takes no two ranks of one
# communicator on one card).
# name: (data, model, shard_embedding, context_parallel, checked steps)
DIST_RUNS = {
    "dp": (2, 1, False, 1, 3),
    "ep": (1, 2, True, 1, 3),
    "cp": (1, 2, False, 2, 3),
    "2x2": (2, 2, True, 2, 1),
}
DIST_BACKEND = "gloo"  # "nccl" where every rank has a card of its own
DIST_TIMEOUT_S = 240
DIST_TIMED = 10  # uncounted steps timed after the checked ones
DIST_METRIC_ATOL = 1e-5
DIST_DECODE_SEQS = 4096  # the first training sequences, under all K conditions
# the ring against one rank's FlashAttention: [B, H, L, Dh], both dtypes, both masks
DIST_RING_SHAPE = (256, 2, 50, 32)
DIST_RING_CASES = [(dtype, causal) for dtype in (torch.float32, torch.bfloat16)
                   for causal in (True, False)]


def _dist_cfg(workdir, cp=1):
    cfg = _train_cfg(workdir)
    cfg["model"]["dropout_rate"] = 0.0
    if cp > 1:
        cfg["model"]["context_parallel"] = cp
    return cfg


def _dist_inputs(datasets):
    """The checked steps' global host batches and negatives: the first
    three batches of epoch 0, the second cut to unequal halves (the second
    half keeps BATCH/8 valid rows), so that a per-rank loss denominator
    shows."""
    rng = np.random.default_rng(11)
    batches = [b for b, _ in zip(datasets[0].get_loader(seed=0), range(3))]
    batches[1] = dict(batches[1], valid=batches[1]["valid"].copy())
    batches[1]["valid"][BATCH // 2 + BATCH // 8:] = False
    negs = [rng.integers(1, NUM_ITEMS, size=(BATCH, 50, 1)) for _ in batches]
    return batches, negs


def _full_grads(trainer, rows=None):
    """The gradients after a step; a row-sharded table's gathered over
    ``model`` and cut to its first ``rows`` (default ``num_items``: without
    its padding row)."""
    from dr4sr_tpu_torch.parallel.collectives import all_gather

    grads = {k: p.grad.detach().clone() for k, p in trainer.rec.module.named_parameters()}
    if trainer.plan.ep_sharded():
        grads["item_embedding.weight"] = all_gather(grads["item_embedding.weight"],
                                                    trainer.plan.axis("model"),
                                                    dim=0)[: rows or trainer.num_items]
    return {k: g.cpu() for k, g in grads.items()}


def _timed_steps(trainer, datasets, n):
    """``n`` uncounted steps (after one warm-up), each from host batch to done."""
    lat_ms = []
    for i, batch in enumerate(datasets[0].get_loader(seed=1)):
        if i > n:
            break
        t0 = time.perf_counter()
        trainer.train_step(trainer.device_batch(batch, is_train=True))
        _sync(trainer.device)
        if i > 0:
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms_p50": float(np.percentile(lat_ms, 50)),
            "step_ms_p90": float(np.percentile(lat_ms, 90)), "timed_steps": len(lat_ms)}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dist_reference(workdir, datasets, device="cuda"):
    """One rank on the card: the checked steps' losses, the first step's
    gradients, the weights after them, the eval of those weights (its
    metrics and the top-k of the first validation batch) and timed steps."""
    batches, negs = _dist_inputs(datasets)
    trainer = Trainer(_dist_cfg(workdir), datasets, workdir=workdir, device=device)
    trainer.init_state()
    init = {k: v.detach().cpu().clone() for k, v in trainer.rec.module.state_dict().items()}
    losses, grads = [], None
    for batch, neg in zip(batches, negs):
        losses.append(trainer.train_step(trainer.device_batch(batch, is_train=True),
                                         torch.from_numpy(neg).to(device)).item())
        grads = grads or _full_grads(trainer)
    final = {k: v.detach().cpu().clone() for k, v in trainer.rec.module.state_dict().items()}
    metrics = trainer._eval_epoch(trainer.val_data, "toy")
    scores, ids = _first_val_topk(trainer)
    return {"init": init, "final": final, "losses": losses, "grads": grads, "metrics": metrics,
            "scores": scores, "ids": ids, "timed": _timed_steps(trainer, datasets, DIST_TIMED)}


def _first_val_topk(trainer):
    """(scores, ids) of this rank's rows of the first validation batch."""
    trainer.val_data.set_eval_domain("toy")
    keep = torch.from_numpy(trainer.val_data.domain_item_mask("toy")).to(trainer.device)
    batch = next(iter(trainer.val_data.get_loader()))
    scores, ids = trainer.eval_topk(trainer.device_batch(batch), keep)
    return scores.cpu(), ids.cpu()


def dist_train_rank(rank, workdir, run, ref, fault, device="cuda"):
    """One rank of a ``DIST_RUNS`` run: the checked steps from ``ref``'s
    weights on its batches and negatives, then ``ref``'s final weights
    evaluated (one pass over the validation rows, sharded as the run
    shards), the attention launches and collectives of both, the top-k of
    the first validation batch, the local weights after the steps (for
    the replicas' bitwise check) and timed steps."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    data, model, shard, cp, steps = DIST_RUNS[run]
    if fault is not None:
        DIST_FAULTS[fault]()
    datasets = prepare_datasets(TRAIN_CONFIG, root=workdir)
    plan = MeshPlan(mesh=create_mesh(data=data, model=model, device_type=device),
                    shard_embedding=shard)
    trainer = Trainer(_dist_cfg(workdir, cp), datasets, workdir=workdir, device=device,
                      mesh_plan=plan)
    trainer.init_state()
    trainer.set_params(ref["init"])
    batches, negs = _dist_inputs(datasets)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    losses, grads, step_collectives = [], None, []
    for batch, neg in list(zip(batches, negs))[:steps]:
        neg = torch.from_numpy(neg).to(device)
        if trainer.data_axis is not None:
            neg = trainer.data_axis.chunk(neg, 0)
        COUNTER.reset()
        losses.append(trainer.train_step(trainer.device_batch(batch, is_train=True), neg).item())
        step_collectives.append(COUNTER.snapshot())
        grads = grads or _full_grads(trainer)
    local = {k: v.detach().cpu().clone() for k, v in trainer.rec.module.state_dict().items()}
    trainer.set_params(ref["final"])
    COUNTER.reset()
    metrics = trainer._eval_epoch(trainer.val_data, "toy")
    _sync(device)
    launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    eval_collectives = COUNTER.snapshot()
    scores, ids = _first_val_topk(trainer)
    refused = None
    if (run == "dp" and torch.distributed.get_backend() == "gloo"
            and torch.device(device).type == "cuda"):
        # N > 1 over gloo on the card: its collectives stage through the host
        cfg = _dist_cfg(workdir)
        cfg["train"]["steps_per_dispatch"] = FUSED_N
        try:
            Trainer(cfg, datasets, workdir=workdir, device=device, mesh_plan=plan)
        except NotImplementedError as e:
            refused = str(e)
        if refused is None or "gloo" not in refused:
            raise AssertionError(f"dist dp: N = {FUSED_N} over gloo on the card: {refused}")
    return {"losses": losses, "grads": grads, "local": local, "metrics": metrics,
            "scores": scores, "ids": ids, "launches": launches,
            "step_collectives": step_collectives, "eval_collectives": eval_collectives,
            "timed": _timed_steps(trainer, datasets, DIST_TIMED),
            "eval_batches": len(datasets[1].get_loader()), "n16_refused": refused}


def dist_world_rank(rank, workdir, runs, ref, more_runs, refs, fault, device="cuda"):
    """One rank of a world size's runs in one process: each of ``runs``
    (``DIST_RUNS``) by :func:`dist_train_rank`, its seconds as ``run_s``,
    then ``more_runs`` by :func:`dist_more_rank`; ``{run: record}``."""
    outs = {}
    for run in runs:
        t0 = time.perf_counter()
        outs[run] = dist_train_rank(rank, workdir, run, ref, None, device)
        outs[run]["run_s"] = time.perf_counter() - t0
    outs.update(dist_more_rank(rank, workdir, more_runs, refs, fault, device))
    return outs


def _dist_launches_want(run, rank, eval_batches):
    """The attention launches a rank of ``run`` makes in its checked steps
    and eval: per layer a forward per step and eval batch and a backward
    (one kernel at L = 50) per step, times the blocks the ring folds into
    this rank's queries under ``causal`` (model index + 1)."""
    data, model, shard, cp, steps = DIST_RUNS[run]
    layers = TRAIN_CONFIG["model"]["layer_num"]
    blocks = rank % model + 1 if cp > 1 else 1
    return layers * (steps + eval_batches) * blocks, layers * steps * blocks


def _ids_differ_only_at_ties(got_scores, got_ids, want_scores, want_ids):
    """Where the ids differ, the reference's neighbouring scores lie within NEAR_TIE."""
    differ = got_ids != want_ids
    if not differ.any():
        return 0, True
    gaps = (want_scores[:, 1:] - want_scores[:, :-1]).abs()
    near = torch.zeros_like(differ)
    near[:, 1:] |= gaps <= NEAR_TIE
    near[:, :-1] |= gaps <= NEAR_TIE
    ok = bool((~differ | near).all()) and (got_scores - want_scores).abs().max().item() <= NEAR_TIE
    return int(differ.sum()), ok


def check_dist_run(run, outs, ref):
    """A run's ranks against the one-rank reference; returns the summary
    and raises on the first fault."""
    data, model, shard, cp, steps = DIST_RUNS[run]
    summary = {"mesh": [data, model], "shard_embedding": shard, "context_parallel": cp,
               "steps": steps}
    parity = _parity({"cuda": (outs[0]["losses"], outs[0]["grads"]),
                      "cpu": (ref["losses"][:steps], ref["grads"])})
    summary["vs_one_rank"] = {k: parity[k] for k in ("grad_max_rel_err", "grad_worst_param",
                                                     "loss_max_abs_err", "losses_card")}
    if not (parity["grad_max_rel_err"] <= GRAD_RTOL and parity["loss_max_abs_err"] <= LOSS_ATOL):
        raise AssertionError(f"dist {run} vs one rank: {summary['vs_one_rank']} (grads rtol "
                             f"{GRAD_RTOL} of the largest, losses atol {LOSS_ATOL})")
    for out in outs[1:]:
        if out["losses"] != outs[0]["losses"]:
            raise AssertionError(f"dist {run}: the ranks' losses differ")
    # replicas bitwise: rank = data index · model + model index; a sharded
    # table's shard is replicated over the data ranks of its model index
    for r, out in enumerate(outs):
        for k, v in out["local"].items():
            twin = outs[r % model] if (shard and k == "item_embedding.weight") else outs[0]
            if not torch.equal(v, twin["local"][k]):
                raise AssertionError(f"dist {run}: replica {k} of rank {r} differs")
    summary["replicas_bitwise"] = True
    metric_err = max(abs(out["metrics"][k] - v) for out in outs for k, v in ref["metrics"].items())
    summary["metric_max_abs_err"] = metric_err
    if metric_err > DIST_METRIC_ATOL:
        raise AssertionError(f"dist {run}: eval metrics off the one-rank eval by {metric_err}")
    rows = ref["ids"].shape[0] // data
    differ = 0
    for r, out in enumerate(outs):
        sl = slice((r // model) * rows, (r // model + 1) * rows)
        n, ok = _ids_differ_only_at_ties(out["scores"], out["ids"], ref["scores"][sl],
                                         ref["ids"][sl])
        differ += n
        if not ok:
            raise AssertionError(f"dist {run}: top-k ids of rank {r} differ beyond near ties")
    summary["topk_ids_differing_at_ties"] = differ
    want = [_dist_launches_want(run, r, outs[r]["eval_batches"]) for r in range(len(outs))]
    got = [out["launches"] for out in outs]
    summary["launches"] = {"fwd": [g[0] for g in got], "bwd": [g[1] for g in got],
                           "want_fwd": [w[0] for w in want], "want_bwd": [w[1] for w in want]}
    if [tuple(g) for g in got] != [tuple(w) for w in want]:
        raise AssertionError(f"dist {run}: launches {got}, want {want}")
    summary["step_collectives"] = outs[0]["step_collectives"][0]
    summary["eval_collectives"] = outs[0]["eval_collectives"]
    check_dist_collectives(run, outs[0]["step_collectives"][0])
    summary["timed"] = [out["timed"] for out in outs]
    if outs[0]["n16_refused"] is not None:
        summary["n16_refused"] = outs[0]["n16_refused"]
    return summary


def check_dist_collectives(run, step):
    """What a step moves, by kind and axis. EP: only the ``model``
    all-reduces of the gathered embeddings (in_item_id, item_id and the
    negatives: 3 · B/D · L · D floats), none of the table's N · D; CP: per
    layer the ring's sends (3 forward, 5 a backward rotation, 2 home) and
    the all-gathers of o, dq, dk and dv, no all-gather of K or V."""
    data, model, shard, cp, steps = DIST_RUNS[run]
    layers, dim, length = TRAIN_CONFIG["model"]["layer_num"], CONFIG["model"]["embed_dim"], 50
    heads = CONFIG["model"]["head_num"]
    b = BATCH // data
    want = {}
    if data > 1:  # the count's all-reduce, then the gradients' with the loss
        want["all_reduce:data"] = 2
    if shard:
        want["all_reduce:model"] = {"calls": 3, "bytes": 3 * b * length * dim * 4}
    if cp > 1:
        qkv = b * heads * length * (dim // heads) * 4
        want["all_gather:model"] = {"calls": 4 * layers, "bytes": 4 * layers * qkv}
        want["send:model"] = 10 * layers
    got = {k: (v if isinstance(want.get(k), dict) else v["calls"]) for k, v in step.items()}
    if got != want:
        raise AssertionError(f"dist {run}: a step's collectives {step}, want {want}")


def dist_ring_rank(rank, device="cuda"):
    """The ring over 2 ranks through both kernels against one rank's
    ``FlashAttention`` on the same inputs: the output and dq, dk, dv, with
    padded rows and a fully padded row, at DIST_RING_SHAPE in both dtypes,
    causal and not, within atol (phases 2 and 3's) + PATH_RTOL · |value|
    (phase 3's rule for a whole path: 0 in f32, one bf16 step in bf16); the ring's collectives and wall time beside
    FlashAttention's. Also whether the ring's sends went through host
    memory, as ``collectives.stages_through_host`` decides it."""
    from dr4sr_tpu_torch.ops.ring_attention import ring_attention
    from dr4sr_tpu_torch.parallel.collectives import COUNTER, stages_through_host
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    axis = MeshPlan(mesh=create_mesh(data=1, model=2, device_type=device)).axis("model")
    b, h, length, dh = DIST_RING_SHAPE
    cases = []
    for i, (dtype, causal) in enumerate(DIST_RING_CASES):
        gen = torch.Generator(device=device).manual_seed(2000 + i)
        q, k, v, do = (torch.randn(b, h, length, dh, generator=gen, device=device).to(dtype)
                       for _ in range(4))
        seqlen = torch.randint(1, length + 1, (b,), generator=gen, device=device)
        seqlen[0] = 0  # a fully padded row
        pad = torch.arange(length, device=device)[None, :] >= seqlen[:, None]
        runs = {}
        for name, fn in (("ring", lambda *t: ring_attention(*t, pad, causal, axis=axis)),
                         ("flash", lambda *t: FlashAttention.apply(*t, pad, causal))):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            COUNTER.reset()
            o = fn(*leaves)
            fwd = COUNTER.snapshot()
            grads = torch.autograd.grad(o, leaves, do)
            _sync(device)
            lat = []
            for _ in range(6):
                t0 = time.perf_counter()
                torch.autograd.grad(fn(*leaves), leaves, do)
                _sync(device)
                lat.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (o.detach(), grads, fwd, float(np.median(lat[1:])))
        (o, grads, fwd, ms), (o_ref, grads_ref, _, ref_ms) = runs["ring"], runs["flash"]
        # phase 3's rule for a whole path: atol + PATH_RTOL · |value| (bf16
        # rounds each block's partial output and gradients once more)
        rtol = PATH_RTOL[dtype]
        excess = [max(((g.float() - w.float()).abs() - rtol * w.float().abs()).max().item()
                      for g, w in zip(got, want))
                  for got, want in (([o], [o_ref]), (grads, grads_ref))]
        zero_row = not any((g[0] != 0).any().item() for g in (o, *grads))
        cases.append({"dtype": str(dtype).replace("torch.", ""), "causal": causal,
                      "shape": list(DIST_RING_SHAPE), "fwd_max_abs_err": _max_err([o], [o_ref]),
                      "bwd_max_abs_err": _max_err(grads, grads_ref), "fwd_excess": excess[0],
                      "bwd_excess": excess[1], "fwd_atol": ATOL[dtype],
                      "bwd_atol": ATOL_BWD[dtype], "path_rtol": rtol, "padded_row_zero": zero_row,
                      "forward_collectives": fwd, "ring_fwd_bwd_ms": ms,
                      "flash_fwd_bwd_ms": ref_ms})
    return cases, stages_through_host(axis, q)


def check_dist_ring(cases):
    b, h, length, dh = DIST_RING_SHAPE
    for case in cases:
        want = {"all_gather:model": {"calls": 1, "bytes": b * h * length * dh
                                     * (4 if case["dtype"] == "float32" else 2)}}
        sends = case["forward_collectives"].get("send:model", {}).get("calls")
        if (case["fwd_excess"] > case["fwd_atol"]
                or case["bwd_excess"] > case["bwd_atol"] or not case["padded_row_zero"]
                or sends != 3 or {k: v for k, v in case["forward_collectives"].items()
                                  if k != "send:model"} != want):
            raise AssertionError(f"dist ring: {case}")


def dist_decode_rank(rank, sequences, device="cuda"):
    """``decode_dataset`` of the committed artifact over a 2-rank data mesh,
    with its forward launches."""
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    plan = MeshPlan(mesh=create_mesh(data=2, model=1, device_type=device))
    gen = load_regenerator(ARTIFACT, device=device)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    tokens = decode_dataset(gen, sequences, REGEN_K, batch_size=DECODE_BATCH,
                            max_len=DECODE_MAX_LEN, mesh_plan=plan)
    _sync(device)
    return {"tokens": tokens, "run_s": time.perf_counter() - t0,
            "launches": (flash_attention_fwd.launches, flash_attention_bwd.launches)}


def dist_nccl_world1(workdir, datasets, result, device="cuda"):
    """NCCL at world size 1: a ``Trainer`` over a 1 × 1 mesh with
    ``shard_embedding`` against a plain one, 3 steps (dropout as configured,
    0.5) and one validation pass, bitwise; then both at N = FUSED_N for an
    epoch (graphs of 16 and 12 steps), bitwise; the launches of each."""
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh, init_distributed

    store = tempfile.mktemp(prefix="store_", dir=workdir)
    backend = "nccl" if device == "cuda" else "gloo"
    init_distributed(backend, store=torch.distributed.FileStore(store, 1), rank=0, world_size=1)
    try:
        runs = {}
        for name in ("plain", "mesh"):
            plan = (MeshPlan(mesh=create_mesh(data=1, model=1, device_type=device),
                             shard_embedding=True) if name == "mesh" else None)
            trainer = Trainer(_train_cfg(workdir), datasets, workdir=workdir, device=device,
                              mesh_plan=plan)
            trainer.init_state()
            flash_attention_fwd.launches = flash_attention_bwd.launches = 0
            losses = [trainer.train_step(trainer.device_batch(b, is_train=True)).item()
                      for b, _ in zip(datasets[0].get_loader(seed=0), range(3))]
            metrics = trainer.validate()
            _sync(device)
            runs[name] = (losses, {k: v.clone() for k, v in trainer.rec.module.state_dict()
                                   .items()}, metrics,
                          (flash_attention_fwd.launches, flash_attention_bwd.launches))
            cfg = _train_cfg(workdir, steps_per_dispatch=FUSED_N)
            trainer = Trainer(cfg, datasets, workdir=workdir, device=device, mesh_plan=plan)
            trainer.init_state()
            flash_attention_fwd.launches = flash_attention_bwd.launches = 0
            loss = trainer.training_epoch(0)
            _sync(device)
            runs[f"{name}_n{FUSED_N}"] = (
                [loss], {k: v.clone() for k, v in trainer.rec.module.state_dict().items()}, {},
                (flash_attention_fwd.launches, flash_attention_bwd.launches),
                sorted(n for _, n in trainer._graphs.cuda.graphs) if trainer._graphs else [])
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    out = {"backend": backend}
    layers = TRAIN_CONFIG["model"]["layer_num"]
    steps = len(datasets[0].get_loader())
    for suffix, want in (("", _nccl_launches_want(len(datasets[1].get_loader()))),
                         (f"_n{FUSED_N}", (layers * steps, layers * steps))):
        plain, mesh = runs[f"plain{suffix}"], runs[f"mesh{suffix}"]
        bitwise = (plain[0] == mesh[0] and plain[2] == mesh[2]
                   and all(torch.equal(v, mesh[1][k]) for k, v in plain[1].items()))
        out[f"steps{suffix or '_n1'}"] = {"bitwise": bitwise, "losses": mesh[0],
                                         "launches": list(mesh[3]), "want": list(want),
                                         "graphs": mesh[4] if len(mesh) > 4 else []}
        if not bitwise or mesh[3] != want:
            result["nccl_world1"] = out
            raise AssertionError(f"dist nccl at world size 1: {out}")
    want_graphs = sorted({FUSED_N, steps % FUSED_N} - {0, 1})
    if runs[f"mesh_n{FUSED_N}"][4] != want_graphs:
        raise AssertionError(f"dist nccl at world size 1: graphs {runs[f'mesh_n{FUSED_N}'][4]}, "
                             f"want {want_graphs}")
    result["nccl_world1"] = out
    return runs["mesh"][3], runs[f"mesh_n{FUSED_N}"][3]


def _nccl_launches_want(eval_batches):
    """3 steps and one validation pass: per layer a forward a step and eval
    batch, a backward a step."""
    layers = TRAIN_CONFIG["model"]["layer_num"]
    return layers * (3 + eval_batches), layers * 3


def _decode_launches_want(batches):
    """The regenerator's 2 encoder layers a batch; no backward."""
    return 2 * batches, 0


def _spawn(fn, world, workdir, device, *args):
    """``fn(rank, *args, device)`` on ``world`` gloo ranks that share the card."""
    from dr4sr_tpu_torch.parallel.launch import run_ranks

    store = tempfile.mktemp(prefix="store_", dir=workdir)
    return run_ranks(fn, world, store, *args, device, backend=DIST_BACKEND,
                     device_type=device, timeout_s=DIST_TIMEOUT_S)


# phase 11's runs of the contrastive, intent and graph models and of DR4SR+
# on a mesh, each at its configs/<model>.yaml widths (phases 7-9's configs,
# dropout 0), held against one rank on the card from its weights, batches,
# negatives, views and aux draws (and, for NCL and ICLRec, its per-epoch
# state; each rank also fits its own, which must be bitwise one value on
# every rank). name: (model, data, model axis, shard_embedding, context_parallel)
DIST_ZOO_RUNS = {
    "dp_cl4srec": ("CL4SRec", 2, 1, False, 1),
    "dp_iclrec": ("ICLRec", 2, 1, False, 1),
    "dp_sgl": ("SGL", 2, 1, False, 1),
    "2x2_ncl": ("NCL", 2, 2, True, 1),
    "2x2_cl4srec": ("CL4SRec", 2, 2, True, 1),
    "ep_gnn": ("GNN", 1, 2, True, 1),
    "ep_simgcl": ("SimGCL", 1, 2, True, 1),
    "cp_cl4srec": ("CL4SRec", 1, 2, False, 2),
}
DIST_ZOO_STEPS = 2  # the first two batches of _dist_inputs (the second's halves unequal)
# DR4SR+ around SASRec (phase 5's widths, dropout 0): a weighted step, an
# outer step and a weighted step. name: (data, model axis, shard_embedding).
# The hypergradient's Neumann step is raised from 1e-3 to 0.1 here: at 1e-3
# the 3 Hessian-vector products move the hypergradient by less than its
# HYPER_RTOL check, so a product left out of the all-reduce would not show
DIST_META_RUNS = {"dp_meta": (2, 1, False), "ep_meta": (1, 2, True)}
DIST_META_HPO_LR = 0.1
_TABLE_KEY = "item_embedding.weight"


def _dist_model_cfg(workdir, model, cp=1):
    """Phase 7's (CL4SRec) or phase 8's config of ``model`` at dropout 0."""
    cfg = _zoo_cfg(workdir, model) if model in ZOO_MODELS else _graph_cfg(workdir, model)
    cfg["model"]["dropout_rate"] = 0.0
    if cp > 1:
        cfg["model"]["context_parallel"] = cp
    return cfg


def _dist_meta_cfgs(workdir):
    meta, sub = _meta_cfgs(workdir, "SASRec")
    sub["model"]["dropout_rate"] = 0.0
    meta["train"]["hpo_learning_rate"] = DIST_META_HPO_LR
    return meta, sub


def _dist_zoo_reference(model, workdir, datasets, device="cuda"):
    """One rank on the card: ``model``'s checked steps from its initial
    weights, with the draws the ranks take: (inputs for the ranks, the
    losses, the first step's gradients)."""
    cfg = _dist_model_cfg(workdir, model)
    trainer = Trainer(cfg, datasets, workdir=workdir, device=device)
    trainer.init_state()
    init = {k: v.detach().cpu().clone() for k, v in trainer.rec.module.state_dict().items()}
    trainer.refresh_state(0)
    state = {k: v.cpu() for k, v in trainer.batch_extras.items() if not k.startswith("edge_")}
    batches, negs = _dist_inputs(datasets)
    gen = torch.Generator(device=device).manual_seed(5)
    aux_draws = getattr(trainer.model_class, "aux_draws", None)
    steps, losses, grads = [], [], None
    for batch, neg in list(zip(batches, negs))[:DIST_ZOO_STEPS]:
        dbatch = trainer.device_batch(batch, is_train=True)
        views = aux = None
        if trainer.contrastive:
            views = augment_views(gen, dbatch["in_item_id"], dbatch["seqlen"], cfg["model"],
                                  NUM_ITEMS)
        if aux_draws is not None:
            aux = aux_draws(gen, dbatch, cfg["model"], NUM_ITEMS)
        neg = torch.from_numpy(neg).to(device)
        losses.append(trainer.train_step(dbatch, neg, views=views, aux_draws=aux).item())
        grads = grads or _full_grads(trainer)
        steps.append((batch, neg.cpu(), _moved(views, "cpu"), _moved(aux, "cpu")))
    return {"init": init, "state": state, "steps": steps, "losses": losses, "grads": grads}


def _dist_meta_reference(workdir, datasets, device="cuda"):
    """One rank on the card: DR4SR+'s weighted, outer and weighted steps
    with the draws the ranks take."""
    meta, sub = _dist_meta_cfgs(workdir)
    trainer = MetaTrainer(meta, datasets, workdir=workdir, device=device, sub_config=sub)
    trainer.init_state()
    init = {k: v.detach().cpu().clone() for k, v in trainer.rec.module.state_dict().items()}
    meta_init = {k: v.detach().cpu().clone() for k, v in trainer.meta_params.items()}
    rng = np.random.default_rng(13)
    batches, _ = _dist_inputs(datasets)
    loader = trainer.train_data.get_loader(seed=4099)
    vb, ob = loader.sample_batch(), loader.sample_batch()

    def draws(batch):  # negatives, Gumbel noise
        item = batch["item_id"]
        return (torch.from_numpy(rng.integers(1, NUM_ITEMS, size=item.shape + (1,))),
                torch.from_numpy(rng.gumbel(size=item.shape + (2,)).astype(np.float32)))

    inputs = {"w1": (batches[1], *draws(batches[1])), "outer": (vb, ob, draws(vb)[0], *draws(ob)),
              "w2": (batches[1], *draws(batches[1]))}
    out = _dist_meta_steps(trainer, inputs, lambda x: x.to(device))
    return {"init": init, "meta_init": meta_init, "inputs": inputs, **out}


def _dist_meta_steps(trainer, inputs, rows):
    """The weighted, outer and weighted steps of ``inputs`` (``rows`` cuts
    a global draw to this rank's rows on its device): each weighted step's
    loss, the first's gradients, the hypergradient, the meta parameters
    after the outer step, each step's collectives and wall time."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER

    out = {"losses": [], "collectives": {}, "ms": {}}
    for step in ("w1", "outer", "w2"):
        COUNTER.reset()
        t0 = time.perf_counter()
        if step == "outer":
            vb, ob, val_neg, train_neg, noise = inputs[step]
            hyper = trainer.outer_step(
                trainer.device_batch(vb, is_train=True), trainer.device_batch(ob, is_train=True),
                val_neg=rows(val_neg), train_neg=rows(train_neg), noise=rows(noise))
            out["hyper"] = {k: v.detach().cpu() for k, v in hyper.items()}
            out["meta"] = {k: v.detach().cpu().clone() for k, v in trainer.meta_params.items()}
        else:
            batch, neg, noise = inputs[step]
            out["losses"].append(trainer.weighted_train_step(
                trainer.device_batch(batch, is_train=True), neg_id=rows(neg),
                noise=rows(noise)).item())
        _sync(trainer.device)
        out["ms"][step] = (time.perf_counter() - t0) * 1e3
        out["collectives"][step] = COUNTER.snapshot()
        if step == "w1":
            out["grads"] = _full_grads(trainer)
    return out


def _rank_rows(x, axis):
    """This rank's rows of a reference's global draws: the views' (seq,
    seqlen) pairs and the augmentation draws' ``start``/``u`` (of each
    branch of an ``item_random`` draw, whose pick is every rank's); a bare
    tensor (a draw over the graph's edges or the catalog) is every rank's."""
    if axis is None or x is None or isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        return {k: (_rank_rows(v, axis) if isinstance(v, list) else v if k == "pick"
                    else axis.chunk(v, 0) if isinstance(v, torch.Tensor) else v)
                for k, v in x.items()}
    if isinstance(x, tuple) and all(isinstance(v, torch.Tensor) for v in x):
        return tuple(axis.chunk(v, 0) for v in x)
    return type(x)(_rank_rows(v, axis) for v in x)


def _views_gather_seq():
    """Fault: the InfoNCE's views gathered with ``gather_seq``'s backward
    (each rank's own chunk of the cotangent) in place of ``gather_rows``'."""
    from dr4sr_tpu_torch.modules import losses
    from dr4sr_tpu_torch.parallel.collectives import gather_seq

    losses.gather_rows = lambda x, axis, dim=0: gather_seq(x, axis, dim)


def _hvps_unreduced():
    """Fault: the outer step's Hessian-vector products left out of the
    all-reduce over ``data`` (``hypergradient`` sums 5 trees an outer step:
    ∂L_val/∂W, the 3 products, ∂(g·p)/∂φ)."""
    from dr4sr_tpu_torch.meta import hypergrad

    real, calls = hypergrad._sum_over, []

    def skip_products(grads, axis):
        calls.append(None)
        return grads if len(calls) % 5 in (2, 3, 4) else real(grads, axis)

    hypergrad._sum_over = skip_products


def dist_more_rank(rank, workdir, runs, refs, fault, device="cuda"):
    """One rank of each of ``runs`` (names of DIST_ZOO_RUNS and
    DIST_META_RUNS of one world size) in one process, from ``refs``' weights
    and draws: per run the checked steps' losses and wall times, the first
    step's gradients, each step's collectives, the attention launches, the
    local weights after the steps and (NCL, ICLRec) the rank's own per-epoch
    state; for DR4SR+ the hypergradient and the meta parameters."""
    from dr4sr_tpu_torch.parallel.collectives import COUNTER
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    if fault is not None:
        DIST_FAULTS[fault]()
    datasets = prepare_datasets(TRAIN_CONFIG, root=workdir)
    results = {}
    for run in runs:
        meta = run in DIST_META_RUNS
        data, model, shard = DIST_META_RUNS[run] if meta else DIST_ZOO_RUNS[run][1:4]
        plan = MeshPlan(mesh=create_mesh(data=data, model=model, device_type=device),
                        shard_embedding=shard)
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        if meta:
            ref = refs["meta"]
            meta_cfg, sub = _dist_meta_cfgs(workdir)
            trainer = MetaTrainer(meta_cfg, datasets, workdir=workdir, device=device,
                                  sub_config=sub, mesh_plan=plan)
            trainer.init_state()
            trainer.set_params(ref["init"])
            trainer.load_meta({k: v for k, v in ref["meta_init"].items() if k != "tau"},
                              ref["meta_init"]["tau"].item())
            axis = trainer.data_axis
            out = _dist_meta_steps(trainer, ref["inputs"],
                                   lambda x: (x if axis is None else axis.chunk(x, 0)).to(device))
        else:
            name, cp = DIST_ZOO_RUNS[run][0], DIST_ZOO_RUNS[run][4]
            ref = refs[name]
            trainer = Trainer(_dist_model_cfg(workdir, name, cp), datasets, workdir=workdir,
                              device=device, mesh_plan=plan)
            trainer.init_state()
            trainer.set_params(ref["init"])
            out = {"losses": [], "collectives": [], "ms": []}
            if ref["state"]:
                trainer.refresh_state(0)
                out["state"] = {k: trainer.batch_extras[k].cpu() for k in ref["state"]}
                trainer.batch_extras.update(_moved(ref["state"], device))
            axis = trainer.data_axis
            for batch, neg, views, aux in ref["steps"]:
                dbatch = trainer.device_batch(batch, is_train=True)
                COUNTER.reset()
                t0 = time.perf_counter()
                neg = neg if axis is None else axis.chunk(neg, 0)
                loss = trainer.train_step(dbatch, neg.to(device),
                                          views=_moved(_rank_rows(views, axis), device),
                                          aux_draws=_moved(_rank_rows(aux, axis), device))
                out["losses"].append(loss.item())
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["collectives"].append(COUNTER.snapshot())
                if "grads" not in out:
                    out["grads"] = _full_grads(trainer, ref["grads"][_TABLE_KEY].shape[0])
        _sync(device)
        out["launches"] = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        out["local"] = {k: v.detach().cpu().clone()
                        for k, v in trainer.rec.module.state_dict().items()}
        out["train_batches"] = len(datasets[0].get_loader())
        results[run] = out
    return results



def _dist_zoo_launches_want(run, rank, train_batches):
    """A rank's attention launches: per step and layer a forward and a
    backward for each encode with a gradient (CL4SRec 3: the batch and two
    views; ICLRec 3, and a fourth forward for the pooled encode that picks
    the intents; the graph models 1), times the ring's blocks under CP
    (model index + 1); ICLRec's E-step encodes its rows of every train
    batch once (a forward per layer and batch)."""
    if run in DIST_META_RUNS:  # two weighted steps; the outer step attends plainly
        layers = TRAIN_CONFIG["model"]["layer_num"]
        return 2 * layers, 2 * layers
    name, data, model, shard, cp = DIST_ZOO_RUNS[run]
    layers = CONFIG["model"]["layer_num"]
    fwd, bwd = {"CL4SRec": (3, 3), "ICLRec": (4, 3)}.get(name, (1, 1))
    blocks = rank % model + 1 if cp > 1 else 1
    refresh = layers * train_batches if name == "ICLRec" else 0
    return (layers * DIST_ZOO_STEPS * fwd * blocks + refresh,
            layers * DIST_ZOO_STEPS * bwd * blocks)


def _dist_zoo_collectives_want(run, ref):
    """A step's collectives (calls, and bytes where given), by kind and
    axis: the views' all-gathers over ``data`` ([B, D] each; ICLRec's
    intent labels besides, [B] int64) and an all-reduce of each one's
    cotangents in its backward, beside the BCE count's and the gradients';
    the graph models' table all-gathered over ``model`` once a step ([N', D],
    N' the table's rows padded to the axis) and ep_gather's all-reduces of
    the looked-up rows ([B/data, L, D] each); CP's ring per layer and
    encode (10 sends, 4 all-gathers of [B, H, L/2·2, Dh])."""
    name, data, model, shard, cp = DIST_ZOO_RUNS[run]
    dim, length, heads = CONFIG["model"]["embed_dim"], 50, CONFIG["model"]["head_num"]
    layers = CONFIG["model"]["layer_num"]
    b = BATCH // data
    rows = ref["init"][_TABLE_KEY].shape[0]
    padded = -(-rows // model) * model
    want = {}
    if data > 1:
        want["all_reduce:data"] = 2
        if name in ("CL4SRec", "ICLRec"):
            want["all_reduce:data"] = 4
            labels = name == "ICLRec"  # its intent labels, [B] int64
            want["all_gather:data"] = {"calls": 2 + labels,
                                       "bytes": 2 * BATCH * dim * 4 + labels * BATCH * 8}
    if shard:
        # looked-up rows: the positives and negatives, SASRec's input ids, CL4SRec's two views'
        lookups = 2 + (name != "GNN") + 2 * (name == "CL4SRec")
        want["all_reduce:model"] = {"calls": lookups, "bytes": lookups * b * length * dim * 4}
        if name in ("GNN", "SGL", "SimGCL", "NCL"):
            want["all_gather:model"] = {"calls": 1, "bytes": padded * dim * 4}
    if cp > 1:
        qkv = b * heads * length * (dim // heads) * 4
        want["all_gather:model"] = {"calls": 4 * layers * 3, "bytes": 4 * layers * 3 * qkv}
        want["send:model"] = 10 * layers * 3
    return want


def _dist_meta_collectives_want(run, param_bytes, meta_bytes):
    """DR4SR+'s steps: DP — a weighted step's BCE count and gradients (2
    all-reduces over ``data``), an outer step's two losses' counts and its
    5 derivative trees (∂L_val/∂W, 3 Hessian-vector products, ∂(g·p)/∂φ);
    EP — ep_gather's 3 all-reduces over ``model`` a forward, and in the
    outer step 3 more for each of the 4 derivatives taken through them with
    ``create_graph`` (the sum of the ranks' cotangents)."""
    data, model, shard = DIST_META_RUNS[run]
    if data > 1:
        return {"w1": {"all_reduce:data": 2}, "w2": {"all_reduce:data": 2},
                "outer": {"all_reduce:data": {"calls": 7,
                                              "bytes": 2 * 4 + 4 * param_bytes + meta_bytes}}}
    return {"w1": {"all_reduce:model": 3}, "w2": {"all_reduce:model": 3},
            "outer": {"all_reduce:model": 2 * 3 + 4 * 3}}


def _collectives_match(got, want):
    return {k: (v if isinstance(want.get(k), dict) else v["calls"])
            for k, v in got.items()} == want


def _check_replicas(run, outs, model, shard):
    for r, out in enumerate(outs):
        for k, v in out["local"].items():
            twin = outs[r % model] if (shard and k == _TABLE_KEY) else outs[0]
            if not torch.equal(v, twin["local"][k]):
                raise AssertionError(f"dist {run}: replica {k} of rank {r} differs")


def check_dist_more_run(run, outs, refs):
    """A run's ranks against the one-rank reference; returns the summary
    and raises on the first fault."""
    meta = run in DIST_META_RUNS
    if meta:
        (data, model, shard), ref = DIST_META_RUNS[run], refs["meta"]
        summary = {"model": "MetaModel/SASRec", "mesh": [data, model], "shard_embedding": shard}
    else:
        name, data, model, shard, cp = DIST_ZOO_RUNS[run]
        ref = refs[name]
        summary = {"model": name, "mesh": [data, model], "shard_embedding": shard,
                   "context_parallel": cp, "steps": DIST_ZOO_STEPS}
    parity = _parity({"cuda": (outs[0]["losses"], outs[0]["grads"]),
                      "cpu": (ref["losses"], ref["grads"])})
    summary["vs_one_rank"] = {k: parity[k] for k in ("grad_max_rel_err", "grad_worst_param",
                                                     "loss_max_abs_err", "losses_card")}
    summary["step_ms"] = [out["ms"] for out in outs]
    if not (parity["grad_max_rel_err"] <= GRAD_RTOL and parity["loss_max_abs_err"] <= LOSS_ATOL):
        raise AssertionError(f"dist {run} vs one rank: {summary['vs_one_rank']} (grads rtol "
                             f"{GRAD_RTOL} of the largest, losses atol {LOSS_ATOL})")
    if any(out["losses"] != outs[0]["losses"] for out in outs[1:]):
        raise AssertionError(f"dist {run}: the ranks' losses differ")
    _check_replicas(run, outs, model, shard)
    summary["replicas_bitwise"] = True
    if meta:
        rel = _rel_errs(outs[0]["hyper"], ref["hyper"])
        summary["hyper_rel_err"] = rel
        if max(rel.values()) > HYPER_RTOL:
            raise AssertionError(f"dist {run}: hypergradient {rel} of the largest (rtol "
                                 f"{HYPER_RTOL})")
        if not all(torch.equal(v, outs[0]["meta"][k]) for out in outs[1:]
                   for k, v in out["meta"].items()):
            raise AssertionError(f"dist {run}: the meta parameters differ across ranks")
        summary["meta_bitwise"] = True
        nbytes = lambda tree: sum(v.numel() * 4 for v in tree.values())  # noqa: E731
        want = _dist_meta_collectives_want(run, nbytes(ref["grads"]), nbytes(ref["hyper"]))
        got = outs[0]["collectives"]
    elif "state" in outs[0]:
        if not all(torch.equal(v, outs[0]["state"][k]) for out in outs[1:]
                   for k, v in out["state"].items()):
            raise AssertionError(f"dist {run}: the refreshed state differs across ranks")
        summary["state_bitwise"] = True
    if not meta:
        want = _dist_zoo_collectives_want(run, ref)
        got = outs[0]["collectives"][0]
    summary["collectives"], summary["collectives_want"] = got, want
    if meta:
        bad = [k for k in want if not _collectives_match(got[k], want[k])]
    else:
        bad = [] if _collectives_match(got, want) else ["step"]
    if bad:
        raise AssertionError(f"dist {run}: collectives {got}, want {want}")
    launches = [tuple(out["launches"]) for out in outs]
    want_l = [_dist_zoo_launches_want(run, r, out["train_batches"]) for r, out in enumerate(outs)]
    summary["launches"] = {"got": launches, "want": want_l}
    if launches != want_l:
        raise AssertionError(f"dist {run}: launches {launches}, want {want_l}")
    return summary


def dist_more(workdir, datasets, result, fwd, bwd, device="cuda", fault=None, only=None,
              ref=None):
    """Phase 11's runs of the zoo and DR4SR+ on a mesh (DIST_ZOO_RUNS,
    DIST_META_RUNS) and, given ``ref`` (the one-rank SASRec reference),
    SASRec's DIST_RUNS first: the ranks of each world size in one spawn
    (a process start and a data load each, not one a run); each run
    checked into ``result`` and its launches (summed over the ranks) into
    ``fwd`` and ``bwd``. ``fault`` patches DIST_FAULTS[fault] into the
    ranks of the zoo and DR4SR+ runs; ``only`` keeps those runs."""
    runs = [r for r in (*DIST_ZOO_RUNS, *DIST_META_RUNS) if only is None or r in only]
    models = {DIST_ZOO_RUNS[r][0] for r in runs if r in DIST_ZOO_RUNS}
    t0 = time.perf_counter()
    refs = {m: _dist_zoo_reference(m, workdir, datasets, device) for m in sorted(models)}
    if any(r in DIST_META_RUNS for r in runs):
        refs["meta"] = _dist_meta_reference(workdir, datasets, device)
    result["references_s"] = time.perf_counter() - t0
    by_world, train_by_world = {}, {}
    for run in runs:
        data, model = (DIST_META_RUNS[run][:2] if run in DIST_META_RUNS
                       else DIST_ZOO_RUNS[run][1:3])
        by_world.setdefault(data * model, []).append(run)
    for run, (data, model, *_rest) in (DIST_RUNS.items() if ref is not None else ()):
        train_by_world.setdefault(data * model, []).append(run)
    for world in sorted(set(by_world) | set(train_by_world)):
        names, train_names = by_world.get(world, []), train_by_world.get(world, [])
        t0 = time.perf_counter()
        outs = _spawn(dist_world_rank, world, workdir, device, workdir, train_names, ref, names,
                      refs, fault)
        result[f"spawn_{world}_s"] = time.perf_counter() - t0
        for run in train_names:
            result[run] = check_dist_run(run, [out[run] for out in outs], ref)
            result[run]["run_s"] = outs[0][run]["run_s"]
            fwd[f"dist_{run}"] = sum(result[run]["launches"]["fwd"])
            bwd[f"dist_{run}"] = sum(result[run]["launches"]["bwd"])
        for run in names:
            ranks = [out[run] for out in outs]
            result[run] = check_dist_more_run(run, ranks, refs)
            fwd[f"dist_{run}"] = sum(o["launches"][0] for o in ranks)
            bwd[f"dist_{run}"] = sum(o["launches"][1] for o in ranks)


def dist(card, workdir, device="cuda"):
    """Phase 11 on phase 6's data: NCCL at world size 1; DP, EP, CP and
    2 × 2 over gloo on the card against one rank; the contrastive, intent and
    graph models and DR4SR+ on a mesh (:func:`dist_more`); the ring through
    both kernels; sharded decode. The ``dist`` line holds what each part read,
    also when one of them fails."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    result = {"card": card, "backend": DIST_BACKEND, "cards": cards,
              "timing": ("host-staged gloo, ranks sharing the card: not a multi-GPU speed"
                         if DIST_BACKEND == "gloo" else f"{DIST_BACKEND}, rank r on card r mod "
                         f"{cards}")}
    fwd, bwd = {}, {}
    try:
        datasets = prepare_datasets(TRAIN_CONFIG, root=workdir)
        n1, n16 = dist_nccl_world1(workdir, datasets, result, device)
        fwd["dist_nccl1"], bwd["dist_nccl1"] = n1
        fwd[f"dist_nccl1_n{FUSED_N}"], bwd[f"dist_nccl1_n{FUSED_N}"] = n16
        ref = _dist_reference(workdir, datasets, device)
        result["one_rank"] = {"losses": ref["losses"], "metrics": ref["metrics"],
                              "timed": ref["timed"]}
        dist_more(workdir, datasets, result, fwd, bwd, device, ref=ref)
        result["ring"], result["ring_sends_staged_through_host"] = _spawn(
            dist_ring_rank, 2, workdir, device)[0]
        check_dist_ring(result["ring"])
        sequences = train_sequences_from_rows(datasets[0].rows())[:DIST_DECODE_SEQS]
        gen = load_regenerator(ARTIFACT, device=device)
        one = decode_dataset(gen, sequences, REGEN_K, batch_size=DECODE_BATCH,
                             max_len=DECODE_MAX_LEN)
        outs = _spawn(dist_decode_rank, 2, workdir, device, sequences)
        batches = REGEN_K * -(-len(sequences) // DECODE_BATCH)
        result["decode"] = {"lanes": len(one), "batches": batches,
                            "equal": [o["tokens"] == one for o in outs],
                            "launches": [list(o["launches"]) for o in outs],
                            "want": list(_decode_launches_want(batches)),
                            "run_s": [o["run_s"] for o in outs]}
        if not all(result["decode"]["equal"]) or any(
                tuple(o["launches"]) != _decode_launches_want(batches) for o in outs):
            raise AssertionError(f"dist decode: {result['decode']}")
        fwd["dist_decode"] = sum(o["launches"][0] for o in outs)
        bwd["dist_decode"] = sum(o["launches"][1] for o in outs)
    finally:
        log(f"dist {json.dumps(result, default=str)}")
    return fwd, bwd


# --nccl: phase 11 over NCCL on NCCL_CARDS cards, rank r on card r, then the
# fused runs on a mesh: train.steps_per_dispatch = FUSED_N, each rank's group
# one replay of its own CUDA graph, the step's collectives inside it, at
# phase 10's configs (dropout as configured; CL4SRec under item_random).
# name: (model, data, model axis, shard_embedding, context_parallel)
NCCL_CARDS = 4
DIST_FUSED_RUNS = {
    "fused_dp": ("SASRec", 2, 1, False, 1),
    "fused_ep": ("SASRec", 1, 2, True, 1),
    "fused_cp": ("SASRec", 1, 2, False, 2),
    "fused_2x2": ("SASRec", 2, 2, True, 2),
    "fused_dp_cl4srec": ("CL4SRec", 2, 1, False, 1),
    "fused_dp_meta": ("MetaModel", 2, 1, False, 1),
}


def _dist_fused_trainer(workdir, model, cp, plan, spd, device):
    if model == "MetaModel":  # DR4SR+ around SASRec, phase 9's configs
        meta, sub = _meta_cfgs(workdir, "SASRec", steps_per_dispatch=spd)
        trainer = MetaTrainer(meta, prepare_datasets(meta, root=workdir), workdir=workdir,
                              device=device, sub_config=sub, mesh_plan=plan)
    else:
        cfg = _fused_cfg(workdir, model, steps_per_dispatch=spd)
        if cp > 1:
            cfg["model"]["context_parallel"] = cp
        trainer = Trainer(cfg, prepare_datasets(cfg, root=workdir), workdir=workdir,
                          device=device, mesh_plan=plan)
    trainer.init_state()
    return trainer


def _timed_groups(trainer, eager, kind):
    """FUSED_TIMED_GROUPS groups of FUSED_N steps, host batches to done:
    through ``trainer``'s graph and, on ``eager`` (N = 1, the same mesh),
    step by step, in turns; ms a step."""
    update = trainer._update if kind == "train" else trainer._weighted_update
    step = eager.train_step if kind == "train" else eager.weighted_train_step
    loaders = itertools.chain.from_iterable(trainer.train_batches(e) for e in itertools.count(1))
    step(eager.device_batch(next(loaders), is_train=True))  # the eager trainer's warm-up
    timed = {"graph": [], "eager": []}
    for _ in range(FUSED_TIMED_GROUPS):
        group = list(itertools.islice(loaders, FUSED_N))
        for name in ("graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "graph":
                trainer.fused_steps(group, kind, update)
            else:
                for batch in group:
                    step(eager.device_batch(batch, is_train=True))
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) * 1e3 / FUSED_N)
    return {f"{name}_step_ms_{q}": float(np.percentile(ms, int(q[1:])))
            for name, ms in timed.items() for q in ("p50", "p90")}


def dist_fused_rank(rank, workdir, runs, fault, device="cuda"):
    """One rank of each of ``runs`` (names of DIST_FUSED_RUNS of one world
    size): a group of FUSED_N steps through the graph against the same
    steps eagerly, twice, from one state (:func:`fused_vs_eager`: launches
    and collectives of each), the local weights after the graph's group,
    and groups timed through the graph against an N = 1 trainer on the
    same mesh. ``fault`` patches NCCL_FAULTS[fault] in."""
    from dr4sr_tpu_torch.parallel.mesh import MeshPlan, create_mesh

    undo = NCCL_FAULTS[fault]() if fault else (lambda: None)
    out = {}
    try:
        for run in runs:
            model, data, axis, shard, cp = DIST_FUSED_RUNS[run]
            plan = MeshPlan(mesh=create_mesh(data=data, model=axis, device_type="cuda"),
                            shard_embedding=shard)
            trainer = _dist_fused_trainer(workdir, model, cp, plan, FUSED_N, device)
            kind = "weighted" if model == "MetaModel" else "train"
            result = fused_vs_eager(trainer, kind)
            local = {k: v.detach().cpu().clone()
                     for k, v in trainer.rec.module.state_dict().items()}
            eager = _dist_fused_trainer(workdir, model, cp, plan, 1, device)
            result["timed"] = _timed_groups(trainer, eager, kind)
            out[run] = {"result": result, "local": local}
            del trainer, eager
            torch.cuda.empty_cache()
    finally:
        undo()
    return out


def _dist_fused_want(run, rank):
    """A rank's attention launches (forward = backward) and collectives by
    kind and axis in a group of FUSED_N steps: per step and layer a kernel
    each way for each encode with a gradient (CL4SRec 3: the batch and two
    views), times the ring's blocks under CP (model index + 1); the BCE
    count's and the gradients' all-reduces over ``data`` (CL4SRec: and the
    two views' gathers, each with an all-reduce in its backward), EP's 3
    gathers over ``model``, and per layer the ring's 10 sends and 4
    all-gathers (o, dq, dk, dv)."""
    model, data, axis, shard, cp = DIST_FUSED_RUNS[run]
    layers = TRAIN_CONFIG["model"]["layer_num"]
    encodes = 3 if model == "CL4SRec" else 1
    blocks = rank % axis + 1 if cp > 1 else 1
    want = {}
    if data > 1:
        want["all_reduce:data"] = 4 if model == "CL4SRec" else 2
        if model == "CL4SRec":
            want["all_gather:data"] = 2
    if shard:
        want["all_reduce:model"] = 3
    if cp > 1:
        want.update({"all_gather:model": 4 * layers, "send:model": 10 * layers})
    return ([FUSED_N * layers * encodes * blocks] * 2,
            {k: FUSED_N * v for k, v in sorted(want.items())})


def check_dist_fused_run(run, outs):
    """Each rank's graph against its eager steps (phase 10's rule), the
    launches and collectives of the graph's group as predicted (and the
    eager group's the same), replicas bitwise across ranks."""
    model, data, axis, shard, cp = DIST_FUSED_RUNS[run]
    summary = {"model": model, "mesh": [data, axis], "shard_embedding": shard,
               "context_parallel": cp, "steps": FUSED_N, "ranks": []}
    for r, out in enumerate(outs):
        res = out["result"]
        launches, collectives = _dist_fused_want(run, r)
        got = {k: v["calls"] for k, v in res["collectives"]["graph"].items()}
        summary["ranks"].append({
            k: res[k] for k in ("bitwise", "tensors", "not_bitwise", "over_bound",
                                "generators_equal", "loss_max_abs_err", "launches",
                                "timed")})
        summary["ranks"][-1].update(collectives=got, want_launches=launches,
                                    want_collectives=collectives)
        check_fused_vs_eager(f"dist {run} rank {r}", res)
        if res["launches"]["graph"] != launches or got != collectives:
            raise AssertionError(f"dist {run} rank {r}: a group's launches "
                                 f"{res['launches']['graph']} and collectives {got}, want "
                                 f"{launches} and {collectives}")
    _check_replicas(run, outs, axis, shard)
    summary["replicas_bitwise"] = True
    return summary


def dist_fused(card, workdir, result, fault=None, only=None):
    """The fused runs on a mesh over NCCL (DIST_FUSED_RUNS), the ranks of
    each world size in one spawn; each checked into ``result``; returns the
    graph groups' launches summed over the ranks, by path."""
    fwd, bwd = {}, {}
    by_world = {}
    for run, (_, data, axis, *_rest) in DIST_FUSED_RUNS.items():
        if only is None or run in only:
            by_world.setdefault(data * axis, []).append(run)
    for world, names in sorted(by_world.items()):
        t0 = time.perf_counter()
        outs = _spawn(dist_fused_rank, world, workdir, "cuda", workdir, names, fault)
        result[f"fused_spawn_{world}_s"] = time.perf_counter() - t0
        for run in names:
            ranks = [out[run] for out in outs]
            result[run] = check_dist_fused_run(run, ranks)
            fwd[f"dist_{run}"] = sum(o["result"]["launches"]["graph"][0] for o in ranks)
            bwd[f"dist_{run}"] = sum(o["result"]["launches"]["graph"][1] for o in ranks)
    return fwd, bwd


def _replay_uncounted():
    """Fault: a replay adds its attention launches but not its collectives."""
    keep = CudaGraphs.replay

    def uncounted(self, key):
        captured = self.graphs[key]
        captured.graph.replay()
        attention.flash_attention_fwd.launches += captured.launches[0]
        attention.flash_attention_bwd.launches += captured.launches[1]
        return captured.outputs

    CudaGraphs.replay = uncounted
    return lambda: setattr(CudaGraphs, "replay", keep)


# --nccl --controls: each fault patched into the ranks of its run, whose
# check must fail
NCCL_FAULTS = {"replay_uncounted": _replay_uncounted}
NCCL_CONTROLS = {"replay_uncounted": "fused_dp"}


def nccl(controls=False) -> int:
    """``--nccl``: phase 11 over NCCL, a card a rank (``dist``), then the
    fused runs on a mesh (:func:`dist_fused`); ``--nccl --controls``: the
    NCCL_CONTROLS faults against the fused runs' checks."""
    global DIST_BACKEND
    cards = torch.cuda.device_count()
    if cards < NCCL_CARDS:
        raise RuntimeError(f"--nccl runs ranks on {NCCL_CARDS} cards, one each; "
                           f"{cards} visible")
    DIST_BACKEND = "nccl"
    start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log("\n".join(smi.stdout.strip().splitlines()))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
        f"{torch.cuda.nccl.version()} python {sys.version.split()[0]}")
    _build.build_all()  # before any rank starts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as workdir:
        _datasets(workdir)
        if controls:
            for fault, run in NCCL_CONTROLS.items():
                try:
                    dist_fused(card, workdir, {}, fault=fault, only=(run,))
                    caught, why = False, None
                except AssertionError as e:
                    caught, why = True, str(e)[:300]
                log(f"control {json.dumps({'path': 'dist_fused', 'fault': fault, 'run': run,
                                           'caught': caught, 'why': why})}")
            return 0
        fwd, bwd = dist(card, workdir)
        log(f"elapsed after phase 11 over NCCL: {time.perf_counter() - start:.1f}s")
        result = {"card": card, "backend": DIST_BACKEND, "cards": cards}
        try:
            more = dist_fused(card, workdir, result)
        finally:
            log(f"dist_fused {json.dumps(result, default=str)}")
        fwd.update(more[0])
        bwd.update(more[1])
        log(f"elapsed after the fused runs: {time.perf_counter() - start:.1f}s")
    print(json.dumps({"launches_by_path": {"flash_attention_fwd": fwd,
                                           "flash_attention_bwd": bwd}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": cards}}))
    return 0


# ------------------------------------------------------------------ 12. tools

TOOLS_EPOCHS = 3
TOOLS_PROFILE_EPOCH = 1  # epoch 0 before it, epoch 2 after it: both unprofiled
TOOLS_LRS = [1e-3, 3e-3]  # tune's grid, one epoch a run
TOOLS_SERVED = 2048  # test histories served from the checkpoint, plain and padded
TOOLS_TIMEOUT_S = 900  # the phase's process, which takes well under a minute
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected), bit by bit: independent of the
    writer's table."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """(field number, value) of each field of a protobuf message: varints as
    ints, fixed32/64 and length-delimited fields as bytes."""
    def varint(i):
        shift = value = 0
        while True:
            b = buf[i]
            value |= (b & 0x7F) << shift
            i, shift = i + 1, shift + 7
            if not b & 0x80:
                return value, i

    out, i = [], 0
    while i < len(buf):
        key, i = varint(i)
        wire = key & 7
        if wire == 0:
            value, i = varint(i)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, i = buf[i:i + size], i + size
        elif wire == 2:
            size, i = varint(i)
            value, i = buf[i:i + size], i + size
        else:
            raise AssertionError(f"protobuf wire type {wire}")
        out.append((key >> 3, value))
    return out


def read_scalars(path):
    """{(step, tag): value} of a TensorBoard event file, each record's
    length and payload checked against their masked CRC-32C; and the file
    version of its first event."""
    scalars, version = {}, None
    with open(path, "rb") as f:
        while header := f.read(8):
            (n,) = struct.unpack("<Q", header)
            (crc,) = struct.unpack("<I", f.read(4))
            if crc != _masked_crc32c(header):
                raise AssertionError(f"{path}: a record's length fails its CRC")
            event = f.read(n)
            (crc,) = struct.unpack("<I", f.read(4))
            if crc != _masked_crc32c(event):
                raise AssertionError(f"{path}: a record fails its CRC")
            fields = dict(_proto_fields(event))
            if 3 in fields:
                version = fields[3].decode()
                continue
            for field, value in _proto_fields(fields[5]):  # summary: its values
                value = dict(_proto_fields(value))
                scalars[(fields.get(2, 0), value[1].decode())] = struct.unpack("<f", value[2])[0]
    return scalars, version


def _counts():
    return flash_attention_fwd.launches, flash_attention_bwd.launches


def _grown(before):
    now = _counts()
    return now[0] - before[0], now[1] - before[1]


def _check_tools_launches(what, got, want):
    if tuple(got) != tuple(want):
        raise AssertionError(f"tools {what}: launches {got}, want {want}")


def _trace_kernel_rows(directory):
    """(forward, backward) attention kernel rows of the one trace in
    ``directory`` (``torch.profiler.tensorboard_trace_handler``'s JSON)."""
    (path,) = [os.path.join(directory, f) for f in os.listdir(directory)
               if f.startswith("rank0.") and f.endswith(".pt.trace.json")]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return (sum("flash_fwd_kernel" in n for n in names),
            sum("flash_bwd" in n for n in names), len(names))


@contextlib.contextmanager
def _watched_epochs(epochs, device):
    """``Trainer._maybe_profile`` wrapped: each epoch's attention launches,
    its training's wall time and the time with the trace written, by
    epoch."""
    original = Trainer._maybe_profile

    @contextlib.contextmanager
    def watched(self, nepoch):
        before = _counts()
        _sync(device)
        t0 = time.perf_counter()
        with original(self, nepoch):
            yield
            _sync(device)
            train_s = time.perf_counter() - t0
        epochs[nepoch] = {"launches": list(_grown(before)), "train_s": train_s,
                          "with_trace_s": time.perf_counter() - t0}

    Trainer._maybe_profile = watched
    try:
        yield
    finally:
        Trainer._maybe_profile = original


@contextlib.contextmanager
def _counted_runs(runs, device):
    """``quickstart.run`` wrapped (``tune`` calls it): each run's learning
    rate, launches, wall time and ``val_best``."""
    original = quickstart.run

    def counted(cfg, **kwargs):
        before = _counts()
        t0 = time.perf_counter()
        out = original(cfg, **kwargs)
        _sync(device)
        runs.append({"learning_rate": cfg["train"]["learning_rate"],
                     "launches": list(_grown(before)), "run_s": time.perf_counter() - t0,
                     "val_best": out["val_best"]})
        return out

    quickstart.run = counted
    try:
        yield
    finally:
        quickstart.run = original


def _tools_cfg(base, name, **train):
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["train"].update(train)
    cfg["eval"]["save_path"] = os.path.join(base, name)
    return cfg


def tools_run(base, data_root, steps, eval_batches, result, device):
    """``quickstart.run`` of SASRec for 3 epochs with TensorBoard scalars and
    epoch 1 profiled: the log file, the event file against metrics.jsonl, the
    trace's kernel rows against the counters, recall, the figure."""
    layers = TRAIN_CONFIG["model"]["layer_num"]
    cfg = _tools_cfg(base, "saved", epochs=TOOLS_EPOCHS, tensorboard_dir=os.path.join(base, "tb"),
                     profile_epoch=TOOLS_PROFILE_EPOCH,
                     profile_dir=os.path.join(base, "profile"))
    epochs = {}
    before = _counts()
    t0 = time.perf_counter()
    with _watched_epochs(epochs, device):
        out = quickstart.run(cfg, root=data_root, device=device)
    _sync(device)
    run = {"run_s": time.perf_counter() - t0, "launches": list(_grown(before)),
           "test": {k: out[k] for k in ("ndcg@20", "recall@20")}, "val_best": out["val_best"],
           "epochs": epochs}
    result["run"] = run
    _check_tools_launches("run", run["launches"],
                          (layers * (TOOLS_EPOCHS * steps + (TOOLS_EPOCHS + 1) * eval_batches),
                           layers * TOOLS_EPOCHS * steps))
    for nepoch, epoch in epochs.items():
        _check_tools_launches(f"epoch {nepoch}", epoch["launches"], (layers * steps,) * 2)

    (log_path,) = glob.glob(os.path.join(base, "log", "SASRec", "amazon-toys", "*.log"))
    with open(log_path) as f:
        text = f.read()
    for want in ("INFO config: {", "INFO epoch 0: ", "INFO epoch 1: ", "INFO test: {"):
        if want not in text:
            raise AssertionError(f"tools: the log file {log_path} lacks {want!r}")
    result["log_lines"] = len(text.splitlines())

    run_dir = os.path.join(base, "saved", "SASRec", "amazon-toys")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    (events,) = glob.glob(os.path.join(base, "tb", "events.out.tfevents.*"))
    scalars, version = read_scalars(events)
    want = {(r["epoch"], k): float(np.float32(v)) for r in records for k, v in r.items()
            if isinstance(v, float)}
    result["scalars"] = len(scalars)
    if version != "brain.Event:2" or scalars != want:
        raise AssertionError(f"tools: the event file's {len(scalars)} scalars ({version}) are "
                             f"not metrics.jsonl's {len(want)} at f32")
    random_recall = 20 / (NUM_ITEMS - 1)
    run["val_recall@20"] = records[-1]["recall@20"]
    if not run["val_recall@20"] > 5 * random_recall:
        raise AssertionError(f"tools: validation recall@20 {run['val_recall@20']} is not above "
                             f"5 x random ({random_recall})")

    fwd_rows, bwd_rows, kernel_rows = _trace_kernel_rows(os.path.join(base, "profile"))
    result["trace"] = {"fwd_kernels": fwd_rows, "bwd_kernels": bwd_rows, "kernels": kernel_rows,
                       "counted": epochs[TOOLS_PROFILE_EPOCH]["launches"]}
    _check_tools_launches("profiled epoch's trace", (fwd_rows, bwd_rows),
                          epochs[TOOLS_PROFILE_EPOCH]["launches"])
    profiled = epochs[TOOLS_PROFILE_EPOCH]
    result["profiler_overhead"] = {"plain_epoch_s": epochs[TOOLS_EPOCHS - 1]["train_s"],
                                   "profiled_epoch_s": profiled["train_s"],
                                   "with_trace_s": profiled["with_trace_s"]}

    figure = os.path.join(run_dir, "figures", "epoch_0.png")
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    result["figure"] = figure if os.path.exists(figure) else None
    if (result["figure"] is not None) != has_matplotlib:
        raise AssertionError(f"tools: figure {result['figure']} with matplotlib "
                             f"{'present' if has_matplotlib else 'missing'}")
    (checkpoint,) = glob.glob(os.path.join(run_dir, "*.ckpt"))
    return checkpoint


def tools_tune(base, data_root, steps, eval_batches, result, device):
    """``quickstart.tune`` over two learning rates, one epoch each: both runs
    through the kernels, the best by ``val_best``."""
    layers = TRAIN_CONFIG["model"]["layer_num"]
    runs = []
    t0 = time.perf_counter()
    with _counted_runs(runs, device):
        best, results = quickstart.tune(_tools_cfg(base, "tune", epochs=1),
                                        {"train.learning_rate": TOOLS_LRS}, root=data_root,
                                        method="grid", device=device)
    result["tune"] = {"runs": runs, "tune_s": time.perf_counter() - t0,
                      "best": best["params"]}
    for run in runs:
        _check_tools_launches(f"tune lr {run['learning_rate']}", run["launches"],
                              (layers * (steps + 2 * eval_batches), layers * steps))
    if ([r["params"]["train.learning_rate"] for r in results] != TOOLS_LRS
            or best["metrics"]["val_best"] != max(r["val_best"] for r in runs)):
        raise AssertionError(f"tools tune: {result['tune']}")
    return [sum(r["launches"][i] for r in runs) for i in (0, 1)]


def tools_serve(base, data_root, checkpoint, result, device):
    """The run's best checkpoint served, then the same with its table padded
    by one row, as an EP run saves it: the same ids."""
    from dr4sr_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    rows = prepare_datasets(TRAIN_CONFIG, root=data_root)[2].rows()
    hists = [list(h[:n]) for h, n in zip(rows.in_item_id[:TOOLS_SERVED], rows.seqlen)]
    params, meta = load_checkpoint(checkpoint)
    table = "item_embedding.weight"
    params[table] = torch.cat([params[table], params[table][:1] * 0])
    padded = os.path.join(base, "padded.ckpt")
    save_checkpoint(padded, params, meta["config"], "SASRec", meta["epoch"], meta["metric"])
    before = _counts()
    served = [Recommender.from_checkpoint(path, root=data_root, batch_size=BATCH, device=device)
              .recommend(hists, k=TOPK) for path in (checkpoint, padded)]
    launches = _grown(before)
    batches = 2 * -(-len(hists) // BATCH)
    result["serve"] = {"histories": len(hists), "padded_rows": int(params[table].shape[0]),
                       "ids_equal": bool(np.array_equal(served[0][0], served[1][0])),
                       "scores_max_diff": float(np.abs(served[0][1] - served[1][1]).max()),
                       "launches": list(launches)}
    if not result["serve"]["ids_equal"]:
        raise AssertionError(f"tools serve: {result['serve']}")
    _check_tools_launches("serve", launches, (TRAIN_CONFIG["model"]["layer_num"] * batches, 0))
    return launches


def tools_fused(base, data_root, steps, result, device):
    """``quickstart.run`` at ``train.steps_per_dispatch = 16`` for 2 epochs
    with epoch 1 profiled: the trace sees the kernels the graphs replay."""
    layers = TRAIN_CONFIG["model"]["layer_num"]
    cfg = _tools_cfg(base, "fused", epochs=2, steps_per_dispatch=FUSED_N, profile_epoch=1,
                     profile_dir=os.path.join(base, "profile_fused"))
    epochs = {}
    before = _counts()
    with _watched_epochs(epochs, device):
        quickstart.run(cfg, root=data_root, device=device)
    launches = _grown(before)
    fwd_rows, bwd_rows, kernel_rows = _trace_kernel_rows(os.path.join(base, "profile_fused"))
    result["fused_profiled"] = {"fwd_kernels": fwd_rows, "bwd_kernels": bwd_rows,
                                "kernels": kernel_rows, "epochs": epochs,
                                "launches": list(launches)}
    _check_tools_launches("fused profiled epoch", (fwd_rows, bwd_rows), epochs[1]["launches"])
    _check_tools_launches("fused epoch 1", epochs[1]["launches"], (layers * steps,) * 2)
    return launches


def tools(card, workdir, device="cuda"):
    """Phase 12 on phase 6's data, in a process of its own (:func:`_tools`
    as the one rank of ``parallel.launch.run_ranks``), as a user's run
    profiles its epoch: in this process, which profiled dozens of times in
    phases 3–11, a session's trace lost the first kernels of the epoch
    (12–36 of them in sessions 4–10 minutes after the first, on an H100;
    a process's first minutes lost none). Returns the launches by path."""
    from dr4sr_tpu_torch.parallel.launch import run_ranks

    store = tempfile.mktemp(prefix="store_tools_", dir=workdir)
    (launches,) = run_ranks(_tools_rank, 1, store, card, workdir, device, device_type=device,
                            timeout_s=TOOLS_TIMEOUT_S)
    return launches


def _tools_rank(rank, card, workdir, device):
    return _tools(card, workdir, device)


def _tools(card, workdir, device="cuda"):
    """Phase 12's body: the dataset rebuilt by the preprocessing CLI from
    phase 6's ``seq2pat_data.npz``; ``quickstart.run`` with TensorBoard and
    a profiled epoch; ``quickstart.tune``; the checkpoint served plain and
    EP-padded; a profiled epoch of CUDA-graph replays. The ``tools`` line
    holds what each part read, also when one of them fails."""
    result = {"card": card}
    fwd, bwd = {}, {}
    base = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    cwd = os.getcwd()
    os.chdir(base)  # the runs' log files go to log/ under the working directory
    try:
        data_root = os.path.join(base, "data")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "dr4sr_tpu_torch.scripts.preprocess",
                        "--from-seq2pat",
                        os.path.join(workdir, "amazon-toys", "toy", "seq2pat_data.npz"),
                        "--out", os.path.join(data_root, "amazon-toys", "toy")],
                       cwd=REPO_DIR, check=True, capture_output=True, text=True, timeout=600)
        datasets = prepare_datasets(TRAIN_CONFIG, root=data_root)
        steps = len(datasets[0].get_loader())
        eval_batches = len(datasets[1].get_loader())
        result["rebuilt"] = {"rows": [len(d) for d in datasets], "steps_per_epoch": steps,
                             "eval_batches": eval_batches, "num_items": datasets[0].num_items,
                             "s": time.perf_counter() - t0}
        checkpoint = tools_run(base, data_root, steps, eval_batches, result, device)
        fwd["tools_run"], bwd["tools_run"] = result["run"]["launches"]
        fwd["tools_tune"], bwd["tools_tune"] = tools_tune(base, data_root, steps, eval_batches,
                                                          result, device)
        fwd["tools_serve"], bwd["tools_serve"] = tools_serve(base, data_root, checkpoint, result,
                                                             device)
        fwd["tools_fused"], bwd["tools_fused"] = tools_fused(base, data_root, steps, result,
                                                             device)
    finally:
        os.chdir(cwd)
        shutil.rmtree(base, ignore_errors=True)
        log(f"tools {json.dumps(result, default=str)}")
    return fwd, bwd


# ------------------------------------------------------------------ 13. suite

SUITE_DATASET = "amazon-toys"
SUITE_EPOCHS = 2
SUITE_TRIALS = [{"ew": 1.0, "gamma": 0.0, "variant": "both"},
                {"ew": 1.0, "gamma": 0.3, "variant": "both"},
                {"variant": "patterns"}]
SUITE_REGEN_EPOCHS = 1
# stage runs the three trials need: one mining tag and one regenerator
# tag shared by the two `both` trials, a decode for each of them, and a
# training for each trial
SUITE_STAGE_RUNS = {"stage1": 1, "stage2": 1, "stage3": 2, "train": 3}
SUITE_TIMEOUT_S = 900  # a run_suite invocation (its four jobs: 87.3 s, H100 80GB HBM3, 700 W)
SUITE_STAGES = {"dr4sr_tpu_torch.scripts.build_pretraining_dataset": "stage1",
                "dr4sr_tpu_torch.scripts.pretrain_regenerator": "stage2",
                "dr4sr_tpu_torch.scripts.hybrid_inference": "stage3",
                "dr4sr_tpu_torch.run": "train"}


def suite_jobs():
    """The evidence matrix's stage-1 jobs on amazon-toys: SASRec base and
    regen at seeds 2023 and 7."""
    from dr4sr_tpu_torch.scripts import r3_matrix

    return [j for j in r3_matrix.stage_jobs(1) if j.split(":")[1] == SUITE_DATASET]


def check_no_error_records(what, records):
    """The harness keeps a failed job as a record and goes on; the phase
    takes any such record for a failure."""
    errors = {k: r for k, r in records.items() if "metrics" not in r}
    if errors:
        raise AssertionError(f"suite {what}: error records {json.dumps(errors)[:2000]}")


def _suite_steps(root, train_file):
    """(layers, training steps an epoch, eval batches of a validation
    pass, of the test pass) of one job's config and data."""
    from dr4sr_tpu_torch.scripts.run_chunk import build_config

    cfg = build_config("SASRec", SUITE_DATASET, train_file, SUITE_EPOCHS, "")
    train_set, val_set, test_set = prepare_datasets(cfg, root=root)
    return (cfg["model"]["layer_num"], len(train_set.get_loader()), len(val_set.get_loader()),
            len(test_set.get_loader()))


def _suite_launches_want(layers, steps, val_batches, test_batches):
    """((forward, backward) launches of one job, its steps an epoch): a
    forward and a backward a layer and training step, a forward a layer
    and eval batch of each validation pass and of the test pass."""
    return ((layers * (SUITE_EPOCHS * steps + SUITE_EPOCHS * val_batches + test_batches),
             layers * SUITE_EPOCHS * steps), steps)


def _val_recalls(path, seen):
    """Validation recall@20 of the epochs appended to ``path`` after its
    first ``seen`` lines."""
    with open(path) as f:
        lines = f.readlines()
    return [json.loads(line)["recall@20"] for line in lines[seen:]], len(lines)


def suite_in_process(base, root, jobs, result, device="cuda"):
    """Step 1: the jobs through ``run_chunk.run_jobs`` in this process, the
    attention counters set to 0 before each job and read after it."""
    from dr4sr_tpu_torch.scripts import run_chunk

    random_recall = 20 / (NUM_ITEMS - 1)
    metrics_path = os.path.join(base, "saved", "SASRec", SUITE_DATASET, "metrics.jsonl")
    wants = {tf: _suite_steps(root, tf) for tf in {run_chunk.parse_job(j)[2] for j in jobs}}
    records, per_job, seen = {}, {}, 0
    gen = run_chunk.run_jobs(jobs, epochs=SUITE_EPOCHS, root=root, device=device)
    for job in jobs:
        flash_attention_fwd.launches = 0
        flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        key, record = next(gen)
        _sync(device)
        launches = _counts()
        records[key] = record
        check_no_error_records("in-process", {key: record})
        want, steps = _suite_launches_want(*wants[run_chunk.parse_job(job)[2]])
        recalls, seen = _val_recalls(metrics_path, seen)
        per_job[key] = {"launches": list(launches), "want": list(want), "steps_per_epoch": steps,
                        "run_s": time.perf_counter() - t0, "val_recall@20": recalls,
                        "test": {k: record["metrics"][k] for k in ("ndcg@20", "recall@20")},
                        "val_best": record["metrics"]["val_best"]}
        result["in_process"] = per_job
        if tuple(launches) != tuple(want):
            raise AssertionError(f"suite {key}: launches {launches}, want {want}")
        if len(recalls) != SUITE_EPOCHS or not recalls[-1] > 5 * random_recall:
            raise AssertionError(f"suite {key}: validation recall@20 {recalls} is not above "
                                 f"5 x random ({random_recall})")
    if next(gen, None) is not None:
        raise AssertionError("suite: run_jobs yielded more records than jobs")
    return records, [sum(j["launches"][i] for j in per_job.values()) for i in (0, 1)]


def start_run_suite(base, root, jobs, device="cuda"):
    """Step 2's first ``run_suite`` invocation, started beside step 1 in a
    working directory of its own (its runs' ``log/`` and ``saved/`` apart
    from the in-process jobs'); returns ``(cmd, cwd, start, process)``."""
    from dr4sr_tpu_torch.scripts._cli import cli_env, module_cmd

    cwd = os.path.join(base, "run_suite")
    os.makedirs(cwd)
    cmd = module_cmd("scripts.run_suite", "--out", os.path.join(base, "suite.json"),
                     "--epochs", str(SUITE_EPOCHS), "--root", root,
                     *(["--cpu"] if device == "cpu" else []), "--jobs", *jobs)
    return cmd, cwd, time.perf_counter(), subprocess.Popen(
        cmd, cwd=cwd, env=cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def suite_subprocess(started, jobs, in_process, result):
    """Step 2: the same jobs through ``run_suite``'s subprocess route (a
    ``python -m dr4sr_tpu_torch.run`` process each, on the card; the
    invocation ``started`` by :func:`start_run_suite`), their metrics
    against the in-process run's, bit for bit; then a second invocation on
    the same file, which must run no job."""
    from dr4sr_tpu_torch.scripts._cli import cli_env

    cmd, cwd, t0, proc = started
    out = cmd[cmd.index("--out") + 1]
    runs = []
    for _ in range(2):
        if runs:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=cwd, env=cli_env(), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        stdout, stderr = proc.communicate(timeout=SUITE_TIMEOUT_S)
        runs.append({"rc": proc.returncode, "s": time.perf_counter() - t0,
                     "ran": sum(line.startswith("=== ") for line in stdout.splitlines()),
                     "skipped": sum(line.startswith("skip ") for line in stdout.splitlines())})
        result["subprocess"] = {"runs": runs}
        if proc.returncode != 0:
            raise AssertionError(f"suite run_suite rc {proc.returncode}: "
                                 f"{(stdout + stderr)[-3000:]}")
        with open(out) as f:
            records = json.load(f)
        if len(runs) == 1:
            first = records
    check_no_error_records("run_suite", first)
    diffs = {}
    for key, record in in_process.items():
        got, want = first[key]["metrics"], record["metrics"]
        diffs[key] = max(abs(got[k] - want[k]) for k in want) if set(got) == set(want) else None
    result["subprocess"].update(max_abs_diff=diffs, records=len(first))
    if set(first) != set(in_process) or any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"suite: run_suite's metrics are not the in-process run's: {diffs}")
    if runs[1]["ran"] != 0 or runs[1]["skipped"] != len(jobs) or records != first:
        raise AssertionError(f"suite: the resume ran jobs or changed the file: {runs[1]}")
    return first


def _stage_of(cmd):
    return SUITE_STAGES[cmd[2]]


def check_sweep_reads(calls, preexisting):
    """Every stage-3 call decodes with a checkpoint that a stage-2 call of
    this sweep wrote, into a decode cache that was not there before it."""
    def flag(cmd, name):
        return cmd[cmd.index(name) + 1]

    written = {flag(c, "--output_name") for s, c in calls if s == "stage2"}
    for stage, cmd in calls:
        if stage != "stage3":
            continue
        ckpt, cache = flag(cmd, "--ckpt_name"), os.path.basename(flag(cmd, "--regen_cache"))
        if ckpt not in written or cache in preexisting:
            raise AssertionError(f"suite sweep: a stage 3 read {ckpt} (this sweep's stage 2 "
                                 f"wrote {sorted(written)}) and the decode cache {cache} "
                                 f"({'there before' if cache in preexisting else 'new'})")


@contextlib.contextmanager
def _counted_stages(calls, run=None):
    """``regen_sweep.run_stage`` wrapped: each call's stage and command in
    ``calls``; ``run`` replaces the stage's run when given."""
    from dr4sr_tpu_torch.scripts import regen_sweep

    original = regen_sweep.run_stage

    def counted(logfile, total, cmd):
        calls.append((_stage_of(cmd), cmd))
        return (run or original)(logfile, total, cmd)

    regen_sweep.run_stage = counted
    try:
        yield
    finally:
        regen_sweep.run_stage = original


def suite_sweep(base, root, result, device="cuda"):
    """Step 3: ``regen_sweep`` of three trials on the same domain, its
    stages counted: stage 1 and stage 2 once (shared by the two `both`
    trials), stage 3 twice, a training a trial."""
    from dr4sr_tpu_torch.scripts import regen_sweep
    from dr4sr_tpu_torch.scripts._cli import dataset_domain

    domain_dir = os.path.join(root, SUITE_DATASET, dataset_domain(SUITE_DATASET))
    preexisting = set(os.listdir(domain_dir))
    calls = []
    t0 = time.perf_counter()
    with _counted_stages(calls):
        records = regen_sweep.main(["--dataset", SUITE_DATASET, "--root", root,
                                    "--out", os.path.join(base, "sweep.json"),
                                    "--regen_epochs", str(SUITE_REGEN_EPOCHS),
                                    "--extra_set", f"train.epochs={SUITE_EPOCHS}",
                                    # its trainings' metrics.jsonl apart from step 1's
                                    "--extra_set",
                                    f"eval.save_path={os.path.join(base, 'sweep_saved')}",
                                    "--trials_json", json.dumps(SUITE_TRIALS),
                                    *(["--cpu"] if device == "cpu" else [])])
    runs = {s: sum(stage == s for stage, _ in calls) for s in SUITE_STAGE_RUNS}
    random_recall = 20 / (NUM_ITEMS - 1)
    result["sweep"] = {"s": time.perf_counter() - t0, "stage_runs": runs,
                       "trials": {k: {"test": {m: r["metrics"][m] for m in ("ndcg@20", "recall@20")},
                                      "val_best": r["metrics"]["val_best"], "wall_s": r["wall_s"]}
                                  if "metrics" in r else r for k, r in records.items()}}
    check_no_error_records("sweep", records)
    if runs != SUITE_STAGE_RUNS or len(records) != len(SUITE_TRIALS):
        raise AssertionError(f"suite sweep: stage runs {runs}, want {SUITE_STAGE_RUNS}")
    check_sweep_reads(calls, preexisting)
    for name, record in records.items():
        if not record["metrics"]["recall@20"] > 5 * random_recall:
            raise AssertionError(f"suite sweep {name}: test recall@20 "
                                 f"{record['metrics']['recall@20']} is not above 5 x random")


def suite_summary(base, results, result):
    """Step 4: ``summarize_r3`` on run_suite's file: its DR4SR row for the
    dataset against the paired Δ and wins computed here from the records."""
    from dr4sr_tpu_torch.scripts import summarize_r3
    from dr4sr_tpu_torch.scripts.r3_matrix import REGEN_FILE
    from dr4sr_tpu_torch.scripts.run_chunk import job_key

    deltas = []
    for seed in (2023, 7):
        base_ndcg, regen_ndcg = (
            results[job_key("SASRec", SUITE_DATASET, tf, f"train.seed={seed}")]["metrics"]["ndcg@20"]
            for tf in ("", REGEN_FILE[SUITE_DATASET]))
        deltas.append(regen_ndcg - base_ndcg)
    mean, wins = sum(deltas) / len(deltas), sum(d > 0 for d in deltas)
    out = os.path.join(base, "summary.md")
    lines = summarize_r3.main(["--results", os.path.join(base, "suite.json"), "--out", out])
    row = summarize_r3.dr4sr_rows(results)[SUITE_DATASET]
    mean_row = [line for line in lines if line.startswith(f"| {SUITE_DATASET} | **mean** |")]
    result["summary"] = {"deltas": deltas, "mean": mean, "wins": wins,
                         "summary_mean": row.get("mean"), "summary_wins": row["wins"],
                         "ci_half": row.get("half"), "mean_row": mean_row}
    with open(out) as f:
        written = f.read()
    if (row["deltas"] != deltas or row["mean"] != mean or row["wins"] != wins
            or mean_row != [f"| {SUITE_DATASET} | **mean** |  |  | **{mean:+.4f}** "
                            f"(95% CI ±{row['half']:.4f} → "
                            f"{'excludes' if abs(mean) > row['half'] else 'includes'} 0) |"]
            or written != "\n".join(lines) + "\n"):
        raise AssertionError(f"suite summary: {result['summary']}")


def suite(card, workdir, device="cuda"):
    """Phase 13 on phase 6's data: the experiment harness on the card. Step
    2's first ``run_suite`` and step 3's sweep (processes of their own,
    which this process only waits on) run beside step 1's in-process jobs,
    whose launches only this process counts. The ``suite`` line holds what
    each step read, also when one of them fails. Returns the in-process
    jobs' launches as ``suite_chunk``."""
    import logging

    result = {"card": card}
    base = tempfile.mkdtemp(prefix="chip_smoke_suite_")
    cwd = os.getcwd()
    os.chdir(base)  # the runs' log/ and saved/ go under the working directory
    started = None
    try:
        jobs = suite_jobs()
        result["jobs"] = jobs
        started = start_run_suite(base, workdir, jobs, device)
        with ThreadPoolExecutor(1) as pool:  # leaving it waits for the sweep
            sweep = pool.submit(suite_sweep, base, workdir, result, device)
            records, (fwd, bwd) = suite_in_process(base, workdir, jobs, result, device)
            results = suite_subprocess(started, jobs, records, result)
            sweep.result()
        suite_summary(base, results, result)
    finally:
        if started is not None and started[3].poll() is None:
            started[3].kill()
            started[3].wait()
        os.chdir(cwd)
        logger = logging.getLogger("dr4sr_tpu_torch")
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        shutil.rmtree(base, ignore_errors=True)
        log(f"suite {json.dumps(result, default=str)}")
    return {"suite_chunk": fwd}, {"suite_chunk": bwd}


def suite_controls(workdir, device="cuda"):
    """``path: suite``: a job whose ``--set`` names an unknown model, in
    process and through ``run_suite``, must leave an error record that the
    phase refuses; and a sweep whose stage-2 cache holds a JAX checkpoint
    under the JAX sweep's name for the tag (the committed artifact is that
    checkpoint): the port's names must not take it, and with the JAX names
    patched in the phase's check must catch the sweep reading it."""
    from dr4sr_tpu_torch.scripts import regen_sweep, run_chunk
    from dr4sr_tpu_torch.scripts._cli import cli_env, dataset_domain, module_cmd

    base = tempfile.mkdtemp(prefix="chip_smoke_suite_controls_")
    try:
        job = f"SASRec:{SUITE_DATASET}::model.model=NoSuchModel"
        records = dict(run_chunk.run_jobs([job], epochs=1, root=workdir, device=device))
        out = os.path.join(base, "suite.json")
        subprocess.run(module_cmd("scripts.run_suite", "--out", out, "--epochs", "1",
                                  "--root", workdir, *(["--cpu"] if device == "cpu" else []),
                                  "--jobs", job),
                       cwd=base, env=cli_env(), capture_output=True, text=True,
                       timeout=SUITE_TIMEOUT_S, check=True)
        with open(out) as f:
            records_sub = json.load(f)
        caught = []
        for recs in (records, records_sub):
            try:
                check_no_error_records("control", recs)
                caught.append(False)
            except AssertionError:
                caught.append(True)
        log(f"control {json.dumps({'path': 'suite', 'fault': 'unknown_model', 'caught': all(caught), 'in_process': records, 'run_suite': records_sub}, default=str)[:3000]}")

        # the sweep with its stages recorded, not run (stage 2 reports success
        # and writes nothing); stage 1's files are placeholders, and the JAX
        # sweep's checkpoint and decode cache for the trial's tags are there
        domain_dir = os.path.join(workdir, SUITE_DATASET, dataset_domain(SUITE_DATASET))
        trial = SUITE_TRIALS[0]
        tag1, tag2, tag3 = regen_sweep.stage_tags(trial)
        for name in (f"patterns_{tag1}.npz", f"pairs_{tag1}.pkl", f"regen_{tag3}.pkl"):
            open(os.path.join(domain_dir, name), "wb").close()
        shutil.copyfile(ARTIFACT, os.path.join(domain_dir, f"regenerator_{tag2}.msgpack"))
        preexisting = set(os.listdir(domain_dir))
        jax_names = {"regenerator_name": lambda tag: f"regenerator_{tag}.msgpack",
                     "decode_cache_name": lambda tag: f"regen_{tag}.pkl"}
        outcome = {}
        for fault in (None, "jax_names"):
            calls = []
            saved = {k: getattr(regen_sweep, k) for k in jax_names}
            if fault:
                for k, fn in jax_names.items():
                    setattr(regen_sweep, k, fn)
            try:
                with _counted_stages(calls, run=lambda logfile, total, cmd: (
                        (0, "") if _stage_of(cmd) == "stage2" else (1, "not run"))):
                    regen_sweep.main(["--dataset", SUITE_DATASET, "--root", workdir,
                                      "--out", os.path.join(base, f"sweep_{fault}.json"),
                                      "--trials_json", json.dumps([trial])])
                check_sweep_reads(calls, preexisting)
                outcome[fault] = {"caught": False}
            except AssertionError as e:
                outcome[fault] = {"caught": True, "error": str(e)[:500]}
            finally:
                for k, fn in saved.items():
                    setattr(regen_sweep, k, fn)
            outcome[fault]["stages"] = [stage for stage, _ in calls]
        caught = not outcome[None]["caught"] and outcome["jax_names"]["caught"]
        log(f"control {json.dumps({'path': 'suite', 'fault': 'jax_checkpoint_preseeded', 'caught': caught, 'unfaulted': outcome[None], 'jax_names': outcome['jax_names']})}")
    finally:
        shutil.rmtree(base, ignore_errors=True)


class _SummingAllReduce(torch.autograd.Function):
    """An all-reduce whose backward sums the cotangent over the axis too, as
    ``torch.distributed.nn.all_reduce``'s does."""

    @staticmethod
    def forward(ctx, x, axis):
        from dr4sr_tpu_torch.parallel.collectives import all_reduce_

        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        from dr4sr_tpu_torch.parallel.collectives import all_reduce_

        return all_reduce_(grad.clone(), ctx.axis), None


def _ep_backward_sums():
    """EP's gathers through :class:`_SummingAllReduce`."""
    from dr4sr_tpu_torch.parallel import ep

    ep.all_reduce_sum = _SummingAllReduce.apply


def _ring_skips_last_send():
    """The ring's backward without its last send: dK and dV stay one rank off."""
    from dr4sr_tpu_torch.ops import ring_attention

    real = ring_attention.ring_exchange
    ring_attention.ring_exchange = lambda ts, axis: ([t.clone() for t in ts] if len(ts) == 2
                                                    else real(ts, axis))


def _bce_per_rank_denominator():
    """BCE and BPR divide by this rank's count, not the global batch's."""
    from dr4sr_tpu_torch.modules import losses

    local = losses.global_count
    losses.global_count = lambda mask_f, axis: local(mask_f, None)


# phase 11's faults (name -> a function that patches it into a rank, called
# by ``dist_train_rank``), and the run whose check must catch each
DIST_FAULTS = {"ep_backward_sums": _ep_backward_sums,
               "ring_skips_last_send": _ring_skips_last_send,
               "bce_per_rank_denominator": _bce_per_rank_denominator,
               "views_gather_seq": _views_gather_seq,
               "hvps_unreduced": _hvps_unreduced}
DIST_CONTROLS = {"ep_backward_sums": "ep", "ring_skips_last_send": "cp",
                 "bce_per_rank_denominator": "dp"}
# the faults of dist_more's runs, and the run whose check must catch each
DIST_MORE_CONTROLS = {"views_gather_seq": "dp_cl4srec", "hvps_unreduced": "dp_meta"}


def dist_controls(workdir, device="cuda"):
    """``--controls``, path ``dist``: each of DIST_FAULTS patched into the
    ranks of its run, whose check against one rank must fail."""
    if device == "cuda":
        _build.build_all()  # before any rank starts
    datasets = _datasets(workdir)
    ref = _dist_reference(workdir, datasets, device)
    for fault, run in DIST_CONTROLS.items():
        data, model, *_rest = DIST_RUNS[run]
        outs = _spawn(dist_train_rank, data * model, workdir, device, workdir, run, ref, fault)
        try:
            check_dist_run(run, outs, ref)
            caught, why = False, None
        except AssertionError as e:
            caught, why = True, str(e)[:200]
        log(f"control {json.dumps({'path': 'dist', 'fault': fault, 'run': run,
                                   'caught': caught, 'why': why})}")
    for fault, run in DIST_MORE_CONTROLS.items():
        result = {}
        try:
            dist_more(workdir, datasets, result, {}, {}, device, fault=fault, only=(run,))
            caught, why = False, None
        except AssertionError as e:
            caught, why = True, str(e)[:300]
        log(f"control {json.dumps({'path': 'dist', 'fault': fault, 'run': run,
                                   'caught': caught, 'why': why})}")


# deliberate faults in the backward route, each of which the card-vs-CPU
# check should catch: the key-padding mask dropped, the causal mask dropped,
# and the row log-sum-exp off by 1e-3 (every p scaled by e^-0.001)
FAULTS = {
    "no_key_padding_mask": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal, scale=None: bwd(
            q, k, v, o, do, lse, None, causal, scale=scale)),
    "not_causal": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal, scale=None: bwd(
            q, k, v, o, do, lse, mask, False, scale=scale)),
    "lse_plus_1e-3": lambda bwd: (
        lambda q, k, v, o, do, lse, mask, causal, scale=None: bwd(
            q, k, v, o, do, lse + 1e-3, mask, causal, scale=scale)),
}


def _generator_unregistered():
    """Fault: the trainer's generator is not registered with the graphs."""
    keep = torch.cuda.CUDAGraph.register_generator_state
    torch.cuda.CUDAGraph.register_generator_state = lambda self, generator: None
    return lambda: setattr(torch.cuda.CUDAGraph, "register_generator_state", keep)


def _batches_not_copied():
    """Fault: after the first group, a group's batches are not copied into
    the graph's inputs (it replays on the previous group's rows)."""
    keep = StepGraphs._copy_in

    def first_only(self, stacked):
        if self._copied is None:
            keep(self, stacked)

    StepGraphs._copy_in = first_only
    return lambda: setattr(StepGraphs, "_copy_in", keep)


def _pick_frozen_at_capture():
    """Fault: a captured step's ``item_random`` pick is a constant the host
    computed at capture (eager steps keep their device pick)."""
    from dr4sr_tpu_torch.modules import augmentation

    keep, host = augmentation.random_draws, int(np.random.default_rng(0).integers(3))

    def frozen(*args, **kwargs):
        draws = keep(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            draws["pick"] = torch.full_like(draws["pick"], host)
        return draws

    augmentation.random_draws = frozen
    return lambda: setattr(augmentation, "random_draws", keep)


def _remat_fresh_draws():
    """Fault: remat's recompute draws fresh dropout masks, not the kept ones."""
    from dr4sr_tpu_torch.modules import layers

    keep = layers._KeptDropout.__call__

    def fresh(self, t):
        if self.replay and self.training and self.p > 0:
            return F.dropout(t, self.p, True)
        return keep(self, t)

    layers._KeptDropout.__call__ = fresh
    return lambda: setattr(layers._KeptDropout, "__call__", keep)


FUSED_FAULTS = {"generator_unregistered": _generator_unregistered,
                "batches_not_copied": _batches_not_copied}
# faults of phase 10's other checks: (the fault, the check that must catch it)
FUSED_MORE_CONTROLS = {"pick_frozen_at_capture": (_pick_frozen_at_capture, fused_picks),
                       "remat_fresh_draws": (_remat_fresh_draws, fused_remat)}


def fused_controls(datasets, workdir):
    """``path: fused``: SASRec's graph-against-eager check at N = 16,
    unfaulted and with each of ``FUSED_FAULTS``, then each of
    ``FUSED_MORE_CONTROLS`` against its check (CL4SRec's picks over many
    replays; SASRec with remat against without); a fault is caught when
    the check fails or the capture raises."""
    runs = [(fault, FUSED_FAULTS.get(fault), None) for fault in (None, *FUSED_FAULTS)]
    runs += [(fault, patch, check) for fault, (patch, check) in FUSED_MORE_CONTROLS.items()]
    for fault, patch, check in runs:
        undo = patch() if patch else (lambda: None)
        try:
            if check is None:
                trainer = Trainer(_fused_cfg(workdir, "SASRec"), datasets, workdir=workdir,
                                  device="cuda")
                trainer.init_state()
                parity = fused_vs_eager(trainer)
                check_fused_vs_eager("SASRec", parity)
            else:
                parity = {}
                check(workdir, parity)
            caught = False
        except (AssertionError, RuntimeError) as e:
            caught, parity = True, {"error": f"{type(e).__name__}: {e}"[:2000]}
        finally:
            undo()
        log(f"control {json.dumps({'path': 'fused', 'fault': fault, 'caught': caught, **parity})}")


def controls() -> int:
    """``--controls``: the card-vs-CPU checks of SASRec, of the
    regenerator, of CL4SRec and of the bilevel trainer's weighted SASRec
    step with each of ``FAULTS`` patched into ``FlashAttention.backward``'s
    call of the backward kernels. On the regenerator's path the key-padding
    mask matters (left-aligned sources under non-causal cross-attention), so
    there all three must be caught. CL4SRec's views and the weighted step's
    rows are right-padded and causal as SASRec's rows are, so a dropped
    key-padding mask may be invisible there too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_controls_") as workdir:
        datasets = _datasets(workdir)
        pairs = mine(markov_sequences(num_users=NUM_USERS, num_items=NUM_ITEMS, seed=0))[1]
        for path, run in (("sasrec", lambda: card_vs_cpu(datasets, workdir)),
                          ("regen", lambda: regen_card_vs_cpu(pairs)),
                          ("cl4srec", lambda: zoo_card_vs_cpu("CL4SRec", workdir)),
                          ("meta", lambda: meta_card_vs_cpu("SASRec", workdir, outer=False))):
            log(f"control {json.dumps({'path': path, 'fault': None, **run()})}")
            for name, fault in FAULTS.items():
                # the wrapper adds to ``attention.flash_attention_bwd.launches``: the fault's
                attention.flash_attention_bwd = fault(flash_attention_bwd)
                attention.flash_attention_bwd.launches = 0
                try:
                    parity = run()
                finally:
                    attention.flash_attention_bwd = flash_attention_bwd
                try:
                    check_card_vs_cpu(parity)
                    caught = False
                except AssertionError:
                    caught = True
                log(f"control {json.dumps({'path': path, 'fault': name, 'caught': caught, **parity})}")
        fused_controls(datasets, workdir)
        dist_controls(workdir)
        suite_controls(workdir)
    return 0


# kernels that do no products, by library: the backward's f32 pre-pass
# (rowsum(dO ⊙ o), and dq zeroed for the atomics)
NO_PRODUCTS = {"flash_attention_bwd": {"flash_bwd_prep_kernel"}}


def hmma_counts(name):
    """Tensor-core instructions (``HMMA``) in the kernel library ``name``'s
    machine code: {kernel: {instantiation: count}}, an instantiation named
    by its template arguments: ``<dtype>`` if it has a type argument, then
    ``dh<Dh>`` and ``mode<m>`` for its integer ones, joined by ``_``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path(name)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cell = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # the kernel's own length-prefixed name, after the namespace's
            m = re.search(r"\d(flash_\w+?_kernel)I(f|13__nv_bfloat16)?((?:Li\d+E)*)", line)
            cell = None
            if m is not None:
                parts = [{"f": "f32", "13__nv_bfloat16": "bf16"}[m.group(2)]] if m.group(2) else []
                args = re.findall(r"Li(\d+)E", m.group(3))
                parts += [f"{tag}{a}" for tag, a in zip(("dh", "mode"), args)]
                inst = "_".join(parts)
                cell = counts.setdefault(m.group(1), {})
                cell[inst] = 0
        elif cell is not None and "HMMA" in line:
            cell[inst] += 1
    return counts


def check_tensor_cores(name, counts):
    """Every instantiation of every kernel of the library that does products
    holds HMMA, and together they cover both dtypes and every head dim, and
    MLA's wide q·kᵀ head dims in bf16."""
    want = {f"{d}_dh{dh}" for d in ("bf16", "f32") for dh in attention.HEAD_DIMS}
    want |= {f"bf16_dh{dqk}" for dqk, _ in attention.WIDE_QK_HEAD_DIMS}
    if not NO_PRODUCTS.get(name, set()) <= set(counts):
        raise AssertionError(f"{name}: no kernel {NO_PRODUCTS[name]} in the machine code")
    products = {k: c for k, c in counts.items() if k not in NO_PRODUCTS.get(name, ())}
    covered = {re.sub(r"_mode\d+$", "", i) for insts in products.values() for i in insts}
    if covered != want or not all(all(insts.values()) for insts in products.values()):
        raise AssertionError(f"{name}: not on tensor cores in every instantiation of every "
                             f"kernel that does products: HMMA counts {products}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--controls"]:
        return controls()
    if sys.argv[1:2] == ["--nccl"] and sys.argv[2:] in ([], ["--controls"]):
        return nccl(controls=sys.argv[2:] == ["--controls"])

    # 1. device
    start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build {time.perf_counter() - t0:.1f}s: {sorted(paths)}")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    hmma = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        hmma[name] = hmma_counts(name)
        log(f"sass HMMA in {name}: {json.dumps(hmma[name])}")
        check_tensor_cores(name, hmma[name])

    # 3. kernels vs plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd_cases = [check_attention(i, *c) for i, c in enumerate(ATTENTION_CASES + FWD_ONLY_CASES)]
    bwd_cases = [check_attention_bwd(i, *c) for i, c in enumerate(ATTENTION_CASES)]
    log(f"elapsed after phase 3: {time.perf_counter() - start:.1f}s")

    # 4. serve through the kernels
    hist = markov_sequences(num_users=3000, num_items=NUM_ITEMS, min_len=1, max_len=80, seed=0)
    hist[0] = []  # one empty history
    requests = [hist[0:1000], hist[1000:2000], hist[2000:3000]]  # 1000 = 3·256 + 232
    serve_launches, serve_bwd_launches = serve(requests, card)
    log(f"elapsed after phase 4: {time.perf_counter() - start:.1f}s")

    # 5. train through the kernels
    train_fwd_launches, train_bwd_launches = train(card)
    log(f"elapsed after phase 5: {time.perf_counter() - start:.1f}s")

    # 6. the regeneration pipeline through the kernels, then 7. the model zoo
    # on the same data and the assembled train_regen, and 8. the graph and
    # intent models on the same data
    with tempfile.TemporaryDirectory(prefix="chip_smoke_regen_") as workdir:
        regen_fwd_launches, regen_bwd_launches = regen(card, workdir)
        log(f"elapsed after phase 6: {time.perf_counter() - start:.1f}s")
        zoo_fwd_launches, zoo_bwd_launches = zoo(card, workdir)
        log(f"elapsed after phase 7: {time.perf_counter() - start:.1f}s")
        graph_fwd_launches, graph_bwd_launches = graph(card, workdir)
        log(f"elapsed after phase 8: {time.perf_counter() - start:.1f}s")
        meta_fwd_launches, meta_bwd_launches = meta(card, workdir)
        log(f"elapsed after phase 9: {time.perf_counter() - start:.1f}s")
        fused_fwd_launches, fused_bwd_launches = fused(card, workdir)
        log(f"elapsed after phase 10: {time.perf_counter() - start:.1f}s")
        dist_fwd_launches, dist_bwd_launches = dist(card, workdir)
        log(f"elapsed after phase 11: {time.perf_counter() - start:.1f}s")
        tools_fwd_launches, tools_bwd_launches = tools(card, workdir)
        log(f"elapsed after phase 12: {time.perf_counter() - start:.1f}s")
        suite_fwd_launches, suite_bwd_launches = suite(card, workdir)
        log(f"elapsed after phase 13: {time.perf_counter() - start:.1f}s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dr4sr_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "dr4sr_tpu/ops/attention.py:66",
        "launches": train_fwd_launches,
        "launches_by_path": {"serve": serve_launches, "train": train_fwd_launches,
                             **regen_fwd_launches, **zoo_fwd_launches,
                             **graph_fwd_launches, **meta_fwd_launches,
                             **fused_fwd_launches, **dist_fwd_launches,
                             **tools_fwd_launches, **suite_fwd_launches},
        **{key: fwd_cases[0][key] for key in keys},
        "sass_hmma": hmma["flash_attention_fwd"],
        "cases": fwd_cases,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "dr4sr_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "dr4sr_tpu/ops/attention.py:206",
        "launches": train_bwd_launches,
        "launches_by_path": {"serve": serve_bwd_launches, "train": train_bwd_launches,
                             **regen_bwd_launches, **zoo_bwd_launches,
                             **graph_bwd_launches, **meta_bwd_launches,
                             **fused_bwd_launches, **dist_bwd_launches,
                             **tools_bwd_launches, **suite_bwd_launches},
        **{key: bwd_cases[0][key] for key in keys},
        "sass_hmma": hmma["flash_attention_bwd"],
        "cases": bwd_cases,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
