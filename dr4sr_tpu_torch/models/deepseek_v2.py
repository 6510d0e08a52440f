"""DeepSeekV2Rec — DeepSeek-V2's decoder (MLA attention, DeepSeekMoE) as the
sequence encoder of the port's sequential recommender.

The item embedding (the scoring table, as every model of the port) feeds
``num_hidden_layers`` pre-norm decoder layers, x += MLA(RMSNorm(x)), x +=
MLP(RMSNorm(x)), the MLP a dense SwiGLU for the first
``first_k_dense_replace`` layers and a DeepSeekMoE layer after; then a final
RMSNorm and ``seq_pooling`` ('origin' when training, 'last' in eval).
There is no absolute position table: YaRN RoPE inside MLA is the position
signal, as published. No biases, no dropout. The layers are
``modules/mla.py`` and ``modules/moe.py``; the plain f32 reference, which
the tests hold it against, is ``tests/torch_deepseek_v2_reference.py``.

Departures from the published model, for the recommender: the scores are
dot products against the input table (``RecModel.item_table``), where
DeepSeek-V2 has an untied output head; no aux balance loss (the config
gives no weight for it). A MoE layer holds experts ``expert_offset`` ..
``expert_offset + n_routed_experts_held - 1`` of ``n_routed_experts`` and
computes their share of the layer (one device of an expert-parallel
deployment) and, with ``model.fold_foreign_experts``, also computes the
assignments to the other experts on the held ones, each by its index modulo
the held count (standing in for the rows the other devices send); pad
positions are routed to no expert.

``train.precision: bf16`` also makes the module run its forward under bf16
autocast on its own, so that serving (``serve.Recommender``, which has no
autocast) computes as training does. ``model.remat`` recomputes each layer
in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dr4sr_tpu_torch.models.base import item_embedding
from dr4sr_tpu_torch.models.registry import register_model
from dr4sr_tpu_torch.modules.layers import seq_pooling
from dr4sr_tpu_torch.modules.mla import MLA, RMSNorm, SwiGLU
from dr4sr_tpu_torch.modules.moe import DeepSeekMoE
from dr4sr_tpu_torch.parallel.ep import embed_lookup


class DecoderLayer(nn.Module):
    def __init__(self, m: Dict[str, Any], dense: bool,
                 generator: Optional[torch.Generator]) -> None:
        super().__init__()
        d, eps = int(m["hidden_size"]), float(m["rms_norm_eps"])
        self.attn_norm = RMSNorm(d, eps)
        self.attn = MLA(d, int(m["num_attention_heads"]), int(m["qk_nope_head_dim"]),
                        int(m["qk_rope_head_dim"]), int(m["v_head_dim"]),
                        int(m["kv_lora_rank"]), eps,
                        dict(m["rope_scaling"], theta=m["rope_theta"]), generator)
        self.mlp_norm = RMSNorm(d, eps)
        if dense:
            self.mlp = SwiGLU(d, int(m["intermediate_size"]), generator)
        else:
            self.mlp = DeepSeekMoE(
                d, int(m["n_routed_experts"]), int(m["num_experts_per_tok"]),
                int(m["moe_intermediate_size"]), int(m["n_shared_experts"]),
                int(m["n_routed_experts_held"]), int(m.get("expert_offset", 0)),
                bool(m["norm_topk_prob"]), float(m["routed_scaling_factor"]), generator,
                bool(m.get("fold_foreign_experts", False)))

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), key_padding_mask)
        h = self.mlp_norm(x)
        if isinstance(self.mlp, DeepSeekMoE):
            return x + self.mlp(h, ~key_padding_mask)
        return x + self.mlp(h)


class DeepSeekV2Encoder(nn.Module):
    def __init__(self, num_items: int, m: Dict[str, Any], compute_dtype: Optional[torch.dtype],
                 training_pooling: str = "origin", eval_pooling: str = "last",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.training_pooling, self.eval_pooling = training_pooling, eval_pooling
        self.compute_dtype = compute_dtype
        self.remat = bool(m.get("remat", False))
        self.item_embedding = item_embedding(num_items, int(m["hidden_size"]), generator)
        dense = int(m["first_k_dense_replace"])
        self.layers = nn.ModuleList(DecoderLayer(m, i < dense, generator)
                                    for i in range(int(m["num_hidden_layers"])))
        self.norm = RMSNorm(int(m["hidden_size"]), float(m["rms_norm_eps"]))

    def _autocast(self, device: torch.device):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype, cache_enabled=False)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        seq = batch["in_item_id"]
        key_padding_mask = seq == 0
        x = embed_lookup(self.item_embedding, seq)
        with self._autocast(seq.device):
            for layer in self.layers:
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, key_padding_mask, use_reentrant=False)
                else:
                    x = layer(x, key_padding_mask)
            x = self.norm(x)
        pooling = self.training_pooling if self.training else self.eval_pooling
        return seq_pooling(x, batch["seqlen"], pooling)


@register_model("DeepSeekV2Rec")
class DeepSeekV2Rec:
    """Architecture factory: builds the module from a layered config."""

    @staticmethod
    def build(config: Dict[str, Any], num_items: int,
              generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
        prec = str(config.get("train", {}).get("precision", "fp32")).lower()
        return DeepSeekV2Encoder(num_items, config["model"],
                                 torch.bfloat16 if prec.startswith("bf") else None,
                                 generator=generator, **kwargs)
