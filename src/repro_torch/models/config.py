"""Model configuration (plain data), the port's copy of ``repro.models.config``.

One ``ModelConfig`` describes the transformer backbone of every family
(dense, moe, audio, vlm, hybrid, ssm); ``MoEConfig`` and ``SSMConfig``
carry the expert and state-space parts.  Modality frontends (musicgen's
EnCodec, llava's vision tower) are stubs, as in the reference: those
configs (``frontend="embed"``) take precomputed (B, S, E) embeddings.
``input_specs`` gives a step's inputs as meta tensors (shapes and dtypes,
no storage) for ``launch.dryrun``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_dff: int
    capacity_factor: float = 1.25
    # "sorted": capacity-bucket dispatch (tokens past an expert's capacity
    # are dropped); "dense": every expert on every token, weighted by the
    # gates (no drops, E/top_k x the active FLOPs)
    impl: str = "sorted"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | audio | hybrid | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    norm: str = "rms"         # rms | ln
    mlp: str = "swiglu"       # swiglu | gelu
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    frontend: str = "tokens"  # tokens | embed
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    window: int = 0           # sliding-window size; 0 = full attention
    global_every: int = 0
    vocab_pad_to: int = 1     # embedding/LM-head rows padded to a multiple
    dtype: str = "bfloat16"
    remat: str = "full"       # none | full | dots (training only)
    attn_chunk: int = 512     # q-chunk of blockwise attention
    attn_mode: str = "masked"  # masked | causal_skip
    constrain_qkv: bool = True
    kv_quant: str = "none"    # none | int8

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        p = max(self.vocab_pad_to, 1)
        return (self.vocab + p - 1) // p * p

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        E, L, V = self.d_model, self.n_layers, self.vocab
        n = V * E
        if not self.tie_embeddings:
            n += E * V
        H, KVH, D = self.n_heads, self.n_kv_heads, self.hd
        per_layer = 0
        if self.has_attention:
            per_layer += E * H * D + 2 * E * KVH * D + H * D * E
            if self.qkv_bias:
                per_layer += (H + 2 * KVH) * D
        if self.moe is not None:
            m = self.moe
            per_layer += E * m.num_experts
            per_layer += m.num_experts * (3 * E * m.expert_dff)
        elif self.d_ff:
            mults = 3 if self.mlp == "swiglu" else 2
            per_layer += mults * E * self.d_ff
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * E
            nh = d_in // s.head_dim
            per_layer += E * (2 * d_in + 2 * s.d_state + nh) + d_in * E
            per_layer += s.conv_width * (d_in + 2 * s.d_state)
            per_layer += 2 * nh
        per_layer += 2 * E
        return n + L * per_layer

    @property
    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D convention)."""
        if self.moe is None:
            return self.param_count
        m = self.moe
        L, E = self.n_layers, self.d_model
        inactive = L * (m.num_experts - m.top_k) * 3 * E * m.expert_dff
        return self.param_count - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input of a step (no
    allocation): the dry-run contract.  Modality frontends are stubs: for
    ``frontend="embed"`` configs the spec carries precomputed embeddings."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        x = (meta((B, S, cfg.d_model), dtype) if cfg.frontend == "embed"
             else meta((B, S), i32))
        if shape.kind == "train":
            return {"inputs": x, "labels": meta((B, S), i32)}
        return {"inputs": x}
    # decode: one new token id per sequence against a cache of seq_len
    # (generated tokens are always ids embedded through the token embedding)
    return {"inputs": meta((B,), i32)}
