"""Model configuration covering all six assigned architecture families.

One frozen dataclass describes every architecture this framework can build:
dense decoder-only, MoE (top-k routed, optional shared experts, optional MLA),
attention-free SSM (RWKV-6), recurrent/attention hybrid (RecurrentGemma),
audio encoder-decoder backbone (Whisper decoder; encoder stubbed), and VLM
backbone (Qwen2-VL; vision tower stubbed).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "audio" | "vlm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0          # 0 for attention-free families (rwkv)
    num_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // num_heads
    window: int = 0             # 0 = full attention; >0 = sliding window
    qk_norm: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # expert intermediate size; 0 -> d_ff
    router_score: str = "softmax"   # "softmax" | "sigmoid" (DeepSeek-V3/Kimi)

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- positional encoding ---
    rope_variant: str = "standard"  # "standard" | "2d" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w split of head_dim//2

    # --- hybrid (RecurrentGemma / Griffin) ---
    layer_pattern: str = ""     # e.g. "RRA" repeated; "" = uniform family block
    d_rnn: int = 0              # RG-LRU recurrence width; 0 -> d_model
    local_window: int = 2048    # window of the hybrid's local-attention layers
    conv1d_width: int = 4

    # --- SSM (RWKV-6) ---
    rwkv_head_size: int = 64

    # --- encoder-decoder (Whisper) ---
    is_encoder_decoder: bool = False
    encoder_len: int = 1500     # stub: precomputed mel/conv frames
    encoder_d_model: int = 0    # 0 -> d_model

    # --- VLM (Qwen2-VL) ---
    vision_stub: bool = False
    vision_d_model: int = 0     # dim of precomputed patch embeddings (0 -> d_model)

    # --- misc ---
    norm: str = "rmsnorm"       # "rmsnorm" | "layernorm"
    activation: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # optimizer choice used by the training launcher / dry-run
    optimizer: str = "adamw"    # "adamw" | "adafactor"
    source: str = ""            # citation / model card

    # ------------------------------------------------------------------ #

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads and not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.family == "hybrid" and not self.d_rnn:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.is_encoder_decoder and not self.encoder_d_model:
            object.__setattr__(self, "encoder_d_model", self.d_model)

    # --- derived sizes ------------------------------------------------ #

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind. 'A' attention+ffn, 'R' recurrent+ffn,
        'W' rwkv (time-mix + channel-mix), 'X' attention+cross-attn+ffn."""
        if self.layer_pattern:
            pat = self.layer_pattern
            kinds = [pat[i % len(pat)] for i in range(self.num_layers)]
            return tuple(kinds)
        if self.family == "ssm":
            return tuple("W" * self.num_layers)
        if self.is_encoder_decoder:
            return tuple("X" * self.num_layers)
        return tuple("A" * self.num_layers)

    # --- parameter counting (used by the roofline / cost model) ------- #

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            q = (d * self.q_lora_rank
                 + self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                 ) if self.q_lora_rank else d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_dim)
            kv += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            return q + kv + o
        hd = self.head_dim
        return (d * self.num_heads * hd          # Q
                + 2 * d * self.num_kv_heads * hd  # K, V
                + self.num_heads * hd * d)        # O

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.activation == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _rwkv_layer_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,w,g projections + output + small lora for decay/mix
        tm = 5 * d * d + d * d + 6 * 32 * d * 2
        # channel-mix: k (d->d_ff), v (d_ff->d), r (d->d)
        cm = d * self.d_ff * 2 + d * d
        return tm + cm

    def _rglru_layer_params(self) -> int:
        d, dr = self.d_model, self.d_rnn
        # two input branches (x, gate), conv1d, rg-lru gates (a, input), out proj
        return 2 * d * dr + self.conv1d_width * dr + 2 * dr * dr // 1 + dr * d

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds():
            if kind == "W":
                n += self._rwkv_layer_params()
                continue
            if kind == "R":
                n += self._rglru_layer_params() + self._ffn_params(self.d_ff)
                continue
            n += self._attn_params()
            if kind == "X":
                n += self._attn_params()  # cross-attention
            if self.is_moe and kind == "A":
                e = self.experts_per_token if active_only else self.num_experts
                n += (e + self.num_shared_experts) * self._ffn_params(self.moe_d_ff)
                n += self.d_model * self.num_experts  # router
            else:
                n += self._ffn_params(self.d_ff)
        return n

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    # --- reduced variant for CPU smoke tests -------------------------- #

    def reduced(self) -> "ModelConfig":
        """Same family/topology, shrunk to run a step on CPU (<=2 layers,
        d_model<=256, <=4 experts)."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        head_dim = (d_model // num_heads) if num_heads else 0
        kv = min(self.num_kv_heads, num_heads) if num_heads else 0
        kv = max(kv, 1) if num_heads else 0
        # keep the GQA ratio flavor: if original had fewer kv heads, halve
        if num_heads and self.num_kv_heads < self.num_heads:
            kv = max(1, num_heads // 2)
        n_layers = min(self.num_layers, 2)
        if self.layer_pattern:
            n_layers = max(n_layers, len(self.layer_pattern))  # cover pattern
            n_layers = min(n_layers, 3)
        changes = dict(
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else 0,
            local_window=min(self.local_window, 32),
            d_rnn=min(self.d_rnn, d_model) if self.d_rnn else 0,
            rwkv_head_size=min(self.rwkv_head_size, 32),
            encoder_len=min(self.encoder_len, 16),
            encoder_d_model=d_model if self.is_encoder_decoder else 0,
            vision_d_model=d_model if self.vision_stub else 0,
            dtype="float32",
        )
        if self.is_moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff, 256),
            )
        if self.use_mla:
            changes.update(kv_lora_rank=64, q_lora_rank=64,
                           qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                           head_dim=32 + 16)
        if self.rope_variant == "mrope":
            half = (changes.get("head_dim") or head_dim) // 2
            t = half // 4
            hw = (half - t) // 2
            changes["mrope_sections"] = (half - 2 * hw, hw, hw)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------- #
# Input shape grid assigned to this paper.
# ---------------------------------------------------------------------- #

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
