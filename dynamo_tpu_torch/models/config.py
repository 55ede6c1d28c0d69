"""Model architecture config, loaded from HF-format config.json (own copy
of the reference dataclass, kept field-for-field identical)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelConfig:
    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: int | list[int] = 2
    # qwen2-family: bias on q/k/v projections
    attention_bias: bool = False
    # mistral-family: attend only to the last `sliding_window` positions
    sliding_window: Optional[int] = None
    # mlp activation: "silu" (llama et al) or "gelu" (gemma)
    hidden_act: str = "silu"
    # gemma-family: x *= sqrt(hidden_size) after embedding lookup, and
    # rmsnorm weights are stored as (w - 1) so the norm multiplies (1+w)
    scale_embeddings: bool = False
    norm_bias_one: bool = False
    # MoE (Mixtral-style)
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # multimodal (filled for vision-language models)
    vision_config: Optional[dict] = None
    # token id the processor substitutes per image patch slot (LLaVA's
    # image_token_index); None = resolve via the tokenizer
    image_token_index: Optional[int] = None

    def __post_init__(self) -> None:
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    @property
    def eos_token_ids(self) -> list[int]:
        e = self.eos_token_id
        return list(e) if isinstance(e, list) else [e]

    @classmethod
    def from_dir(cls, path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "ModelConfig":
        # VLM configs (LLaVA layout) nest the language model under
        # text_config; hoist it and keep the vision_config alongside
        # (reference: examples/multimodal serves such checkpoints)
        if "text_config" in raw:
            merged = dict(raw["text_config"])
            if raw.get("vision_config") is not None:
                merged["vision_config"] = raw["vision_config"]
            if "image_token_index" in raw:
                merged["image_token_index"] = raw["image_token_index"]
            structural = {
                "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
            }
            missing = structural - set(merged)
            if missing:
                # real llava-hf text_configs are often sparse and lean
                # on transformers' LlamaConfig (7B) defaults — which
                # this dataclass happens to share. Weight loading
                # validates every shape, so a wrong guess fails loudly
                # there; random-weight runs would not, hence the warning.
                import logging

                logging.getLogger("dynamo_tpu_torch.models").warning(
                    "text_config omits %s; assuming Llama-7B-shaped "
                    "defaults (weight loading validates shapes)",
                    sorted(missing),
                )
            raw = merged
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        kwargs = {k: v for k, v in raw.items() if k in known}
        # qwen2 checkpoints always use qkv bias but don't say so in config
        if raw.get("model_type") == "qwen2" and "attention_bias" not in raw:
            kwargs["attention_bias"] = True
        # normalize HF gelu variants onto the one gelu we implement
        if kwargs.get("hidden_act") in ("gelu_pytorch_tanh", "gelu_new"):
            kwargs["hidden_act"] = "gelu"
        # gemma semantics are implied by the model_type, not config keys
        if raw.get("model_type") == "gemma":
            kwargs["scale_embeddings"] = True
            kwargs["norm_bias_one"] = True
            kwargs.setdefault("hidden_act", "gelu")
            kwargs.setdefault("tie_word_embeddings", True)
        # qwen2 configs carry sliding_window but HF defaults
        # use_sliding_window to FALSE: the window only applies when the
        # flag is explicitly true (mistral-family configs have no such
        # flag and the window always applies)
        if raw.get("model_type") == "qwen2" and not raw.get("use_sliding_window", False):
            kwargs["sliding_window"] = None
        elif raw.get("use_sliding_window") is False:
            kwargs["sliding_window"] = None
        return cls(**kwargs)
