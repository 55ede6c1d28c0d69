"""Engine-facing protocol types: the port's own copy of the reference's
request/response model, field-for-field, so requests validate the same
way on both engines. Engines only ever see these types."""

from __future__ import annotations

import enum
from typing import Any, ClassVar, Optional

from pydantic import BaseModel, Field


class FinishReason(str, enum.Enum):
    STOP = "stop"            # hit a stop token / stop string
    LENGTH = "length"        # hit max_tokens / context limit
    CANCELLED = "cancelled"  # client disconnected or kill-signalled
    TIMEOUT = "timeout"      # request deadline budget expired
    ERROR = "error"
    CONTENT_FILTER = "content_filter"
    MIGRATE = "migrate"      # drain handoff marker, never client-facing


class SamplingOptions(BaseModel):
    """Sampling knobs, engine-agnostic."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    # token id -> additive logit bias (OpenAI-style)
    logit_bias: Optional[dict[int, float]] = None
    seed: Optional[int] = None
    n: int = 1
    use_greedy: bool = False

    @property
    def needs_penalties(self) -> bool:
        """True when this request needs token-count penalty sampling."""
        return bool(
            self.frequency_penalty
            or self.presence_penalty
            or (
                self.repetition_penalty is not None
                and self.repetition_penalty != 1.0
            )
        )

    # Sampling shapes the distribution on the top-TOP_K_CAP logit slice;
    # top_k above the cap is clamped at the request boundary.
    TOP_K_CAP: ClassVar[int] = 128

    def normalized(self) -> "SamplingOptions":
        """Resolve greedy mode: temperature<=0 means greedy decoding.
        Clamps top_k to TOP_K_CAP."""
        s = self.model_copy()
        if s.temperature is not None and s.temperature <= 0.0:
            s.use_greedy = True
            s.temperature = None
        if s.top_k is not None and s.top_k > self.TOP_K_CAP:
            s.top_k = self.TOP_K_CAP
        return s


class GuidedOptions(BaseModel):
    """Constrained-decoding spec (JSON schema, regex or JSON mode)."""

    kind: str  # "json_schema" | "regex" | "json_object"
    json_schema: Optional[dict[str, Any]] = None
    regex: Optional[str] = None


class StopConditions(BaseModel):
    """Stop criteria. ``stop_token_ids_hidden`` stop generation and are
    excluded from output; ``stop`` strings are matched against the
    detokenized stream."""

    max_tokens: Optional[int] = None
    stop: list[str] = Field(default_factory=list)
    stop_token_ids_hidden: list[int] = Field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def apply_ignore_eos(self) -> "StopConditions":
        if self.ignore_eos:
            s = self.model_copy()
            s.stop = []
            s.stop_token_ids_hidden = []
            return s
        return self


class OutputOptions(BaseModel):
    """What the caller wants back beyond text."""

    logprobs: Optional[int] = None
    echo: bool = False
    skip_special_tokens: bool = True


class PreprocessedRequest(BaseModel):
    """Tokenized, template-rendered request: what engines consume."""

    request_id: str
    token_ids: list[int]
    sampling: SamplingOptions = Field(default_factory=SamplingOptions)
    stop: StopConditions = Field(default_factory=StopConditions)
    output: OutputOptions = Field(default_factory=OutputOptions)
    # Routing hints
    model: Optional[str] = None
    lora_name: Optional[str] = None
    # per-request speculative-decoding opt-in/out (None = engine default)
    speculative: Optional[bool] = None
    # guided decoding constraint (None = unconstrained)
    guided: Optional[GuidedOptions] = None
    # tokens a previous worker already generated and delivered; the
    # sampling seed continues from here so a resumed stream stays the same
    resume_offset: int = 0
    migration: Optional[bool] = None
    remote_prefill: Optional[dict[str, Any]] = None
    annotations: list[str] = Field(default_factory=list)
    # multimodal embedding segments to inject over placeholder tokens
    mm_embeds: Optional[list[dict[str, Any]]] = None


class LLMEngineOutput(BaseModel):
    """One streamed engine step for one request: token id deltas,
    optional text, log probs, finish reason."""

    request_id: str = ""
    token_ids: list[int] = Field(default_factory=list)
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    log_probs: Optional[list[float]] = None
    top_logprobs: Optional[list[dict[int, float]]] = None
    index: int = 0
    finish_reason: Optional[FinishReason] = None
    # engine metrics piggybacked on the final chunk
    prompt_tokens: Optional[int] = None
    completion_tokens: Optional[int] = None

    @classmethod
    def final(cls, request_id: str, reason: FinishReason) -> "LLMEngineOutput":
        return cls(request_id=request_id, finish_reason=reason)

    @property
    def is_final(self) -> bool:
        return self.finish_reason is not None
