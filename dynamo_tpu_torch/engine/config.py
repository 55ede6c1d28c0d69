"""Engine configuration: the fields of the reference ``EngineConfig`` that
the serial serving path reads, plus ``device``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class EngineConfig:
    model_path: str = ""
    # KV cache. block_size None = 16-token pages.
    block_size: Optional[int] = None
    # None = size the cache from free device memory (torch.cuda.mem_get_info)
    num_blocks: Optional[int] = None
    # share of free device memory the auto-sized cache may take
    hbm_utilization: float = 0.9
    # "bfloat16" or "int8" (per-(slot, head) f32 scales, ops/kv_quant.py)
    kv_cache_dtype: str = "bfloat16"
    enable_prefix_caching: bool = True
    # batching
    max_batch_size: int = 64
    max_prefill_tokens: int = 4096
    prefill_chunk_size: int = 1024
    max_model_len: Optional[int] = None
    # weights: random (seeded) weights are the only source in this port
    random_weights: bool = False
    # weight-only quantization: None | "int8" (models/quant.py)
    quantization: Optional[str] = None
    seed: int = 0
    # torch device the engine runs on; "cpu" runs every kernel's plain
    # version (tests), "cuda" launches the CUDA kernels
    device: str = "cuda"

    def resolve_block_size(self) -> int:
        return self.block_size if self.block_size is not None else 16
