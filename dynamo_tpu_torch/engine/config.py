"""Engine configuration: the fields of the reference ``EngineConfig`` that
the serving path reads, plus ``device`` and ``cuda_graphs``."""

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
    # overlapped decode pipeline: the host plans and dispatches step N+1
    # while the device runs step N (its token column chained on the
    # device); output is bit-identical with overlap on or off. False
    # restores the serial plan -> dispatch -> sync -> emit loop.
    overlap: bool = True
    # explicit mid decode bucket (None = auto: pad/2 when the pad is >= 64;
    # 0 = no mid bucket)
    decode_batch_mid: Optional[int] = None
    # static serving shapes: pad the decode batch to one of a few buckets
    # (small, mid, max_batch_size) and the block-table width to the
    # max_model_len cap, so decode runs a fixed set of shapes
    static_shapes: bool = True
    # capture every decode shape at launch (None = auto: on for "cuda",
    # off elsewhere); off, a shape is captured at its first use
    prewarm: Optional[bool] = None
    # decode steps as CUDA graph replays, one graph per (decode shape,
    # sampling variant), forward and sample together (None = auto: on for
    # "cuda", off for "cpu"; True on the CPU raises). Off, the same step
    # runs eagerly; the two give the same tokens.
    cuda_graphs: Optional[bool] = None

    def resolve_block_size(self) -> int:
        return self.block_size if self.block_size is not None else 16

    def resolve_cuda_graphs(self) -> bool:
        on_cuda = self.device.startswith("cuda")
        if self.cuda_graphs is None:
            return on_cuda
        if self.cuda_graphs and not on_cuda:
            raise ValueError(
                f"cuda_graphs=True needs a CUDA device (device={self.device!r})"
            )
        return self.cuda_graphs

    def resolve_prewarm(self) -> bool:
        if self.prewarm is None:
            return self.device.startswith("cuda")
        return self.prewarm
