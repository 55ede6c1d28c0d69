#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It takes no arguments and runs every phase in order; any failure raises
and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. build: compile ``dynamo_tpu_torch/csrc/*.cu`` with nvcc, one process
   per source in parallel; print the build time, ptxas's resource lines
   and warnings, and each K1 variant's dynamic shared memory.
3. kernels: hold each CUDA kernel against its plain PyTorch version at the
   serving path's shapes (Llama-8B: D=4096, F=14336, V=128256, H=32, Hk=8,
   Dh=128), with the tolerance stated per kernel, and time kernel, plain
   version and one PyTorch library call (CUDA events, median of warm
   runs, L2 flushed before each run). K2 runs at four shapes (B=64,
   contexts 128-4096; B=8 at 8192; B=32 at 129-192; B=64 at 129-192 with
   the static serving width of 520 table entries, whose splits are
   mostly empty), each with its ``decode_plan`` printed. ``bound_ms`` is the least time the
   card could take: the larger of bytes moved over memory bandwidth and
   operations over the bf16 tensor rate, from the H100 SXM data sheet
   (any other card raises). Each K1 row also gives its launch plan,
   ``vs_library`` (kernel / library time) and ``of_bound`` (bound /
   kernel time). Attention is held within 2^-7 relative (one
   bf16 ulp of the output) plus 2^-7 x max|ref| absolute: its outputs
   average over hundreds of keys, so a fixed absolute limit would be the
   size of a typical value.
4. parity: a small model (Dh=64) through ``forward`` on the GPU (kernels)
   and on the CPU (plain versions), from the same seeded weights:
   prefill then decode, logits within tolerance and equal greedy tokens
   wherever the top-2 gap exceeds it.
5. serve: ``TorchEngine.launch`` at the full 8B geometry (random int8
   weights from the port's seeded init, int8 KV cache, max_batch_size 64)
   on the engine's default path: static decode shapes (buckets 4, 32 and
   64 at table width 520), each decode shape a CUDA graph captured at
   launch, and the overlapped decode pipeline. It answers 8 concurrent
   ``generate`` streams with prompts of 16-1500 tokens, some greedy and
   some sampled. Every stream must finish with 32 tokens, two identical
   greedy requests must agree, and the launch count of every kernel must
   have grown during this phase alone (graph replays add the launches
   their capture recorded).
6. profile: at the same 8B geometry and default path, under
   ``torch.profiler``, a steady decode batch of 32 streams (device time by
   kernel, the share of decode wall time the device was busy, the median
   decode step, and K2's device time: its split and merge kernels
   together), then a prefill-only batch of 2 streams of 2048-token
   prompts with 1 output token (device time by kernel over the prefill
   steps, and K3's share).
7. graphs: 32 greedy + 8 sampled streams (fixed seeds), 128-token
   prompts, 64 output tokens, submitted as one burst, in three fresh
   engines: (graphs off, overlap off), (graphs on, overlap off) and
   (graphs on, overlap on). The tokens must be identical in all three,
   greedy and sampled. Per mode: the decode step median (host clock),
   output tok/s, the device-busy share of wall time and the median device
   ms of a decode step, both from CUDA events around each step's device
   work (no profiler), capture seconds and the graph pool's bytes.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``{"kernels": [...]}``: one entry per kernel wrapper, its numbers at one
representative serving shape (decode batch 64; prefill's second
1024-token chunk), its launches in the serve phase, and under
``checks`` every shape checked.
"""

from __future__ import annotations

import asyncio
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): memory bytes/s, bf16 tensor FLOP/s
H100_SXM = "H100 80GB HBM3"
H100_SXM_PEAKS = (3.35e12, 989e12)

# attention tolerance: rtol, and atol as a fraction of max|ref|
ATTN_RTOL = ATTN_ATOL_FRAC = 2 ** -7

# 8B geometry (DeepSeek-R1-Distill-Llama-8B)
D, F, V, L, H, HK, DH = 4096, 14336, 128256, 32, 32, 8, 128
# the engine's static block-table width at max_position_embeddings 8192
# in 16-token pages: ceil((8192 + 1) / 16) + 1 = 514, to a multiple of 8
STATIC_WIDTH = 520
# a stuck engine fails its phase instead of running into the call's limit
PHASE_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[float, float]:
    if H100_SXM in name:
        return H100_SXM_PEAKS
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


class Bench:
    """Timing and comparison helpers on one card."""

    def __init__(self, torch, device_name: str):
        self.torch = torch
        self.bw, self.flops = card_peaks(device_name)
        # larger than the 50 MB L2: zeroed before every timed run
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(self, fn, reps: int = 10, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bound_ms(self, nbytes: float, ops: float) -> tuple[float, str]:
        tb, to = nbytes / self.bw * 1e3, ops / self.flops * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")


def compare(torch, got, ref, rtol: float, atol: float, mag=None) -> dict:
    """|got - ref| <= atol + rtol * mag elementwise; ``mag`` defaults to
    |ref| (for a sum, pass the magnitude of its operands)."""
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    err = (g - r).abs()
    mag = r.abs() if mag is None else mag
    excess = (err - (atol + rtol * mag)).max().item()
    return {
        "max_abs_err": err.max().item(),
        # relative to |ref|, floored at atol (values near zero)
        "max_rel_err": (err / r.abs().clamp_min(max(atol, 1e-30))).max().item(),
        "max_ref": r.abs().max().item(),
        "ok": excess <= 0.0,
        "rtol": rtol,
        "atol": atol,
    }


# ---------------------------------------------------------------------------
# Phase: kernels
# ---------------------------------------------------------------------------


def check_qmm(torch, bench: Bench, gen, results: dict) -> None:
    from dynamo_tpu_torch.ops import qmatmul as qm

    def rand_w(K, N):
        return torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)

    def rand_s(K, N):
        return torch.rand(N, device="cuda", generator=gen) * (2.0 / (127 * math.sqrt(K))) + 1e-5

    shapes = [  # (weights, K, N) of the serving path
        ("wq/wo", D, H * DH),
        ("wk/wv", D, HK * DH),
        ("gate/up", D, F),
        ("w_down", F, D),
    ]
    # every (K, N) in every epilogue, at decode (8, 32: the profile's
    # batch, 64) and prefill (1024) M
    cases = [(M, name, kind, K, N) for M in (8, 32, 64, 1024) for name, K, N in shapes
             for kind in ("", "residual", "gate_up")]
    cases += [(M, "lm_head", "lm_head", D, V) for M in (8, 32, 64)]
    for M, wname, kind, K, N in cases:
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        w, s = rand_w(K, N), rand_s(K, N)
        nw = 1
        if kind == "gate_up":
            w2, s2 = rand_w(K, N), rand_s(K, N)
            nw = 2
            fn = lambda: qm.qmm_gate_up(x, w, s, w2, s2)  # noqa: E731
            plain = lambda: qm.qmm_gate_up_plain(x, w, s, w2, s2)  # noqa: E731
            wcat = torch.cat([(w.float() * s).to(torch.bfloat16), (w2.float() * s2).to(torch.bfloat16)], 1)
            lib = lambda: x @ wcat  # noqa: E731
            wrapper, rtol = "qmm_gate_up", 2 ** -6
        else:
            r = torch.randn(M, N, device="cuda", generator=gen).to(torch.bfloat16) if kind == "residual" else None
            if kind == "lm_head":
                fn = lambda: qm.qmm_lm_head(x, w, s)  # noqa: E731
                wrapper = "qmm_lm_head"
            else:
                fn = lambda: qm.qmm(x, w, s, residual=r)  # noqa: E731
                wrapper = "qmm"
            plain = lambda: qm.qmm_plain(x, w, s, r)  # noqa: E731
            wdq = (w.float() * s).to(torch.bfloat16)
            lib = lambda: x @ wdq  # noqa: E731
            rtol = 2 ** -7
        out = fn()
        ref = plain()
        # residual: the final bf16 add rounds at the scale of its operands
        mag = r.float().abs() + qm.qmm_plain(x, w, s).float().abs() if kind == "residual" else None
        torch.cuda.synchronize()
        c = compare(torch, out, ref, rtol=rtol, atol=2 ** -9 * ref.float().abs().max().item(), mag=mag)
        nbytes = M * K * 2 + nw * (K * N + N * 4) + M * N * 2 + (M * N * 2 if kind == "residual" else 0)
        bound, by = bench.bound_ms(nbytes, 2.0 * M * N * K * nw)
        plan = qm.launch_plan(M, N, K, "gate_up" if kind == "gate_up" else "")
        row = {
            "wrapper": wrapper, "shape": f"{wname} {kind or 'plain'} M={M} K={K} N={N}",
            "kernel_ms": bench.time_ms(fn), "plain_ms": bench.time_ms(plain, reps=3),
            "library_ms": bench.time_ms(lib), "bound_ms": bound, "bound_by": by, **c,
            "plan": {"config": plan.config, "bn": plan.bn, "splits": plan.splits, "blocks": plan.blocks},
        }
        row["vs_library"] = row["kernel_ms"] / row["library_ms"]
        row["of_bound"] = bound / row["kernel_ms"]
        log("check " + json.dumps(row))
        results.setdefault(wrapper, []).append(row)
        if not c["ok"]:
            raise AssertionError(f"{wrapper} {row['shape']} disagrees with its plain version")
        del x, w, s, out, ref
        torch.cuda.empty_cache()


def _paged_layout(torch, np_rng, ctx_lens, bs, width=None):
    """Scrambled block tables (block 0 left as the garbage page), ``width``
    entries a row (default: the longest context's)."""
    import numpy as np

    pages = [-(-int(c) // bs) for c in ctx_lens]
    W = width or max(max(pages), 1)
    n_pages = sum(pages) + 1
    perm = np_rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((len(ctx_lens), W), np.int32)
    at = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[at:at + n]
        at += n
    return torch.from_numpy(tables).cuda(), n_pages


def _make_cache(torch, gen, n_pages, bs, layer, quantized):
    """Stacked [L, S, Hk, Dh] cache with only ``layer`` filled (the
    kernels index it in place; other layers are never read)."""
    S = n_pages * bs
    dt = torch.int8 if quantized else torch.bfloat16
    caches, scales = [], []
    for _ in range(2):
        c = torch.zeros((L, S, HK, DH), dtype=dt, device="cuda")
        if quantized:
            c[layer] = torch.randint(-127, 128, (S, HK, DH), dtype=torch.int8, device="cuda", generator=gen)
            sc = torch.ones((L, n_pages, HK, bs), device="cuda")
            sc[layer] = torch.rand((n_pages, HK, bs), device="cuda", generator=gen) * (2.0 / 127) + 1e-3
            scales.append(sc)
        else:
            c[layer] = torch.randn((S, HK, DH), device="cuda", generator=gen).to(dt)
        caches.append(c)
    if not quantized:
        scales = [None, None]
    return caches, scales


def _sdpa_inputs(torch, q4, caches, scales, tables, bs, layer, quantized):
    """Gathered, dequantized, head-expanded K/V for the library yardstick."""
    from dynamo_tpu_torch.ops.kv_quant import gather_slot_scales

    B, W = tables.shape
    slots = (tables.long()[:, :, None] * bs + torch.arange(bs, device="cuda")).reshape(B, W * bs)
    kv = []
    for c, sc in zip(caches, scales):
        g = c[layer][slots].float()
        if quantized:
            g = g * gather_slot_scales(sc[layer], slots, bs, HK)[..., None]
        kv.append(g.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(H // HK, dim=1).contiguous())
    return kv


def check_attention(torch, bench: Bench, gen, results: dict) -> None:
    import numpy as np
    import torch.nn.functional as Fn

    from dynamo_tpu_torch.ops.paged_attention import (
        decode_plan,
        paged_attention_decode_stacked,
        paged_attention_prefill_stacked,
        paged_attention_plain,
    )

    np_rng = np.random.default_rng(11)
    layer = L - 1
    scale = 1.0 / math.sqrt(DH)
    # K2: B=64, contexts 128..4096 (both page sizes and cache types, with
    # and without a window); B=8 at ctx 8192; B=32 at ctx 129..192 (the
    # decode profile's batch); B=64 at ctx 129..192 at the engine's static
    # table width (8192-token cap in 16-token pages: 520 entries)
    c64 = np.linspace(128, 4096, 64).astype(np.int32)
    np_rng.shuffle(c64)
    c32 = np.linspace(129, 192, 32).astype(np.int32)
    np_rng.shuffle(c32)
    c64s = np.linspace(129, 192, 64).astype(np.int32)
    np_rng.shuffle(c64s)
    decode_shapes = [("B=64 ctx=128..4096", c64, (16, 128), (True, False), (None, 1000), None),
                     ("B=8 ctx=8192", np.full(8, 8192, np.int32), (16,), (True,), (None,), None),
                     ("B=32 ctx=129..192", c32, (16,), (True,), (None,), None),
                     (f"B=64 ctx=129..192 W={STATIC_WIDTH}", c64s, (16,), (True,), (None,),
                      STATIC_WIDTH)]
    for label, ctx_np, page_sizes, dtypes, windows, width in decode_shapes:
        B = len(ctx_np)
        ctx = torch.from_numpy(ctx_np).cuda()
        for bs in page_sizes:
            tables, n_pages = _paged_layout(torch, np_rng, ctx_np, bs, width)
            kps, n_splits = decode_plan(B, HK, tables.shape[1], bs)
            plan = {"keys_per_split": kps, "n_splits": n_splits, "blocks": B * HK * n_splits,
                    "live_blocks": HK * int(sum(-(-int(c) // kps) for c in ctx_np))}
            log(f"decode_plan {label} bs={bs} W={tables.shape[1]}: {json.dumps(plan)}")
            for quantized in dtypes:
                caches, scales = _make_cache(torch, gen, n_pages, bs, layer, quantized)
                q = torch.randn((B, H, DH), device="cuda", generator=gen).to(torch.bfloat16)
                for window in windows:
                    args = (q, caches[0], caches[1], layer, tables, ctx, bs, window, scales[0], scales[1])
                    fn = lambda: paged_attention_decode_stacked(*args)  # noqa: E731
                    pos = (ctx.long() - 1)[:, None]
                    plain = lambda: paged_attention_plain(  # noqa: E731
                        q[:, None], caches[0], caches[1], layer, tables, pos, ctx, bs, window,
                        scales[0], scales[1])[:, 0]
                    out, ref = fn(), plain()
                    torch.cuda.synchronize()
                    c = compare(torch, out, ref, rtol=ATTN_RTOL, atol=ATTN_ATOL_FRAC * ref.float().abs().max().item())
                    eff = np.minimum(ctx_np, window) if window else ctx_np
                    itemsize = 1 if quantized else 2
                    nbytes = (2 * q.numel() * 2 + int(eff.sum()) * HK * DH * itemsize * 2
                              + (int(eff.sum()) * HK * 8 if quantized else 0) + tables.numel() * 4 + B * 4)
                    bound, by = bench.bound_ms(nbytes, 4.0 * H * DH * float(eff.sum()))
                    k_l, v_l = _sdpa_inputs(torch, q, caches, scales, tables, bs, layer, quantized)
                    kpos = torch.arange(k_l.shape[2], device="cuda")
                    mask = kpos[None, :] < ctx[:, None]
                    if window:
                        mask &= kpos[None, :] >= (ctx[:, None] - window)
                    mask = mask[:, None, None, :]
                    q4 = q[:, :, None, :]
                    lib = lambda: Fn.scaled_dot_product_attention(q4, k_l, v_l, attn_mask=mask)  # noqa: E731
                    row = {
                        "wrapper": "paged_attention_decode_stacked",
                        "shape": f"{label} bs={bs} {'int8' if quantized else 'bf16'} window={window} layer={layer}",
                        "kernel_ms": bench.time_ms(fn), "plain_ms": bench.time_ms(plain, reps=3),
                        "library_ms": bench.time_ms(lib, reps=5), "bound_ms": bound, "bound_by": by,
                        "plan": plan, **c,
                    }
                    row["of_bound"] = bound / row["kernel_ms"]
                    log("check " + json.dumps(row))
                    results.setdefault(row["wrapper"], []).append(row)
                    if not c["ok"]:
                        raise AssertionError(f"decode {row['shape']} disagrees with its plain version")
                    del k_l, v_l, out, ref
                del caches, scales
                torch.cuda.empty_cache()
    # K3: B=2, T=1024, first chunk then second chunk (16-token pages);
    # the second chunk of an int8 cache at 128-token pages
    T = 1024
    for bs, quantized, window, starts_ in ((16, True, None, (0, T)), (16, False, None, (0, T)),
                                           (16, True, 700, (0, T)), (128, True, None, (T,))):
        full = np.array([2 * T, 2 * T], np.int32)
        tables, n_pages = _paged_layout(torch, np_rng, full, bs)
        caches, scales = _make_cache(torch, gen, n_pages, bs, layer, quantized)
        q = torch.randn((2, T, H, DH), device="cuda", generator=gen).to(torch.bfloat16)
        for start in starts_:
            starts = torch.full((2,), start, dtype=torch.int32, device="cuda")
            ctxp = torch.full((2,), start + T, dtype=torch.int32, device="cuda")
            args = (q, caches[0], caches[1], layer, tables, starts, ctxp, bs, window, scales[0], scales[1])
            fn = lambda: paged_attention_prefill_stacked(*args)  # noqa: E731
            pos = starts.long()[:, None] + torch.arange(T, device="cuda")[None]
            plain = lambda: paged_attention_plain(  # noqa: E731
                q, caches[0], caches[1], layer, tables, pos, ctxp, bs, window, scales[0], scales[1])
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            c = compare(torch, out, ref, rtol=ATTN_RTOL, atol=ATTN_ATOL_FRAC * ref.float().abs().max().item())
            qp = np.arange(start, start + T)[:, None]
            kp = np.arange(start + T)[None, :]
            valid = kp <= qp
            if window:
                valid &= kp > qp - window
            pairs = 2 * int(valid.sum())
            keys = 2 * int(valid.any(axis=0).sum())
            itemsize = 1 if quantized else 2
            nbytes = 2 * q.numel() * 2 + keys * HK * DH * itemsize * 2 + (keys * HK * 8 if quantized else 0)
            bound, by = bench.bound_ms(nbytes, 4.0 * H * DH * pairs)
            k_l, v_l = _sdpa_inputs(torch, q, caches, scales, tables, bs, layer, quantized)
            k_l, v_l = k_l[:, :, : start + T], v_l[:, :, : start + T]
            mask = torch.from_numpy(valid).cuda()[None, None]
            qh = q.permute(0, 2, 1, 3)
            lib = lambda: Fn.scaled_dot_product_attention(qh, k_l, v_l, attn_mask=mask)  # noqa: E731
            row = {
                "wrapper": "paged_attention_prefill_stacked",
                "shape": f"B=2 T={T} start={start} bs={bs} {'int8' if quantized else 'bf16'} window={window} layer={layer}",
                "kernel_ms": bench.time_ms(fn), "plain_ms": bench.time_ms(plain, reps=3),
                "library_ms": bench.time_ms(lib, reps=5), "bound_ms": bound, "bound_by": by, **c,
            }
            log("check " + json.dumps(row))
            results.setdefault(row["wrapper"], []).append(row)
            if not c["ok"]:
                raise AssertionError(f"prefill {row['shape']} disagrees with its plain version")
            del k_l, v_l, out, ref
        del caches, scales
        torch.cuda.empty_cache()


# representative shape per wrapper for the kernels line (decode batch 64,
# int8 cache, 16-token pages; prefill: the second 1024-token chunk)
REPRESENTATIVE = {
    "qmm": "wq/wo plain M=64",
    "qmm_gate_up": "gate/up gate_up M=64",
    "qmm_lm_head": "lm_head lm_head M=64",
    "paged_attention_decode_stacked": "B=64 ctx=128..4096 bs=16 int8 window=None",
    "paged_attention_prefill_stacked": "start=1024 bs=16 int8 window=None",
}
SOURCES = {
    "qmm": ("dynamo_tpu_torch/csrc/qmm.cu", "dynamo_tpu/ops/qmatmul.py:437"),
    "qmm_gate_up": ("dynamo_tpu_torch/csrc/qmm.cu", "dynamo_tpu/ops/qmatmul.py:460"),
    "qmm_lm_head": ("dynamo_tpu_torch/csrc/qmm.cu", "dynamo_tpu/ops/qmatmul.py:480"),
    "paged_attention_decode_stacked": (
        "dynamo_tpu_torch/csrc/paged_attention.cu", "dynamo_tpu/ops/paged_attention.py:181"),
    "paged_attention_prefill_stacked": (
        "dynamo_tpu_torch/csrc/paged_attention.cu", "dynamo_tpu/ops/paged_attention.py:401"),
}


def kernel_entries(results: dict, launches: dict) -> list[dict]:
    out = []
    for name, (src, replaces) in SOURCES.items():
        rows = results.get(name, [])
        rep = next((r for r in rows if REPRESENTATIVE[name] in r["shape"]), rows[0] if rows else None)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
            "ms": rep and rep["kernel_ms"], "plain_ms": rep and rep["plain_ms"],
            "bound_ms": rep and rep["bound_ms"], "bound_by": rep and rep["bound_by"],
            "library_ms": rep and rep["library_ms"], "shape": rep and rep["shape"],
            "checks": rows,
        })
    return out


# ---------------------------------------------------------------------------
# Phase: parity (small model, kernels on the GPU vs plain versions on the CPU)
# ---------------------------------------------------------------------------


def check_parity(torch) -> dict:
    import numpy as np

    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.quant import init_params_quantized

    mc = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     max_position_embeddings=512)
    bs, nb, T = 16, 16, 40
    params_cpu = init_params_quantized(mc, seed=3, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    caches = {d: llama.init_cache(mc, nb, bs, torch.int8, d) for d in ("cpu", "cuda")}
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, mc.vocab_size, (2, T)).astype(np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    tol = 5e-2
    worst, flips, steps = 0.0, 0, 0
    toks = prompt
    for step in range(4):
        if step == 0:
            pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
            feed = prompt
            ctx = np.array([T, T], np.int32)
            last = np.array([T - 1, T - 1], np.int32)
        else:
            p = T + step - 1
            pos = np.array([[p], [p]], np.int32)
            feed = toks[:, -1:]
            ctx = np.array([p + 1, p + 1], np.int32)
            last = np.zeros(2, np.int32)
        slots = (table[np.arange(2)[:, None], pos // bs] * bs + pos % bs).reshape(-1).astype(np.int32)
        logits = {}
        for d, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            kc, vc = caches[d]
            with torch.inference_mode():
                lg, kc, vc = llama.forward(mc, params, kc, vc, t(feed), t(pos), t(slots), t(table),
                                           t(ctx), t(last), bs)
            logits[d] = lg.float().cpu()
        ref, got = logits["cpu"], logits["cuda"]
        if not torch.isfinite(got).all() or got.shape != (2, mc.vocab_size):
            raise AssertionError("parity: GPU logits malformed")
        worst = max(worst, (got - ref).abs().max().item())
        top2 = ref.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = got.argmax(-1) == ref.argmax(-1)
        flips += int((decisive & ~agree).sum())
        toks = np.concatenate([toks, ref.argmax(-1).numpy().astype(np.int32)[:, None]], 1)
        steps += 1
    res = {"steps": steps, "max_abs_logit_err": worst, "tol": tol, "decisive_flips": flips}
    log("parity " + json.dumps(res))
    if worst > tol or flips:
        raise AssertionError(f"parity: GPU forward disagrees with the CPU reference {res}")
    return res


# ---------------------------------------------------------------------------
# Phase: serve (the 8B engine path)
# ---------------------------------------------------------------------------


def engine_8b(**overrides):
    """(EngineConfig, ModelConfig) of the serving path at the 8B geometry;
    the engine's defaults otherwise (static shapes, CUDA graphs, overlap)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    mc = ModelConfig(vocab_size=V, hidden_size=D, intermediate_size=F, num_hidden_layers=L,
                     num_attention_heads=H, num_key_value_heads=HK, max_position_embeddings=8192)
    cfg = EngineConfig(device="cuda", random_weights=True, quantization="int8", kv_cache_dtype="int8",
                       max_batch_size=64, block_size=16, prefill_chunk_size=1024,
                       max_prefill_tokens=4096, seed=0, **overrides)
    return cfg, mc


def graph_info(engine) -> dict:
    """What the engine's decode graphs cost at launch."""
    sched = engine.scheduler
    return {
        "cuda_graphs": engine.use_graphs, "overlap": engine.config.overlap,
        "decode_buckets": sched.decode_buckets(), "table_width": sched.table_width_pad,
        "graphs": len(engine.decode.graphs),
        "capture_s": engine.decode.capture_seconds, "pool_bytes": engine.decode.pool_bytes,
    }


def _median_ms(xs: list[float]):
    return statistics.median(xs) * 1e3 if xs else None


async def serve(torch) -> dict:
    import numpy as np

    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.protocols.common import (
        FinishReason,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    t0 = time.monotonic()
    engine = await TorchEngine.launch(*engine_8b())
    torch.cuda.synchronize()
    launch_s = time.monotonic() - t0
    graphs = graph_info(engine)
    if graphs["table_width"] != STATIC_WIDTH or graphs["graphs"] != 6:
        raise AssertionError(f"serve: unexpected static shapes or graphs {graphs}")
    rng = np.random.default_rng(1)
    lens = [16, 64, 200, 500, 900, 1500, 48, 48]
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    prompts[7] = list(prompts[6])  # two identical greedy requests
    greedy = [True, False, True, False, True, False, True, True]
    osl = 32

    async def one(i: int):
        samp = (SamplingOptions(use_greedy=True) if greedy[i]
                else SamplingOptions(temperature=0.7, top_p=0.9, top_k=50, seed=100 + i))
        req = PreprocessedRequest(request_id=f"smoke-{i}", token_ids=prompts[i], sampling=samp,
                                  stop=StopConditions(max_tokens=osl, ignore_eos=True))
        t_sub = time.monotonic()
        first, toks, finish = None, [], None
        async for out in engine.as_async_engine().generate(req, Context()):
            if out.token_ids and first is None:
                first = time.monotonic() - t_sub
            toks += out.token_ids
            finish = out.finish_reason or finish
        return toks, finish, first

    try:
        t1 = time.monotonic()
        res = await asyncio.wait_for(asyncio.gather(*[one(i) for i in range(len(lens))]), PHASE_TIMEOUT_S)
        wall = time.monotonic() - t1
    finally:
        await engine.shutdown()
    for i, (toks, finish, _) in enumerate(res):
        if len(toks) != osl or finish != FinishReason.LENGTH:
            raise AssertionError(f"request {i}: {len(toks)} tokens, finish {finish}")
        if not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {i}: token id out of range")
    if res[6][0] != res[7][0]:
        raise AssertionError("identical greedy requests gave different tokens")
    n_out = sum(len(r[0]) for r in res)
    return {
        "requests": len(lens), "prompt_tokens": lens, "output_tokens": n_out,
        "launch_s": launch_s, "wall_s": wall, "tok_s": n_out / wall,
        "ttft_s": [r[2] for r in res], "steps": dict(engine.steps),
        "decode_step_ms_median": _median_ms(engine.step_seconds["decode"]),
        "prefill_step_ms": [x * 1e3 for x in engine.step_seconds["prefill"]],
        "num_blocks": engine.allocator.num_blocks, "graphs": graphs,
        "overlap": engine.overlap.stats(),
    }


def _device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) by kernel from a torch.profiler run,
    largest first; raises if the profiler saw no device time."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    if sum(r[0] for r in rows) <= 0:
        raise AssertionError("profile: the profiler saw no device time")
    return rows


def _top(rows, n=15) -> list[dict]:
    return [{"ms": ms, "calls": c, "name": k[:90]} for ms, c, k in rows[:n]]


async def profile(torch) -> dict:
    """Two profiled windows on one 8B engine. Decode: a steady batch of 32
    streams (128 prompt tokens, 64 generated): device time by kernel, the
    device-busy share of the wall time, the median decode step. Prefill:
    2 streams of 2048-token prompts and 1 output token, i.e. prefill steps
    only (1024-token chunks): device time by kernel and K3's share of it."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    engine = await TorchEngine.launch(*engine_8b())
    rng = np.random.default_rng(2)
    n, isl, osl = 32, 128, 64
    p_n, p_isl = 2, 2048

    async def one(i, isl=isl, osl=osl):
        req = PreprocessedRequest(
            request_id=f"prof-{isl}-{i}", token_ids=rng.integers(0, V, isl).tolist(),
            sampling=SamplingOptions(use_greedy=True), stop=StopConditions(max_tokens=osl))
        return [t async for out in engine.as_async_engine().generate(req, Context()) for t in out.token_ids]

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        await asyncio.wait_for(asyncio.gather(*[one(i) for i in range(4)]), PHASE_TIMEOUT_S)  # warm-up
        engine.step_seconds = {"prefill": [], "decode": []}
        with torch_profile(activities=activities) as prof:
            t0 = time.monotonic()
            outs = await asyncio.wait_for(asyncio.gather(*[one(i) for i in range(n)]), PHASE_TIMEOUT_S)
            wall = time.monotonic() - t0
        dec = engine.step_seconds["decode"]
        prefill_ms = [x * 1e3 for x in engine.step_seconds["prefill"]]
        engine.step_seconds = {"prefill": [], "decode": []}
        with torch_profile(activities=activities) as pprof:
            t0 = time.monotonic()
            p_outs = await asyncio.wait_for(asyncio.gather(*[one(i, p_isl, 1) for i in range(p_n)]),
                                            PHASE_TIMEOUT_S)
            p_wall = time.monotonic() - t0
        p_steps = dict(engine.step_seconds)
    finally:
        await engine.shutdown()
    if any(len(o) != osl for o in outs) or any(len(o) != 1 for o in p_outs):
        raise AssertionError("profile: a stream did not finish")
    rows, p_rows = _device_rows(prof), _device_rows(pprof)
    device_ms = sum(r[0] for r in rows)
    p_device_ms = sum(r[0] for r in p_rows)
    k3_ms = sum(r[0] for r in p_rows if "prefill_kernel" in r[2])
    # K2 = its split kernel plus its merge kernel
    k2 = [r for r in rows if "k2::split_kernel" in r[2] or "k2::merge_kernel" in r[2]]
    return {
        "streams": n, "isl": isl, "osl": osl, "wall_s": wall,
        "tok_s": n * osl / wall,
        "device_busy_share_of_wall": device_ms / 1e3 / wall,
        "decode_steps": len(dec), "decode_step_ms_median": _median_ms(dec),
        "prefill_step_ms": prefill_ms,
        "device_ms_total": device_ms,
        "k2_ms": sum(r[0] for r in k2), "k2_launches": {r[2][:60]: r[1] for r in k2},
        "top_kernels_ms": _top(rows),
        "prefill_only": {
            "streams": p_n, "isl": p_isl, "osl": 1, "wall_s": p_wall,
            "prefill_step_ms": [x * 1e3 for x in p_steps["prefill"]],
            "decode_steps": len(p_steps["decode"]),
            "device_ms_total": p_device_ms,
            "device_busy_share_of_wall": p_device_ms / 1e3 / p_wall,
            "k3_ms": k3_ms, "k3_share_of_device": k3_ms / p_device_ms,
            "top_kernels_ms": _top(p_rows),
        },
    }


# ---------------------------------------------------------------------------
# Phase: graphs (eager vs captured decode, serial vs overlapped)
# ---------------------------------------------------------------------------

GRAPH_MODES = (("eager_serial", False, False), ("graphs_serial", True, False),
               ("graphs_overlap", True, True))


async def graphs_mode(torch, cuda_graphs: bool, overlap: bool) -> dict:
    """One fresh 8B engine; 32 greedy + 8 sampled streams of 128-token
    prompts and 64 output tokens, submitted as one burst (admitted by one
    plan, so every mode runs the same batches). Device time per step from
    CUDA events around its device work (``record_device_time``)."""
    import numpy as np

    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    n_greedy, n_sampled, isl, osl = 32, 8, 128, 64
    rng = np.random.default_rng(4)
    t0 = time.monotonic()
    engine = await TorchEngine.launch(*engine_8b(cuda_graphs=cuda_graphs, overlap=overlap))
    torch.cuda.synchronize()
    launch_s = time.monotonic() - t0
    info = graph_info(engine)

    def request(i):
        if i < n_greedy:
            samp = SamplingOptions(use_greedy=True)
        elif i % 2:
            samp = SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=500 + i)
        else:
            samp = SamplingOptions(temperature=1.0, seed=500 + i)
        return PreprocessedRequest(request_id=f"graphs-{i}", token_ids=rng.integers(0, V, isl).tolist(),
                                   sampling=samp, stop=StopConditions(max_tokens=osl, ignore_eos=True))

    async def drain(q):
        toks = []
        while (item := await q.get()) is not None:
            toks += item.token_ids
        return toks

    reqs = [request(i) for i in range(n_greedy + n_sampled)]
    try:
        engine.record_device_time = True
        t1 = time.monotonic()
        queues = engine.submit_many([(r, Context()) for r in reqs])
        outs = await asyncio.wait_for(asyncio.gather(*[drain(q) for q in queues]), PHASE_TIMEOUT_S)
        wall = time.monotonic() - t1
    finally:
        await engine.shutdown()
    if any(len(o) != osl or not all(0 <= t < V for t in o) for o in outs):
        raise AssertionError("graphs: a stream did not finish with valid tokens")
    dev_ms = engine.device_ms
    return {
        "tokens": outs,
        "launch_s": launch_s, "wall_s": wall, "tok_s": len(reqs) * osl / wall,
        "steps": dict(engine.steps),
        "decode_step_ms_median": _median_ms(engine.step_seconds["decode"]),
        "decode_device_ms_median": statistics.median(dev_ms["decode"]),
        "device_busy_share_of_wall": (sum(dev_ms["decode"]) + sum(dev_ms["prefill"])) / 1e3 / wall,
        "prefill_device_ms": dev_ms["prefill"],
        "idle_gap_ms_median": statistics.median(
            s["idle_gap_ms"] for s in engine.step_stamps["decode"]),
        "overlap": engine.overlap.stats(), **info,
    }


def graphs_phase(torch) -> dict:
    modes = {}
    for name, cuda_graphs, overlap in GRAPH_MODES:
        modes[name] = asyncio.run(graphs_mode(torch, cuda_graphs, overlap))
        torch.cuda.empty_cache()
    ref = modes["eager_serial"]["tokens"]
    for name, res in modes.items():
        diff = [i for i, (a, b) in enumerate(zip(ref, res.pop("tokens"))) if a != b]
        res["streams_differing_from_eager_serial"] = diff
        if diff:
            raise AssertionError(f"graphs: mode {name} changed the tokens of streams {diff}")
    return modes


def launch_counts() -> dict:
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import qmatmul as qm

    return {
        "qmm": qm.qmm.launches,
        "qmm_gate_up": qm.qmm_gate_up.launches,
        "qmm_lm_head": qm.qmm_lm_head.launches,
        "paged_attention_decode_stacked": pa.paged_attention_decode_stacked.launches,
        "paged_attention_prefill_stacked": pa.paged_attention_prefill_stacked.launches,
    }


def reset_counts() -> None:
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import qmatmul as qm

    for fn in (qm.qmm, qm.qmm_gate_up, qm.qmm_lm_head,
               pa.paged_attention_decode_stacked, pa.paged_attention_prefill_stacked):
        fn.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import dynamo_tpu_torch  # noqa: F401
        from dynamo_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the dynamo_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    logs = _build.build_all()
    log(f"build_seconds {time.monotonic() - t0:.1f}")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "warning")):
                log(f"ptxas {src}: {line.strip()}")
    from dynamo_tpu_torch.ops import qmatmul as qm

    lib = qm._lib()
    for cfg, variant in enumerate(("prefill", "decode", "decode narrow")):
        for epi, kind in enumerate(("plain", "residual", "gate_up")):
            smem = lib.qmm_smem_bytes(cfg, epi)
            if smem:
                log(f"qmm {variant} {kind}: {smem} bytes of dynamic shared memory a block")
        # what launch_plan assumes (_CLUSTERS_AT_ONCE) against this card
        held = [lib.qmm_max_clusters(cfg, s) for s in range(1, len(qm._CLUSTERS_AT_ONCE[cfg]) + 1)]
        log(f"qmm {variant}: clusters of 1.. blocks held at once {held}; plan assumes "
            f"{list(qm._CLUSTERS_AT_ONCE[cfg])}")

    results: dict = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bench = Bench(torch, name)
    check_qmm(torch, bench, gen, results)
    check_attention(torch, bench, gen, results)
    del bench
    torch.cuda.empty_cache()

    check_parity(torch)
    torch.cuda.empty_cache()

    reset_counts()
    info = asyncio.run(serve(torch))
    launches = launch_counts()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    info["launches"] = launches
    log(json.dumps({"serve": info}))

    log(json.dumps({"profile": asyncio.run(profile(torch))}))
    torch.cuda.empty_cache()

    log(json.dumps({"graphs": graphs_phase(torch)}))

    log(json.dumps({"kernels": kernel_entries(results, launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
