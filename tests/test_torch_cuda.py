"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no GPU is present (here: decided
inside the fixture, never at import). On a machine with one, without
JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Shapes are small and ragged, to reach the kernels' edge handling that the
serving shapes never do: M, N and K not multiples of the tiles, split-K,
every GQA group size, both head widths, both page sizes.

Tolerances: K1 within 2^-7 relative (about one bf16 ulp) plus 2^-9 x
max|ref| (2^-6 relative for gate_up: its activation is rounded twice;
for the residual add, relative to |r| + |x @ W * s|, the magnitude of
the operands it rounds);
attention within 2^-7 relative (one bf16 ulp of the output) plus 2^-7 x
max|ref| absolute, the maximum taken per sequence: an output averages
over up to hundreds of keys, so it is far smaller than the values it
averages, and a fixed absolute limit would hide a mis-weighted key.
"""

import math

import pytest
import torch

from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import qmatmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, ref, rtol, atol_frac=2 ** -9, mag=None):
    """|got - ref| <= atol + rtol * mag (mag: |ref|, or for a sum the
    magnitude of its operands)."""
    torch.cuda.synchronize()
    atol = atol_frac * ref.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    mag = ref.float().abs() if mag is None else mag
    excess = (got.float() - ref.float()).abs() - (atol + rtol * mag)
    assert excess.max().item() <= 0, excess.max().item()


@pytest.mark.parametrize("M,K,N", [(1, 64, 64), (5, 200, 100), (13, 4096, 1024),
                                   (70, 640, 4096), (129, 1536, 192)])
@pytest.mark.parametrize("variant", ["plain", "residual", "gate_up_silu", "gate_up_gelu", "lm_head"])
def test_qmm_kernel_matches_plain(gen, M, K, N, variant):
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
    w2 = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand(N, device="cuda", generator=gen) / (64 * math.sqrt(K)) + 1e-5
    s2 = torch.rand(N, device="cuda", generator=gen) / (64 * math.sqrt(K)) + 1e-5
    r = torch.randn(M, N, device="cuda", generator=gen).to(torch.bfloat16)
    if variant == "plain":
        got, ref = qm.qmm(x, w, s), qm.qmm_plain(x, w, s)
    elif variant == "residual":
        got, ref = qm.qmm(x, w, s, residual=r), qm.qmm_plain(x, w, s, r)
        _close(got, ref, rtol=2 ** -7, mag=r.float().abs() + qm.qmm_plain(x, w, s).float().abs())
        return
    elif variant == "lm_head":
        got, ref = qm.qmm_lm_head(x, w, s), qm.qmm_plain(x, w, s)
    else:
        act = variant.split("_")[-1]
        got = qm.qmm_gate_up(x, w, s, w2, s2, act=act)
        ref = qm.qmm_gate_up_plain(x, w, s, w2, s2, act)
        _close(got, ref, rtol=2 ** -6)
        return
    _close(got, ref, rtol=2 ** -7)


def test_qmm_counts_launches_and_checks_operands(gen):
    x = torch.randn(4, 64, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand(64, device="cuda", generator=gen)
    before = qm.qmm.launches
    qm.qmm(x, w, s)
    assert qm.qmm.launches == before + 1
    with pytest.raises(TypeError):
        qm.qmm(x.float(), w, s)  # the kernel takes bf16 activations
    with pytest.raises(ValueError):
        qm.qmm(x, w.cpu(), s)
    assert qm.qmm.launches == before + 1


def _close_per_sequence(got, ref):
    for b in range(ref.shape[0]):
        _close(got[b], ref[b], rtol=2 ** -7, atol_frac=2 ** -7)


def _paged(gen, B, ctx, bs, L, Hk, Dh, quantized):
    W = max(1, max(-(-c // bs) for c in ctx))
    n_pages = sum(-(-c // bs) for c in ctx) + 1
    perm = torch.randperm(n_pages - 1, device="cuda", generator=gen) + 1
    tables = torch.zeros(B, W, dtype=torch.int32, device="cuda")
    at = 0
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    S = n_pages * bs
    if quantized:
        kv = [torch.randint(-127, 128, (L, S, Hk, Dh), dtype=torch.int8, device="cuda", generator=gen)
              for _ in range(2)]
        sc = [torch.rand(L, n_pages, Hk, bs, device="cuda", generator=gen) * 0.02 + 1e-3 for _ in range(2)]
    else:
        kv = [torch.randn(L, S, Hk, Dh, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2)]
        sc = [None, None]
    return tables, kv, sc


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hk", [(8, 8), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 50])
def test_decode_kernel_matches_plain(gen, Dh, H, Hk, bs, quantized, window):
    ctx_list = [1, 37, 0, 300, 129]
    B, L, layer = len(ctx_list), 3, 2
    tables, kv, sc = _paged(gen, B, ctx_list, bs, L, Hk, Dh, quantized)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, Dh, device="cuda", generator=gen).to(torch.bfloat16)
    got = pa.paged_attention_decode_stacked(q, kv[0], kv[1], layer, tables, ctx, bs, window, *sc)
    pos = (ctx.long() - 1)[:, None]
    ref = pa.paged_attention_plain(q[:, None], kv[0], kv[1], layer, tables, pos, ctx, bs, window, *sc)[:, 0]
    torch.cuda.synchronize()
    _close_per_sequence(got, ref)
    assert (got[2] == 0).all()  # ctx 0: exact zeros


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hk", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("start", [0, 70])
def test_prefill_kernel_matches_plain(gen, Dh, H, Hk, quantized, window, start):
    T, bs, L, layer = 100, 16, 2, 1
    chunk = [100, 37, 0]
    ctx_list = [start + c if c else 0 for c in chunk]
    tables, kv, sc = _paged(gen, 3, ctx_list, bs, L, Hk, Dh, quantized)
    starts = torch.tensor([start, start, 0], dtype=torch.int32, device="cuda")
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn(3, T, H, Dh, device="cuda", generator=gen).to(torch.bfloat16)
    got = pa.paged_attention_prefill_stacked(q, kv[0], kv[1], layer, tables, starts, ctx, bs, window, *sc)
    pos = starts.long()[:, None] + torch.arange(T, device="cuda")[None]
    ref = pa.paged_attention_plain(q, kv[0], kv[1], layer, tables, pos, ctx, bs, window, *sc)
    torch.cuda.synchronize()
    _close_per_sequence(got, ref)
    assert (got[1, 37:] == 0).all() and (got[2] == 0).all()  # padded rows


def test_attention_rejects_what_the_kernel_does_not_take(gen):
    tables, kv, sc = _paged(gen, 1, [20], 16, 1, 2, 96, False)
    q = torch.randn(1, 4, 96, device="cuda", generator=gen).to(torch.bfloat16)
    ctx = torch.tensor([20], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_decode_stacked(q, kv[0], kv[1], 0, tables, ctx, 16)
    with pytest.raises(IndexError):
        tables2, kv2, _ = _paged(gen, 1, [20], 16, 1, 2, 64, False)
        pa.paged_attention_decode_stacked(q[..., :64].contiguous(), kv2[0], kv2[1], 5, tables2, ctx, 16)
