"""The port's int8-weight matmuls (dynamo_tpu_torch/ops/qmatmul.py, plain
versions on the CPU) against the reference, on the same inputs.

Tolerances, and why:
- f32 activations: the reference ``models/llama.py::mm`` (and the
  composed gate/up and ``lm_head``) on its XLA path
  (DYN_MATMUL_IMPL=reference) at rtol 1e-5, with an absolute floor of
  1e-5 x max|ref| for outputs that cancel to near zero: the two differ
  only in f32 accumulation order.
- bf16 activations: within 1 bf16 ulp elementwise (of the larger of the
  two values; for the residual variant, of the larger operand of the
  final add): both round the same f32 sum at the same points, so only an
  accumulation-order difference straddling a rounding boundary moves a
  value, by one ulp. gate_up: 2 bf16 ulps, plus an absolute floor of
  2^-16 x max|ref|: the activation is computed by different f32 code
  (XLA's logistic/tanh vs torch's) and rounded twice after it, and
  gelu's 1 + tanh cancels to noise where it drives values to ~0. For
  gelu in bf16 also 2^-8 x |g * u|: the reference evaluates 1 + tanh in
  bf16, which near tanh -> -1 costs up to 2^-9 x |g| before the product.
- against the reference's Pallas kernel run interpreted, the same bf16
  tolerance; not bit equality, which that kernel no longer keeps even
  with the reference's own ``mm`` under jax 0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.ops import qmatmul as jqm
from dynamo_tpu_torch.ops import qmatmul as tqm

K, N = 64, 128


@pytest.fixture(autouse=True)
def _reference_matmul(monkeypatch):
    monkeypatch.setenv("DYN_MATMUL_IMPL", "reference")


def _operands(seed, lead, k=K, n=N, two=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    ws = [rng.integers(-127, 128, (k, n)).astype(np.int8) for _ in range(2 if two else 1)]
    ss = [rng.uniform(0.001, 0.02, n).astype(np.float32) for _ in ws]
    r = rng.standard_normal((*lead, n)).astype(np.float32)
    return x, ws, ss, r


def _bf16(a: np.ndarray) -> tuple[torch.Tensor, jax.Array]:
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ulp_bf16(mag: np.ndarray) -> np.ndarray:
    mag = np.maximum(mag, np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_within_ulp(got: torch.Tensor, ref, mag=None, ulps=1, floor=0.0, extra=0.0):
    g = got.float().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    if mag is None:
        mag = np.maximum(np.abs(g), np.abs(r))
    allowed = ulps * _ulp_bf16(mag) * 1.0000001 + floor * np.abs(r).max() + extra + 1e-30
    np.testing.assert_array_less(np.abs(g - r), allowed)


GATE_UP_TOL = dict(ulps=2, floor=2.0 ** -16)


def _assert_f32(got: torch.Tensor, ref):
    r = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


LEADS = [(5,), (13,), (2, 3)]


@pytest.mark.parametrize("lead", LEADS)
def test_qmm_f32_matches_reference_mm(lead):
    x, (w,), (s,), r = _operands(0, lead)
    p = {"w": jnp.asarray(w), "w_scale": jnp.asarray(s)}
    ref = jl.mm(p, "w", jnp.asarray(x))
    got = tqm.qmm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    assert tuple(got.shape) == (*lead, N) and got.dtype == torch.float32
    _assert_f32(got, ref)
    # residual variant: x + mm(...) in the output dtype
    got_r = tqm.qmm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
                    residual=torch.from_numpy(r))
    _assert_f32(got_r, jnp.asarray(r) + ref)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("lead", LEADS)
def test_qmm_gate_up_f32_matches_reference(lead, act):
    x, (wg, wu), (sg, su), _ = _operands(1, lead, two=True)
    mc = JModelConfig(hidden_act=act)
    p = {"g": jnp.asarray(wg), "g_scale": jnp.asarray(sg),
         "u": jnp.asarray(wu), "u_scale": jnp.asarray(su)}
    xj = jnp.asarray(x)
    ref = jl.mlp_act(mc, jl.mm(p, "g", xj)) * jl.mm(p, "u", xj)
    got = tqm.qmm_gate_up(torch.from_numpy(x), *(torch.from_numpy(a) for a in (wg, sg, wu, su)), act=act)
    _assert_f32(got, ref)


def test_qmm_lm_head_f32_matches_reference():
    x, (w,), (s,), _ = _operands(2, (3,), k=64, n=256)
    ref = jl.lm_head({"lm_head": jnp.asarray(w), "lm_head_scale": jnp.asarray(s)}, jnp.asarray(x))
    got = tqm.qmm_lm_head(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)).float()
    _assert_f32(got, ref)


@pytest.mark.parametrize("lead", LEADS)
def test_qmm_bf16_within_one_ulp_of_reference(lead):
    x, (w,), (s,), r = _operands(3, lead)
    xt, xj = _bf16(x)
    rt, rj = _bf16(r)
    p = {"w": jnp.asarray(w), "w_scale": jnp.asarray(s)}
    ref = jl.mm(p, "w", xj)
    got = tqm.qmm(xt, torch.from_numpy(w), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got, ref)
    got_r = tqm.qmm(xt, torch.from_numpy(w), torch.from_numpy(s), residual=rt)
    ref_r = rj + ref
    mag = np.abs(np.asarray(rj, np.float32)) + np.abs(np.asarray(ref, np.float32))
    _assert_within_ulp(got_r, ref_r, mag)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("lead", LEADS)
def test_qmm_gate_up_and_lm_head_bf16_within_ulps(lead, act):
    x, (wg, wu), (sg, su), _ = _operands(4, lead, two=True)
    xt, xj = _bf16(x)
    p = {"g": jnp.asarray(wg), "g_scale": jnp.asarray(sg),
         "u": jnp.asarray(wu), "u_scale": jnp.asarray(su)}
    g, u = jl.mm(p, "g", xj), jl.mm(p, "u", xj)
    ref = jl.mlp_act(JModelConfig(hidden_act=act), g) * u
    got = tqm.qmm_gate_up(xt, *(torch.from_numpy(a) for a in (wg, sg, wu, su)), act=act)
    extra = 0.0
    if act == "gelu":
        extra = 2.0 ** -8 * np.abs(np.asarray(g, np.float32) * np.asarray(u, np.float32))
    _assert_within_ulp(got, ref, extra=extra, **GATE_UP_TOL)
    ref_lm = jl.lm_head({"lm_head": jnp.asarray(wg), "lm_head_scale": jnp.asarray(sg)}, xj)
    got_lm = tqm.qmm_lm_head(xt, torch.from_numpy(wg), torch.from_numpy(sg)).float()
    _assert_within_ulp(got_lm, ref_lm)


@pytest.mark.parametrize("variant", ["plain", "residual", "gate_up", "lm_head"])
def test_matches_interpreted_pallas_kernel_within_ulps(variant):
    x, (w, w2), (s, s2), r = _operands(5, (13,), two=True)
    xt, xj = _bf16(x)
    rt, rj = _bf16(r)
    tw, ts, tw2, ts2 = (torch.from_numpy(a) for a in (w, s, w2, s2))
    jw, js, jw2, js2 = (jnp.asarray(a) for a in (w, s, w2, s2))
    mag, tol = None, {}
    if variant == "plain":
        ref, got = jqm.qmm(xj, jw, js, interpret=True), tqm.qmm(xt, tw, ts)
    elif variant == "residual":
        ref = jqm.qmm(xj, jw, js, residual=rj, interpret=True)
        got = tqm.qmm(xt, tw, ts, residual=rt)
        y = np.asarray(jqm.qmm(xj, jw, js, interpret=True), np.float32)
        mag = np.abs(np.asarray(rj, np.float32)) + np.abs(y)
    elif variant == "gate_up":
        ref = jqm.qmm_gate_up(xj, jw, js, jw2, js2, interpret=True)
        got = tqm.qmm_gate_up(xt, tw, ts, tw2, ts2)
        tol = GATE_UP_TOL
    else:
        ref = jqm.qmm_lm_head(xj, jw, js, interpret=True)
        got = tqm.qmm_lm_head(xt, tw, ts)
    _assert_within_ulp(got, ref, mag, **tol)


# (K, N, epilogue) of the 8B serving path: wq/wo, wk/wv, gate/up, w_down, lm_head
SERVING = {"wq/wo": (4096, 4096, ""), "wk/wv": (4096, 1024, ""), "gate_up": (4096, 14336, "gate_up"),
           "w_down": (14336, 4096, "residual"), "lm_head": (4096, 128256, "")}
# the card tests' shapes (M, K, N), ragged ones included
CARD_SHAPES = [(1, 64, 64), (5, 200, 100), (13, 4096, 1024), (70, 640, 4096), (129, 1536, 192),
               (64, 4096, 1024), (64, 1024, 4096), (65, 1024, 4096), (200, 512, 392)]
PLAN_CASES = ([(M, *SERVING[name], name) for name in SERVING for M in (1, 8, 32, 64, 65, 1024, 2048)]
              + [(M, K, N, epi, "card") for M, K, N in CARD_SHAPES for epi in ("", "residual", "gate_up")])


@pytest.mark.parametrize("M,K,N,epi,name", PLAN_CASES)
def test_launch_plan(M, K, N, epi, name):
    plan = tqm.launch_plan(M, N, K, epi)
    # one K range per cluster rank, whole 64-deep steps, no gap, no overlap
    ranges = tqm.split_steps(K, plan.splits)
    assert len(ranges) == plan.splits and all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(-(-K // 64)))
    assert plan.splits <= (tqm.MAX_CLUSTER if plan.nonportable else tqm.MAX_PORTABLE_CLUSTER)
    assert plan.grid[0] % plan.splits == 0
    assert plan.grid == (-(-M // plan.bm) * plan.splits, -(-N // plan.bn))
    if plan.splits > 1:  # every cluster runs at once: no second wave
        assert plan.blocks // plan.splits <= tqm.clusters_at_once(plan)
    assert plan.config == ("decode" if M <= tqm.DECODE_MAX_M else "prefill")
    assert plan.bm == (64 if plan.config == "decode" else 128)
    if M == 64 and name != "card":
        assert plan.blocks >= tqm.SMS  # the split fills the card at decode


def test_gate_up_rejects_unknown_activation():
    x, (w, w2), (s, s2), _ = _operands(6, (2,), two=True)
    with pytest.raises(ValueError, match="unsupported activation"):
        tqm.qmm_gate_up(*(torch.from_numpy(a) for a in (x, w, s, w2, s2)), act="relu")
