"""The port's sampler (dynamo_tpu_torch/engine/sampling.py) against the
reference's (dynamo_tpu/engine/sampling.py).

Greedy tokens are equal and the chosen log-probabilities agree within
1e-5 (both are an f32 log-softmax of the same logits), in both variants
of ``sample`` (all-greedy and sampled). The keep mask of top-k/top-p/min-p
is equal on the same inputs. Sampled tokens are not compared stream to
stream: the reference draws its gumbel noise from ``jax.random`` keys and
the port from a counter-based hash of (seed, vocabulary index). Instead,
one seed must reproduce one row, and the empirical distribution over
many seeds must match the (filtered) softmax within 0.03 absolute per
token (4000 draws: a standard error of <= 0.008). The noise's mean and
variance match Gumbel(0, 1) (Euler's gamma and pi^2/6) within 0.02 and
0.05 over 2^18 draws: about 8 and 7 standard errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.protocols.common import SamplingOptions


def jax_log_softmax(logits):
    return jax.nn.log_softmax(jnp.asarray(logits), axis=-1)


def _jax_batch(arrays):
    out = {k: jnp.asarray(v) for k, v in arrays.items()}
    out["seeds"] = jnp.asarray(np.asarray(arrays["seeds"], np.uint32))
    return out


def _sample(logits, arrays, sampled=None):
    """The port's sample on CPU tensors, its variant picked as the engine
    picks it unless given."""
    if sampled is None:
        sampled = ts.any_sampled(arrays)
    return ts.sample(logits, ts.sampling_tensors(arrays, "cpu"), sampled)


def test_greedy_and_logprobs_match_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    arrays = ts.batch_arrays([SamplingOptions(use_greedy=True)] * 6, list(range(6)))
    jtok, jlp = js.sample(jnp.asarray(logits), _jax_batch(arrays))
    for sampled in (False, True):  # the greedy variant, and the sampled one
        tok, lp = _sample(torch.from_numpy(logits), arrays, sampled)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)
        assert tok.dtype == torch.int32


def test_greedy_rows_of_a_mixed_batch_match_reference():
    """The sampled variant keeps greedy rows greedy (its per-row select),
    as the reference's does, with filtering and free rows beside them."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((4, 300)) * 2).astype(np.float32)
    opts = [SamplingOptions(use_greedy=True), SamplingOptions(temperature=0.9, top_k=5),
            SamplingOptions(temperature=0.0), SamplingOptions(temperature=1.1)]
    arrays = ts.batch_arrays(opts, [5, 6, 7, 8])
    assert ts.any_sampled(arrays)
    tok, lp = _sample(torch.from_numpy(logits), arrays)
    jtok, jlp = js.sample(jnp.asarray(logits), _jax_batch(arrays))
    for row in (0, 2):
        assert int(tok[row]) == int(np.asarray(jtok)[row]) == int(logits[row].argmax())
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jax_log_softmax(logits))[np.arange(4), tok.numpy()],
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy()[[0, 2]], np.asarray(jlp)[[0, 2]], rtol=0, atol=1e-5)


def test_batch_arrays_match_reference_sampling_batch():
    opts = [SamplingOptions(use_greedy=True), SamplingOptions(temperature=0.7, top_k=20),
            SamplingOptions(top_p=0.9, min_p=0.05), SamplingOptions()]
    from dynamo_tpu.protocols.common import SamplingOptions as JOpts

    ref = js.SamplingBatch.from_options([JOpts(**o.model_dump()) for o in opts], [1, 2, 3, 4]).arrays
    got = ts.batch_arrays(opts, [1, 2, 3, 4])
    for k in ("temperature", "top_k", "top_p", "min_p", "seeds"):
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype), err_msg=k)


@pytest.mark.parametrize("top_k,top_p,min_p", [(0, 0.8, 0.0), (5, 1.0, 0.0), (0, 1.0, 0.1), (3, 0.5, 0.02)])
def test_filter_keep_mask_matches_reference(top_k, top_p, min_p):
    rng = np.random.default_rng(1)
    scaled = (rng.standard_normal((4, 200)) * 2).astype(np.float32)
    t = torch.from_numpy(scaled)
    vals, _ = torch.topk(t, 128, dim=-1)
    lse = torch.logsumexp(t, dim=-1, keepdim=True)
    k = torch.full((4,), top_k, dtype=torch.int32)
    p = torch.full((4,), top_p)
    m = torch.full((4,), min_p)
    got = ts.filter_keep_mask(vals, lse, k, p, m, 200)
    ref = js.filter_keep_mask(jnp.asarray(vals.numpy()), jnp.asarray(lse.numpy()),
                              jnp.asarray(k.numpy()), jnp.asarray(p.numpy()),
                              jnp.asarray(m.numpy()), 200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_seeded_sampling_is_reproducible():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    opts = [SamplingOptions(temperature=0.9), SamplingOptions(temperature=1.2, top_p=0.9),
            SamplingOptions(temperature=0.5, top_k=10), SamplingOptions(use_greedy=True)]
    a = _sample(logits, ts.batch_arrays(opts, [11, 12, 13, 14]))[0]
    b = _sample(logits, ts.batch_arrays(opts, [11, 12, 13, 14]))[0]
    assert torch.equal(a, b)
    draws = {int(_sample(logits, ts.batch_arrays(opts, [s, s, s, s]))[0][0]) for s in range(20)}
    assert len(draws) > 1  # different seeds, different draws
    assert int(a[3]) == int(logits[3].argmax())  # greedy row untouched by noise


@pytest.mark.parametrize("opts,keep", [
    (SamplingOptions(temperature=0.7), None),
    (SamplingOptions(temperature=1.0, top_k=3), 3),
    (SamplingOptions(temperature=1.0, top_p=0.7, min_p=0.1), "reference"),
])
def test_sampling_matches_softmax_distribution(opts, keep):
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -0.5, -1.0, 0.8, 0.0]])
    n = 4000
    arrays = ts.batch_arrays([opts] * n, list(range(1000, 1000 + n)))
    tok, lp = _sample(logits.expand(n, -1).contiguous(), arrays)
    freq = np.bincount(tok.numpy(), minlength=8) / n
    t = opts.temperature
    probs = torch.softmax(logits[0] / t, -1).numpy()
    if keep == "reference":
        # the reference's keep mask over the descending slice
        order = np.argsort(-probs)
        scaled = (logits[0] / t).numpy()
        vals = jnp.asarray(scaled[order][None])
        lse = jnp.asarray(np.log(np.exp(scaled).sum()).reshape(1, 1).astype(np.float32))
        kept = np.asarray(js.filter_keep_mask(
            vals, lse, jnp.asarray([0], jnp.int32), jnp.asarray([opts.top_p], jnp.float32),
            jnp.asarray([opts.min_p], jnp.float32), 8))[0]
        mask = np.zeros(8, bool)
        mask[order[kept]] = True
        assert 1 < mask.sum() < 8
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    elif keep is not None:
        mask = np.zeros(8, bool)
        mask[np.argsort(-probs)[:keep]] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    np.testing.assert_allclose(freq, probs, atol=0.03)
    # the reported logprob is the unscaled distribution's
    ref_lp = torch.log_softmax(logits[0], -1)[tok.long()]
    np.testing.assert_allclose(lp.numpy(), ref_lp.numpy(), rtol=0, atol=1e-6)


def test_gumbel_noise_is_reproducible_per_seed():
    """A row depends on its seed alone: the same seed gives the same row
    in another batch, at another position, with another vocabulary cut."""
    seeds = torch.tensor([3, 2**40 + 17, 99, 3], dtype=torch.int64)
    g = ts.gumbel_noise(seeds, 1000)
    assert g.shape == (4, 1000) and g.dtype == torch.float32
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], g[3])
    assert torch.equal(ts.gumbel_noise(seeds[1:2], 1000)[0], g[1])
    assert torch.equal(ts.gumbel_noise(torch.tensor([99]), 600)[0], g[2, :600])


def test_gumbel_noise_rows_with_different_seeds_differ():
    seeds = torch.arange(64, dtype=torch.int64) + 1000
    g = ts.gumbel_noise(seeds, 4096)
    assert len({tuple(r) for r in g[:, :8].tolist()}) == 64
    # neighbouring seeds give unrelated rows (no shared or shifted stream)
    c = torch.corrcoef(g)
    off = c[~torch.eye(64, dtype=torch.bool)]
    assert off.abs().max().item() < 0.08  # 5 standard errors at n=4096
    # seeds that differ only in their upper 32 bits differ too
    hi = ts.gumbel_noise(torch.tensor([5, 5 + 2**32]), 256)
    assert not torch.equal(hi[0], hi[1])


def test_gumbel_noise_matches_gumbel_moments():
    g = ts.gumbel_noise(torch.arange(4, dtype=torch.int64) * 7919, 1 << 16).double()
    assert abs(g.mean().item() - 0.5772156649) < 0.02
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.05
    assert g.min().item() > -3.0 and g.max().item() < 17.4


def test_noise_integer_ops_stay_in_range():
    """Every intermediate of the hash is a 32-bit value held in int64, and
    the 16-bit split multiply equals the exact product mod 2^32."""
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789], dtype=torch.int64)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        got = ts._mul32(x, c)
        want = [(int(v) * c) % 2**32 for v in x]
        assert got.tolist() == want
    m = ts._mix32(x)
    assert (m >= 0).all() and (m < 2**32).all()
