"""The port's sampler (dynamo_tpu_torch/engine/sampling.py) against the
reference's (dynamo_tpu/engine/sampling.py).

Greedy tokens are equal and the chosen log-probabilities agree within
1e-5 (both are an f32 log-softmax of the same logits). The keep mask of
top-k/top-p/min-p is equal on the same inputs. Sampled tokens are not
compared stream to stream: the reference draws its gumbel noise from
``jax.random`` keys and the port from ``torch.Generator``s. Instead,
one seed must reproduce one stream, and the empirical distribution over
many seeds must match the (filtered) softmax within 0.03 absolute per
token (4000 draws: a standard error of <= 0.008)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.protocols.common import SamplingOptions


def _jax_batch(arrays):
    out = {k: jnp.asarray(v) for k, v in arrays.items()}
    out["seeds"] = jnp.asarray(np.asarray(arrays["seeds"], np.uint32))
    return out


def test_greedy_and_logprobs_match_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    arrays = ts.batch_arrays([SamplingOptions(use_greedy=True)] * 6, list(range(6)))
    tok, lp = ts.sample(torch.from_numpy(logits), arrays)
    jtok, jlp = js.sample(jnp.asarray(logits), _jax_batch(arrays))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)
    assert tok.dtype == torch.int32


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
    a = ts.sample(logits, ts.batch_arrays(opts, [11, 12, 13, 14]))[0]
    b = ts.sample(logits, ts.batch_arrays(opts, [11, 12, 13, 14]))[0]
    assert torch.equal(a, b)
    draws = {int(ts.sample(logits, ts.batch_arrays(opts, [s, s, s, s]))[0][0]) for s in range(20)}
    assert len(draws) > 1  # different seeds, different draws
    assert int(a[3]) == int(logits[3].argmax())  # greedy row untouched by noise


@pytest.mark.parametrize("opts,keep", [
    (SamplingOptions(temperature=0.7), None),
    (SamplingOptions(temperature=1.0, top_k=3), 3),
])
def test_sampling_matches_softmax_distribution(opts, keep):
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -0.5, -1.0, 0.8, 0.0]])
    n = 4000
    arrays = ts.batch_arrays([opts] * n, list(range(1000, 1000 + n)))
    tok, lp = ts.sample(logits.expand(n, -1).contiguous(), arrays)
    freq = np.bincount(tok.numpy(), minlength=8) / n
    t = opts.temperature
    probs = torch.softmax(logits[0] / t, -1).numpy()
    if keep is not None:
        mask = np.zeros(8, bool)
        mask[np.argsort(-probs)[:keep]] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    np.testing.assert_allclose(freq, probs, atol=0.03)
    # the reported logprob is the unscaled distribution's
    ref_lp = torch.log_softmax(logits[0], -1)[tok.long()]
    np.testing.assert_allclose(lp.numpy(), ref_lp.numpy(), rtol=0, atol=1e-6)
