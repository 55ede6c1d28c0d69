"""The port's int8 KV quantization (dynamo_tpu_torch/ops/kv_quant.py)
against the reference's (dynamo_tpu/ops/kv_quant.py), on the same inputs.

Tolerance: int8 values equal (same f32 amax, same division, same
round-half-to-even and clip); scales within 1 f32 ulp (both are one f32
division of the same amax by 127)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import kv_quant as jq
from dynamo_tpu_torch.ops import kv_quant as tq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((24, 2, 16)) * rng.uniform(0.01, 5, (24, 2, 1))).astype(np.float32)
    x[3, 1] = 0.0  # all-zero row: the 1e-8 amax floor
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.dtype(dtype))
    q_t, s_t = tq.quantize_kv(xt)
    q_j, s_j = jq.quantize_kv(xj)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_max_ulp(s_t.numpy(), np.asarray(s_j), maxulp=1)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == (24, 2)


def test_scale_layout_helpers_match_reference():
    L, N, Hk, bs = 2, 6, 2, 8
    assert tq.kv_scale_shape(L, N, bs, Hk) == jq.kv_scale_shape(L, N, bs, Hk)
    rng = np.random.default_rng(1)
    slots = rng.integers(0, N * bs, (5, 7)).astype(np.int32)
    n_t, o_t = tq.scale_scatter_indices(torch.from_numpy(slots), bs)
    n_j, o_j = jq.scale_scatter_indices(jnp.asarray(slots), bs)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    scales = rng.uniform(0.1, 2, (N, Hk, bs)).astype(np.float32)
    g_t = tq.gather_slot_scales(torch.from_numpy(scales), torch.from_numpy(slots), bs, Hk)
    g_j = jq.gather_slot_scales(jnp.asarray(scales), jnp.asarray(slots), bs, Hk)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
