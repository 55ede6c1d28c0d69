"""Carrying the reference's parameters and caches across to the port
(dynamo_tpu_torch/models/convert.py): names, shapes, dtypes and bits
survive the trip, bf16 included."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.quant import init_params_quantized as j_init_q
from dynamo_tpu_torch.models.convert import (
    cache_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)

_DTYPES = {
    "bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8,
}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _roundtrip(np_params: dict) -> None:
    tp = params_from_numpy(np_params, "cpu")
    assert list(tp) == list(np_params)
    for name, a in np_params.items():
        t = tp[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == _DTYPES[a.dtype.name], name
        np.testing.assert_array_equal(tensor_to_numpy(t), _bits(a), err_msg=name)


def test_bf16_params_roundtrip_bit_exact():
    mc = JModelConfig(**CFG)
    _roundtrip({k: np.asarray(v) for k, v in jl.init_params(mc, seed=0).items()})


def test_int8_params_roundtrip_bit_exact():
    mc = JModelConfig(**CFG)
    _roundtrip({k: np.asarray(v) for k, v in j_init_q(mc, seed=1).items()})


def test_cache_roundtrip_bf16_and_int8_pairs():
    mc = JModelConfig(**CFG)
    k, _ = jl.init_cache(mc, 4, 8, dtype=jnp.bfloat16)
    kc = cache_from_numpy(np.asarray(k).copy(), "cpu")
    assert kc.dtype == torch.bfloat16 and tuple(kc.shape) == (2, 32, 2, 16)
    (kv, ks), _ = jl.init_cache(mc, 4, 8, dtype=jnp.int8)
    pair = cache_from_numpy((np.asarray(kv), np.asarray(ks)), "cpu")
    assert isinstance(pair, tuple)
    assert pair[0].dtype == torch.int8 and pair[1].dtype == torch.float32
    assert tuple(pair[1].shape) == (2, 4, 2, 8)


def test_bf16_special_values_survive():
    a = np.array([0.0, -0.0, 1.5, -3.25e-3, np.inf, -np.inf, 1e38], np.float32).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("convert", [params_from_numpy, cache_from_numpy, tensor_from_numpy])
def test_device_must_be_named(convert):
    # the port runs on cuda unless asked for the cpu: no quiet default
    arg = {"w": np.zeros(2, np.float32)} if convert is params_from_numpy else np.zeros(2, np.float32)
    with pytest.raises(TypeError):
        convert(arg)
