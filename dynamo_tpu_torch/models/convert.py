"""Carry parameters and caches across from numpy (e.g. the reference
package's arrays, via ``np.asarray`` on each leaf) to the port's tensors,
with the same names, shapes and dtypes.

bf16 numpy arrays (the ``bfloat16`` extension dtype) cannot go through
``torch.from_numpy``; their bits go as int16 and are reinterpreted.

``device`` is required: the port runs on ``cuda`` unless the caller asks
for ``"cpu"``, and a conversion must not pick the CPU on its own.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """One array -> tensor on ``device``, bit-exact (bf16 included)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a device buffer: own a copy
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bf16 comes back as its raw bits (uint16), which
    a caller with the bfloat16 numpy dtype can view as such."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(
    np_params: dict[str, np.ndarray], device: str | torch.device
) -> dict[str, torch.Tensor]:
    return {name: tensor_from_numpy(a, device) for name, a in np_params.items()}


def cache_from_numpy(np_cache, device: str | torch.device):
    """A cache as an array, or an int8 (values, scales) pair of arrays."""
    if isinstance(np_cache, tuple):
        return tuple(tensor_from_numpy(a, device) for a in np_cache)
    return tensor_from_numpy(np_cache, device)
