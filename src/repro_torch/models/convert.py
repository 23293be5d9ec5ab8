"""Parameters and optimizer state of the JAX package, as numpy arrays,
turned into the port's.

``params_from_jax(tree)`` takes the pytree that ``repro.models.transformer.
init_params`` returns, with every leaf already converted to a numpy array
(the caller does ``jax.tree.map(np.asarray, params)``; this module imports
no JAX), and returns the port's parameter dictionary: the same nested keys,
the same stacked (L, ...) block layout, the same values. Both packages then
compute the same function, which is what the differential tests compare.
``opt_from_jax`` does the same for an ``AdamWState`` of numpy leaves. A
bfloat16 leaf (``ml_dtypes.bfloat16``) comes across bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.optim.adamw import AdamWState


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A copy of the numpy array `a` on `device`, bfloat16 included."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected numpy leaves, got {type(a).__name__}")
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    return T.map(lambda a: tensor_from_numpy(a, device), tree)


def opt_from_jax(state, device="cuda") -> AdamWState:
    """The port's AdamWState from the JAX package's, with numpy leaves
    (``jax.tree.map(np.asarray, opt_state)``): step, m and v."""
    step, m, v = state
    return AdamWState(step=tensor_from_numpy(np.asarray(step), device),
                      m=params_from_jax(m, device),
                      v=params_from_jax(v, device))
