"""Parameters of the JAX package, as numpy arrays, turned into the port's.

``params_from_jax(tree)`` takes the pytree that ``repro.models.transformer.
init_params`` returns, with every leaf already converted to a numpy array
(the caller does ``jax.tree.map(np.asarray, params)``; this module imports
no JAX), and returns the port's parameter dictionary: the same nested keys,
the same stacked (L, ...) block layout, the same values. Both packages then
compute the same function, which is what the differential tests compare.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .transformer import map_params


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    def leaf(a):
        if not isinstance(a, np.ndarray):
            raise TypeError(f"expected numpy leaves, got {type(a).__name__}")
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return map_params(tree, leaf)
