"""Sharding rules: param / cache / batch specs for a device mesh (port of
``repro/distributed/sharding.py``).

Strategy: FSDP over the `data` axis x tensor parallelism over the `model`
axis; batch over (`pod`, `data`). Expert parallelism puts the MoE expert
axis on `model`. Rules are path-based, so every family's param tree is
covered; an axis that is absent from the mesh, or does not divide its
dimension, is dropped (that dimension is replicated on it, as the JAX
package's rules do, where DTensor would shard it unevenly).

The core is pure: a spec is a tuple with one entry per tensor dimension, an
axis name, a tuple of axis names (one dimension over several axes, major
to minor) or None -- the entries of JAX's ``PartitionSpec`` -- computed from
the mesh's axis names and sizes alone (`mesh` may be a ``DeviceMesh`` or a
{name: size} mapping in mesh order). `placements` turns a spec into
DTensor placements on a ``DeviceMesh``, `distribute` / `gather` move a tree
of tensors to and from DTensors.

The port's counterpart of ``jax.set_mesh`` is `set_mesh`, the ambient mesh
that the MoE dispatch (``models.moe.moe_dispatch``) and the decode layer
(``models.layers.attention_decode_sublayer``) read: under it they run the
rank's share of an SPMD program (``distributed.collectives``). The JAX
package's `shard_hint` (a ``with_sharding_constraint``) has nothing to act
on in eager PyTorch and has no counterpart.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.optim.adamw import AdamWState

# (path regex, spec WITHOUT the stacked-layer axis). First match wins.
_PARAM_RULES: Tuple[Tuple[str, Optional[Tuple]], ...] = (
    # embeddings
    (r"embed/tok$",       ("model", "data")),     # (V, d): vocab-TP
    (r"embed/pos$",       (None, None)),
    (r"embed/unembed$",   ("data", "model")),     # (d, V)
    (r"enc_pos$",         (None, None)),
    (r"meta$",            (None, None)),
    (r"mm_proj$",         ("data", "model")),
    # attention
    (r"attn/wq$|xattn/wq$", ("data", "model")),
    (r"attn/wk$|xattn/wk$", ("data", "model")),
    (r"attn/wv$|xattn/wv$", ("data", "model")),
    (r"attn/wo$|xattn/wo$", ("model", "data")),
    (r"attn/qn_w$|attn/kn_w$", (None,)),
    # dense MLP
    (r"mlp/wi$",          ("data", "model")),
    (r"mlp/wo$",          ("model", "data")),
    # MoE
    (r"moe/router$",      ("data", None)),
    (r"moe/we_in$",       ("model", "data", None)),   # (E, d, ff)
    (r"moe/we_out$",      ("model", None, "data")),   # (E, ff, d)
    # rwkv time-mix / channel-mix (cm_* before the generic w[rkvg] rule)
    (r"cm_wk$",           ("data", "model")),
    (r"cm_wv$",           ("model", "data")),
    (r"cm_wr$",           ("data", "model")),
    (r"blocks/w[rkvg]$",  ("data", "model")),
    (r"blocks/wo$",       ("model", "data")),
    (r"tm_lora_down$|w_lora_down$", ("data", None)),
    (r"tm_lora_up$",      (None, None, "model")),
    (r"w_lora_up$",       (None, "model")),
    (r"w_base$",          ("model",)),
    (r"tm_mu$|cm_mu$",    (None, None)),
    (r"/u$",              (None, None)),
    (r"ln_x$",            ("model",)),
    # hymba mamba branch (d_inner sharded over model)
    (r"m_in$",            ("data", "model")),
    (r"m_conv$",          (None, "model")),
    (r"m_dt$",            (None, "model")),
    (r"m_dt_bias$",       ("model",)),
    (r"m_bc$",            ("model", None)),
    (r"m_A_log$",         ("model", None)),
    (r"m_D$",             ("model",)),
    (r"m_out$",           ("model", "data")),
    (r"fuse_na$|fuse_ns$", (None,)),
    (r"fuse_beta$",       (None,)),
    # norms and anything else 1-D: replicate
    (r".*",               None),
)

BATCH_AXES = ("pod", "data")


# ------------------------------------------------------------ mesh shape

def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: Optional[str]) -> int:
    """The size of axis `name`, 1 when it is None or not in the mesh."""
    if name is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Logical batch axes present in this mesh (pod first if multi-pod)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in BATCH_AXES if a in sizes)


def batch_size(mesh) -> int:
    """The number of batch shards: the product of the batch axes' sizes."""
    n = 1
    for a in batch_axes(mesh):
        n *= axis_size(mesh, a)
    return n


# ----------------------------------------------------------------- specs

def _path_str(path) -> str:
    return "/".join(path)


def _fit_spec(shape, raw_spec, sizes: Dict[str, int], stacked: bool) -> Tuple:
    """A spec of len(shape) entries, dropping axes that don't divide evenly
    or don't exist in the mesh, with None prepended for the stacked (L,)
    dimension."""
    if raw_spec is None:
        return (None,) * len(shape)
    dims = list(raw_spec)
    if stacked:
        dims = [None] + dims
    while len(dims) < len(shape):
        dims.append(None)
    dims = dims[: len(shape)]
    out = []
    for size, ax in zip(shape, dims):
        if ax is None or ax not in sizes or size % sizes[ax]:
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def param_specs(params_like, mesh):
    """A spec for each leaf of a params tree (tensors of any device, ``meta``
    included: only shapes are read), by the path rules."""
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        s = _path_str(path)
        stacked = "blocks/" in s or s.startswith("blocks")
        for pat, raw in _PARAM_RULES:
            if re.search(pat, s):
                return _fit_spec(tuple(leaf.shape), raw, sizes, stacked)
        return ()
    flat = T.flatten_with_path(params_like)
    return T.unflatten(params_like, [one(p, leaf) for p, leaf in flat])


def batch_specs(batch_like, mesh, *, shard_batch: bool = True):
    """Shard the leading batch dim of every batch leaf over (pod, data)."""
    baxes = batch_axes(mesh)
    bsize = batch_size(mesh)

    def one(leaf):
        if not shard_batch or leaf.ndim == 0 or leaf.shape[0] % bsize:
            return ()
        return (baxes,) + (None,) * (leaf.ndim - 1)
    return T.map(one, batch_like)


def cache_specs(cache_like, mesh):
    """KV caches: (L, B, S, Hkv, hd) -> batch over (pod, data), seq over
    model. SSM states: (L, B, ...) -> batch over (pod, data), the last
    dimension past B that model divides over model. `length`
    replicated."""
    baxes = batch_axes(mesh)
    bsize = batch_size(mesh)
    msize = axis_size(mesh, "model")

    def one(path, leaf):
        s = _path_str(path)
        if s == "length" or leaf.ndim <= 1:
            return ()
        dims: List[Any] = [None] * leaf.ndim
        bdim = 1 if leaf.ndim >= 2 else 0
        if leaf.shape[bdim] % bsize == 0 and bsize > 1:
            dims[bdim] = baxes
        if leaf.ndim == 5 and leaf.shape[2] % msize == 0:
            dims[2] = "model"
        elif leaf.ndim >= 3:
            for ax in range(leaf.ndim - 1, 1, -1):
                if leaf.shape[ax] % msize == 0 and msize > 1:
                    dims[ax] = "model"
                    break
        return tuple(dims)
    flat = T.flatten_with_path(cache_like)
    return T.unflatten(cache_like, [one(p, leaf) for p, leaf in flat])


def opt_specs(opt_like: AdamWState, pspecs) -> AdamWState:
    """AdamW state (step, m, v): m / v shard like params, step replicated."""
    def like(tree):
        return T.map(lambda _, sp: sp, tree, pspecs)
    return AdamWState(step=(), m=like(opt_like.m), v=like(opt_like.v))


# ------------------------------------------------------------ placements

def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """DTensor placements on `mesh` (a DeviceMesh) for `spec`: Shard(dim)
    on each mesh dimension the spec names, Replicate on the others. A
    tensor dimension over several axes keeps their major-to-minor order,
    which must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec!r}")
            out[i] = Shard(dim)
    return out


def distribute(tree, specs, mesh):
    """Each leaf (the whole tensor, the same on every rank) as a DTensor
    placed by its spec: the rank keeps a copy of its own shard, with no
    communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        pl = placements(spec, mesh)
        local = distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()
        return DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return T.map(one, tree, specs)


def gather(tree):
    """Every DTensor leaf gathered to the whole tensor (a collective: every
    rank of its mesh calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return T.map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                 tree)


def spec_of(t) -> Tuple:
    """The spec of a DTensor's placements (one entry a dimension: the axis
    name, a tuple of them major to minor, or None); all None for any other
    tensor."""
    from torch.distributed.tensor import DTensor
    spec: List[Any] = [None] * t.ndim
    if isinstance(t, DTensor):
        for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
            if p.is_shard():
                e = spec[p.dim]
                spec[p.dim] = name if e is None else axes_of(e) + (name,)
    return tuple(spec)


def to_local(t):
    """The rank's shard of a DTensor; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


# ------------------------------------------------------------- SPMD view

def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis `name` (0 when the axis is absent)."""
    if name not in axis_sizes(mesh):
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's line along axis `name`."""
    return mesh.get_group(name)


def batch_index(mesh) -> int:
    """This rank's batch shard: its (pod, data) coordinates, major to
    minor."""
    idx = 0
    for a in batch_axes(mesh):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def batch_rows(mesh, n_rows: int) -> slice:
    """The rows of a batch of `n_rows` that this rank holds (`batch_specs`:
    a batch that the batch axes do not divide is refused here, where the
    JAX package would replicate it)."""
    n = batch_size(mesh)
    if n_rows % n:
        raise ValueError(f"batch of {n_rows} not divisible by the mesh's "
                         f"{n} batch shards {batch_axes(mesh)}")
    b = n_rows // n
    i = batch_index(mesh)
    return slice(i * b, (i + 1) * b)


def from_rows(t: torch.Tensor, mesh, n_rows: int):
    """This rank's `batch_rows` of a (n_rows, ...) result as a DTensor of the
    whole, sharded over the batch axes (`batch_specs`)."""
    from torch.distributed.tensor import DTensor
    shape = (n_rows,) + tuple(t.shape[1:])
    spec = (batch_axes(mesh),) if batch_size(mesh) > 1 else ()
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


_MESH: List[Any] = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make `mesh` the ambient mesh for the body (``jax.set_mesh``)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The ambient mesh, or None outside `set_mesh`."""
    return _MESH[-1] if _MESH else None
