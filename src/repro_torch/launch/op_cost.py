"""Per-rank cost of one step, counted op by op (the port's counterpart of
``repro/launch/hlo_cost.py``).

The JAX dry run parses the compiled HLO. Eager PyTorch has no HLO: here one
``TorchDispatchMode`` sees each aten op as the step dispatches it (on fake
tensors, ``launch.specs``) and counts it with ``hlo_cost``'s definitions:

  * flops: matmul-class ops only, 2 x result numel x contraction size
    (``torch.utils.flop_counter``'s formulas), the bfloat16 / float16 ones
    (tensor cores) apart from the others (FP32 on the CUDA cores: the port
    turns TF32 off); elementwise flops are ignored;
  * bytes: 2 x result bytes of every op that makes a tensor (write + read
    proxy), an in-place op charged what it writes, views nothing, plus the
    step's arguments read once;
  * collective bytes by category (all-gather, all-reduce, reduce-scatter,
    all-to-all, send-recv in place of collective-permute), the
    result-shape bytes of each ``c10d`` / ``c10d_functional`` op, and the
    largest single result of each category;
  * memory: the live storages over the step, the arguments registered
    first, giving JAX's ``memory_analysis`` record: argument, output,
    temp and alias bytes and their peak;
  * matmul argument bytes: the arguments (each storage once) that a
    matmul-class op reads directly or through a view. On a one-rank mesh,
    where gathering a DTensor returns its own storage, that is every
    weight the step multiplies: a floor on its bytes from HBM.

A Python loop runs its body once a pass, so every pass is counted: there
is no trip-count problem. A DTensor op is counted on its local shards; the
steps compute on local tensors, and an implicit redistribution inside a
DTensor op would not be seen (none is on the dry run's paths).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "send-recv")
_COLL_NAMES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("send", "send-recv"), ("recv", "send-recv"))
_COLL_NS = ("c10d", "_c10d_functional", "c10d_functional")
_LOW = (torch.bfloat16, torch.float16)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(x) -> List[torch.Tensor]:
    return [_local(t) for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str | None:
    """The category of a collective op, None for any other op."""
    if func.namespace not in _COLL_NS:
        return None
    name = func._schema.name.split("::")[-1]
    if name.startswith("wait"):
        return None
    for key, kind in _COLL_NAMES:
        if key in name:
            return kind
    return None


class OpCost(TorchDispatchMode):
    """Counts flops, bytes, collective bytes and live memory of the ops
    dispatched under it. `arguments(tree)` registers the step's inputs
    before it runs; `record(outputs)` gives the totals after."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops_bf16 = 0.0
        self.flops_fp32 = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.coll_max = {k: 0.0 for k in COLLECTIVES}
        self._live: Dict[int, int] = {}
        self._fin: Dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args: Dict[int, int] = {}
        self._multiplied: Dict[int, int] = {}

    # ------------------------------------------------------------ memory

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._fin[key] = weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._fin.pop(key, None)

    def _hand_over(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """`dst` is `src` (a collective's wait returns its input, where a
        fake tensor's wait makes a new one): its storage takes over src's
        count, so the fake copy adds no bytes."""
        old, new = src.untyped_storage(), dst.untyped_storage()
        if old is new or id(old) not in self._live or id(new) in self._live:
            return
        n = self._live.pop(id(old))
        self._fin.pop(id(old)).detach()
        self._live[id(new)] = n
        self._fin[id(new)] = weakref.finalize(new, self._free, id(new))

    def arguments(self, tree) -> None:
        """Register the step's inputs: live from the start, read once."""
        for t in _tensors(tree):
            key = self._track(t)
            if key not in self._args:
                self._args[key] = self._live[key]
                self.bytes += self._live[key]

    # -------------------------------------------------------------- count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        outs = _tensors(out)
        if not outs:
            return out
        if func.namespace in _COLL_NS and func._schema.name.endswith(
                "wait_tensor"):
            self._hand_over(_tensors(args)[0], outs[0])
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            ins = _tensors(args)
            n = self._flops[packet](*tree_map(_local, args),
                                    **tree_map(_local, kwargs),
                                    out_val=tree_map(_local, out))
            if ins and ins[0].dtype in _LOW:
                self.flops_bf16 += n
            else:
                self.flops_fp32 += n
            for t in ins:
                key = id(t.untyped_storage())
                if key in self._args:
                    self._multiplied[key] = self._args[key]
        kind = _collective_kind(func)
        if kind is not None:
            n = sum(_nbytes(t) for t in outs)
            self.coll[kind] += n
            self.coll_max[kind] = max(self.coll_max[kind], n)
        rets = func._schema.returns
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets):
            return out                                   # a view
        written = sum(_nbytes(t) for t in outs)
        if any(r.alias_info is not None and r.alias_info.is_write
               for r in rets):
            mutated = {id(t.untyped_storage()) for t in outs}
            src = sum(_nbytes(t) for t in _tensors((args, kwargs))
                      if id(t.untyped_storage()) not in mutated)
            if src:
                written = min(written, src)
        self.bytes += 2 * written
        for t in outs:
            self._track(t)
        return out

    # ------------------------------------------------------------- result

    def record(self, outputs) -> Dict[str, Any]:
        """The totals: flops (and their split), bytes, collectives and the
        memory record of JAX's dry run."""
        arg = sum(self._args.values())
        seen: Dict[int, int] = {}
        for t in _tensors(outputs):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        out = sum(seen.values())
        alias = sum(n for k, n in seen.items() if k in self._args)
        temp = max(0, self.peak_bytes - arg - (out - alias))
        coll = dict(self.coll)
        return {
            "flops": self.flops_bf16 + self.flops_fp32,
            "flops_bf16": self.flops_bf16,
            "flops_fp32": self.flops_fp32,
            "bytes": self.bytes,
            "collectives": coll,
            "collective_bytes": sum(coll.values()),
            "collective_max": dict(self.coll_max),
            "matmul_argument_bytes": sum(self._multiplied.values()),
            "memory": {"argument_bytes": arg, "output_bytes": out,
                       "temp_bytes": temp, "alias_bytes": alias,
                       "peak_bytes_est": arg + out + temp - alias},
        }


def analyze(step, args, mode):
    """(outputs, record): step(*args) run under `mode` (the fake mode the
    arguments were made in) and counted by an `OpCost`."""
    cost = OpCost()
    cost.arguments(args)
    with mode, cost:
        out = step(*args)
    return out, cost.record(out)
