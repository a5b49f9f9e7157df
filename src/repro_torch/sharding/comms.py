"""Collectives per step, and a sum over ranks that autograd can run.

`all_sum(x, group)` adds `x` over the ranks of `group`; every rank then
holds the same sum and goes on alike, so the loss reads it once and the
gradient of each rank's part is the sum's own gradient (the identity).
The model's manual vocab-parallel lookup and loss and the pipeline's
output use it.

`StepCommMode` counts each collective that runs under it, as
`torch.distributed.tensor.debug.CommDebugMode` does: DTensor's
redistributions (the functional collectives they lower to) and direct
`torch.distributed` calls (the `c10d` ops) alike. It also adds up each
collective's output bytes by the reference's five kinds (`all-gather`,
`all-reduce`, `reduce-scatter`, `all-to-all`, `collective-permute`, and
`total`), as `repro.launch.dryrun.collective_bytes` reads them from the
compiled HLO: the gathered tensor of an all-gather, the reduced one of an
all-reduce, this rank's shard of a reduce-scatter, the received tensor
of an all-to-all, the received one of a point-to-point exchange (a
send is counted and adds no bytes: they are its receiver's output).

`CommDebugMode` itself cannot watch a train step: its module tracker
adds a forward hook to a module each time the module runs, so a layer
that runs once per microbatch pops its parent twice, and an op outside
every module (the optimizer's) has no parent to count under.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_NOT_COLLECTIVES = ("wait_tensor", "barrier", "monitored_barrier",
                    "_wrap_tensor_autograd")
# collective name (trailing "_" stripped) -> the reference's kind
KINDS = {
    **dict.fromkeys(("all_gather_into_tensor", "all_gather",
                     "all_gather_into_tensor_coalesced", "allgather",
                     "_allgather_base", "allgather_into_tensor_coalesced",
                     "allgather_coalesced"), "all-gather"),
    **dict.fromkeys(("all_reduce", "all_reduce_coalesced", "allreduce",
                     "allreduce_coalesced"), "all-reduce"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter",
                     "reduce_scatter_tensor_coalesced",
                     "_reduce_scatter_base"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "all_to_all", "alltoall_base",
                     "alltoall"), "all-to-all"),
    **dict.fromkeys(("send", "recv", "isend", "irecv", "recv_any_source"),
                    "collective-permute"),
}
# point-to-point sends: counted, but their bytes are the receiver's output
_SENDS = ("send", "isend")


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepCommMode(TorchDispatchMode):
    """Counts collectives by op name while it is active."""

    def __init__(self):
        super().__init__()
        self.comm_counts: Counter = Counter()
        self.comm_bytes: Counter = Counter()
        self.by_op: Counter = Counter()
        self._op = "outside DTensor"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            # let DTensor lower the op first; its collectives come back
            # here, and are put down to this op
            self._op = str(func._overloadpacket)
            return NotImplemented
        ns, name = func._overloadpacket._qualified_op_name.split("::")
        out = func(*args, **(kwargs or {}))
        if ns in _NAMESPACES and name not in _NOT_COLLECTIVES:
            name = name.rstrip("_")
            self.comm_counts[name] += 1
            self.by_op[(self._op, name)] += 1
            # functional ops return their output; c10d ops write into
            # their first argument (the output tensors) and return a work
            b = 0 if name in _SENDS else \
                _nbytes(out if ns != "c10d" else args[0])
            self.comm_bytes[KINDS.get(name, name)] += b
            self.comm_bytes["total"] += b
        return out

    def counts(self) -> Dict[str, int]:
        """{collective name: count}, by name."""
        return dict(sorted(self.comm_counts.items()))

    def bytes_by_kind(self) -> Dict[str, int]:
        """{the reference's kind, or the collective's own name where it has
        none: output bytes}, and "total"; empty where none ran."""
        return dict(sorted(self.comm_bytes.items()))

    def counts_by_op(self) -> Dict[str, int]:
        """{"<DTensor op that redistributed> <collective>": count}; direct
        `torch.distributed` calls and redistributions that no op asked
        for are put down to the last DTensor op seen before them."""
        return {f"{op} {c}": n for (op, c), n in sorted(self.by_op.items())}

    def get_total_counts(self) -> int:
        return sum(self.comm_counts.values())


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (module docstring)."""
    return _AllSum.apply(x, group)
