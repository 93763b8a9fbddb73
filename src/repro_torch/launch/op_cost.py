"""Operator cost counter: the FLOPs, bytes and peak memory of one step.

The H100 counterpart of ``repro.launch.hlo_cost``.  The reference parses
XLA's compiled HLO and corrects its cost analysis for loop trip counts.
PyTorch runs eagerly and has no HLO, so nothing is translated: :class:`OpCost`
is a ``TorchDispatchMode`` that sees every ATen operator a step runs (the
backward's too) and the hand-written kernels' own reports.  The same step
gives the same ``flops`` and ``bytes`` on the card, on the CPU and on
``meta`` (``launch/dryrun.py`` runs it there, allocating nothing).

- ``flops``: ``torch.utils.flop_counter``'s registered formulas for the
  ATen matrix, convolution and attention operators, plus each kernel's
  reported FLOPs (``kernels/_lib.reported``; #8 and its backward).
  Elementwise work counts in bytes only.  XLA's ``flops`` also counts
  elementwise operations, so the two differ by that work (ROADMAP C35).
- ``bytes``: the tensor inputs plus outputs of every ATen operator that is
  not a view or a metadata or allocation operator, plus each kernel's
  reported bytes.  An in-place scatter (``index_copy_``, ``index_put_``,
  ...) counts its index and source read and the source's bytes written,
  not its whole destination: it touches only those slots, as XLA counts a
  dynamic-update-slice.
- Inside a kernel's report the plain operators its wrapper runs (its plain
  version on the CPU) are not counted, so every device counts the kernel
  alike.
- ``peak_bytes``: the high-water mark of live storage bytes, each storage
  rounded up to the card allocator's 512-byte blocks, from the storages
  given as ``live`` (the step's parameters, state and inputs) plus every
  storage an operator makes, until ``weakref.finalize`` sees it freed.
  ``meta`` storages all have ``data_ptr`` 0, so they are keyed by their
  Python storage object.
  ``peak_by_op`` splits the peak by what made each live storage
  (``arguments`` for ``live``, else the operator or kernel).
- ``by_op``: the operators that moved the most bytes and did the most
  FLOPs.

Eager PyTorch executes every layer and every chunk, so each is counted as
it runs: the reference's trip-count machinery (``hlo_cost.py:61-267``) has
no counterpart here.

A sharded step (DTensors on a ``DeviceMesh``, ``launch/steps.place``) is
counted as one device runs it, which is what the reference reads from its
post-SPMD HLO:

- an operator on DTensors is not counted itself: the mode hands it to
  DTensor (``NotImplemented``), and counts the operators DTensor runs on
  the local shards, with the shards' shapes;
- DTensor's sharding propagation runs operators at the global shapes,
  on ``FakeTensor``s or (through a decomposition, torch 2.13) on ``meta``
  tensors that carry a ``_spec`` and that it allocates, beside the small
  CPU tensors of the one-device mesh it traces on: those are neither
  counted nor tracked (``tests/test_torch_sharded.py`` holds the peak of
  such a step to a hand count, so a torch that moves the propagation out
  of the frames :func:`_in_sharding_propagation` knows fails there);
- each collective DTensor issues (a ``_c10d_functional`` operator, or its
  own ``_dtensor.shard_dim_alltoall``) is recorded in
  ``collectives`` under the reference's keys (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``): ``count``, ``operand_bytes`` (the local input)
  and ``wire_bytes`` by the reference's ring model
  (``repro.launch.dryrun.parse_collectives``) with n the size of the
  collective's group, plus ``total_operand_bytes`` and
  ``total_wire_bytes``.  Collectives add to neither ``flops`` nor
  ``bytes``; what they allocate counts toward the peak.
"""

from __future__ import annotations

import sys
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _lib

ALLOC_BLOCK = 512  # the CUDA caching allocator rounds every block up to this

_aten = torch.ops.aten
# operators that move no element: metadata, allocation, and views the
# schema does not mark as views
_NOT_COUNTED = {
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
    _aten.size, _aten.stride, _aten.is_same_size, _aten.empty, _aten.empty_like,
    _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
    _aten.lift_fresh, _aten.resize_, _aten.set_,
}
# in-place scatters: the first argument is written only where the index says
_SCATTERS = {
    _aten.index_copy_, _aten.index_put_, _aten._index_put_impl_, _aten.index_add_,
    _aten.scatter_, _aten.scatter_add_, _aten.scatter_reduce_,
}


# the reference's collective ops and ring-model wire factors for a group of
# n devices (``repro.launch.dryrun.parse_collectives``)
COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
RING_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: float(n - 1),
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}
# ``_c10d_functional`` operators (what DTensor issues) -> the reference's op
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own (``_dtensor``), Shard(i) -> Shard(j)
}


def empty_collectives() -> dict:
    """The reference's collectives record with nothing in it."""
    out = {op: {"count": 0, "operand_bytes": 0, "wire_bytes": 0} for op in COLL_OPS}
    out["total_operand_bytes"] = out["total_wire_bytes"] = 0
    return out


def _group_size(args) -> int:
    """The size of the process group a collective's call names (its last
    argument: a group's name, or the group)."""
    group = args[-1]
    if isinstance(group, str):
        group = dist.distributed_c10d._resolve_process_group(group)
    return group.size()


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the Python stack: it
    allocates ``meta`` tensors at the global shape, and the CPU tensors of
    a one-device mesh, to trace an operator's decomposition
    (``torch/distributed/tensor/_decompositions.py``)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "distributed/tensor/" in name and name.endswith(("_decompositions.py",
                                                            "_sharding_prop.py")):
            return True
        f = f.f_back
    return False


def storage_bytes(nbytes: int) -> int:
    """A storage's bytes as the card's allocator counts them."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _plain(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor that holds ``t``'s elements: a DTensor's local shard,
    the tensor an ``AsyncCollectiveTensor`` (a collective's result in
    flight) wraps."""
    while isinstance(t, (DTensor, AsyncCollectiveTensor)):
        t = t.to_local() if isinstance(t, DTensor) else t.elem
    return t


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class OpCost(TorchDispatchMode):
    """Counts one step run inside ``with OpCost(live=...) as cost:``.

    ``live`` holds the tensors already alive that the step reads (a pytree
    of tensors), counted at the start of ``peak_bytes``.  After the block:
    ``flops``, ``bytes``, ``peak_bytes``, ``live_bytes`` (the start),
    ``kernels`` (name -> [calls, flops, bytes]), ``collectives`` and
    :meth:`by_op`.  A DTensor in ``live`` counts its local shard."""

    def __init__(self, live=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, list] = {}
        self._op_bytes: Counter = Counter()
        self._op_flops: Counter = Counter()
        self._in_kernel = 0
        self._kernel = None
        self._entered = 0
        self._live: dict[int, tuple] = {}
        self._live_by_op: Counter = Counter()
        self.peak_by_op: Counter = Counter()
        self.current_bytes = self.peak_bytes = 0
        self.collectives = empty_collectives()
        for t in _tensors(live):
            self._track(t, "arguments")
        self.live_bytes = self.current_bytes

    # -- storages ------------------------------------------------------------

    def _track(self, t: torch.Tensor, op: str) -> None:
        st = _plain(t).untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = storage_bytes(st.nbytes())
        self._live[key] = (n, op)
        self._live_by_op[op] += n
        self.current_bytes += n
        if self.current_bytes > self.peak_bytes:
            self.peak_bytes = self.current_bytes
            self.peak_by_op = +self._live_by_op
        weakref.finalize(st, self._free, key)

    def _alias(self, src: torch.Tensor, dst: torch.Tensor, op: str) -> None:
        """``dst`` holds ``src``'s elements (a collective's ``wait_tensor``
        or autograd wrapper): on ``meta`` it has a storage of its own, which
        takes over ``src``'s entry, so the bytes count once."""
        src_st, dst_st = _plain(src).untyped_storage(), _plain(dst).untyped_storage()
        if id(src_st) == id(dst_st) or id(dst_st) in self._live:
            return
        entry = self._live.pop(id(src_st), None)
        if entry is None:
            self._track(dst, op)
            return
        self._live[id(dst_st)] = entry
        weakref.finalize(dst_st, self._free, id(dst_st))

    def _free(self, key: int) -> None:
        n, op = self._live.pop(key, (0, None))
        if op is not None:
            self.current_bytes -= n
            self._live_by_op[op] -= n

    # -- kernels (``_lib.reported``) -----------------------------------------

    def kernel_enter(self, name: str, flops: int, nbytes: int) -> None:
        if self._in_kernel == 0:
            row = self.kernels.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
            self.flops += flops
            self.bytes += nbytes
            if flops:
                self._op_flops[f"kernel {name}"] += flops
            self._op_bytes[f"kernel {name}"] += nbytes
            self._kernel = f"kernel {name}"
        self._in_kernel += 1

    def kernel_exit(self) -> None:
        self._in_kernel -= 1
        if self._in_kernel == 0:
            self._kernel = None

    # -- the mode --------------------------------------------------------------

    def __enter__(self):
        self._entered += 1
        if self._entered == 1:
            _lib.cost_sinks.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if self._entered == 0:
            _lib.cost_sinks.remove(self)
        return super().__exit__(*exc)

    def _collective(self, func, args, ins) -> None:
        op = _COLLECTIVE_OF[func.overloadpacket.__name__]
        n = _group_size(args)
        operand = _nbytes(ins)
        row = self.collectives[op]
        row["count"] += 1
        row["operand_bytes"] += operand
        row["wire_bytes"] += int(operand * RING_FACTOR[op](n))
        self.collectives["total_operand_bytes"] += operand
        self.collectives["total_wire_bytes"] += int(operand * RING_FACTOR[op](n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, (DTensor, AsyncCollectiveTensor)) for t in ins):
            # DTensor (or a collective's result) runs it; the operators and
            # collectives it runs on plain tensors come back here
            return NotImplemented
        if any(isinstance(t, FakeTensor) or hasattr(t, "_spec") for t in ins) or (
                all(t.device.type == "cpu" for t in ins) and _in_sharding_propagation()):
            # DTensor's sharding propagation: FakeTensors, or meta tensors
            # at the global shape that carry a spec (through decompositions)
            # and the allocations that make them, or its mesh's CPU tensors
            return func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "_dtensor"):
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if name in _COLLECTIVE_OF:
                self._collective(func, args, ins)
                for t in _tensors(out):
                    self._track(t, name)
            else:  # wait_tensor, the autograd wrapper: the same elements
                self._alias(ins[0], _tensors(out)[0], name)
            return out
        if func._can_decompose():
            # a composite operator (``matmul``, ``softmax`` ... under
            # ``inference_mode``): count the operators it decomposes into,
            # as autograd does where a gradient is wanted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # an allocation of DTensor's sharding propagation
        packet = func.overloadpacket
        name = self._kernel or str(packet).removeprefix("aten.")
        for t in outs:
            self._track(t, name)
        if self._in_kernel or func.is_view or packet in _NOT_COUNTED:
            return out
        if packet in _SCATTERS:
            nbytes = _nbytes(ins[1:]) + _nbytes(ins[-1:])
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.bytes += nbytes
        self.flops += flops
        self._op_bytes[name] += nbytes
        if flops:
            self._op_flops[name] += flops
        return out

    def by_op(self, n: int = 10) -> dict:
        """The ``n`` operators (and kernels) that moved the most bytes and
        did the most FLOPs: ``{"bytes": [[name, bytes], ...], "flops":
        [...]}``."""
        return {"bytes": [list(kv) for kv in self._op_bytes.most_common(n)],
                "flops": [list(kv) for kv in self._op_flops.most_common(n)]}
