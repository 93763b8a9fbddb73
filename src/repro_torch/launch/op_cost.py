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
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch
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


def storage_bytes(nbytes: int) -> int:
    """A storage's bytes as the card's allocator counts them."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class OpCost(TorchDispatchMode):
    """Counts one step run inside ``with OpCost(live=...) as cost:``.

    ``live`` holds the tensors already alive that the step reads (a pytree
    of tensors), counted at the start of ``peak_bytes``.  After the block:
    ``flops``, ``bytes``, ``peak_bytes``, ``live_bytes`` (the start),
    ``kernels`` (name -> [calls, flops, bytes]) and :meth:`by_op`."""

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
        for t in _tensors(live):
            self._track(t, "arguments")
        self.live_bytes = self.current_bytes

    # -- storages ------------------------------------------------------------

    def _track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
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
        packet = func.overloadpacket
        name = self._kernel or str(packet).removeprefix("aten.")
        for t in outs:
            self._track(t, name)
        if self._in_kernel or func.is_view or packet in _NOT_COUNTED:
            return out
        ins = _tensors((args, kwargs))
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
