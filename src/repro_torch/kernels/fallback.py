"""Degradation-ladder twins of the fused sweeps.

Counterpart of ``repro.kernels.fallback``.  When a launch of a hand-written
kernel fails at serving time, :class:`repro_torch.launch.spatial_serve.
SpatialServer` retries the batch on the next rung of its ladder
``cuda → torch → host``:

* **cuda rung** — :data:`SEARCHES`: the sweep of
  :mod:`repro_torch.kernels.pyramid_scan` with ``engine="kernel"`` (kernels
  #1 and #3 on a CUDA tensor);
* **torch rung** — the same function with ``engine="torch"``: the port's
  plain PyTorch version of each kernel, on the index's device (there is no
  third copy of the sweep here);
* **host rung** — the same sweep in numpy on host copies of the arrays,
  the last resort when the device path itself fails.

:data:`FALLBACKS` maps ``(precision, live)`` to ``(torch twin, host twin)``
as the reference's table does.  Every twin is called as ``twin(queries,
inputs, *, block_w)``, where ``inputs`` is what the cuda rung sweeps: a
:class:`~repro_torch.core.flat.LevelSchedule` (pristine float32), a
:class:`~repro_torch.core.flat.QuantizedSchedule` (pristine compact and
compact8) or an :class:`~repro_torch.update.buffer.AugmentedArrays`
(live).  The host twins take the same objects with their tensors on the
CPU (:func:`to_host`) and return numpy arrays.  Every twin reproduces the
kernel's recurrence exactly — root slot unconditional (tree schedules),
parent-gated overlap per level, flat unconditional delta levels from
``base_levels``, per-object confirming pass, tombstone mask — so degraded
answers equal the healthy path's hits and per-level visits bit for bit;
only latency changes.  The reference's memory-bounded ``stream=True`` host
twin is not needed here: the server never streams.

:data:`JOIN_FALLBACKS` does the same for ``SpatialIndex.join``: the torch
twin is :func:`~repro_torch.kernels.join_scan.fused_join` with
``engine="torch"`` (``pair_sweep_torch``), the host twin a numpy pair
sweep before the shared epilogue on CPU tensors.

:func:`run_ladder` walks a ladder for both callers: the rungs, the retries
with backoff, the trace events, the warning on every degrade and the
ledger.  On a CUDA device it counts only an injected
:class:`repro_torch.ft.InjectedFailure` as a rung failure; a real error
there raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings

import numpy as np
import torch

from repro_torch.ft.failures import InjectedFailure
from repro_torch.obs import trace as _trace

from .join_scan import fused_join, join_epilogue
from .pyramid_scan import (
    fused_search_compact_live,
    fused_search_live,
    pyramid_scan,
    pyramid_scan_compact,
    pyramid_scan_compact8,
)


def _overlap(a, b):
    """Closed-boundary rectangle intersection, broadcasting (numpy; the
    integer grid of the compact path too, where <= and & mean the same)."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def to_host(inputs):
    """Host copies of a rung's ``inputs`` (a schedule, a quantized
    schedule or an ``AugmentedArrays``): the same object with every tensor
    on the CPU."""
    if hasattr(inputs, "arrays"):  # AugmentedArrays
        return dataclasses.replace(inputs, arrays=tuple(a.cpu() for a in inputs.arrays))
    return inputs.to("cpu")


# ---------------------------------------------------------------------------
# cuda rung and torch twin: the port's sweep, by engine
# ---------------------------------------------------------------------------


def search_f32(queries, sched, *, block_w: int = 128, engine: str = "kernel"):
    return pyramid_scan(sched, queries, block_w=block_w, engine=engine)


def search_compact(queries, qsched, *, block_w: int = 128, engine: str = "kernel"):
    return pyramid_scan_compact(qsched, queries, block_w=block_w, engine=engine)


def search_compact8(queries, qsched, *, block_w: int = 128, engine: str = "kernel"):
    return pyramid_scan_compact8(qsched, queries, block_w=block_w, engine=engine)


def search_live(queries, aug, *, block_w: int = 128, engine: str = "kernel"):
    fn = fused_search_compact_live if aug.precision == "compact" else fused_search_live
    return fn(queries, *aug.arrays, block_w=block_w, engine=engine, **aug.statics)


# variant key -> the cuda rung's sweep
SEARCHES = {
    ("float32", False): search_f32,
    ("compact", False): search_compact,
    ("compact8", False): search_compact8,
    ("float32", True): search_live,
    ("compact", True): search_live,
}


# ---------------------------------------------------------------------------
# host twin: the same sweep in numpy
# ---------------------------------------------------------------------------


def _quantize_queries_np(queries, origin, inv_cell, cells):
    """Outward query quantization of the compact sweep (floor lo, ceil hi,
    clip), in float32 as the device does it."""
    t = (queries - origin[None, :]) * inv_cell[None, :]
    qq = np.concatenate([np.floor(t[:, :2]), np.ceil(t[:, 2:])], axis=1)
    return np.clip(qq, 0.0, float(cells)).astype(np.int32)


def _level_act(ov, prev, parent_l, *, l, nq, w, root_unconditional, uncond_from):
    """One level of the sweep recurrence — identical on every rung."""
    if l == 0:
        if root_unconditional and uncond_from > 0:
            act = np.zeros((nq, w), bool)
            act[:, 0] = True
        else:
            act = ov
    elif l >= uncond_from:
        act = ov  # flat delta level: no parent gate
    else:
        act = ov & prev[:, parent_l]
    return act


def _sweep_np(queries, mbr_cm, parent, *, root_unconditional, uncond_from):
    """(L, Q, W) active mask of the one-grid sweep."""
    levels, _, w = mbr_cm.shape
    mbr_rm = mbr_cm.transpose(0, 2, 1)  # (L, W, 4)
    nq = queries.shape[0]
    uncond_from = levels if uncond_from is None else uncond_from
    acts = np.zeros((levels, nq, w), bool)
    prev = None
    for l in range(levels):
        ov = _overlap(mbr_rm[l][None, :, :], queries[:, None, :])
        acts[l] = _level_act(ov, prev, parent[l], l=l, nq=nq, w=w,
                             root_unconditional=root_unconditional,
                             uncond_from=uncond_from)
        prev = acts[l]
    return acts


def _sweep_hier(qq8, qq16, mbr8, mbr16, parent, *, root_unconditional):
    """(L, Q, W) active mask of the hierarchical (uint8 upper / uint16
    lower) sweep."""
    l8 = mbr8.shape[0]
    levels = l8 + mbr16.shape[0]
    nq = qq16.shape[0]
    w = mbr16.shape[2]
    acts = np.zeros((levels, nq, w), bool)
    prev = None
    for l in range(levels):
        if l < l8:
            ov = _overlap(mbr8[l].T.astype(np.int32)[None, :, :], qq8[:, None, :])
        else:
            ov = _overlap(mbr16[l - l8].T.astype(np.int32)[None, :, :], qq16[:, None, :])
        acts[l] = _level_act(ov, prev, parent[l], l=l, nq=nq, w=w,
                             root_unconditional=root_unconditional, uncond_from=levels)
        prev = acts[l]
    return acts


def _finish(queries, act, obj_level, obj_slot, gate_mbr, obj_id, n_objects, alive=None):
    """Shared epilogue: per-level visits, entry activity, exact confirm
    gate, global-id scatter, tombstones."""
    visits = act.sum(axis=2).T.astype(np.int32)
    hit = act[obj_level, :, obj_slot].T  # (Q, E)
    if gate_mbr is not None:
        hit = hit & _overlap(gate_mbr[None, :, :], queries[:, None, :])
    hits = np.zeros((queries.shape[0], max(n_objects, 1)), bool)
    # OR the entries of each id (tree schedules and live sentinels repeat
    # ids): every write stores True, so repeats cannot race
    qi, ei = np.nonzero(hit)
    hits[qi, obj_id[ei]] = True
    if alive is not None:
        hits &= alive[None, :]
    return hits, visits


def search_f32_np(queries, sched, *, block_w: int = 128):
    del block_w  # kernel-only tiling
    queries = np.asarray(queries, np.float32)
    act = _sweep_np(queries, _np(sched.mbr_cm), _np(sched.parent).astype(np.int64),
                    root_unconditional=sched.root_unconditional, uncond_from=None)
    return _finish(queries, act, _np(sched.obj_level), _np(sched.obj_slot),
                   _np(sched.obj_mbr) if sched.test_object_mbr else None,
                   _np(sched.obj_id), sched.n_objects)


def search_compact_np(queries, qsched, *, block_w: int = 128):
    del block_w
    base = qsched.base
    queries = np.asarray(queries, np.float32)
    qq = _quantize_queries_np(queries, _np(qsched.origin), _np(qsched.inv_cell), qsched.cells)
    act = _sweep_np(qq, _np(qsched.mbr_q).astype(np.int32),
                    _np(qsched.parent_q).astype(np.int64),
                    root_unconditional=base.root_unconditional, uncond_from=None)
    return _finish(queries, act, _np(base.obj_level), _np(base.obj_slot),
                   _np(qsched.confirm_mbr), _np(base.obj_id), base.n_objects)


def search_compact8_np(queries, qsched, *, block_w: int = 128):
    if qsched.split == 0:
        return search_compact_np(queries, qsched, block_w=block_w)
    base = qsched.base
    queries = np.asarray(queries, np.float32)
    origin = _np(qsched.origin)
    qq16 = _quantize_queries_np(queries, origin, _np(qsched.inv_cell), qsched.cells)
    qq8 = _quantize_queries_np(queries, origin, _np(qsched.inv_cell8), qsched.cells8)
    split = qsched.split
    act = _sweep_hier(qq8, qq16, _np(qsched.mbr_q8), _np(qsched.mbr_q)[split:],
                      _np(qsched.parent_q).astype(np.int64),
                      root_unconditional=base.root_unconditional)
    return _finish(queries, act, _np(base.obj_level), _np(base.obj_slot),
                   _np(qsched.confirm_mbr), _np(base.obj_id), base.n_objects)


def search_live_np(queries, aug, *, block_w: int = 128):
    """Host twin of the live sweep: base levels + flat delta levels,
    per-object confirm, tombstones."""
    del block_w
    st = aug.statics
    queries = np.asarray(queries, np.float32)
    if aug.precision == "compact":
        mbr_q, parent_q, gate, obj_level, obj_slot, obj_id, origin, inv_cell, alive = (
            _np(a) for a in aug.arrays)
        qeff = _quantize_queries_np(queries, origin, inv_cell, st["cells"])
        tiles = mbr_q.astype(np.int32)
        parent = parent_q.astype(np.int64)
    else:
        tiles, parent, obj_mbr, obj_level, obj_slot, obj_id, alive = (
            _np(a) for a in aug.arrays)
        parent = parent.astype(np.int64)
        qeff = queries
        gate = obj_mbr if st.get("test_object_mbr", True) else None
    act = _sweep_np(qeff, tiles, parent, root_unconditional=st["root_unconditional"],
                    uncond_from=st["base_levels"])
    return _finish(queries, act, obj_level, obj_slot, gate, obj_id, st["n_objects"],
                   alive=alive.astype(bool))


# variant key -> (torch twin, host twin); the server picks by the same
# (precision, live) pair it used to choose the cuda rung's sweep.
FALLBACKS = {
    key: (functools.partial(SEARCHES[key], engine="torch"), host)
    for key, host in (
        (("float32", False), search_f32_np),
        (("compact", False), search_compact_np),
        (("compact8", False), search_compact8_np),
        (("float32", True), search_live_np),
        (("compact", True), search_live_np),
    )
}


# ---------------------------------------------------------------------------
# tree-vs-tree join twins
# ---------------------------------------------------------------------------


def _pair_sweep_np(a_cm, a_parent, b_cm, b_parent, symmetric=False):
    """(K, Wa, Wb) pair-active mask in numpy (uint16 tiles compare as
    float32, exactly); ``symmetric`` keeps slot pairs ``a <= b`` and gathers
    the parents from the mirrored previous level."""
    k_levels, _, wa = a_cm.shape
    wb = b_cm.shape[2]
    a = np.asarray(a_cm, np.float32)
    b = np.asarray(b_cm, np.float32)
    triu = np.arange(wa)[:, None] <= np.arange(wb)[None, :] if symmetric else None
    acts = np.zeros((k_levels, wa, wb), bool)
    for k in range(k_levels):
        al, bl = a[k], b[k]
        ov = ((al[0][:, None] <= bl[2][None, :]) & (bl[0][None, :] <= al[2][:, None])
              & (al[1][:, None] <= bl[3][None, :]) & (bl[1][None, :] <= al[3][:, None]))
        if k == 0:
            acts[k] = ov
        else:
            prev = acts[k - 1]
            if symmetric:
                prev = prev | prev.T
            acts[k] = ov & prev[a_parent[k]][:, b_parent[k]]
        if symmetric:
            acts[k] &= triu
    return acts


def fused_join_np(a_cm, a_parent, a_anc, a_level, a_gid,
                  b_cm, b_parent, b_anc, b_level, b_gid,
                  table_a, table_b, alive_a, alive_b, delta_a, delta_b,
                  *, symmetric: bool = False):
    """Host rung of the join: the pair sweep in numpy on host copies, then
    the shared candidate/confirm epilogue on CPU tensors.  Returns ``(pairs,
    visits)`` on the CPU, equal to :func:`fused_join`'s."""
    act = _pair_sweep_np(_np(a_cm.cpu()), _np(a_parent.cpu()).astype(np.int64),
                         _np(b_cm.cpu()), _np(b_parent.cpu()).astype(np.int64), symmetric)
    rest = [t.cpu() for t in (a_anc, a_level, a_gid, b_anc, b_level, b_gid, table_a,
                              table_b, alive_a, alive_b, delta_a, delta_b)]
    return join_epilogue(torch.from_numpy(act), *rest, symmetric=symmetric)


# degradation-ladder rung -> join twin; the cuda rung is ``fused_join``
# itself (kernel #6)
JOIN_FALLBACKS = {"torch": functools.partial(fused_join, engine="torch"),
                  "host": fused_join_np}


# ---------------------------------------------------------------------------
# the ladder walk, shared by the region server and the serve join
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LadderLedger:
    """The health counts of one ladder walk, in the shape
    ``AccessStats.absorb_health`` folds."""

    retries: int = 0
    degraded_batches: int = 0
    rung_dispatches: dict = dataclasses.field(default_factory=dict)
    rung_failures: dict = dataclasses.field(default_factory=dict)


class LadderExhausted(RuntimeError):
    """Every rung of a degradation ladder failed."""


def run_ladder(rungs, attempt, *, ledger, device, fault_plan=None, start: int = 0,
               max_retries: int = 0, backoff: float = 0.0, backoff_cap: float = 1.0,
               who: str = "ladder", **span_args):
    """Walk ``rungs[start:]`` until one answers; returns ``(attempt(rung),
    index of the rung that answered)``.

    Each rung is tried ``max_retries + 1`` times, with a sleep of
    ``backoff * 2**k`` (at most ``backoff_cap``) after failure ``k``, then
    the walk degrades to the next rung with a ``serve.degrade`` trace event
    and a ``RuntimeWarning``.  ``fault_plan.launch(rung)`` fires before
    every attempt, inside a ``serve.rung`` span (with ``span_args``).
    ``ledger`` is any object with ``retries`` and ``degraded_batches``
    counts and ``rung_dispatches`` / ``rung_failures`` dicts keyed by rung;
    an answer below ``rungs[0]`` counts as degraded.

    What counts as a rung failure: on a CUDA ``device`` only an injected
    :class:`repro_torch.ft.InjectedFailure`.  Any other exception there is
    a real fault of the card's path, which the ladder does not answer
    around: it raises ``RuntimeError`` chained to it, uncounted.  On the
    CPU every ``Exception`` is a rung failure, as in the reference.  A
    simulated kill (``KillPoint``, a ``BaseException``) always passes
    through untouched.  When every rung failed, raises
    :class:`LadderExhausted` chained to the last failure.
    """
    on_card = torch.device(device).type == "cuda"
    last_exc: Exception | None = None
    for ri in range(start, len(rungs)):
        rung = rungs[ri]
        for k in range(max_retries + 1):
            try:
                with _trace.span("serve.rung", rung=rung, attempt=k, **span_args):
                    if fault_plan is not None:
                        fault_plan.launch(rung)
                    out = attempt(rung)
            except Exception as exc:
                if on_card and not isinstance(exc, InjectedFailure):
                    raise RuntimeError(
                        f"{who}: the {rung!r} rung raised {type(exc).__name__} on {device}; "
                        "a real fault on the card is not absorbed by the ladder") from exc
                last_exc = exc
                ledger.rung_failures[rung] = ledger.rung_failures.get(rung, 0) + 1
                _trace.instant("serve.rung_failure", rung=rung, attempt=k,
                               error=type(exc).__name__)
                if k < max_retries:
                    ledger.retries += 1
                    if backoff > 0:
                        time.sleep(min(backoff * 2**k, backoff_cap))
                continue
            ledger.rung_dispatches[rung] = ledger.rung_dispatches.get(rung, 0) + 1
            if ri > 0:
                ledger.degraded_batches += 1
            return out, ri
        if ri + 1 < len(rungs):
            _trace.instant("serve.degrade", **{
                "from": rung, "to": rungs[ri + 1], "failures": max_retries + 1})
            warnings.warn(
                f"{who}: rung {rung!r} failed {max_retries + 1}x ({last_exc!r}); "
                f"degrading to {rungs[ri + 1]!r}", RuntimeWarning, stacklevel=4)
    raise LadderExhausted(f"{who}: every ladder rung {tuple(rungs)!r} failed") from last_exc
