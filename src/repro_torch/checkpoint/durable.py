"""Crash-consistent spatial serving: snapshot + mutation WAL.

Counterpart of ``repro.checkpoint.durable``, on the same files: a root
written by either package recovers in the other.  A :class:`DurableIndex`
wraps a live :class:`repro_torch.index.SpatialIndex` with the classic
recovery pair:

* **snapshots** — generation-numbered, atomically published copies of the
  full index state (``snap_<g>/``, :mod:`repro_torch.checkpoint.spatial`);
* **a write-ahead log per generation** (``wal_<g>.log``,
  :mod:`repro_torch.update.wal`): every ``insert`` / ``delete`` / ``flush``
  is fsync'd to the WAL *before* it touches index state.

``recover(root)`` = latest complete snapshot + deterministic replay of
its WAL tail.  Because global ids, merge triggers, and rebuilds are pure
functions of the op sequence, replay reconstructs the pre-crash live set
exactly — a kill at ANY point (before the append, after it, mid-merge,
or tearing the record itself) recovers to the last durable op.  On the
card, replayed merges run kernels #4 and #5 again; both are deterministic
(#4 orders signed zeros by their bits, ROADMAP C12), so the recovered
schedule equals the one the un-killed run built, bit for bit.

Directory layout::

    root/
      snap_<g>/      snapshot at generation g  (atomic os.replace publish)
      wal_<g>.log    mutations since snap_<g>  (fsync'd, checksummed)

:meth:`checkpoint` rotates: publish ``snap_<g+1>``, start ``wal_<g+1>``,
garbage-collect older generations.  The crash windows are safe by
ordering — a kill after the snapshot publish but before the new WAL
exists reads as "new snapshot + empty log"; a kill mid-publish leaves
the previous generation intact.

Admission control (the serving-side backpressure story): when the delta
buffer cannot absorb a batch, ``admission="merge"`` folds it into a
compaction (flush-then-insert; works even with ``auto=False`` policies),
``"shed"`` drops it, and ``"queue"`` parks it host-side — queued batches
reach the WAL only when they are actually applied, so recovery never
replays a mutation that was still pending.

Backends: ``create`` and ``open`` build on ``backend="cuda"`` by default.
``recover`` with no ``backend`` reopens on the backend and backend options
the snapshot recorded; a snapshot of the JAX package records its own
names, which map to the port's (``pallas`` → ``cuda``, ``lax`` → ``torch``,
rung names in ``ladder`` likewise), and its options that the port does not
have (:data:`JAX_ONLY_OPTS`) are dropped by name.  An explicit ``backend``
takes the caller's options only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as _obs_trace
from repro_torch.update.wal import WriteAheadLog, recover_wal

from .spatial import load_index, save_index, snapshot_meta

ADMISSION_MODES = ("merge", "shed", "queue")

# The JAX package's backend and ladder-rung names, and the port's for them.
JAX_BACKEND_NAMES = {"pallas": "cuda", "lax": "torch"}
# Backend options a JAX snapshot may record that the port does not have:
# ``interpret`` (run the Pallas kernel in interpreter mode).
JAX_ONLY_OPTS = ("interpret",)

_SNAP_RE = re.compile(r"^snap_(\d+)$")


@dataclasses.dataclass(frozen=True)
class MutationResult:
    """Outcome of one durable mutation.

    status: ``applied`` (durable in the WAL and visible to queries),
            ``shed`` (dropped by admission control), or ``queued``
            (parked host-side; durable only once drained).
    ids:    global ids of applied inserts (empty for deletes/flushes and
            for non-applied batches).
    """

    status: str
    ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )

    @property
    def applied(self) -> bool:
        return self.status == "applied"


class DurableIndex:
    """A SpatialIndex with WAL-backed crash consistency.

    Construct via :meth:`create` (fresh directory) or :meth:`recover`
    (reopen after a crash or clean shutdown — same call either way).
    Query methods (``region``/``point``/``count``/``knn``) delegate to
    the wrapped index; mutations go WAL-first.
    """

    def __init__(self, index, root, wal: WriteAheadLog, *,
                 generation: int, ops_total: int, admission: str = "merge",
                 fault_plan=None, sync: bool = True, keep: int = 1):
        if admission not in ADMISSION_MODES:
            raise ValueError(
                f"unknown admission {admission!r}; expected one of "
                f"{ADMISSION_MODES}"
            )
        self.index = index
        self.root = pathlib.Path(root)
        self.wal = wal
        self.generation = int(generation)
        self.ops_total = int(ops_total)  # durable ops since create()
        self.admission = admission
        self.sync = bool(sync)
        self.keep = int(keep)            # extra old generations retained
        self._pending: List[np.ndarray] = []  # queued insert batches
        self.fault_plan = None
        if fault_plan is not None:
            self.bind_fault_plan(fault_plan)

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, mbrs, root, *, structure: str = "mqr",
               backend: str = "cuda", device=None, admission: str = "merge",
               sync: bool = True, keep: int = 1, fault_plan=None,
               **opts) -> "DurableIndex":
        """Build a fresh index at ``root`` on ``device`` (the card when
        None): snapshot generation 0 is published before this returns, so
        the build itself is durable."""
        from repro_torch.index.api import SpatialIndex

        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        index = SpatialIndex.build(
            mbrs, structure=structure, backend=backend, device=device, **opts
        )
        save_index(
            index, root / "snap_0",
            extra_meta={"durable": {"generation": 0, "ops_total": 0}},
        )
        wal = WriteAheadLog(root / "wal_0.log", sync=sync)
        return cls(index, root, wal, generation=0, ops_total=0,
                   admission=admission, fault_plan=fault_plan, sync=sync,
                   keep=keep)

    @classmethod
    def recover(cls, root, *, backend: Optional[str] = None, device=None,
                admission: str = "merge", sync: bool = True, keep: int = 1,
                fault_plan=None, **opts) -> "DurableIndex":
        """Reopen ``root``: latest complete snapshot + WAL tail replay.

        Torn WAL tails are detected (checksum / sequence break), dropped,
        and the file repaired; the surviving op prefix is replayed in
        order through the same code paths that applied it originally, so
        the recovered live set is bit-identical to the pre-crash state at
        the last durable op.  The fault plan is bound only AFTER replay —
        recovery itself never re-triggers the fault that killed us.
        ``backend=None`` reopens on the backend the snapshot recorded (see
        the module docstring); ``device`` is the card when None.
        """
        root = pathlib.Path(root)
        gen = cls._latest_generation(root)
        if gen is None:
            raise FileNotFoundError(
                f"{root}: no complete snapshot generation to recover from"
            )
        meta = snapshot_meta(root / f"snap_{gen}") or {}
        if backend is None:
            backend, recorded = recorded_backend(meta)
            opts = {**recorded, **opts}
        index = load_index(root / f"snap_{gen}", backend=backend, device=device, **opts)
        wal, records, torn = recover_wal(
            root / f"wal_{gen}.log", sync=sync
        )
        base_ops = int(meta.get("durable", {}).get("ops_total", 0))
        self = cls(index, root, wal, generation=gen,
                   ops_total=base_ops + len(records), admission=admission,
                   sync=sync, keep=keep)
        self.recovered_ops = len(records)
        self.recovered_torn = torn
        for op, arr in records:
            self._apply(op, arr)
        if fault_plan is not None:
            self.bind_fault_plan(fault_plan)
        return self

    @classmethod
    def open(cls, root, mbrs=None, *, structure: str = "mqr",
             backend: Optional[str] = None, device=None, admission: str = "merge",
             sync: bool = True, keep: int = 1, fault_plan=None,
             **opts) -> "DurableIndex":
        """Recover ``root`` if it holds a complete snapshot generation,
        else create it fresh from ``mbrs``.

        This is the serving front end's restart path: a tenant declared
        with ``durable_root`` comes back with its last durable live set
        on every process start, and bootstraps from its dataset only the
        first time.  ``structure`` applies only to the create path — on
        recovery the structure is whatever the snapshot recorded.
        ``backend=None`` is ``cuda`` on the create path and the recorded
        backend on recovery.
        """
        root = pathlib.Path(root)
        if cls._latest_generation(root) is not None:
            # build-time options (structure shape, delta capacity, merge
            # policy) are recorded IN the snapshot — only backend options
            # may pass through to recovery
            build_only = ("capacity", "merge", "levels", "max_entries",
                          "build")
            backend_opts = {
                k: v for k, v in opts.items() if k not in build_only
            }
            return cls.recover(root, backend=backend, device=device,
                               admission=admission, sync=sync, keep=keep,
                               fault_plan=fault_plan, **backend_opts)
        if mbrs is None:
            raise FileNotFoundError(
                f"{root}: nothing to recover and no mbrs to create from"
            )
        return cls.create(mbrs, root, structure=structure,
                          backend="cuda" if backend is None else backend,
                          device=device, admission=admission, sync=sync,
                          keep=keep, fault_plan=fault_plan, **opts)

    @staticmethod
    def _latest_generation(root: pathlib.Path) -> Optional[int]:
        gens = []
        for p in root.iterdir() if root.exists() else []:
            m = _SNAP_RE.match(p.name)
            if m and snapshot_meta(p) is not None:
                gens.append(int(m.group(1)))
        return max(gens) if gens else None

    # -- fault injection ------------------------------------------------
    def bind_fault_plan(self, plan) -> None:
        """Thread one :class:`repro_torch.ft.FaultPlan` through every layer:
        WAL appends (torn writes), the update log (mid-merge kills), the
        serving ladder (launch failures), and this op loop (kill sites).
        """
        self.fault_plan = plan
        self.wal.fault_plan = plan
        self.index.bind_fault_plan(plan)

    def _op_event(self, site: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.op_event(site, self.ops_total)

    # -- mutations (WAL-first) ------------------------------------------
    def insert(self, new_mbrs) -> MutationResult:
        """Durably insert a batch; admission control may shed or queue it
        when the delta buffer (or its id headroom) cannot absorb it."""
        from repro_torch.index.api import validate_mbrs

        new_mbrs = validate_mbrs(new_mbrs, what="insert batch")
        n = new_mbrs.shape[0]
        if n == 0:
            return MutationResult("applied")
        if not self._admit(n):
            if self.admission == "shed":
                self.index.stats.shed_mutations += n
                return MutationResult("shed")
            self._pending.append(new_mbrs)
            self.index.stats.queued_mutations += n
            return MutationResult("queued")
        log = self.index._ensure_log()
        if (
            not log.policy.auto
            and n <= log.capacity
            and not log.can_buffer(n)
        ):
            # admission="merge" backpressure under a manual (auto=False)
            # policy: compact DURABLY first — the façade would otherwise
            # raise BufferFullError after the WAL append, poisoning
            # replay with a record that can never apply.
            self._commit("flush", None)
        gids = self._commit("insert", new_mbrs)
        return MutationResult("applied", ids=gids)

    def delete(self, ids) -> MutationResult:
        """Durably tombstone live objects by global id."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return MutationResult("applied")
        self._check_deletable(ids)  # KeyError BEFORE the WAL sees it
        self._commit("delete", ids)
        return MutationResult("applied")

    def flush(self) -> MutationResult:
        """Durably compact (merge buffer + tombstones into a fresh base),
        then drain any queued batches into the room it made."""
        self._commit("flush", None)
        self.drain_queue()
        return MutationResult("applied")

    def _commit(self, op: str, arr):
        """The WAL-before-apply discipline, with kill sites around every
        boundary: the record is durable before index state changes, so
        the surviving prefix is exactly what replay reconstructs."""
        with _obs_trace.span("durable.commit", op=op, seq=self.ops_total):
            self._op_event("pre-append")   # kill here: op lost, state clean
            self.wal.append(op, arr)       # torn-write kills land inside
            self._op_event("post-append")  # kill here: op durable, unapplied
            out = self._apply(op, arr)     # mid-merge kills land inside
            self._op_event("post-apply")   # kill here: op durable + applied
            self.ops_total += 1
            return out

    def _apply(self, op: str, arr):
        if op == "insert":
            return self.index.insert(arr)
        if op == "delete":
            self.index.delete(arr)
            return None
        self.index.flush()
        return None

    # -- admission ------------------------------------------------------
    def _admit(self, n: int) -> bool:
        """Can the delta buffer absorb ``n`` inserts right now?  With
        ``admission="merge"`` the answer is always yes — an unbufferable
        batch folds into a compaction (the façade's documented path)."""
        if self.admission == "merge":
            return True
        log = self.index._ensure_log()
        return n <= log.capacity and log.can_buffer(n)

    def drain_queue(self) -> int:
        """Apply queued batches that now fit (in arrival order, stopping
        at the first that still doesn't); returns objects drained."""
        drained = 0
        while self._pending and self._admit(self._pending[0].shape[0]):
            batch = self._pending.pop(0)
            self._commit("insert", batch)
            drained += batch.shape[0]
        return drained

    @property
    def pending(self) -> int:
        """Objects parked by ``admission="queue"``, not yet durable."""
        return int(sum(b.shape[0] for b in self._pending))

    def _check_deletable(self, ids: np.ndarray) -> None:
        log = self.index._ensure_log()
        bad = ids[(ids < 0) | (ids >= log.id_capacity)]
        if bad.size == 0:
            bad = ids[~log.alive[ids]]
        if bad.size:
            raise KeyError(
                f"id {int(bad[0])} is not a live object (dead or unknown)"
            )

    # -- checkpoint rotation --------------------------------------------
    def checkpoint(self) -> int:
        """Publish a new snapshot generation and rotate the WAL.

        Ordering makes every kill window safe: (1) drain the queue, (2)
        atomically publish ``snap_<g+1>``, (3) start ``wal_<g+1>``, (4)
        close the old log and GC stale generations.  A kill between (2)
        and (3) recovers as "new snapshot + empty log"; earlier kills
        leave the previous generation authoritative.  Returns the new
        generation number.
        """
        self.drain_queue()
        g = self.generation + 1
        with _obs_trace.span("durable.checkpoint", generation=g,
                             ops_total=self.ops_total):
            save_index(
                self.index, self.root / f"snap_{g}",
                extra_meta={
                    "durable": {"generation": g, "ops_total": self.ops_total}
                },
            )
            new_wal = WriteAheadLog(self.root / f"wal_{g}.log", sync=self.sync)
            new_wal.fault_plan = self.fault_plan
            old = self.wal
            self.wal, self.generation = new_wal, g
            old.close()
            self._gc()
        return g

    def _gc(self) -> None:
        floor = self.generation - self.keep
        for p in self.root.iterdir():
            m = _SNAP_RE.match(p.name)
            if m and int(m.group(1)) < floor:
                shutil.rmtree(p, ignore_errors=True)
                (self.root / f"wal_{m.group(1)}.log").unlink(missing_ok=True)
            elif p.name.startswith("snap_") and ".tmp-" in p.name:
                shutil.rmtree(p, ignore_errors=True)  # crashed mid-save

    def close(self) -> None:
        self.wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- query delegation -----------------------------------------------
    @property
    def stats(self):
        return self.index.stats

    @property
    def n_objects(self) -> int:
        return self.index.n_objects

    @property
    def device(self):
        return self.index.device

    @property
    def id_space(self) -> int:
        return self.index.id_space

    def region(self, queries):
        return self.index.region(queries)

    def point(self, points):
        return self.index.point(points)

    def count(self, queries):
        return self.index.count(queries)

    def knn(self, points, k: int):
        return self.index.knn(points, k)

    def join(self, other, predicate: str = "intersects"):
        """Tree-vs-tree join of the durable live set against another
        index; joins are read-only, so no WAL traffic —
        the other side may be a plain or durable index."""
        return self.index.join(
            getattr(other, "index", other), predicate=predicate
        )


def recorded_backend(meta: dict) -> Tuple[str, dict]:
    """The backend name and JSON-safe backend options a snapshot's
    meta.json recorded, in the port's names: the JAX package's backend
    and ladder-rung names are mapped (:data:`JAX_BACKEND_NAMES`) and its
    options listed in :data:`JAX_ONLY_OPTS` are dropped.  Any other
    option goes to the backend, which raises ``TypeError`` on one it does
    not take."""
    backend = meta.get("backend", "cuda")
    backend = JAX_BACKEND_NAMES.get(backend, backend)
    opts = {k: v for k, v in (meta.get("backend_opts") or {}).items()
            if k not in JAX_ONLY_OPTS}
    if opts.get("ladder") is not None:
        opts["ladder"] = tuple(JAX_BACKEND_NAMES.get(r, r) for r in opts["ladder"])
    return backend, opts


def live_ids(d: "DurableIndex") -> np.ndarray:
    """Global ids of the durable live set (sorted) — the unit the crash
    tests compare against the host oracle."""
    log = d.index._updates
    if log is None:
        return np.arange(d.index.n_objects, dtype=np.int64)
    return np.nonzero(log.alive)[0].astype(np.int64)


def mutation_workload(n_ops: int, *, seed: int = 0,
                      base_n: int = 64) -> Tuple[np.ndarray, list]:
    """A deterministic mixed mutation workload for the fault harness:
    ``(base_mbrs, ops)`` where ops are ``("insert", (n,4) mbrs)``,
    ``("delete", k)`` (delete k live ids, chosen by the runner), or
    ``("flush", None)`` — weighted toward inserts so the live set grows
    and merges trigger organically."""
    from repro_torch.core import datasets

    rng = np.random.default_rng(seed)
    base = datasets.uniform_squares(base_n, seed=seed)
    ops: list = []
    for i in range(n_ops):
        r = rng.random()
        if r < 0.62:
            k = int(rng.integers(1, 5))
            ops.append(("insert", datasets.uniform_squares(
                k, seed=int(rng.integers(0, 2**31))
            )))
        elif r < 0.9:
            ops.append(("delete", int(rng.integers(1, 4))))
        else:
            ops.append(("flush", None))
    return base, ops
