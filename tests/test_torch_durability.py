"""Port parity: crash recovery of ``repro_torch.checkpoint.DurableIndex``
== the JAX package's, under the same ``FaultPlan``.

Both packages run the same mixed insert/delete/flush workload
(``mutation_workload``), killed at a fixed sample of op indices at each
kill site and with torn writes, then recover.  The recovered op count,
torn flag, live ids, WAL bytes and region hits and visits must equal the
JAX package's and the host oracle's (``update.oracle``).  Checkpoint
rotation and GC, a kill between the new snapshot and its WAL, a kill
inside a merge, the ``shed`` and ``queue`` admission modes, and a root
written by one package recovered by the other are covered the same way.

The kill indices are fixed (no environment variable selects them).  The
port runs on the CPU, on its ``cuda`` backend (the kernels' plain
versions) unless a test says otherwise; the JAX package on ``host``.

Tolerance: exact — ids, boolean masks, integer counts and file bytes.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import DurableIndex as JaxDurable
from repro.checkpoint import live_ids as jax_live_ids
from repro.checkpoint import mutation_workload as jax_workload
from repro.core import datasets
from repro.ft import FaultPlan as JaxPlan
from repro.ft import KillPoint as JaxKill
from repro_torch.checkpoint import DurableIndex, live_ids, mutation_workload
from repro_torch.checkpoint.durable import JAX_ONLY_OPTS, recorded_backend
from repro_torch.ft import KILL_SITES, FaultPlan, KillPoint
from repro_torch.update import oracle

N_OPS = 60
# A fixed sample of kill indices: the first and last ops and a spread.
KILL_AT = (0, 9, 23, 41, N_OPS - 1)
CAPACITY = 12


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _run_ops(d, ops, ids_of, *, upto=None):
    """Drive the workload; deletes target the lowest live ids, so the
    sequence is a pure function of durable state."""
    applied = 0
    for op, arg in ops:
        if upto is not None and applied >= upto:
            break
        if op == "insert":
            d.insert(arg)
        elif op == "delete":
            lids = ids_of(d)
            if lids.size == 0:
                continue
            d.delete(lids[: min(arg, lids.size)])
        else:
            d.flush()
        applied += 1
    return applied


def _killed_run(pkg, root, base, ops, plan_kw, **opts):
    if pkg == "jax":
        plan, kill = JaxPlan(**plan_kw), JaxKill
        d = JaxDurable.create(base, root, backend="host", sync=False, capacity=CAPACITY,
                              fault_plan=plan, **opts)
        ids_of = jax_live_ids
    else:
        plan, kill = FaultPlan(**plan_kw), KillPoint
        d = DurableIndex.create(base, root, device="cpu", sync=False, capacity=CAPACITY,
                                fault_plan=plan, **opts)
        ids_of = live_ids
    killed = False
    try:
        _run_ops(d, ops, ids_of)
    except kill:
        killed = True
    d.close()
    return killed, plan


def _recover(pkg, root):
    if pkg == "jax":
        return JaxDurable.recover(root, backend="host", sync=False)
    return DurableIndex.recover(root, device="cpu", sync=False)


def test_workload_equals_the_reference():
    pb, pops = mutation_workload(N_OPS, seed=7, base_n=32)
    jb, jops = jax_workload(N_OPS, seed=7, base_n=32)
    assert np.array_equal(pb, jb)
    assert [op for op, _ in pops] == [op for op, _ in jops]
    for (_, a), (_, b) in zip(pops, jops):
        assert (a is None and b is None) or np.array_equal(a, b)


def _matrix():
    for k in KILL_AT:
        for site in KILL_SITES:
            yield k, site, False
        yield k, "post-append", True  # torn write at op k


@pytest.mark.parametrize("k,site,torn", list(_matrix()))
def test_kill_anywhere_recovers_like_the_reference(tmp_path, k, site, torn):
    base, ops = mutation_workload(N_OPS, seed=7, base_n=32)
    queries = datasets.region_queries(base, 10, seed=9)
    plan_kw = dict(kill_at_op=k, kill_site=site, torn_write=torn)
    out = {}
    for pkg in ("jax", "port"):
        killed, plan = _killed_run(pkg, tmp_path / pkg, base, ops, plan_kw)
        out[pkg] = (killed, plan.kills, _recover(pkg, tmp_path / pkg))
    (jk, jkills, jr), (pk, pkills, pr) = out["jax"], out["port"]
    assert (jk, jkills) == (pk, pkills)
    if pk and not (site == "mid-merge"):
        assert pr.ops_total == (k if (site == "pre-append" or torn) else k + 1)
    assert (pr.ops_total, pr.recovered_ops, pr.recovered_torn, pr.generation) == (
        jr.ops_total, jr.recovered_ops, jr.recovered_torn, jr.generation)
    assert np.array_equal(live_ids(pr), jax_live_ids(jr))
    # the repaired logs are the same bytes
    assert ((tmp_path / "jax" / "wal_0.log").read_bytes()
            == (tmp_path / "port" / "wal_0.log").read_bytes())
    got, ref = pr.region(queries), jr.region(queries)
    assert np.array_equal(_np(got.hits), ref.hits)
    assert np.array_equal(_np(got.hits), oracle.hits_mask(pr.index, queries, pr.id_space))
    host = pr.index.with_backend("host").region(queries)
    assert np.array_equal(_np(host.visits_per_level), ref.visits_per_level)


def test_kill_mid_merge_replays_the_merge(tmp_path):
    base, ops = mutation_workload(N_OPS, seed=2, base_n=24)
    probe = DurableIndex.create(base, tmp_path / "probe", device="cpu", sync=False,
                                capacity=8)
    merge_ops, applied = [], 0
    for op, arg in ops:
        before = probe.index.stats.flushes
        if op == "insert":
            probe.insert(arg)
        elif op == "delete":
            lids = live_ids(probe)
            if lids.size == 0:
                continue
            probe.delete(lids[: min(arg, lids.size)])
        else:
            probe.flush()
        if probe.index.stats.flushes > before:
            merge_ops.append(applied)
        applied += 1
    probe.close()
    assert merge_ops, "workload never merged"
    k = merge_ops[len(merge_ops) // 2]
    recovered = {}
    for pkg in ("jax", "port"):
        plan_kw = dict(kill_at_op=k, kill_site="mid-merge", slow_merge=0.001)
        if pkg == "jax":
            plan = JaxPlan(**plan_kw)
            d = JaxDurable.create(base, tmp_path / pkg, backend="host", sync=False,
                                  capacity=8, fault_plan=plan)
            with pytest.raises(JaxKill):
                _run_ops(d, ops, jax_live_ids)
        else:
            plan = FaultPlan(**plan_kw)
            d = DurableIndex.create(base, tmp_path / pkg, device="cpu", sync=False,
                                    capacity=8, fault_plan=plan)
            with pytest.raises(KillPoint):
                _run_ops(d, ops, live_ids)
        d.close()
        assert plan.kills == 1
        recovered[pkg] = _recover(pkg, tmp_path / pkg)
    r = recovered["port"]
    assert r.ops_total == recovered["jax"].ops_total == k + 1  # merge replayed
    assert np.array_equal(live_ids(r), jax_live_ids(recovered["jax"]))
    # the replayed merge equals an un-killed run of the same ops
    clean = DurableIndex.create(base, tmp_path / "clean", device="cpu", sync=False,
                                capacity=8)
    _run_ops(clean, ops, live_ids, upto=k + 1)
    for f in ("mbr_cm", "parent", "n_real", "obj_mbr", "obj_level", "obj_slot", "obj_id"):
        assert torch.equal(getattr(r.index.schedule, f), getattr(clean.index.schedule, f)), f


def test_checkpoint_rotation_and_gc(tmp_path):
    base, ops = mutation_workload(30, seed=3, base_n=24)
    ds = {"jax": JaxDurable.create(base, tmp_path / "jax", backend="host", sync=False,
                                   capacity=CAPACITY),
          "port": DurableIndex.create(base, tmp_path / "port", device="cpu", sync=False,
                                      capacity=CAPACITY)}
    for pkg, d in ds.items():
        ids_of = jax_live_ids if pkg == "jax" else live_ids
        for i in range(3):
            _run_ops(d, ops[10 * i: 10 * (i + 1)], ids_of)
            d.checkpoint()
    d = ds["port"]
    assert d.generation == 3
    for pkg in ds:
        names = sorted(p.name for p in (tmp_path / pkg).iterdir())
        assert names == ["snap_2", "snap_3", "wal_2.log", "wal_3.log"], (pkg, names)
    assert np.array_equal(live_ids(d), jax_live_ids(ds["jax"]))
    for pkg in ds:  # each package recovers the other's root too
        r = DurableIndex.recover(tmp_path / pkg, device="cpu", sync=False)
        assert r.generation == 3 and r.ops_total == d.ops_total
        assert np.array_equal(live_ids(r), live_ids(d))


def test_kill_between_snapshot_and_new_wal(tmp_path):
    base, _ = mutation_workload(1, seed=0, base_n=24)
    d = DurableIndex.create(base, tmp_path / "d", device="cpu", sync=False, capacity=8)
    d.insert(datasets.uniform_squares(3, seed=1))
    d.checkpoint()
    d.close()
    (tmp_path / "d" / "wal_1.log").unlink()  # the kill
    r = DurableIndex.recover(tmp_path / "d", device="cpu", sync=False)
    assert r.generation == 1 and r.n_objects == 27 and r.recovered_ops == 0
    j = JaxDurable.recover(tmp_path / "d", backend="host", sync=False)
    assert np.array_equal(live_ids(r), jax_live_ids(j))


def test_recover_empty_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DurableIndex.recover(tmp_path / "nothing", device="cpu")


def test_shed_admission(tmp_path):
    results = {}
    for pkg in ("jax", "port"):
        kw = dict(admission="shed", sync=False, capacity=4, merge={"auto": False})
        d = (JaxDurable.create(datasets.uniform_squares(20, seed=0), tmp_path / pkg,
                               backend="host", **kw) if pkg == "jax" else
             DurableIndex.create(datasets.uniform_squares(20, seed=0), tmp_path / pkg,
                                 device="cpu", **kw))
        first = d.insert(datasets.uniform_squares(4, seed=1))
        shed = d.insert(datasets.uniform_squares(2, seed=2))
        results[pkg] = (first.status, shed.status, d.stats.shed_mutations, d.n_objects,
                        first.ids.tolist())
    assert results["port"] == results["jax"] == ("applied", "shed", 2, 24,
                                                 [20, 21, 22, 23])


def test_queue_admission(tmp_path):
    kw = dict(admission="queue", sync=False, capacity=4, merge={"auto": False})
    d = DurableIndex.create(datasets.uniform_squares(20, seed=0), tmp_path / "d",
                            device="cpu", **kw)
    j = JaxDurable.create(datasets.uniform_squares(20, seed=0), tmp_path / "j",
                          backend="host", **kw)
    for x in (d, j):
        assert x.insert(datasets.uniform_squares(4, seed=1)).applied
        res = x.insert(datasets.uniform_squares(2, seed=2))
        assert res.status == "queued" and x.pending == 2 and x.stats.queued_mutations == 2
    # queued batches are not durable: recovery sees only applied ops
    r = DurableIndex.recover(tmp_path / "d", device="cpu", sync=False)
    assert r.n_objects == 24
    for x in (d, j):
        x.flush()
        assert x.pending == 0 and x.n_objects == 26
    r = DurableIndex.recover(tmp_path / "d", device="cpu", sync=False)
    assert np.array_equal(live_ids(r), live_ids(d))
    assert np.array_equal(live_ids(d), jax_live_ids(j))
    assert ((tmp_path / "d" / "wal_0.log").read_bytes()
            == (tmp_path / "j" / "wal_0.log").read_bytes())


def test_port_recovers_a_jax_root_on_the_recorded_backend(tmp_path):
    """A root the JAX package wrote on ``pallas`` (with its
    ``interpret`` option) reopens in the port on ``cuda``: the backend
    name is mapped and the JAX-only option dropped by name; an option the
    port does not know otherwise still raises."""
    base, ops = mutation_workload(20, seed=4, base_n=24)
    j = JaxDurable.create(base, tmp_path / "j", structure="pyramid", build="device",
                          backend="pallas", sync=False, capacity=CAPACITY,
                          interpret=True, block_w=128, autotune="off")
    _run_ops(j, ops, jax_live_ids)
    j.close()
    assert "interpret" in JAX_ONLY_OPTS
    r = DurableIndex.recover(tmp_path / "j", device="cpu", sync=False)
    assert r.index.backend == "cuda" and r.index._backend_opts == {
        "block_w": 128, "autotune": "off"}
    assert np.array_equal(live_ids(r), jax_live_ids(j))
    queries = datasets.region_queries(base, 8, seed=5)
    assert np.array_equal(_np(r.region(queries).hits),
                          oracle.hits_mask(r.index, queries, r.id_space))
    meta = {"backend": "serve", "backend_opts": {"ladder": ["pallas", "lax", "host"],
                                                 "interpret": None, "query_block": 4}}
    assert recorded_backend(meta) == ("serve", {"ladder": ("cuda", "torch", "host"),
                                                "query_block": 4})
    assert recorded_backend({"backend": "lax", "backend_opts": {}}) == ("torch", {})
    with pytest.raises(TypeError):
        DurableIndex.recover(tmp_path / "j", device="cpu", sync=False, stream_tiles=3)


def test_jax_recovers_a_port_root(tmp_path):
    base, ops = mutation_workload(20, seed=6, base_n=24)
    plan = FaultPlan(kill_at_op=14, kill_site="post-append")
    d = DurableIndex.create(base, tmp_path / "d", device="cpu", sync=False,
                            capacity=CAPACITY, fault_plan=plan)
    with pytest.raises(KillPoint):
        _run_ops(d, ops, live_ids)
    d.close()
    j = JaxDurable.recover(tmp_path / "d", backend="host", sync=False)
    r = DurableIndex.recover(tmp_path / "d", device="cpu", sync=False)
    assert j.ops_total == r.ops_total == 15
    assert np.array_equal(live_ids(r), jax_live_ids(j))


@pytest.mark.parametrize("backend", ["cuda", "torch", "host", "serve"])
def test_recovered_state_on_every_backend(tmp_path, backend):
    base, ops = mutation_workload(40, seed=1, base_n=32)
    queries = datasets.region_queries(base, 10, seed=3)
    plan = FaultPlan(kill_at_op=23, kill_site="post-append")
    d = DurableIndex.create(base, tmp_path / "d", device="cpu", sync=False,
                            capacity=CAPACITY, fault_plan=plan)
    with pytest.raises(KillPoint):
        _run_ops(d, ops, live_ids)
    d.close()
    r = DurableIndex.recover(tmp_path / "d", backend=backend, device="cpu", sync=False)
    assert r.index.backend == backend
    ref = oracle.hits_mask(r.index, queries, r.id_space)
    assert np.array_equal(_np(r.region(queries).hits), ref)
