"""Port parity: the mutation write-ahead log of ``repro_torch`` == the JAX
package's, byte for byte.

The same op script gives identical log files from both packages, each
package reads the other's, and the reference's torn-tail, corrupt-payload,
bad-magic, missing-file and torn-write cases (tests/test_durability.py)
come out the same on both: the same surviving records, the same torn flag
and the same end of the valid prefix.

Tolerance: exact — file bytes, decoded operands and offsets.
"""
import numpy as np
import pytest
import torch

from repro.ft import FaultPlan as JaxFaultPlan
from repro.ft import KillPoint as JaxKillPoint
from repro.update import wal as jwal
from repro_torch.ft import FaultPlan, KillPoint
from repro_torch.update import wal as pwal

PACKAGES = {"jax": (jwal, JaxFaultPlan, JaxKillPoint), "port": (pwal, FaultPlan, KillPoint)}

# One op script; the operands come in the types each package's callers pass
# (float32 MBRs, int32 and list ids, torch tensors on the port).
SCRIPT = (
    ("insert", np.arange(8.0).reshape(2, 4)),
    ("delete", [3, 1]),
    ("flush", None),
    ("insert", np.array([[0.5, 0.25, 1.5, 2.0]], np.float32)),
    ("delete", np.array([7], np.int32)),
    ("insert", np.zeros((0, 4))),
    ("flush", None),
)


def _operand(pkg, arr):
    if pkg == "port" and arr is not None and not isinstance(arr, list):
        return torch.from_numpy(np.asarray(arr))
    return arr


def _write(pkg, path, script=SCRIPT, **kw):
    mod = PACKAGES[pkg][0]
    with mod.WriteAheadLog(path, sync=False, **kw) as w:
        seqs = [w.append(op, _operand(pkg, arr)) for op, arr in script]
    return seqs


def _same_read(a, b):
    (ra, ta, ea), (rb, tb, eb) = a, b
    assert ta == tb and ea == eb
    assert [op for op, _ in ra] == [op for op, _ in rb]
    for (_, x), (_, y) in zip(ra, rb):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def test_constants_equal_the_reference():
    assert pwal.MAGIC == jwal.MAGIC
    assert pwal.OPS == jwal.OPS
    assert pwal._HEAD.format == jwal._HEAD.format


def test_same_script_writes_identical_bytes(tmp_path):
    seqs = {pkg: _write(pkg, tmp_path / f"{pkg}.log") for pkg in PACKAGES}
    assert seqs["jax"] == seqs["port"] == list(range(len(SCRIPT)))
    assert (tmp_path / "jax.log").read_bytes() == (tmp_path / "port.log").read_bytes()


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_each_package_reads_the_others_log(tmp_path, writer):
    path = tmp_path / "w.log"
    _write(writer, path)
    _same_read(jwal.read_wal(path), pwal.read_wal(path))
    records, torn, _ = pwal.read_wal(path)
    assert not torn and [op for op, _ in records] == [op for op, _ in SCRIPT]
    assert records[0][1].dtype == np.float64 and records[0][1].shape == (2, 4)
    assert records[1][1].dtype == np.int64 and records[2][1].size == 0


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_reopen_appends_across_packages(tmp_path, writer):
    path = tmp_path / "w.log"
    _write(writer, path, SCRIPT[:2])
    other = "port" if writer == "jax" else "jax"
    with PACKAGES[other][0].WriteAheadLog(path, sync=False) as w:
        assert w.seq == 2
        w.append("flush")
    _write("jax", tmp_path / "ref.log", SCRIPT[:2] + (("flush", None),))
    assert path.read_bytes() == (tmp_path / "ref.log").read_bytes()


def _torn_tail(path):
    path.write_bytes(path.read_bytes()[:-3])


def _corrupt_payload(path):
    raw = bytearray(path.read_bytes())
    # a byte inside the third record's payload
    off = len(jwal.MAGIC)
    for _ in range(2):
        length, _crc = jwal._HEAD.unpack(raw[off: off + jwal._HEAD.size])
        off += jwal._HEAD.size + length
    raw[off + 10] ^= 0xFF
    path.write_bytes(bytes(raw))


def _torn_header(path):
    path.write_bytes(path.read_bytes()[:5])


def _out_of_sequence(path):
    # drop the first record: the rest start at seq 1, an untrusted tail
    raw = path.read_bytes()
    off = len(jwal.MAGIC)
    length, _crc = jwal._HEAD.unpack(raw[off: off + jwal._HEAD.size])
    path.write_bytes(raw[:off] + raw[off + jwal._HEAD.size + length:])


DAMAGE = {"torn_tail": _torn_tail, "corrupt_payload": _corrupt_payload,
          "out_of_sequence": _out_of_sequence}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damaged_logs_read_and_repair_alike(tmp_path, damage):
    for pkg in PACKAGES:
        _write(pkg, tmp_path / f"{pkg}.log")
        DAMAGE[damage](tmp_path / f"{pkg}.log")
    jp, pp = tmp_path / "jax.log", tmp_path / "port.log"
    assert jp.read_bytes() == pp.read_bytes()
    jr, pr = jwal.read_wal(jp), pwal.read_wal(pp)
    _same_read(jr, pr)
    assert pr[1], damage  # a torn (untrusted) tail was found
    jw, jrec, jtorn = jwal.recover_wal(jp, sync=False)
    pw, prec, ptorn = pwal.recover_wal(pp, sync=False)
    assert jtorn == ptorn and jw.seq == pw.seq == len(prec) == len(jrec)
    jw.append("flush")
    pw.append("flush")
    jw.close()
    pw.close()
    assert jp.read_bytes() == pp.read_bytes()
    records, torn, _ = pwal.read_wal(pp)
    assert not torn and len(records) == len(prec) + 1


def test_torn_header_reads_alike_and_the_port_repairs_it(tmp_path):
    """A kill inside the magic itself: both packages read an empty, torn
    log.  The reference's repair pads the header with zeros, which its
    next open rejects as bad magic (ROADMAP C15); the port rewrites the
    magic, so the repaired log equals a fresh one."""
    for pkg in PACKAGES:
        _write(pkg, tmp_path / f"{pkg}.log")
        _torn_header(tmp_path / f"{pkg}.log")
    jp, pp = tmp_path / "jax.log", tmp_path / "port.log"
    _same_read(jwal.read_wal(jp), pwal.read_wal(pp))
    assert pwal.read_wal(pp) == ([], True, len(pwal.MAGIC))
    with pytest.raises(jwal.WalCorruption):
        jwal.recover_wal(jp, sync=False)
    w, records, torn = pwal.recover_wal(pp, sync=False)
    assert torn and records == [] and w.seq == 0
    w.append("flush")
    w.close()
    _write("jax", tmp_path / "ref.log", (("flush", None),))
    assert pp.read_bytes() == (tmp_path / "ref.log").read_bytes()


def test_bad_magic_raises_on_both(tmp_path):
    p = tmp_path / "w.log"
    p.write_bytes(b"NOTAWAL0" + b"x" * 32)
    with pytest.raises(jwal.WalCorruption):
        jwal.read_wal(p)
    with pytest.raises(pwal.WalCorruption):
        pwal.read_wal(p)


def test_missing_file_is_an_empty_log_on_both(tmp_path):
    _same_read(jwal.read_wal(tmp_path / "nope.log"), pwal.read_wal(tmp_path / "nope.log"))
    assert pwal.read_wal(tmp_path / "nope.log") == ([], False, len(pwal.MAGIC))


@pytest.mark.parametrize("kill_at", [0, 2])
def test_torn_write_injection_leaves_the_same_file(tmp_path, kill_at):
    for pkg, (mod, plan_cls, kill_cls) in PACKAGES.items():
        plan = plan_cls(kill_at_op=kill_at, torn_write=True)
        w = mod.WriteAheadLog(tmp_path / f"{pkg}.log", sync=False, fault_plan=plan)
        with pytest.raises(kill_cls):
            for i, (op, arr) in enumerate(SCRIPT):
                plan.op_event("pre-append", i)
                w.append(op, _operand(pkg, arr))
        w.close()
        assert plan.kills == 1
    jp, pp = tmp_path / "jax.log", tmp_path / "port.log"
    assert jp.read_bytes() == pp.read_bytes()
    records, torn, _ = pwal.read_wal(pp)
    assert torn and len(records) == kill_at
    _same_read(jwal.read_wal(jp), pwal.read_wal(pp))


def test_unknown_op_rejected():
    with pytest.raises(ValueError, match="unknown WAL op"):
        pwal._coerce("upsert", None)


def test_kill_point_is_not_an_exception():
    assert issubclass(KillPoint, BaseException) and not issubclass(KillPoint, Exception)
