"""Mutation write-ahead log for the durable spatial index.

Counterpart of ``repro.update.wal``, byte for byte: the same magic,
record layout, dtypes and JSON header, so the port and the JAX package
write identical files for the same ops and each reads the other's.

Append-only binary file of mutation records.  Every ``insert`` /
``delete`` / ``flush`` is appended — and fsync'd — *before* the in-memory
/ on-device index state is touched, so a crash at any point loses at most
the op whose record never became durable.  Recovery replays the log over
the last snapshot; because the update subsystem is deterministic (global
ids, merge triggers, and rebuilds are pure functions of the op sequence),
replay reconstructs exactly the pre-crash live set.

On-disk layout::

    file   := MAGIC (8 bytes, b"MQRWAL01") record*
    record := u32 payload_len | u32 crc32(payload) | payload
    payload:= json-header \\x00 raw-array-bytes

The JSON header carries ``{op, seq, dtype, shape}``; the array bytes are
the op's operand (``(n, 4)`` float64 MBRs for insert, ``(n,)`` int64 ids
for delete, empty for flush).  All integers are little-endian.

A *torn tail* — a record whose bytes or checksum are incomplete because
the process died mid-append — is detected on replay and truncated away:
everything before it is trusted (each record's crc32 passed), everything
from it on is not.  A checksum failure anywhere therefore ends replay at
the last durable op, never yields garbage mutations.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as _obs_trace

MAGIC = b"MQRWAL01"
_HEAD = struct.Struct("<II")  # payload_len, crc32

OPS = ("insert", "delete", "flush")

_OP_DTYPE = {"insert": np.float64, "delete": np.int64, "flush": np.float64}
_OP_COLS = {"insert": 4, "delete": None, "flush": None}


class WalCorruption(RuntimeError):
    """The WAL prefix itself is unreadable (bad magic) — distinct from a
    torn tail, which is expected after a crash and repaired silently."""


def _encode(op: str, seq: int, arr: np.ndarray) -> bytes:
    header = json.dumps(
        {"op": op, "seq": seq, "dtype": str(arr.dtype), "shape": list(arr.shape)}
    ).encode()
    payload = header + b"\x00" + arr.tobytes()
    return _HEAD.pack(len(payload), zlib.crc32(payload)) + payload


def _decode(payload: bytes) -> Tuple[str, int, np.ndarray]:
    head, _, raw = payload.partition(b"\x00")
    meta = json.loads(head.decode())
    arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"]
    ).copy()
    return meta["op"], int(meta["seq"]), arr


def _coerce(op: str, arr) -> np.ndarray:
    """The record's operand as the reference stores it: insert MBRs as
    (n, 4) float64 (the façade validates to float32-exact float64), delete
    ids as (n,) int64."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    if op not in OPS:
        raise ValueError(f"unknown WAL op {op!r}; expected one of {OPS}")
    dtype = _OP_DTYPE[op]
    if arr is None:
        arr = np.zeros((0, 4) if op == "insert" else (0,), dtype)
    arr = np.asarray(arr, dtype)
    return arr.reshape(-1, 4) if op == "insert" else arr.reshape(-1)


class WriteAheadLog:
    """One append-only mutation log (one per snapshot generation).

    sync=True fsyncs every append — the durability contract; tests and
    benchmarks may turn it off to measure the fsync tax.  ``fault_plan``
    (a :class:`repro_torch.ft.FaultPlan`) lets the harness tear the in-flight
    record to simulate a kill mid-write.
    """

    def __init__(self, path, *, sync: bool = True, fault_plan=None):
        self.path = pathlib.Path(path)
        self.sync = sync
        self.fault_plan = fault_plan
        fresh = not self.path.exists() or self.path.stat().st_size == 0
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(MAGIC)
            self._flush()
        self.seq = 0 if fresh else len(read_wal(self.path)[0])

    # ------------------------------------------------------------------
    def append(self, op: str, arr=None) -> int:
        """Durably append one mutation record; returns its sequence
        number.  The record is on disk (fsync'd when ``sync``) before
        this returns — the caller then applies the op to live state."""
        with _obs_trace.span("wal.append", op=op, seq=self.seq,
                             sync=self.sync):
            arr = _coerce(op, arr)
            record = _encode(op, self.seq, arr)
            if self.fault_plan is not None and self.fault_plan.tear_now():
                # Simulated kill mid-write: half the record reaches the
                # disk, the process dies.  Replay must detect and drop
                # this tail.
                self._f.write(record[: max(len(record) // 2, 1)])
                self._flush()
                raise self.fault_plan.killed_mid_append()
            self._f.write(record)
            self._flush()
            self.seq += 1
            return self.seq - 1

    def _flush(self) -> None:
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wal(path) -> Tuple[List[Tuple[str, np.ndarray]], bool, int]:
    """Replay a WAL file.

    Returns ``(records, torn, n_valid)``: the decoded ``(op, operand)``
    list, whether a torn/corrupt tail was found after the valid prefix,
    and the byte offset of the end of the valid prefix (pass to
    :func:`repair_wal` to truncate the tail away).  A missing file reads
    as an empty log (the crash window between snapshot publish and WAL
    creation).
    """
    path = pathlib.Path(path)
    if not path.exists():
        return [], False, len(MAGIC)
    data = path.read_bytes()
    if len(data) < len(MAGIC):
        # the header itself was torn: an empty, repairable log
        return [], True, len(MAGIC)
    if data[: len(MAGIC)] != MAGIC:
        raise WalCorruption(f"{path}: bad WAL magic {data[:8]!r}")
    records: List[Tuple[str, np.ndarray]] = []
    off = len(MAGIC)
    expected_seq = 0
    buf = io.BytesIO(data)
    buf.seek(off)
    while True:
        head = buf.read(_HEAD.size)
        if len(head) == 0:
            return records, False, off  # clean EOF
        if len(head) < _HEAD.size:
            return records, True, off  # torn length/crc header
        length, crc = _HEAD.unpack(head)
        payload = buf.read(length)
        if len(payload) < length or zlib.crc32(payload) != crc:
            return records, True, off  # torn or corrupt payload
        try:
            op, seq, arr = _decode(payload)
        except Exception:
            return records, True, off  # checksum passed but undecodable
        if op not in OPS or seq != expected_seq:
            return records, True, off  # out-of-sequence tail: untrusted
        records.append((op, arr))
        expected_seq += 1
        off += _HEAD.size + length


def repair_wal(path, valid_end: int) -> None:
    """Truncate a torn tail off a WAL so future appends extend the valid
    prefix (idempotent; fsyncs the truncation).

    A torn header (a file shorter than the magic) is rewritten to the
    magic.  The reference pads it with zeros instead, which its next read
    rejects as bad magic (ROADMAP C15)."""
    path = pathlib.Path(path)
    if not path.exists():
        path.write_bytes(MAGIC)
    with open(path, "r+b") as f:
        f.truncate(max(valid_end, len(MAGIC)))
        if f.read(len(MAGIC)) != MAGIC:
            f.seek(0)
            f.write(MAGIC)
        f.flush()
        os.fsync(f.fileno())


def recover_wal(path, *, sync: bool = True, fault_plan=None):
    """Read + repair a WAL, then reopen it for appending.

    Returns ``(wal, records, torn)`` — the repaired, append-ready log,
    the surviving op prefix, and whether a torn tail was dropped.
    """
    records, torn, valid_end = read_wal(path)
    if torn:
        repair_wal(path, valid_end)
    wal = WriteAheadLog(path, sync=sync, fault_plan=fault_plan)
    wal.seq = len(records)
    return wal, records, torn
