"""Failure injection for fault-tolerance tests.

Counterpart of ``repro.ft.failures``, with the port's rung names.  Two
generations of harness live here:

* :class:`FailureInjector` — the train-loop hook: deterministic or random
  crashes at step boundaries (``maybe_fail(step)``).
* :class:`FaultPlan` — the spatial-serving harness.  One plan threads
  through the durable index, the write-ahead log, the update log's merge
  and the spatial server's dispatch loop, so a single object scripts
  *where* in the op/launch timeline a fault lands:

    - ``kill_at_op`` / ``kill_site``: simulate a process kill at op ``k``,
      at the ``pre-append`` / ``post-append`` / ``post-apply`` WAL
      boundary or ``mid-merge`` (inside the compaction the op triggered);
    - ``torn_write``: the kill lands mid-append, leaving a torn
      (checksum-failing) record at the WAL tail;
    - ``fail_launches`` / ``fail_rungs``: the next N dispatches on the
      named ladder rungs (``cuda``, ``torch``, ``host``) raise, exercising
      the degradation ladder;
    - ``slow_merge``: stretch every merge by a sleep.

Kills raise :class:`KillPoint`, which deliberately subclasses
``BaseException`` so production ``except Exception`` recovery paths can
never swallow a simulated SIGKILL — only the test harness catches it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np


class InjectedFailure(RuntimeError):
    """A scripted component failure (device launch, node, ...)."""


class KillPoint(BaseException):
    """Simulated process kill: NOT an Exception, so no recovery/retry
    path can accidentally absorb it — the process is 'dead'."""


KILL_SITES = ("pre-append", "post-append", "post-apply", "mid-merge")


@dataclasses.dataclass
class FaultPlan:
    """Scripted faults threaded through the durability + serving stack.

    The op counter is owned by the caller (the durable index passes the
    op index into :meth:`op_event` / sets :attr:`current_op` before the
    apply phase); launch failures keep their own countdown.
    """

    kill_at_op: Optional[int] = None
    kill_site: str = "post-append"
    torn_write: bool = False
    fail_launches: int = 0
    fail_rungs: Tuple[str, ...] = ("cuda",)
    fail_from_launch: Optional[int] = None
    slow_merge: float = 0.0
    current_op: int = dataclasses.field(default=-1, init=False)
    kills: int = dataclasses.field(default=0, init=False)
    launch_failures: int = dataclasses.field(default=0, init=False)
    launches_seen: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if self.kill_site not in KILL_SITES:
            raise ValueError(
                f"kill_site {self.kill_site!r} not in {KILL_SITES}"
            )

    # -- op timeline ----------------------------------------------------
    def op_event(self, site: str, op_index: int) -> None:
        """Called by the durable index at each WAL boundary of op
        ``op_index``; raises :class:`KillPoint` when the plan says the
        process dies here.  A ``torn_write`` kill is raised by the WAL
        itself (mid-append), never at a clean boundary."""
        self.current_op = op_index
        if self.torn_write:
            return
        if self.kill_at_op == op_index and self.kill_site == site:
            self.kills += 1
            raise KillPoint(f"injected kill at op {op_index} ({site})")

    def tear_now(self) -> bool:
        """Should the WAL tear the record of the current op?  (The WAL
        writes a partial record, then raises the kill itself.)"""
        return self.torn_write and self.kill_at_op == self.current_op

    def killed_mid_append(self) -> KillPoint:
        self.kills += 1
        return KillPoint(
            f"injected kill mid-append at op {self.current_op} (torn write)"
        )

    def merge_event(self) -> None:
        """Called from inside the update log's merge (compaction)."""
        if self.slow_merge > 0:
            time.sleep(self.slow_merge)
        if (
            self.kill_site == "mid-merge"
            and self.kill_at_op is not None
            and self.kill_at_op == self.current_op
        ):
            self.kills += 1
            raise KillPoint(
                f"injected kill mid-merge at op {self.current_op}"
            )

    # -- launch timeline ------------------------------------------------
    def launch(self, rung: str) -> None:
        """Called by the server before dispatching on ``rung``; raises
        :class:`InjectedFailure` while the countdown lasts.

        With ``fail_from_launch=N`` the countdown is armed only once the
        plan has witnessed N launch attempts on the named rungs — a
        mid-run degradation: the server runs healthy, then its device
        rung starts failing partway through a workload.
        """
        if rung not in self.fail_rungs:
            return
        self.launches_seen += 1
        if (
            self.fail_from_launch is not None
            and self.launches_seen <= self.fail_from_launch
        ):
            return
        if self.fail_launches > 0:
            self.fail_launches -= 1
            self.launch_failures += 1
            raise InjectedFailure(f"injected launch failure on rung {rung!r}")


class FailureInjector:
    def __init__(self, fail_at_step: Optional[int] = None,
                 fail_prob: float = 0.0, seed: int = 0, max_failures: int = 1):
        self.fail_at_step = fail_at_step
        self.fail_prob = fail_prob
        self.rng = np.random.default_rng(seed)
        self.remaining = max_failures

    def maybe_fail(self, step: int) -> None:
        if self.remaining <= 0:
            return
        hit = (self.fail_at_step is not None and step == self.fail_at_step) or (
            self.fail_prob > 0 and self.rng.random() < self.fail_prob
        )
        if hit:
            self.remaining -= 1
            raise InjectedFailure(f"injected node failure at step {step}")
