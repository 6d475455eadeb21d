"""Fault-tolerant training loop: heartbeats, checkpoint/restart, injection.

Port of ``repro/runtime/fault.py`` over the port's checkpointer: a restore
builds the state on ``state_device`` and, on a mesh, lays it out by
``state_shardings``, as the reference's does.

The loop owns training: it checkpoints on a cadence, watches a
heartbeat (hosts report liveness; in single-host runs a watchdog thread
stands in), and on failure restores the latest checkpoint and replays the
data stream from the stored step — the data pipeline is deterministic in
(step, host), so recovery is exact.  ``FailureInjector`` drives the tests:
it raises at chosen steps to prove end-to-end restart works.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class Heartbeat:
    """Liveness tracking for hosts; a silent host past ``timeout`` is dead."""

    num_hosts: int
    timeout: float = 60.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [
            h
            for h in range(self.num_hosts)
            if now - self.last_seen.get(h, now) > self.timeout
        ]


@dataclasses.dataclass
class RunState:
    step: int = 0
    restarts: int = 0
    history: list = dataclasses.field(default_factory=list)


def run_with_restarts(
    *,
    total_steps: int,
    make_state: Callable[[], Any],
    train_step: Callable[[Any, int], Any],
    checkpointer: Checkpointer,
    save_every: int = 50,
    state_device=None,
    state_shardings=None,
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 10,
    on_step: Optional[Callable[[int, Any], None]] = None,
) -> RunState:
    """Generic checkpoint/restart loop.

    ``make_state()`` builds fresh (params, opt_state, ...) trees of tensors;
    ``train_step(state, step)`` advances one step and returns the new state.
    On any exception the latest checkpoint is restored and training resumes,
    onto ``state_device``, laid out by ``state_shardings`` when given (a
    tree of ``launch.sharding.NamedSharding``: the restore of a run on a
    mesh).
    """
    run = RunState()
    state = None
    while run.step < total_steps:
        try:
            if state is None:
                proto = make_state()
                if checkpointer.latest_step() is not None:
                    state, meta, ck_step = checkpointer.restore(
                        proto, device=state_device, shardings=state_shardings
                    )
                    run.step = ck_step
                else:
                    state = proto
                    checkpointer.save(0, state)
                    checkpointer.wait()
            while run.step < total_steps:
                if injector is not None:
                    injector.maybe_fail(run.step)
                state = train_step(state, run.step)
                run.step += 1
                if on_step is not None:
                    on_step(run.step, state)
                if run.step % save_every == 0:
                    checkpointer.save(run.step, state)
            checkpointer.save(run.step, state)
            checkpointer.wait()
        except SimulatedFailure as e:
            run.restarts += 1
            run.history.append((run.step, str(e)))
            if run.restarts > max_restarts:
                raise
            state = None  # force restore from checkpoint
            run.step = 0   # will be overwritten by the restore
    return run
