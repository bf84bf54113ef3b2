"""Fault tolerance for 1000+-node runs: step monitoring, straggler
detection, failure simulation, and elastic rescale planning. A copy of
``repro/runtime/fault.py`` (plain Python; the port's trainer drives it).

The single-host container cannot kill real nodes, so the machinery is
exercised through injectable clocks/failure hooks (tests/test_runtime.py);
the decision logic — what a production deployment would run on the
coordinator — is the real, tested artifact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class StepStats:
    step: int
    duration_s: float
    flagged: bool


class StepMonitor:
    """EMA-based per-step deadline monitor (straggler detection).

    A step slower than ``threshold`` x the EMA flags a straggler;
    ``trip_after`` consecutive flags trips the monitor (the signal a
    coordinator would use to trigger elastic rescale or node replacement).
    """

    def __init__(self, threshold: float = 2.5, trip_after: int = 3,
                 ema: float = 0.9, clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.trip_after = trip_after
        self.ema_factor = ema
        self.clock = clock
        self.ema_s: Optional[float] = None
        self.consecutive = 0
        self.history: List[StepStats] = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = self.clock()

    def end_step(self, step: int) -> StepStats:
        assert self._t0 is not None, "start_step not called"
        dur = self.clock() - self._t0
        self._t0 = None
        flagged = False
        if self.ema_s is not None and dur > self.threshold * self.ema_s:
            flagged = True
            self.consecutive += 1
            # a straggling step must not poison the baseline
        else:
            self.consecutive = 0
            self.ema_s = (dur if self.ema_s is None
                          else self.ema_factor * self.ema_s
                          + (1 - self.ema_factor) * dur)
        st = StepStats(step, dur, flagged)
        self.history.append(st)
        return st

    @property
    def tripped(self) -> bool:
        return self.consecutive >= self.trip_after

    def reset(self, rebaseline: bool = True, window: int = 5):
        """Clear the tripped state after a coordinator action (elastic
        rescale, node swap).

        Flagged steps never feed the EMA (a straggler must not poison the
        baseline), so after a rescale to a *legitimately* slower steady
        state every step keeps flagging against the stale pre-rescale
        baseline and the monitor stays tripped forever. ``rebaseline``
        re-seeds the EMA from the mean of the last ``window`` recorded
        steps — the new steady state; ``rebaseline=False`` cold-starts
        the baseline like a fresh monitor.
        """
        self.consecutive = 0
        self._t0 = None
        if not rebaseline:
            self.ema_s = None
        elif self.history:
            recent = [st.duration_s for st in self.history[-window:]]
            self.ema_s = float(sum(recent) / len(recent))


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.failures = 0

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise NodeFailure(f"injected node failure at step {step}")


class NodeFailure(RuntimeError):
    pass


def elastic_plan(n_healthy: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid on the surviving devices.

    Keeps the model axis intact (weights are TP-sharded across it; shrinking
    it would need a different weight partitioning), and drops data-parallel
    replicas to the largest multiple that fits — the standard elastic
    response to losing hosts.
    """
    if n_healthy < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_healthy} devices")
    return n_healthy // model_parallel, model_parallel


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_s: float = 0.0  # container tests keep this 0

    def __post_init__(self):
        self.restarts = 0

    def should_restart(self) -> bool:
        # check before mutating: a denied call must not burn budget, so
        # probing the policy after exhaustion stays False forever instead
        # of sliding restarts past max_restarts
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        if self.backoff_s:
            time.sleep(self.backoff_s * min(self.restarts, 5))
        return True
