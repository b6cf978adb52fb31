"""Advisory replica autoscaling from the serving loop's load signals.

Counterpart of ``mpi_tensorflow_tpu/serving/autoscale.py``, ported
whole.  ``engine.run`` and ``router.run`` feed a ``ScaleAdvisor`` one
observation an iteration; it records scale-up and scale-down decisions
under hysteresis (a watermark must hold for ``hold_ticks`` observations
in a row) and a cooldown after each decision.  Advisory: nothing here
starts or stops a replica.  The load score is the router's
``load_score`` (queue depth first; live-slot fraction, pool occupancy,
shed rate and the prefill backlog as tie-breakers) over the advised
replica count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Watermarks + damping for the advisor.  ``high_load`` /
    ``low_load`` bound the per-replica load score; ``hold_ticks`` is
    the hysteresis window (consecutive observations beyond a watermark
    before a decision); ``cooldown_ticks`` silences the advisor after
    each decision while the fleet would be reacting."""
    high_load: float = 4.0
    low_load: float = 0.25
    hold_ticks: int = 8
    cooldown_ticks: int = 32
    min_replicas: int = 1
    max_replicas: int = 8

    def __post_init__(self):
        if not self.high_load > self.low_load >= 0:
            raise ValueError(
                f"scale watermarks need high_load > low_load >= 0, got "
                f"high={self.high_load} low={self.low_load}")
        if self.hold_ticks < 1 or self.cooldown_ticks < 0:
            raise ValueError(
                f"scale damping needs hold_ticks >= 1 and "
                f"cooldown_ticks >= 0, got hold={self.hold_ticks} "
                f"cooldown={self.cooldown_ticks}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"replica bounds need 1 <= min <= max, got "
                f"min={self.min_replicas} max={self.max_replicas}")


class ScaleAdvisor:
    """Per-tick load observer -> advisory scale decisions.

    Single-owner like the scheduler: the thread driving the serve loop
    calls ``observe`` once per iteration and reads ``report`` after the
    run.  ``replicas`` tracks the ADVISED count, clamped to the
    policy's bounds — it never touches real engines."""

    def __init__(self, policy: Optional[ScalePolicy] = None, *,
                 replicas: int = 1):
        self.policy = policy if policy is not None else ScalePolicy()
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = int(replicas)
        self.ticks = 0
        self.peak_load = 0.0
        self.decisions: List[dict] = []
        self._above = 0
        self._below = 0
        self._cool = 0

    def load(self, *, queue_depth: float, occupancy: float,
             shed_rate: float = 0.0, live_fraction: float = 0.0,
             prefill_backlog: float = 0.0) -> float:
        """Instantaneous per-replica load score (the router's
        ``load_score`` weights), divided by the advised replica count.
        ``prefill_backlog`` is admitted-but-unprefilled prompt work in
        prefill-chunk units (engine.load_signals) — head-of-line
        pressure the queue depth misses: a burst of long prompts fills
        slots with sequences that emit nothing for many steps while
        the waiting queue looks empty."""
        raw = (queue_depth + 0.5 * live_fraction + 0.3 * occupancy
               + 0.2 * shed_rate + 0.2 * prefill_backlog)
        return raw / max(1, self.replicas)

    def observe(self, now_s: float, *, queue_depth: float,
                occupancy: float, shed_rate: float = 0.0,
                live_fraction: float = 0.0,
                prefill_backlog: float = 0.0) -> Optional[dict]:
        """One tick: fold the signals into the load score, advance the
        hysteresis counters, and return the decision dict if one fired
        this tick (None otherwise — the common case)."""
        load = self.load(queue_depth=queue_depth, occupancy=occupancy,
                         shed_rate=shed_rate, live_fraction=live_fraction,
                         prefill_backlog=prefill_backlog)
        self.ticks += 1
        self.peak_load = max(self.peak_load, load)
        if self._cool > 0:
            # cooldown: the fleet would still be reacting to the last
            # decision; watermark streaks restart after it
            self._cool -= 1
            self._above = self._below = 0
            return None
        p = self.policy
        if load > p.high_load:
            self._above += 1
            self._below = 0
        elif load < p.low_load:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= p.hold_ticks and self.replicas < p.max_replicas:
            return self._decide(now_s, "up", load)
        if self._below >= p.hold_ticks and self.replicas > p.min_replicas:
            return self._decide(now_s, "down", load)
        return None

    def observe_step(self, rec: dict) -> Optional[dict]:
        """One tick from a tracing step record (serving/tracing
        ``TraceBuffer`` entry): the record's ``signals`` are exactly
        ``engine.load_signals()`` captured at step end, so with tracing
        on the advisor and the trace read the SAME observation — advice
        is explainable by replaying the buffer through this method."""
        return self.observe(rec["t1"], **rec["signals"])

    def _decide(self, now_s: float, action: str, load: float) -> dict:
        before = self.replicas
        self.replicas += 1 if action == "up" else -1
        self._above = self._below = 0
        self._cool = self.policy.cooldown_ticks
        decision = {
            "tick": self.ticks,
            "t_s": round(float(now_s), 4),
            "action": action,
            "load": round(float(load), 4),
            "replicas_before": before,
            "replicas_after": self.replicas,
        }
        self.decisions.append(decision)
        return decision

    def report(self) -> dict:
        """The canonical ``autoscale`` result block bench detail
        carries: the decision log plus the final advice and enough
        policy echo to read the decisions against."""
        return {
            "ticks": self.ticks,
            "peak_load": round(self.peak_load, 4),
            "replicas_advised": self.replicas,
            "decisions": list(self.decisions),
            "policy": dataclasses.asdict(self.policy),
        }
