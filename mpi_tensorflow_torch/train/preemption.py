"""A cooperative stop flag wired to OS signals, for preemptible runs.

Counterpart of ``mpi_tensorflow_tpu/train/preemption.py``.  A
preemptible machine gets SIGTERM shortly before it is taken away:
``PreemptionGuard`` turns the signal into a flag (the handler only sets
it), the training loop polls the flag, checkpoints and returns, and
``--resume`` continues from the saved step (``train.ckpt_hooks``).
``request_stop()`` raises the same flag from code (tests, a scheduler).

    guard = PreemptionGuard.install()          # takes SIGTERM
    for step in range(n):
        ...
        if guard.should_stop:
            save_checkpoint(); break
    guard.uninstall()

``installed()`` is the context-manager form: the previous handlers come
back on the way out, even when the body raises.  Handlers can only be
installed on the main thread (``signal.signal`` raises ValueError
elsewhere).
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Optional

SIGNALS = (signal.SIGTERM,)      # what a preemptible machine is sent


class PreemptionGuard:
    """The stop flag; ``reason`` says what raised it first."""

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._prev: dict = {}
        self.reason: Optional[str] = None

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self, reason: str = "requested") -> None:
        self.reason = self.reason or reason
        self._stop.set()

    def _handler(self, signum, frame) -> None:
        self.request_stop(f"signal {signal.Signals(signum).name}")

    @classmethod
    def install(cls) -> "PreemptionGuard":
        """A guard whose handler now takes ``SIGNALS``; the handlers it
        replaced are kept for ``uninstall``."""
        guard = cls()
        for s in SIGNALS:
            guard._prev[s] = signal.signal(s, guard._handler)
        return guard

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    @classmethod
    @contextlib.contextmanager
    def installed(cls):
        """``with PreemptionGuard.installed() as guard:``, the handlers
        restored on exit whatever the body does."""
        guard = cls.install()
        try:
            yield guard
        finally:
            guard.uninstall()
