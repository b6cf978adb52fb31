"""Checkpoint, resume and preemption for the training loops.

Counterpart of ``mpi_tensorflow_tpu/train/ckpt_hooks.py``, used by
``train.loop.train`` and ``train.mlm_loop.train_mlm`` at the reference's
call sites:

    hooks = CheckpointHooks(config.checkpoint_dir, device=dev)
    state, start = hooks.resume(state) if config.resume else (state, 0)
    for t in range(start, num_steps):
        ...
        if hooks.stop_now(t):              # each step, one rank only
            hooks.preempt_save(state, t); break
        if trace_point:
            hooks.save_async(state, t)
            if hooks.stop_agreed(t):       # trace points, every rank
                hooks.preempt_save(state, t, already_queued=True); break
    hooks.close()

A SIGTERM seen at different steps on different ranks must not make each
rank checkpoint (or stop calling collectives) at a step of its own.
With more than one rank the stop is therefore agreed at trace points:
an all-reduce (MAX) of each rank's flag over the process group, on the
training device (NCCL for a card, gloo for the CPU), so every rank
stops, saves and names the checkpoint at the same step.  One rank alone
stops at the step it sees the flag.

Checkpoints are ``train.checkpoint``'s sharded form, written by an
``AsyncSaver`` from the leaves ``train.state_io.parts`` gives
(``stacked``: avg50's replica-per-rank state).  ``stalls`` and
``restore_seconds`` keep what the loop waited for: each ``save_async``
call's seconds and the restore's.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

import torch

from mpi_tensorflow_torch.parallel import collectives
from mpi_tensorflow_torch.parallel import mesh as meshlib
from mpi_tensorflow_torch.train import checkpoint, preemption, state_io


class CheckpointHooks:
    """The loops' checkpoint machinery; inactive without a directory."""

    def __init__(self, checkpoint_dir: Optional[str], *,
                 verbose: bool = True, device="cpu",
                 stacked: bool = False) -> None:
        self.dir = checkpoint_dir
        self.verbose = verbose
        self.device = torch.device(device)
        self.stacked = stacked
        self.saver: Optional[checkpoint.AsyncSaver] = None
        self.guard: Optional[preemption.PreemptionGuard] = None
        self.stalls: list = []
        self.restore_seconds: Optional[float] = None
        if checkpoint_dir:
            self.saver = checkpoint.AsyncSaver()
            try:
                self.guard = preemption.PreemptionGuard.install()
            except ValueError:
                self.guard = None   # signal handlers need the main thread

    def _say(self, msg: str) -> None:
        if self.verbose and meshlib.process_index() == 0:
            print(msg, flush=True)

    def resume(self, state: Any) -> Tuple[Any, int]:
        """``(state, first step)``: the latest committed checkpoint
        restored into ``state`` in place, and its step + 1 (``(state,
        0)`` when there is none)."""
        if not self.dir:
            return state, 0
        last = checkpoint.latest_step(self.dir)
        if last is None:
            return state, 0
        t0 = time.perf_counter()
        arrays, _ = checkpoint.restore_latest(
            self.dir, state_io.parts(state, self.stacked), last)
        state = state_io.load(state, arrays, self.stacked)
        self.restore_seconds = time.perf_counter() - t0
        self._say(f"[checkpoint] resumed from step {last}")
        return state, last + 1

    def stop_now(self, t: int) -> bool:
        """The local flag, with one rank only (a lone rank leaving the
        loop would leave its peers waiting in a collective)."""
        return (self.guard is not None and self.guard.should_stop
                and meshlib.process_count() == 1)

    def stop_agreed(self, t: int) -> bool:
        """At a trace point, on every rank: stop iff any rank saw the
        signal."""
        if self.guard is None:
            return False
        local = self.guard.should_stop
        if meshlib.process_count() == 1:
            return local
        flag = torch.tensor([1 if local else 0], dtype=torch.int32,
                            device=self.device)
        agreed = bool(int(collectives.allreduce_max(flag)))
        if agreed and not local:
            self.guard.request_stop("peer preemption")
        return agreed

    def save_async(self, state: Any, t: int) -> None:
        """Queue the checkpoint of step ``t``: the host copy now, the
        write on the saver's thread (after the write before it ends)."""
        if self.saver is None:
            return
        t0 = time.perf_counter()
        self.saver.save(checkpoint.step_path(self.dir, t),
                        state_io.parts(state, self.stacked), step=t)
        self.stalls.append(time.perf_counter() - t0)

    def preempt_save(self, state: Any, t: int, *,
                     already_queued: bool = False) -> None:
        """Step ``t`` committed to disk before the loop stops;
        ``already_queued``: ``save_async(state, t)`` was just called."""
        if not already_queued:
            self.saver.save(checkpoint.step_path(self.dir, t),
                            state_io.parts(state, self.stacked), step=t)
        self.saver.wait()
        reason = self.guard.reason if self.guard else "stop"
        self._say(f"[preemption] {reason}: checkpointed step {t}, exiting "
                  "cleanly")

    def close(self) -> None:
        if self.guard is not None:
            self.guard.uninstall()
        if self.saver is not None:
            self.saver.close()
