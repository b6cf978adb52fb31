"""Which failures are worth a retry.

Counterpart of ``is_transient`` and its tables in
``mpi_tensorflow_tpu/train/elastic.py``: serving's crash recovery
(``serving/recovery.run_with_replay``) and the replica router
(``serving/router``) classify every fault through it.  The restart
supervisor of training (``run_with_recovery``, ``--max-restarts``) is
not ported yet (ROADMAP Queue 1 item 15c).

The verdict is taken by exception type first (OS and connection errors
retry), then by the canonical status code a message leads with
(``"UNAVAILABLE: ..."``; the reference's PJRT errors carry one, and the
router's injected faults do here), and only then by substrings of the
message.  The tables are the reference's.

CUDA adds its own permanent cases, checked before anything else: a
sticky fault (an illegal memory access, an unspecified launch failure,
a device-side assert) poisons the CUDA context of the whole process, so
an engine rebuilt in the same process cannot recover.  These faults,
and ``torch.cuda.OutOfMemoryError``, are permanent: the process dies and
the replay journal replays its work in a fresh one.
"""

from __future__ import annotations

from typing import Optional

import torch

_TRANSIENT_MARKERS = ("device_lost", "device lost", "unavailable",
                      "aborted", "preempt", "connection", "socket",
                      "deadline", "heartbeat", "simulated")
_PERMANENT_MARKERS = ("resource_exhausted", "out of memory", "oom",
                      "invalid_argument", "unimplemented", "failed_precond")

# canonical absl/gRPC status codes, classified before any free-text
# matching; UNKNOWN is in neither set (gRPC's catch-all falls through to
# the substrings)
_TRANSIENT_CODES = frozenset({"UNAVAILABLE", "ABORTED", "DEADLINE_EXCEEDED",
                              "CANCELLED"})
_PERMANENT_CODES = frozenset({"RESOURCE_EXHAUSTED", "INVALID_ARGUMENT",
                              "UNIMPLEMENTED", "FAILED_PRECONDITION",
                              "NOT_FOUND", "ALREADY_EXISTS", "OUT_OF_RANGE",
                              "PERMISSION_DENIED", "UNAUTHENTICATED"})

# CUDA's sticky faults: the context is lost for the rest of the process
_CUDA_STICKY_MARKERS = ("illegal memory access", "unspecified launch failure",
                        "device-side assert")


def _status_code(e: BaseException) -> Optional[str]:
    """Leading canonical status code of an error message, if any."""
    head = str(e).split(":", 1)[0].strip().upper().replace(" ", "_")
    if head in _TRANSIENT_CODES or head in _PERMANENT_CODES:
        return head
    return None


def is_transient(e: BaseException) -> bool:
    """Worth retrying in this process?  CUDA's sticky faults and an
    out-of-memory error never are; then the reference's order: OS and
    connection errors are, then the status code decides, then the
    message's substrings."""
    msg = str(e).lower()
    if isinstance(e, torch.cuda.OutOfMemoryError) \
            or any(m in msg for m in _CUDA_STICKY_MARKERS):
        return False
    if isinstance(e, (OSError, ConnectionError)):
        return True
    code = _status_code(e)
    if code is not None:
        return code in _TRANSIENT_CODES
    if any(m in msg for m in _PERMANENT_MARKERS):
        return False
    return any(m in msg for m in _TRANSIENT_MARKERS)
