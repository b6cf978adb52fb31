"""Console trace, line for line the reference's format.

Counterpart of ``mpi_tensorflow_tpu/utils/logging.py`` (itself the MPI
script's ``Process ID: <rank>  training session starts!`` and ``<rank>
process at <step> with test error: <e>%`` lines — one per shard at each
trace point — plus the validation line of early stopping and the timing
summary), so a port trace and a reference trace diff line by line.
"""

from __future__ import annotations

import sys


def session_start(rank: int) -> None:
    print("Process ID:", rank, " training session starts!")
    sys.stdout.flush()


def step_trace(rank: int, step: int, test_error: float) -> None:
    print(rank, " process at ", step, "with test error: %.1f%%" % test_error)
    sys.stdout.flush()


def val_trace(rank: int, val_error: float) -> None:
    """The validation error at a trace point (early stopping only)."""
    print(f"{rank}  validation error: {val_error:.1f}%")
    sys.stdout.flush()


def timing_summary(images_per_sec: float, step_time_ms: float,
                   num_devices: int) -> None:
    print(f"[timing] {images_per_sec:,.0f} images/sec "
          f"({images_per_sec / max(num_devices, 1):,.0f} /chip) | "
          f"step {step_time_ms:.3f} ms | {num_devices} device(s)")
    sys.stdout.flush()
