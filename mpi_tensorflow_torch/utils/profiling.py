"""Host-side step timing, and the device-time summary of a profile.

``StepTimer`` is the counterpart of ``StepTimer`` in
``mpi_tensorflow_tpu/utils/profiling.py``.  PyTorch returns before the
card finishes, so the timer synchronises the card before each clock
read: a step's time is the device work it queued, not the time to queue
it.  Evaluation stays off the timed path (the loop stops the timer
before it evaluates).

``profiled_kernels`` records a call's kernels with ``torch.profiler``
(after a discarded warm cycle) and ``device_summary`` reads them: device
time by kernel category, the top kernels, and the device's idle share
of the window.  ``chip_smoke.py`` and the profiling scripts
(``scripts/torch_*_profile.py``) share them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass
class StepTimer:
    """Accumulates steady-state step wall time, skipping warmup steps
    (first-use kernel builds, allocator growth)."""
    warmup_steps: int = 2
    device: Optional[torch.device] = None
    _steps: int = 0
    _total: float = 0.0
    _t0: float = 0.0

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, count: int = 1) -> None:
        self._sync()
        dt = time.perf_counter() - self._t0
        if self.warmup_steps > 0:
            self.warmup_steps -= count
            return
        self._steps += count
        self._total += dt

    @property
    def steps_timed(self) -> int:
        return self._steps

    @property
    def mean_step_seconds(self) -> float:
        return self._total / self._steps if self._steps else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        s = self.mean_step_seconds
        return batch_size / s if s == s and s > 0 else float("nan")


KERNEL_CATEGORIES = (                # first match wins, on the lower name
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_dq", ("flash_dq_kernel",)),
    ("flash_dkdv", ("flash_dkdv_kernel",)),
    ("paged_attention", ("paged_attention",)),
    # BatchNorm's statistics, normalisation and backward (native and
    # cuDNN kernels)
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
    # the momentum update's multi-tensor kernels
    ("optimizer", ("multi_tensor_apply",)),
    # cuDNN's convolution kernels alone (fprop, dgrad, wgrad; its
    # CUTLASS implicit-GEMM ones), not every kernel cuDNN names
    ("conv", ("wgrad", "dgrad", "fprop_implicit_gemm",
              "implicitgemmconvolution")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "matmul",
                "gemv")),
    ("index/gather/scatter", ("index", "gather", "scatter", "embedding")),
    ("reduce/norm/softmax", ("reduce", "softmax", "norm", "argmax",
                             "max_kernel")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill",
                     "copy", "cat")),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for cat, keys in KERNEL_CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def cuda_kernels(prof) -> list:
    """The device (kernel) events of a finished ``torch.profiler``."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profiled_kernels(warm, run) -> list:
    """The kernel events of ``run()``, recorded by ``torch.profiler``
    after a cycle that records ``warm()`` and is discarded: kernels
    queued just after a profiler starts can go unrecorded (two of six
    10 ms launches were, when it started cold on an H100).  Both calls
    end with a card synchronisation."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cycles = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(cuda_kernels(p))
                 ) as prof:
        for fn in (warm, run):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return cycles[0]


def device_summary(kernels) -> dict:
    """Device time of a list of kernel events: kernel count, busy time
    (the union of kernel intervals), window, idle share (1 - busy /
    window), ms and share by ``kernel_category``, and the ten kernels
    with the most time."""
    by_name, by_cat, spans = {}, {}, []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        cat = kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    total = sum(by_cat.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernel_events": len(kernels),
        "device_busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "device_idle_share": 1.0 - busy / window if window else None,
        "device_ms_by_category": {k: v / 1e3 for k, v in sorted(
            by_cat.items(), key=lambda kv: -kv[1])},
        "share_by_category": {k: v / total for k, v in by_cat.items()}
        if total else {},
        "top_kernels_ms": [[n[:90], v / 1e3] for n, v in ranked],
    }
