"""Runs stopped and resumed for ``tests/test_torch_checkpoint.py``: the
helpers its one-process tests share, and one rank of its 2-rank gloo
world.

    python tests/_torch_ckpt_worker.py RANK WORLD WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest).  The rank joins the world through a file in ``WORKDIR`` (a
rendezvous that needs no port, so no other test's world can take it)
over gloo, on one thread (the test starts it with one OpenMP and BLAS
thread too), and runs each case of ``CASES`` three times, each
run writing its checkpoints to a directory of its own under
``WORKDIR``: uninterrupted (``full``), stopped by ``request_stop`` on
rank 0 after step ``STOP`` (``part``: the stop is agreed at the next
trace point), and resumed from that checkpoint in a fresh run of the
same world (``part`` again).  Rank 0 writes ``WORKDIR/result.json``:
each run's printed lines, history, first step and what each rank's
guard recorded.  Each rank logs a ``[stamp]`` line at its import, its
rendezvous and the end of every run, with the seconds it took, so a
world that overruns the test's wait shows where.  The world's runs keep
no metrics sink (the one-process tests read theirs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import signal
import sys
import time

T0 = time.perf_counter()

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.config import Config  # noqa: E402
from mpi_tensorflow_torch.data import synthetic  # noqa: E402
from mpi_tensorflow_torch.models import bert, resnet  # noqa: E402
from mpi_tensorflow_torch.parallel import mesh  # noqa: E402
from mpi_tensorflow_torch.train import gspmd, loop, mlm_loop  # noqa: E402
from mpi_tensorflow_torch.train import preemption, step as step_lib  # noqa
from mpi_tensorflow_torch.train import checkpoint  # noqa: E402

# the image cases: a tiny basic-block ResNet on 32x32x3 synthetic rows,
# 10 classes; 8 rows a shard, trace every 4 steps: 203 train rows after
# the validation split, 12 steps a rank at world 2, 25 in one process
RESNET_GEO = dict(stage_sizes=(1, 1), widths=(8, 16), bottleneck=False,
                  cifar_stem=True, num_classes=10)
IMAGE_ROWS = (221, 16)                   # train (with validation), test
IMAGE = dict(epochs=1, batch_size=8, log_every=4, dropout_rate=0.0)
# the MLM cases: BERT_TINY at one layer, S = 16, 48 train rows, global
# batch 4 (2 a rank), trace every 3 steps of 12
MLM_CFG = dataclasses.replace(bert.BERT_TINY, layers=1, dropout=0.0)
MLM = dict(seq_len=16, train_n=48, test_n=8, learning_rate=1e-3)
MLM_CONFIG = dict(model="bert_base", epochs=1, batch_size=2, log_every=3,
                  seed=1)
STOP = 5                       # rank 0 asks to stop after this step
CASES = ("psum", "avg50", "replicated", "zero1", "fsdp")


def image_splits():
    return synthetic.image_classification(*IMAGE_ROWS, size=32, channels=3,
                                          num_classes=10, seed=4)


@contextlib.contextmanager
def stopping(step, on_rank=True, by_signal=False):
    """Runs in the block record their guards (the yielded list), and the
    one whose ``on_rank`` is set asks to stop once its state has taken
    train step ``step`` (None: never): ``request_stop``, or with
    ``by_signal`` a SIGTERM to this process."""
    guards = []
    install = preemption.PreemptionGuard.install.__func__
    real = step_lib.make_train_step, gspmd.make_train_step

    def recorded(cls, *a, **kw):
        guards.append(install(cls, *a, **kw))
        return guards[-1]

    def fire(taken):
        if step is not None and on_rank and taken == step + 1:
            if by_signal:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                guards[-1].request_stop()

    def wrap(make, count):
        def made(*a, **kw):
            fn = make(*a, **kw)

            def train_step(state, *rest):
                out = fn(state, *rest)
                fire(count(state))
                return out
            return train_step
        return made

    preemption.PreemptionGuard.install = classmethod(recorded)
    step_lib.make_train_step = wrap(real[0], lambda s: int(s.opt.step))
    gspmd.make_train_step = wrap(real[1], lambda s: int(s.step))
    try:
        yield guards
    finally:
        preemption.PreemptionGuard.install = classmethod(install)
        step_lib.make_train_step, gspmd.make_train_step = real


def run_case(case, ckpt_dir, resume=False, stop=None, on_rank=True,
             world_batch=None, by_signal=False, metrics=True):
    """One run of ``case`` with checkpoints in ``ckpt_dir`` (and, with
    ``metrics``, its metrics sink there too): ``(result, printed lines,
    guards)``."""
    metrics_dir = ckpt_dir if metrics else None
    with stopping(stop, on_rank, by_signal) as guards, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        if case in ("psum", "avg50"):
            cfg = Config(**IMAGE, sync=case, fused_steps=1 if case == "avg50"
                         else 4, checkpoint_dir=ckpt_dir, resume=resume,
                         metrics_dir=metrics_dir)
            model = resnet.ResNet.from_seed(resnet.Geometry(**RESNET_GEO),
                                            seed=0)
            res = loop.train(cfg, model=model, splits=image_splits(),
                             device="cpu")
        else:
            cfg = Config(**{**MLM_CONFIG, "batch_size": world_batch
                            or MLM_CONFIG["batch_size"]},
                         param_sharding=case, checkpoint_dir=ckpt_dir,
                         resume=resume, metrics_dir=metrics_dir)
            res = mlm_loop.train_mlm(cfg, MLM_CFG, device="cpu", **MLM)
    lines = [ln for ln in out.getvalue().splitlines()
             if not ln.startswith("[timing]")]
    return res, lines, guards


def summary(res, lines, guards) -> dict:
    return {"lines": lines, "history": res.history,
            "reasons": [g.reason for g in guards]}


def stamp(what: str, t0: float) -> None:
    """One line of the rank's log: what ended, at how many seconds
    since the rank started and how many it took."""
    now = time.perf_counter()
    print(f"[stamp] {what}: {now - T0:.3f} s since start, "
          f"{now - t0:.3f} s", flush=True)



def main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    t = time.perf_counter()
    stamp("imports", T0)
    mesh.initialize_distributed(
        "cpu", "gloo", init_method="file://" + os.path.join(
            os.path.abspath(workdir), "rendezvous"),
        rank=rank, world_size=world)
    stamp("rendezvous", t)
    out = {}
    try:
        for case in CASES:
            full = os.path.join(workdir, case, "full")
            part = os.path.join(workdir, case, "part")
            runs = {}
            for run, path, kw in (
                    ("full", full, {}),
                    ("stopped", part, dict(stop=STOP, on_rank=rank == 0)),
                    ("resumed", part, dict(resume=True))):
                t = time.perf_counter()
                # no metrics sink: no assertion of the world reads it,
                # and its first writer imports tensorboardX (~3 s a rank)
                runs[run] = run_case(case, path, metrics=False, **kw)
                stamp(f"{case} {run}", t)
                if run == "stopped":
                    stopped_at = checkpoint.latest_step(part)
            out[case] = {k: summary(*v) for k, v in runs.items()}
            out[case].update(last_step=checkpoint.latest_step(full),
                             stopped_at=stopped_at)
        if rank == 1:
            reasons = {c: out[c]["stopped"]["reasons"] for c in CASES}
            with open(os.path.join(workdir, "rank1.json"), "w") as f:
                json.dump(reasons, f)
        mesh.shutdown()
    except BaseException:
        mesh.shutdown()
        raise
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
