"""The image-family host loop: ``python -m mpi_tensorflow_torch``'s
zero-flag path (the reference MPI script's ``Cnn.run_process``).

Counterpart of ``mpi_tensorflow_tpu/train/loop.py``.  The JAX mesh's
``data`` axis is the ``torch.distributed`` world (one rank per card,
``parallel.mesh``), or, with no process group, ``num_shards`` shards in
one process (``psum`` only):

- per-shard contiguous layout (shard i owns train rows ``[i*local_n,
  (i+1)*local_n)``; every rank loads the same split and keeps its own
  shard), ``num_steps = epochs * local_n // batch_size``, and one decay
  of the LR per local epoch;
- sequential wraparound batching per shard, no shuffling
  (``data/prefetch.assemble_window``);
- ``psum``: the gradients averaged every step (``train/step.py``),
  each shard's batch split into ``grad_accum`` microbatches whose
  gradients add up first;
  ``avg50``: each rank steps its own replica, and the replicas'
  parameters and velocity are averaged at every trace point but the
  last (mpipy.py:91); the replicas start from rank 0's parameters;
- a trace point at ``(t > 0 and t % log_every == 0) or t ==
  num_steps - 1``, in the JAX loop's order: stop the timer, evaluate
  the test set (each rank its rows of every window,
  ``evaluation.eval_sharded``), print one line per shard, average
  (avg50), check early stopping on the averaged state, restart the
  timer.  Rank 0 alone prints, so a W-rank run prints what the JAX loop
  prints on a W-device mesh;
- windows of K = ``fused_steps + 1`` steps (1 when ``fused_steps`` is
  1; always 1 under avg50, as in the reference) ending on the trace
  cadence (``window_schedule``, from the first step of the run or of a
  resume), each uploaded once.  ``prefetch`` ``thread`` and ``auto``
  assemble the windows ahead on a background thread
  (``data.prefetch.ThreadPrefetcher``, closed in a ``finally``); ``off``
  assembles each inline, just before its upload.  The reference's
  ``auto`` takes its C++ worker when that loads; the port's takes the
  thread (``native`` is ROADMAP Queue 1 item 15c);
- the scanned arm (K > 1): one ``step.make_multi_train_step`` call a
  window, the reference's one scanned dispatch.  On the card it is one
  CUDA graph replay (``train.graphs``): one graph per distinct width of
  the schedule (the first window, the middle ones, the tail; a resume
  adds at most one), all captured before the first timed span, and the
  evaluation is one replay over every test window, uploaded once
  (``step.make_multi_eval_step``).  Under gloo (two ranks on one card)
  and on the CPU the steps run one after another.  K = 1 (``fused_steps
  1``, avg50) steps one step at a time, as the reference's
  one-dispatch-per-step shape;
- early stopping on the validation split when ``early_stop_patience >
  0`` (every rank reaches the same verdict from the gathered
  predictions).

The model is the reference CNN (``mnist_cnn``), a ResNet (``resnet20``,
``resnet50``; ``models/resnet.py``), whose BatchNorm statistics ride in
the train state (``train/step.py``), or the ViT (``vit``;
``models/vit.py``, BERT's encoder on image patches); the data is
MNIST, CIFAR-10 or the ImageNet-shaped set (``load_dataset``).  A label
the model cannot score (``>= num_classes``) raises before any step:
the reference builds ResNet-50 with ``config.num_classes`` (10 unless
``--num-classes`` says otherwise) and on ``imagenet_synthetic``'s 1000
classes reads NaN from its ``take_along_axis``.

Timing: ``StepTimer(warmup_steps=1)`` with this rank's card
synchronised at every trace point, so each span is the device work it
queued; the first span (the first window) is skipped.  Rank 0's time is
the one reported, as the JAX loop reports process 0's: under psum the
per-step all-reduce keeps the ranks in step, under avg50 they meet only
at the trace points.  ``images_per_sec`` counts the global batch, batch
x shards.  Batches go to the device named by ``device`` (``cuda``
unless the caller asks for the CPU); nothing falls back.

Checkpoints, resume and preemption (``train.ckpt_hooks``, at the
reference's call sites): with ``checkpoint_dir`` each trace point
queues a sharded checkpoint of its step after the average and the
early-stopping verdict, and ``resume`` restarts from the latest
committed one (``window_schedule`` from its step + 1).  A SIGTERM (or
``request_stop``) stops one rank after the step it lands in,
checkpointed; a graph replay cannot stop inside its window, so on the
card's scanned arm the stop lands at the window's end, as the
reference's does (``loop.py:268-270``).  Across ranks the stop is
agreed at the next trace point.  Under avg50 the
state is saved as the reference's stacked one, each rank its replica.
The step's dropout generator is seeded by the step, so a resumed run
repeats the uninterrupted one.  With ``metrics_dir`` rank 0 writes
``eval/test_error_pct`` at each trace point and ``perf/images_per_sec``
at the end (``utils.metrics_writer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import cifar, imagenet, mnist, prefetch
from mpi_tensorflow_torch.data import sharding
from mpi_tensorflow_torch.data.idx import error_rate
from mpi_tensorflow_torch.models import cnn, resnet, vit
from mpi_tensorflow_torch.parallel import mesh as meshlib
from mpi_tensorflow_torch.train import evaluation, step as step_lib
from mpi_tensorflow_torch.train.ckpt_hooks import CheckpointHooks
from mpi_tensorflow_torch.train.gspmd import step_generator
from mpi_tensorflow_torch.utils import logging as logs
from mpi_tensorflow_torch.utils import metrics_writer
from mpi_tensorflow_torch.utils.device import device_name, resolve_device
from mpi_tensorflow_torch.utils.profiling import StepTimer


@dataclasses.dataclass
class TrainResult:
    state: Any
    history: list          # [(step, global test error %), ...]
    final_test_error: float
    images_per_sec: float
    step_time_seconds: float
    num_devices: int       # shards: ranks x shards in a process
    num_steps: int
    final_loss: float      # the last step's training loss
    device: str            # the card's name, or "cpu"


def build_model(config: Config):
    """The model of ``config.model``, random weights from
    ``config.seed``."""
    if config.model == "mnist_cnn":
        return cnn.MnistCnn.from_seed(
            config.seed, image_size=config.image_size,
            num_channels=config.num_channels,
            num_classes=config.num_classes,
            dropout_rate=config.dropout_rate,
            compute_dtype=config.compute_dtype)
    if config.model in ("resnet20", "resnet50"):
        return resnet.build(config.model, num_classes=config.num_classes,
                            seed=config.seed,
                            compute_dtype=config.compute_dtype,
                            remat=config.remat)
    if config.model == "vit":
        # the reference's rule: channels follow the dataset (MNIST is
        # single-channel), the patch the input size (28 -> 7 px patches,
        # a 4x4 grid; 32 -> 4 px, 8x8; else 16 px, 224 -> 14x14)
        patch = {28: 7, 32: 4}.get(config.image_size, 16)
        return vit.VisionTransformer.from_seed(dataclasses.replace(
            vit.VIT_TINY_CIFAR, image_size=config.image_size, patch=patch,
            channels=1 if config.dataset == "mnist" else 3,
            num_classes=config.num_classes, dtype=config.compute_dtype,
            remat=config.remat), seed=config.seed)
    raise ValueError(f"unknown image model {config.model!r}")


def load_dataset(config: Config, num_shards: int,
                 verbose: bool = True) -> mnist.Splits:
    if config.dataset == "mnist":
        mnist.ensure_data(config.data_dir, verbose=verbose)
        return mnist.load_splits(config.data_dir, num_shards=num_shards)
    if config.dataset == "cifar10":
        return cifar.load_splits(config.data_dir)
    if config.dataset == "imagenet_synthetic":
        return imagenet.load_splits(config.data_dir)
    raise ValueError(f"unknown dataset {config.dataset!r} for the image "
                     f"loop")


def check_labels(splits: mnist.Splits, num_classes: int) -> None:
    """Raise unless every label is a class the model scores."""
    top = max(int(a.max()) for a in (splits.train_labels,
                                     splits.test_labels, splits.val_labels)
              if a.size)
    if top >= num_classes:
        raise ValueError(
            f"the data has label {top}, the model scores {num_classes} "
            f"classes: pass --num-classes {top + 1} or more (the reference "
            f"trains on such labels and reads NaN losses)")


def is_trace_step(t: int, log_every: int, num_steps: int) -> bool:
    return (t > 0 and t % log_every == 0) or t == num_steps - 1


def window_schedule(num_steps: int, log_every: int, window_k: int,
                    start_step: int = 0):
    """``(starts, widths)``: windows of at most ``window_k`` steps, each
    ending at the latest on the next trace step, so the trace (and eval
    and early-stop) schedule is the per-step loop's."""
    L = log_every
    starts, widths = [], []
    t = start_step
    while t < num_steps:
        T = min(((max(t, 1) + L - 1) // L) * L, num_steps - 1)
        w = min(T - t + 1, window_k)
        starts.append(t)
        widths.append(w)
        t += w
    return starts, widths


def train(config: Config, model=None, splits: Optional[mnist.Splits] = None,
          num_shards: Optional[int] = None, verbose: bool = True,
          device="cuda") -> TrainResult:
    """Data-parallel training of ``model`` (default: ``build_model``) on
    ``device``: one shard per rank of the process group, or, without
    one, ``num_shards`` shards in one process (default 1).
    ``config.mesh_shape`` must give the ``data`` axis the world size."""
    world = meshlib.data_axis_size(meshlib.make_mesh(config.mesh_shape))
    rank = meshlib.process_index()
    across_ranks = meshlib.active()
    if across_ranks and num_shards not in (None, 1):
        raise ValueError(f"a rank holds one shard; num_shards={num_shards} "
                         f"is the in-process data axis")
    local_shards = num_shards or 1
    avg50 = config.sync == "avg50"
    if avg50 and local_shards > 1:
        raise ValueError("avg50 runs one replica per rank: launch "
                         f"{local_shards} ranks, not num_shards="
                         f"{local_shards} in one process")
    ndev = world * local_shards
    say = verbose and rank == 0
    model = model if model is not None else build_model(config)
    dev = resolve_device(device)
    model = model.to(dev)
    if splits is None:
        splits = load_dataset(config, ndev, verbose=say)
    check_labels(splits, model.num_classes)
    b = config.batch_size

    local_n = splits.train_labels.shape[0] // ndev
    if local_n <= b:
        raise ValueError(f"local train size {local_n} must exceed batch {b}")
    tr_d = splits.train_data[:local_n * ndev].reshape(
        ndev, local_n, *splits.train_data.shape[1:])
    tr_l = splits.train_labels[:local_n * ndev].reshape(ndev, local_n)
    mine = slice(rank * local_shards, (rank + 1) * local_shards)
    tr_d, tr_l = tr_d[mine], tr_l[mine]
    num_steps = sharding.steps_per_run(local_n, b, config.epochs)
    global_b = b * ndev

    step_lib.broadcast_params(model)
    state = step_lib.init_state(model)
    fused = 1 if avg50 else max(1, int(config.fused_steps or 1))
    window_k = fused + 1 if fused > 1 else 1
    multi_step = eval_multi = None
    if avg50:
        train_step = step_lib.make_local_train_step(model, config,
                                                    decay_steps=local_n)
        average = step_lib.make_average_step(state)
    elif window_k == 1:
        train_step = step_lib.make_train_step(
            model, config, local_shards, decay_steps=local_n,
            across_ranks=across_ranks)
    else:
        multi_step = step_lib.make_multi_train_step(
            model, config, local_shards, decay_steps=local_n,
            across_ranks=across_ranks, rank=rank, horizon=num_steps)
        eval_multi = step_lib.make_multi_eval_step(model, config)
    eval_step = step_lib.make_eval_step(model, config)
    dropout = getattr(model, "dropout_rate", 0.0) > 0.0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def generator(t):
        if not dropout:
            return None
        if config.grad_accum == 1:
            return step_generator(config.seed + 1, t, dev, rank)
        return [step_generator(config.seed + 1, t, dev, rank, i)
                for i in range(config.grad_accum)]

    uploads = {}            # the eval sets' windows, on the device once

    def run_eval(data):
        if eval_multi is None:
            return evaluation.eval_sharded(
                lambda x: eval_step(state, put(x)).cpu().numpy(), data,
                global_b, rank, world)
        if id(data) not in uploads:
            uploads[id(data)] = put(evaluation.rank_windows(
                data, global_b, rank, world))
        return evaluation.eval_sharded_fused(
            lambda w: eval_multi(state, w).cpu().numpy(), uploads[id(data)],
            data.shape[0], global_b, world)

    es_patience = int(config.early_stop_patience or 0)
    es_usable = es_patience > 0 and splits.val_labels.shape[0] >= global_b
    if es_patience > 0 and not es_usable and say:
        print(f"[early-stop] DISABLED: validation split "
              f"({splits.val_labels.shape[0]} rows) is smaller than the "
              f"global batch ({global_b}) — --early-stop-patience ignored")
    es_best, es_bad = float("inf"), 0

    def check_early_stop() -> bool:
        nonlocal es_best, es_bad
        if not es_usable:
            return False
        val_err = error_rate(run_eval(splits.val_data), splits.val_labels)
        if say:
            logs.val_trace(0, val_err)
        if val_err < es_best - 1e-12:
            es_best, es_bad = val_err, 0
            return False
        es_bad += 1
        if es_bad >= es_patience:
            if say:
                print(f"[early-stop] validation error has not improved for "
                      f"{es_patience} trace points (best {es_best:.2f}%)")
            return True
        return False

    timer = StepTimer(warmup_steps=1, device=dev)
    history = []
    metrics = {}
    pending = 0                 # steps queued since the span started
    hooks = CheckpointHooks(config.checkpoint_dir, verbose=verbose,
                            device=dev, stacked=avg50)
    mw = metrics_writer.for_process(config.metrics_dir, rank)
    pf = None
    try:
        start_step = 0
        if config.resume:
            state, start_step = hooks.resume(state)
        schedule = window_schedule(num_steps, config.log_every, window_k,
                                   start_step)
        if config.prefetch != "off":
            pf = prefetch.make_prefetcher(tr_d, tr_l, *schedule, window_k,
                                          b, force=config.prefetch)
        if multi_step is not None:
            # every width's graph before the first timed span
            shape = (window_k, b * local_shards)
            multi_step.prepare(
                state, put(np.zeros(shape + tr_d.shape[2:], tr_d.dtype)),
                put(np.zeros(shape, tr_l.dtype)), schedule[1])
        if say:
            logs.session_start(0)
        timer.start()
        for t0, w in zip(*schedule):
            if pf is not None:
                bs, ls, _ = pf.next()
            else:
                bs, ls = prefetch.assemble_window(tr_d, tr_l, t0, w,
                                                  window_k, b)
            if multi_step is not None:
                state, m = multi_step(state, put(bs), put(ls), w,
                                      stop=hooks.stop_now)
                taken = int(state.opt.step) - t0
                metrics = {"loss": m["loss"][taken - 1]}
            else:
                bdev, ldev = put(bs[:w]), put(ls[:w])
                for taken in range(1, w + 1):
                    state, metrics = train_step(
                        state, bdev[taken - 1], ldev[taken - 1],
                        generator(t0 + taken - 1))
                    if hooks.stop_now(t0 + taken - 1):
                        break
            pending += taken
            if hooks.stop_now(t0 + taken - 1):
                hooks.preempt_save(state, t0 + taken - 1)
                break
            t = t0 + w - 1
            if not is_trace_step(t, config.log_every, num_steps):
                continue
            # close the timed span, evaluate off it, trace, average
            timer.stop(pending)
            pending = 0
            preds = run_eval(splits.test_data)
            history.append((t, error_rate(preds, splits.test_labels)))
            mw.scalar("eval/test_error_pct", history[-1][1], t)
            if say:
                for r, e in enumerate(evaluation.shard_error_rates(
                        preds, splits.test_labels, ndev)):
                    logs.step_trace(r, t, e)
            last = t == num_steps - 1
            if avg50 and not last:                 # mpipy.py:91
                state = average(state)
            stop_early = not last and check_early_stop()
            hooks.save_async(state, t)
            if stop_early:
                break
            if not last and hooks.stop_agreed(t):
                hooks.preempt_save(state, t, already_queued=True)
                break
            timer.start()
        ips = timer.images_per_sec(global_b)
        if ips == ips:              # a run with no timed span reads NaN
            mw.scalar("perf/images_per_sec", ips, num_steps)
    finally:
        if pf is not None:
            pf.close()
        hooks.close()               # every queued checkpoint on disk
        mw.close()

    final_err = history[-1][1] if history else float("nan")
    if say:
        logs.timing_summary(ips, timer.mean_step_seconds * 1e3, ndev)
    return TrainResult(
        state=state, history=history, final_test_error=final_err,
        images_per_sec=ips, step_time_seconds=timer.mean_step_seconds,
        num_devices=ndev, num_steps=num_steps,
        final_loss=float(metrics["loss"]) if metrics else float("nan"),
        device=device_name(dev))
