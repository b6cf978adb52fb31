#!/usr/bin/env python3
"""How far two float32 runs of the port's CNN training part, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_cnn_drift.py

Two measurements behind the CNN's parity design:

1. ``threads``: the port's train step from the JAX reference's initial
   parameters (``MnistCnn().init(jax.random.key(1))``) on the synthetic
   MNIST (1200 train rows, batch 8, dropout 0, the first 125 steps, as
   ``tests/test_torch_cnn_train.py`` trains), run at torch's default
   thread count, 4, 2 and 1 thread, each against the reference's own
   train step (``jax.jit`` on a one-device mesh) over the same batches
   from the same parameters.  One line per thread count: the largest
   parameter difference from the reference every 10 steps and at the
   end, the first step past 1e-6, conv1_b's difference at the end; and
   against the default thread count's run, the first step whose
   forward takes another ReLU or max-pool decision, and conv1_b at the
   end.  float32 sums in another order part the trajectories; a flipped
   decision may amplify the part, or not.
2. ``fp64``: the same step from the port's own init (seed 3) over the
   first 15 batches of 64 rows, float32 against float64 — the drift
   ``chip_smoke.py`` phase 10a's card-vs-CPU tolerance is set against.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from __graft_entry__ import _force_virtual_cpu_env  # noqa: E402

_force_virtual_cpu_env(os.environ, 1)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mpi_tensorflow_tpu.config import Config as JaxConfig  # noqa: E402
from mpi_tensorflow_tpu.models import cnn as jax_cnn  # noqa: E402
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh  # noqa: E402
from mpi_tensorflow_tpu.train import optimizer as jax_opt  # noqa: E402
from mpi_tensorflow_tpu.train import step as jax_step  # noqa: E402
from mpi_tensorflow_torch.config import Config  # noqa: E402
from mpi_tensorflow_torch.data import mnist, prefetch  # noqa: E402
from mpi_tensorflow_torch.models import cnn, convert  # noqa: E402
from mpi_tensorflow_torch.train import step  # noqa: E402


def decisions(model, x) -> dict:
    """The forward's discrete decisions: ReLU signs and max-pool
    indices."""
    p = model.param_tree()
    with torch.no_grad():
        h = (F.conv2d(x.permute(0, 3, 1, 2), p["conv1_w"], padding=2)
             + p["conv1_b"][:, None, None])
        out = {"relu1": h > 0}
        h, out["pool1"] = F.max_pool2d(F.relu(h), 2, 2, ceil_mode=True,
                                       return_indices=True)
        h = F.conv2d(h, p["conv2_w"], padding=2) + p["conv2_b"][:, None,
                                                                None]
        out["relu2"] = h > 0
        h, out["pool2"] = F.max_pool2d(F.relu(h), 2, 2, ceil_mode=True,
                                       return_indices=True)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        out["relu3"] = h @ p["fc1_w"] + p["fc1_b"] > 0
    return out


def run(params, batches, threads, dtype=torch.float32, record=False):
    torch.set_num_threads(threads)
    model = cnn.MnistCnn(params, dropout_rate=0.0).to(dtype)
    state = step.init_state(model)
    train_step = step.make_train_step(model, Config(dropout_rate=0.0), 1,
                                      decay_steps=1000)
    snaps, seen = [], []
    for x, y in batches:
        x = torch.from_numpy(x).to(dtype)
        if record:
            seen.append(decisions(model, x))
        state, _ = train_step(state, x, torch.from_numpy(y))
        snaps.append([p.detach().double().clone()
                      for p in model.param_tree().values()])
    return snaps, seen


def run_reference(init, batches):
    """The reference's parameters (float64, port order) after each of
    its train steps over ``batches``."""
    model = jax_cnn.MnistCnn(dropout_rate=0.0)
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    train_step = jax_step.make_train_step(
        model, JaxConfig(dropout_rate=0.0), mesh, decay_steps=1000)
    state = jax_step.TrainState(jax.tree.map(jax.numpy.asarray, init),
                                jax_opt.momentum_init(init), {})
    rng = jax.random.key(0)
    snaps = []
    for x, y in batches:
        state, _ = train_step(state, x, y, rng)
        params = convert.cnn_params_from_jax(
            jax.tree.map(np.asarray, state.params))
        snaps.append([params[k].double() for k in cnn.NAMES])
    return snaps


def main() -> int:
    default_threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as d:
        mnist._write_synthetic(d, train_n=1200, test_n=256)
        splits = mnist.load_splits(d, train_n=1200, test_n=256)
    tr_d = splits.train_data[None]
    tr_l = splits.train_labels[None]
    batches = [tuple(a[0] for a in prefetch.assemble_window(
        tr_d, tr_l, t, 1, 1, 8)) for t in range(125)]
    init = jax.tree.map(np.asarray, jax.jit(jax_cnn.MnistCnn().init)(
        jax.random.key(1)))
    params = convert.cnn_params_from_jax(init)
    conv1_b = cnn.NAMES.index("conv1_b")
    ref = run_reference(init, batches)

    def parted(x, y):
        """Largest parameter difference after each step."""
        return [max(float((p - q).abs().max()) for p, q in zip(sx, sy))
                for sx, sy in zip(x, y)]

    base = None
    for threads in sorted({default_threads, 4, 2, 1}, reverse=True):
        snaps, seen = run(params, batches, threads, record=True)
        vs_ref = parted(snaps, ref)
        line = {"threads": threads,
                "vs_reference_after_step": vs_ref[::10] + [vs_ref[-1]],
                "vs_reference_first_step_past_1e-6": next(
                    (t for t, d in enumerate(vs_ref) if d > 1e-6), None),
                "vs_reference_conv1_b_at_end": float(
                    (snaps[-1][conv1_b] - ref[-1][conv1_b]).abs().max())}
        if base is None:
            base = snaps, seen
        else:
            vs_base = parted(snaps, base[0])
            flips = [{k: int((da[k] != db[k]).sum()) for k in da}
                     for da, db in zip(base[1], seen)]
            first = next((t for t, f in enumerate(flips)
                          if any(f.values())), None)
            line.update({
                "vs_default_threads_first_step_deciding_differently": first,
                "decisions_differing_there": flips[first]
                if first is not None else None,
                "param_diff_before_that_step": vs_base[first - 1]
                if first else None,
                "vs_default_threads_conv1_b_at_end": float(
                    (snaps[-1][conv1_b] - base[0][-1][conv1_b]).abs()
                    .max())})
        print(json.dumps(line))
    big = [(splits.train_data[i * 64:(i + 1) * 64],
            splits.train_labels[i * 64:(i + 1) * 64]) for i in range(15)]
    own = cnn.init_params(torch.Generator().manual_seed(3))
    f32, _ = run(own, big, default_threads)
    f64, _ = run(own, big, default_threads, dtype=torch.float64)
    print(json.dumps({"fp32_vs_fp64_after_15_steps_of_64": max(
        float((x - y).abs().max()) for x, y in zip(f32[-1], f64[-1]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
