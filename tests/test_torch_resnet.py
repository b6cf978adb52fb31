"""The port's ResNet path against the JAX reference, on the CPU.

Integer and host logic must match exactly: the CIFAR-10 binary parse
and splits on a small written ``cifar-10-batches-bin``, the synthetic
CIFAR-10 and ImageNet sets, ``imagenet.load_splits`` on user-provided
``.npy`` shards (the resolution-marker refusal too), the parameter and
state trees of ``resnet20`` and ``resnet50`` (names, shapes,
``l2_params``) against ``jax.eval_shape`` of the reference's ``init``,
and the FLOP counts.  A class-per-directory image tree whose images do
not decode raises, as the reference's ingest does, rather than falling
back to synthetic data (``tests/test_torch_data_path.py`` ingests
real ones), and so does a label the model cannot score.

Float parity, from the reference's own parameters carried across by
``convert.resnet_params_from_jax`` (HWIO -> OIHW):

- SAME convolution and max-pooling at every side 1-17 and 224, k in
  {1, 3, 7}, s in {1, 2}: the pool exactly, the convolution within
  ``CONV_TOL``; a convolution with PyTorch's symmetric padding misses
  that bound at stride 2 on an even side;
- ``batch_norm``'s output and new state in training and evaluation,
  float32 and bf16, against ``nn.batch_norm``: float32 within
  ``BN_TOL``, bf16 outputs within one bf16 ulp of their magnitude
  (statistics in float32 on both sides); the control, the running
  variance that ``F.batch_norm``'s own buffers keep (unbiased), misses
  ``BN_TOL``;
- the forward of a tiny basic-block net (the CIFAR stem) and a tiny
  bottleneck net (7x7/2 stem + max-pool, a projection in each block)
  at an even and an odd image size, training and evaluation: logits
  and new state within ``FWD_TOL`` (float32); in bf16, the reference
  rounding at every operation it writes, the logits within
  ``BF16_LOGITS_TOL`` x max|logit|, a bound the port's float32 logits
  miss;
- three psum steps of the tiny basic-block net on one shard, on two
  shards in one process (each normalised with its own statistics), and
  on two shards with ``grad_accum`` 2 (the state chained through the
  microbatches), against the reference's ``make_train_step`` on 1- and
  2-device meshes: losses, parameters, velocity and BatchNorm state
  within ``STEP_TOL``; the control, one set of statistics over the two
  shards' concatenated batch, misses it.

The reference compiles with XLA's optimisation passes off
(``FAST_COMPILE``), each group of cases under one compile.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import cifar as jax_cifar
from mpi_tensorflow_tpu.data import imagenet as jax_imagenet
from mpi_tensorflow_tpu.data import synthetic as jax_synthetic
from mpi_tensorflow_tpu.models import resnet as jax_resnet
from mpi_tensorflow_tpu.ops import nn as jax_nn
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_tpu.utils import flops as jax_flops
from mpi_tensorflow_torch import bench, cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import cifar, imagenet, synthetic
from mpi_tensorflow_torch.models import convert, resnet
from mpi_tensorflow_torch.ops import nn
from mpi_tensorflow_torch.train import loop, step
from mpi_tensorflow_torch.utils import flops
from mpi_tensorflow_torch.utils import tree as tree_lib

from _torch_resnet_inputs import TINY
from _torch_resnet_inputs import jax_net as _jax_net
from _torch_resnet_inputs import net_inputs as _net_inputs
from _torch_resnet_inputs import shapes as _shapes
from test_data import write_imagenet_npy_dir

# XLA's optimisation passes off (they only slow the compile), and no
# excess precision: by default XLA may keep a bf16 intermediate in
# float32 where the program rounds it, and the reference's bf16 logits
# then sit as far from its own rounding points as float32 logits do
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True,
                "xla_allow_excess_precision": False}
SIDES = tuple(range(1, 18)) + (224,)
KS = ((1, 1), (1, 2), (3, 1), (3, 2), (7, 1), (7, 2))
# float32 sums in another order by another library, relative to the
# output's largest magnitude (measured 6.5e-7: 1.1e-5 at 17.6, k = 7)
CONV_TOL = 2e-6
BN_TOL = 1e-5
FWD_TOL = 1e-5
STEP_TOL = 1e-5
# a quarter of a bf16 ulp (2^-8 relative) of the largest logit: the
# port's bf16 logits were bit-identical to the reference's at every case
# measured, its float32 logits 1.45e-3 to 8.6e-3 of max|logit| away
BF16_LOGITS_TOL = 2 ** -10

SIZES = {"basic": (8, 9), "bottleneck": (16, 17)}


def _fast(fn, *args):
    """``fn`` jitted and compiled with ``FAST_COMPILE`` for ``args``."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _port_net(name, params, dtype=torch.float32):
    geo = resnet.Geometry(**{k: TINY[name][k] for k in (
        "stage_sizes", "widths", "bottleneck", "cifar_stem")})
    return resnet.ResNet(geo, convert.resnet_params_from_jax(params),
                         compute_dtype=dtype)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_close(got, want, tol, what):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want], what
    worst = 0.0
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=0,
                                   err_msg=f"{what} {path}")
        worst = max(worst, float(np.abs(g - np.asarray(w)).max()))
    return worst


# ------------------------------------------------------ SAME conv and pool

@pytest.fixture(scope="module")
def same_ops():
    """Every (side, k, s) case's input, weight and the reference's conv
    and max-pool outputs, under one compile."""
    rng = np.random.default_rng(0)
    cases = [(n, k, s) for k, s in KS for n in SIDES]
    xs = [rng.normal(size=(2, n, n, 3)).astype(np.float32)
          for n, _, _ in cases]
    ws = [rng.normal(size=(k, k, 3, 4)).astype(np.float32)
          for _, k, _ in cases]

    def run(xs, ws):
        conv = [lax.conv_general_dilated(
            x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
            for x, w, (_, _, s) in zip(xs, ws, cases)]
        pool = [lax.reduce_window(x, -jnp.inf, lax.max, (1, k, k, 1),
                                  (1, s, s, 1), "SAME")
                for x, (_, k, s) in zip(xs, cases)]
        return conv, pool

    conv, pool = _fast(run, xs, ws)(xs, ws)
    return {c: (x, w, np.asarray(cv), np.asarray(pl))
            for c, x, w, cv, pl in zip(cases, xs, ws, conv, pool)}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous().numpy()


@pytest.mark.parametrize("k,s", KS)
def test_same_conv_matches_reference(same_ops, k, s):
    for n in SIDES:
        x, w, want, _ = same_ops[n, k, s]
        got = _nhwc(nn.conv2d(_nchw(x), torch.from_numpy(
            w.transpose(3, 2, 0, 1).copy()), s))
        assert got.shape == want.shape, (n, k, s)
        np.testing.assert_allclose(got, want, rtol=0, err_msg=f"side {n}",
                                   atol=CONV_TOL * np.abs(want).max())


@pytest.mark.parametrize("k,s", KS)
def test_same_max_pool_exact(same_ops, k, s):
    for n in SIDES:
        x, _, _, want = same_ops[n, k, s]
        got = _nhwc(nn.max_pool(_nchw(x), k, s))
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), \
            (n, k, s)


def test_symmetric_padding_misses_the_reference(same_ops):
    """PyTorch's ``padding=k // 2`` at stride 2 on an even side shifts
    every window; the same-shaped output misses ``CONV_TOL``."""
    for n, k in ((16, 3), (224, 7)):
        x, w, want, _ = same_ops[n, k, 2]
        got = _nhwc(F.conv2d(_nchw(x), torch.from_numpy(
            w.transpose(3, 2, 0, 1).copy()), stride=2, padding=k // 2))
        assert got.shape == want.shape
        assert np.abs(got - want).max() > 100 * CONV_TOL * np.abs(
            want).max(), (n, k)
    assert nn.same_pads(224, 7, 2) == (2, 3)
    assert nn.same_pads(112, 3, 2) == (0, 1)
    assert nn.same_pads(16, 3, 2) == (0, 1)
    assert nn.same_pads(17, 3, 2) == (1, 1)


# ------------------------------------------------------------- BatchNorm

@pytest.fixture(scope="module")
def bn_cases():
    """Input (N, H, W, C), parameters, state, and the reference's output
    and new state in each mode and dtype, under one compile."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 5, 5, 8)) * 2.0 + 0.7).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "offset": rng.normal(size=8).astype(np.float32)}
    state = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    modes = [(train, dt) for train in (True, False)
             for dt in (jnp.float32, jnp.bfloat16)]

    def run(x, params, state):
        return [jax_nn.batch_norm(x.astype(dt), params, state, train=train)
                for train, dt in modes]

    out = _fast(run, x, params, state)(x, params, state)
    return x, params, state, {
        (train, dt): (np.asarray(y.astype(jnp.float32)), _host(s))
        for (train, dt), (y, s) in zip(modes, out)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_batch_norm_matches_reference(bn_cases, train, dtype):
    x, params, state, ref = bn_cases
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want_y, want_state = ref[train, jdt]
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    y, new_state = nn.batch_norm(
        _nchw(x).to(tdt), {k: torch.from_numpy(v) for k, v in
                           params.items()}, tstate, train=train)
    assert y.dtype == tdt
    y = _nhwc(y.float())
    tol = BN_TOL if dtype == "fp32" else 2 ** -8 * np.abs(want_y).max()
    np.testing.assert_allclose(y, want_y, atol=tol, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(), want_state[k],
                                   atol=BN_TOL, rtol=0, err_msg=k)
    if not train:
        assert new_state is tstate
    else:        # the old state is never written in place
        assert all(np.array_equal(tstate[k].numpy(), state[k])
                   for k in state)


def test_unbiased_running_variance_misses_the_reference(bn_cases):
    """``F.batch_norm``'s running buffers take the unbiased variance,
    n / (n - 1) times the reference's (n = 150 here)."""
    x, params, state, ref = bn_cases
    _, want_state = ref[True, jnp.float32]
    mean, var = (torch.from_numpy(state[k].copy()) for k in ("mean", "var"))
    F.batch_norm(_nchw(x), mean, var, torch.from_numpy(params["scale"]),
                 torch.from_numpy(params["offset"]), True, 0.1, 1e-5)
    np.testing.assert_allclose(mean.numpy(), want_state["mean"],
                               atol=BN_TOL, rtol=0)
    assert np.abs(var.numpy() - want_state["var"]).max() > 10 * BN_TOL


# -------------------------------------------------------- tiny forwards

@pytest.fixture(scope="module")
def forwards():
    """Each tiny net's reference logits and new state at both sizes, in
    training and evaluation, float32, and in training bf16 at the even
    size, under one compile per net."""
    out = {}
    for name in TINY:
        params, state = _net_inputs(name)
        rng = np.random.default_rng(2)
        xs = {n: rng.normal(size=(4, n, n, 3)).astype(np.float32)
              for n in SIZES[name]}
        cases = [(n, train, jnp.float32) for n in SIZES[name]
                 for train in (True, False)]
        cases.append((SIZES[name][0], True, jnp.bfloat16))

        def run(params, state, xs):
            return [_jax_net(name, dt).apply_with_state(
                params, state, xs[n], train=train) for n, train, dt in cases]

        res = _fast(run, params, state, xs)(params, state, xs)
        out[name] = (params, state, xs, {
            c: (np.asarray(lg), _host(ns)) for c, (lg, ns) in
            zip(cases, res)})
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("size", ["even", "odd"])
@pytest.mark.parametrize("name", list(TINY))
def test_tiny_forward_matches_reference(forwards, name, size, train):
    params, state, xs, ref = forwards[name]
    n = SIZES[name][size == "odd"]
    want_logits, want_state = ref[n, train, jnp.float32]
    model = _port_net(name, params)
    tstate = convert.params_from_jax(state)
    logits, new_state = model.apply_with_state(
        tstate, torch.from_numpy(xs[n]), train=train)
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=FWD_TOL, rtol=0)
    _tree_close(convert.params_to_numpy(new_state), want_state,
                FWD_TOL, f"{name} {n} state")
    if train:        # statistics moved, the input state untouched
        _tree_close(convert.params_to_numpy(tstate), state, 0.0,
                    "input state")
        assert _tree_diff(want_state, state) > 10 * FWD_TOL


def _tree_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("name", list(TINY))
def test_bf16_forward_matches_reference(forwards, name):
    """bf16 on both sides keeps the reference's rounding points; the
    port's float32 logits miss the bound."""
    params, state, xs, ref = forwards[name]
    n = SIZES[name][0]
    want, want_state = ref[n, True, jnp.bfloat16]
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        logits, new_state = _port_net(name, params, dt).apply_with_state(
            convert.params_from_jax(state), torch.from_numpy(xs[n]),
            train=True)
        got[dt] = logits.detach().numpy()
    tol = BF16_LOGITS_TOL * np.abs(want).max()
    np.testing.assert_allclose(got[torch.bfloat16], want, atol=tol, rtol=0)
    assert np.abs(got[torch.float32] - want).max() > tol


# ---------------------------------------------------------------- trees

@pytest.mark.parametrize("name", ["resnet20", "resnet50"])
def test_trees_match_reference(name):
    """Names and shapes of the parameter and state trees (conv weights
    HWIO there, OIHW here), and ``l2_params``, with no compute on the
    reference's side (``_shapes``)."""
    jmodel = jax_resnet.build(name)
    want_params = _shapes(jmodel)
    want_state = jax.eval_shape(jmodel.init_state)
    model = resnet.build(name)
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    hwio = lambda s: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    got = jax.tree.map(hwio, shapes(model.param_tree()),
                       is_leaf=lambda x: isinstance(x, tuple))
    assert got == shapes(want_params)
    assert shapes(model.init_state()) == shapes(want_state)
    assert [hwio(tuple(p.shape)) for p in model.l2_params()] == [
        tuple(p.shape) for p in jmodel.l2_params(want_params)]
    count = sum(p.numel() for p in model.parameters())
    assert count == {"resnet20": 272_474, "resnet50": 25_557_032}[name]
    assert model.num_classes == jmodel.num_classes
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in model.parameters() if p.ndim == 4)
    # remat changes nothing of the tree (the reference's jax.checkpoint
    # neither)
    rematted = resnet.build(name, remat=True)
    assert rematted.remat and not model.remat
    assert shapes(rematted.param_tree()) == shapes(model.param_tree())


# ----------------------------------------------------------- psum steps

B, STEPS, DECAY = 4, 3, 100
STEP_CASES = {"one_shard": (1, 1), "two_shards": (2, 1),
              "two_shards_accum2": (2, 2)}


@pytest.fixture(scope="module")
def step_runs():
    """Each case's reference run: 3 psum steps of the tiny basic net,
    batch ``B`` per shard, from the reference's init, on a 1- or
    2-device mesh: the losses and the state after each step."""
    params, _ = _net_inputs("basic", seed=3)
    model = _jax_net("basic")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(STEPS, 2 * B, 9, 9, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(STEPS, 2 * B)).astype(np.int64)
    out = {}
    for case, (shards, accum) in STEP_CASES.items():
        m = jax_mesh.make_mesh({"data": shards},
                               devices=jax.devices()[:shards])
        cfg = JaxConfig(batch_size=B, grad_accum=accum)
        state = jax.device_put(jax_step.TrainState(
            params, jax_opt.momentum_init(params), model.init_state()),
            NamedSharding(m, P()))
        rows = slice(0, B * shards)
        args = (x[0][rows], y[0][rows].astype(np.int32), jax.random.key(0))
        train = jax_step.make_train_step(model, cfg, m, DECAY).lower(
            state, *args).compile(FAST_COMPILE)
        losses = []
        for t in range(STEPS):
            state, metrics = train(state, x[t][rows],
                                   y[t][rows].astype(np.int32),
                                   jax.random.key(0))
            losses.append(float(metrics["loss"]))
        out[case] = (np.array(losses), _host(state))
    return params, x, y, out


def _port_steps(params, x, y, shards, accum):
    model = _port_net("basic", params)
    state = step.init_state(model)
    train = step.make_train_step(model, Config(batch_size=B,
                                               grad_accum=accum),
                                 shards, DECAY)
    rows = slice(0, B * shards) if shards > 1 else slice(0, B)
    losses = []
    for t in range(STEPS):
        state, metrics = train(state, torch.from_numpy(x[t][rows]),
                               torch.from_numpy(y[t][rows]))
        losses.append(float(metrics["loss"]))
    return np.array(losses), {
        "params": convert.resnet_params_to_numpy(model.param_tree()),
        "velocity": convert.resnet_params_to_numpy(tree_lib.unflatten(
            model.param_tree(), state.opt.velocity)),
        "model_state": convert.params_to_numpy(state.model_state)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_psum_steps_match_reference(step_runs, case):
    params, x, y, ref = step_runs
    shards, accum = STEP_CASES[case]
    want_losses, want = ref[case]
    losses, got = _port_steps(params, x, y, shards, accum)
    np.testing.assert_allclose(losses, want_losses, atol=STEP_TOL, rtol=0)
    _tree_close(got["params"], want.params, STEP_TOL, f"{case} params")
    _tree_close(got["velocity"], want.opt.velocity, STEP_TOL,
                f"{case} velocity")
    _tree_close(got["model_state"], want.model_state, STEP_TOL,
                f"{case} state")
    assert _tree_diff(want.model_state, _host(
        _jax_net("basic").init_state())) > 1e-3


def test_global_batch_statistics_miss_two_shards(step_runs):
    """One set of statistics over the two shards' concatenated batch (a
    one-shard step on 2B rows) is another computation: its BatchNorm
    state misses the 2-device reference's bound."""
    params, x, y, ref = step_runs
    _, want = ref["two_shards"]
    model = _port_net("basic", params)
    state = step.init_state(model)
    train = step.make_train_step(model, Config(batch_size=2 * B), 1, DECAY)
    for t in range(STEPS):
        train(state, torch.from_numpy(x[t]), torch.from_numpy(y[t]))
    got = convert.params_to_numpy(state.model_state)
    assert _tree_diff(got, want.model_state) > 10 * STEP_TOL


# ---------------------------------------------------------------- data

def _write_cifar_bins(root, counts=(3, 2, 4, 1, 3), test=5):
    bin_dir = os.path.join(root, cifar.BIN_DIR)
    os.makedirs(bin_dir)
    rng = np.random.default_rng(9)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name, n in zip(names, list(counts) + [test]):
        rec = rng.integers(0, 256, size=(n, 3073), dtype=np.uint8)
        rec[:, 0] = rng.integers(0, 10, size=n)
        rec.tofile(os.path.join(bin_dir, name))
    return bin_dir


def _same_splits(got, want):
    for f in dataclasses.fields(got):
        g, w = np.asarray(getattr(got, f.name)), np.asarray(
            getattr(want, f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        assert g.tobytes() == w.tobytes(), f.name


def test_cifar_bins_parse_and_split_byte_identical(tmp_path):
    bin_dir = _write_cifar_bins(str(tmp_path))
    path = os.path.join(bin_dir, "data_batch_3.bin")
    for g, w in zip(cifar._parse_bin(path), jax_cifar._parse_bin(path)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for n in ((None, None), (11, 4)):
        _same_splits(cifar.load_splits(str(tmp_path), *n),
                     jax_cifar.load_splits(str(tmp_path), *n))


def test_synthetic_image_sets_byte_identical(tmp_path):
    """The synthetic CIFAR-10 (no bin dir) and ImageNet sets the loaders
    fall back to, against the reference's generator (its CIFAR loader
    would first try the network, so the generator is called directly)."""
    _same_splits(cifar.load_splits(str(tmp_path), 300, 40),
                 jax_synthetic.image_classification(
                     300, 40, size=32, channels=3, num_classes=10))
    _same_splits(imagenet.load_splits(str(tmp_path), 26, 4, image_size=20),
                 jax_imagenet.load_splits(str(tmp_path), 26, 4,
                                          image_size=20))
    _same_splits(synthetic.image_classification(
        13, 3, size=6, channels=3, num_classes=1000, seed=5),
        jax_synthetic.image_classification(
            13, 3, size=6, channels=3, num_classes=1000, seed=5))


def test_imagenet_npy_shards_and_refusals(tmp_path):
    data_dir = str(write_imagenet_npy_dir(tmp_path / "npy"))
    got = imagenet.load_splits(data_dir, image_size=32)
    _same_splits(got, jax_imagenet.load_splits(data_dir, image_size=32))
    assert isinstance(got.train_data.base, np.memmap) or \
        isinstance(got.train_data, np.memmap)
    # the reference's own ingest marker at another resolution: refused
    with open(os.path.join(data_dir, imagenet.NPY_DIR,
                           "ingest_meta.json"), "w") as f:
        json.dump({"image_size": 32}, f)
    for load in (imagenet.load_splits, jax_imagenet.load_splits):
        with pytest.raises(ValueError, match="auto-ingested"):
            load(data_dir)
    # a class-per-directory image tree that does not decode: the ingest
    # fails in both packages, leaves its failure marker, and there is no
    # synthetic fallback
    from PIL import UnidentifiedImageError

    for load, name in ((imagenet.load_splits, "port"),
                       (jax_imagenet.load_splits, "reference")):
        tree = tmp_path / f"jpeg_{name}"
        for cls in ("n01", "n02"):
            os.makedirs(tree / "train" / cls)
            (tree / "train" / cls / "a.JPEG").write_bytes(b"\xff\xd8")
        with pytest.raises(UnidentifiedImageError):
            load(str(tree))
        assert os.path.exists(tree / "imagenet_npy.failed")
        assert not os.path.exists(tree / "imagenet_npy")


# ------------------------------------------------------- loop, CLI, bench

def test_labels_the_model_cannot_score_raise(tmp_path):
    """ResNet-50 at the default ``--num-classes`` (10) on 1000 classes."""
    model = resnet.ResNet(resnet.Geometry(**{**TINY["bottleneck"],
                                             "num_classes": 10}),
                          resnet.init_params(resnet.Geometry(
                              **TINY["bottleneck"]),
                              torch.Generator().manual_seed(0)))
    splits = synthetic.image_classification(40, 8, size=16, channels=3,
                                            num_classes=1000)
    with pytest.raises(ValueError, match="--num-classes"):
        loop.train(Config(model="resnet50", batch_size=4), model=model,
                   splits=splits, device="cpu")


def test_cli_trains_resnet20_on_the_cpu(tmp_path, monkeypatch):
    """The first 120 / 32 rows of the synthetic CIFAR-10."""
    monkeypatch.setattr(loop, "load_dataset", lambda config, *_, **__:
                        cifar.load_splits(config.data_dir, 120, 32))
    argv = ["--model", "resnet20", "--dataset", "cifar10", "--device",
            "cpu", "--epochs", "1", "--data-dir", str(tmp_path),
            "--batch-size", "8", "--log-every", "5"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    lines = out.getvalue().splitlines()
    trace = [ln for ln in lines if " process at " in ln]
    assert lines[0] == "Process ID: 0  training session starts!"
    assert [int(ln.split()[3]) for ln in trace] == [5, 10, 12]
    assert lines[-1].startswith("[timing]")
    assert not os.listdir(tmp_path)       # synthetic: nothing written


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--model", "resnet20", "--dataset", "cifar10"],
                 ["--model", "resnet50", "--dataset", "imagenet_synthetic",
                  "--num-classes", "1000"]):
        with pytest.raises(RuntimeError, match="no card"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="no card"):
        bench.main(["--mode", "train", "--model", "resnet50"])


def test_bench_line_and_flops():
    res = bench.measure_train("resnet20", batch_size=8, steps=2, warmup=1,
                              device="cpu")
    assert res["model"] == "resnet20" and res["image_shape"] == [32, 32, 3]
    assert res["num_classes"] == 10 and np.isfinite(res["final_loss"])
    assert res["images_per_sec"] > 0 and res["mfu_pct"] is None
    assert bench.IMAGE_SPECS["resnet50"]["shape"] == (224, 224, 3)
    assert bench.IMAGE_SPECS["resnet50"]["classes"] == 1000
    for name in ("resnet20", "resnet50", "mnist_cnn"):
        assert flops.image_train_flops(name, 64) == \
            jax_flops.image_train_flops(name, 64)
