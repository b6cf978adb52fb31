"""The port's ViT (``models/vit.py``) against the JAX reference, on the CPU.

Integer and host logic must match exactly: ``build_model``'s patch,
channel and class choice for each dataset and input size, the
configuration fields, ``vit_train_flops``, and the trace lines of a
``cli.main`` run.

Float parity at tiny widths (hidden 32, 2 layers, 2 heads, MLP 64),
float32, dropout 0, every parameter drawn from numpy and carried across
by ``convert.vit_params_from_jax``:

- the logits of ``VisionTransformer`` against the reference's
  ``VisionTransformer.apply`` at the three geometries ``build_model``
  picks (28 px, 1 channel, 7 px patches; 32 px, 3 channels, 4 px; 224
  px, 3 channels, 16 px) within ``TOL``: two layers of float32 products
  summed in another order by another library;
- the image step's loss gradient, then three momentum steps of the
  image loop's step (``train/step.py``) against the reference's
  ``make_train_step`` on a one-device mesh: losses, parameters and
  velocity within ``TOL``.

The port alone, where the reference draws other dropout masks: remat on
bit-equal to remat off with dropout on; two in-process shards within
``TOL`` of one shard on the same global batch; a run stopped by
``request_stop`` and resumed bit-equal to the uninterrupted one.  The
reference compiles with XLA's optimisation passes off.
"""

import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ckpt_worker as worker
from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.models import vit as jax_vit
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_tpu.utils import flops as jax_flops
from mpi_tensorflow_torch import bench, cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import cifar, synthetic
from mpi_tensorflow_torch.models import convert, vit
from mpi_tensorflow_torch.train import checkpoint, loop, step
from mpi_tensorflow_torch.utils import flops
from mpi_tensorflow_torch.utils import tree as tree_lib

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TOL = 1e-5
WIDTHS = dict(hidden=32, layers=2, heads=2, mlp=64, dropout=0.0)
# build_model's three geometries: (image size, channels, patch)
GEOMETRIES = {"mnist": (28, 1, 7), "cifar10": (32, 3, 4),
              "imagenet": (224, 3, 16)}
B, STEPS, DECAY = 4, 3, 1000


def _cfgs(size, channels, patch, **kw):
    geo = dict(image_size=size, channels=channels, patch=patch,
               **{**WIDTHS, **kw})
    return (dataclasses.replace(jax_vit.VIT_TINY_CIFAR, **geo),
            dataclasses.replace(vit.VIT_TINY_CIFAR, **geo))


def _np_params(jcfg, seed):
    """The reference's tree with every leaf redrawn from numpy: LayerNorm
    scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jax_vit.VisionTransformer(jcfg).init,
                          jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _port(tcfg, params):
    return vit.VisionTransformer(tcfg, convert.vit_params_from_jax(params))


def _images(n, size, channels, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, channels)).astype(np.float32)


def _close(got, want, what):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want], what
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"{what} {path}")


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_logits_match_reference(geometry):
    jcfg, tcfg = _cfgs(*GEOMETRIES[geometry])
    params = _np_params(jcfg, 1)
    x = _images(2, jcfg.image_size, jcfg.channels, 2)
    model = jax_vit.VisionTransformer(jcfg)
    want = jax.jit(model.apply).lower(params, x).compile(FAST_COMPILE)(
        params, x)
    got = _port(tcfg, params)(torch.from_numpy(x))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def test_gradient_and_three_steps_match_reference():
    """The velocity after the first step is the loss's gradient (it
    starts at zero, and ViT has no L2 term); then two more steps."""
    jcfg, tcfg = _cfgs(*GEOMETRIES["cifar10"])
    params = _np_params(jcfg, 3)
    x = _images(STEPS * B, 32, 3, 4).reshape(STEPS, B, 32, 32, 3)
    y = np.random.default_rng(5).integers(0, 10, (STEPS, B))
    model = jax_vit.VisionTransformer(jcfg)
    jconfig = JaxConfig(batch_size=B, model="vit", dataset="cifar10",
                        image_size=32)
    key = jax.random.key(0)
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    state = jax_step.TrainState(params, jax_opt.momentum_init(params), {})
    args = (x[0], y[0].astype(np.int32), key)
    train = jax_step.make_train_step(model, jconfig, mesh, DECAY).lower(
        state, *args).compile(FAST_COMPILE)
    want_losses, want_grad = [], None
    for t in range(STEPS):
        state, m = train(state, x[t], y[t].astype(np.int32), key)
        want_losses.append(float(m["loss"]))
        if want_grad is None:
            want_grad = jax.tree.map(np.asarray, state.opt.velocity)

    port = _port(tcfg, params)
    config = Config(batch_size=B, model="vit", dataset="cifar10",
                    image_size=32)
    ts = step.init_state(port)
    train_step = step.make_train_step(port, config, 1, DECAY)
    losses = []
    for t in range(STEPS):
        ts, m = train_step(ts, torch.from_numpy(x[t]),
                           torch.from_numpy(y[t]))
        losses.append(float(m["loss"]))
        if t == 0:
            _close(convert.vit_params_to_numpy(tree_lib.unflatten(
                port.param_tree(), ts.opt.velocity)), want_grad,
                "gradient")
    np.testing.assert_allclose(losses, want_losses, atol=TOL, rtol=0)
    _close(convert.vit_params_to_numpy(port.param_tree()), state.params,
           "params")
    _close(convert.vit_params_to_numpy(tree_lib.unflatten(
        port.param_tree(), ts.opt.velocity)), state.opt.velocity,
        "velocity")


def test_remat_bit_equal_with_dropout():
    """Remat recomputes each layer from the generator's state at its
    start: the same masks, the same loss and gradients, bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = []
        for remat in (False, True):
            _, tcfg = _cfgs(*GEOMETRIES["cifar10"], dropout=0.1,
                            remat=remat)
            model = vit.VisionTransformer.from_seed(tcfg, seed=3)
            x = torch.from_numpy(_images(B, 32, 3, 6))
            gen = torch.Generator().manual_seed(7)
            loss = torch.nn.functional.cross_entropy(
                model(x, train=True, generator=gen),
                torch.arange(B) % 10)
            out.append([loss] + list(torch.autograd.grad(
                loss, tree_lib.leaves(model.param_tree()))))
        for a, b in zip(*out):
            assert torch.equal(a, b)
        assert len(out[0]) == 1 + len(tree_lib.leaves(
            model.param_tree()))
    finally:
        torch.set_num_threads(n)


def test_two_shards_match_one():
    """The psum step on two in-process shards of the global batch (the
    mean of the shards' mean losses) against one shard of it: ViT keeps
    no batch statistics, so the two are one gradient."""
    _, tcfg = _cfgs(*GEOMETRIES["cifar10"])
    x = torch.from_numpy(_images(2 * B, 32, 3, 8))
    y = torch.arange(2 * B) % 10
    got = []
    for shards, batch in ((1, 2 * B), (2, B)):
        model = vit.VisionTransformer.from_seed(tcfg, seed=4)
        ts = step.init_state(model)
        train = step.make_train_step(model, Config(batch_size=batch),
                                     shards, DECAY)
        for _ in range(2):
            ts, _m = train(ts, x, y)
        got.append(convert.vit_params_to_numpy(model.param_tree()))
    _close(got[1], got[0], "two shards")


@pytest.mark.parametrize("dataset,size", [
    ("mnist", 28), ("cifar10", 32), ("imagenet_synthetic", 224),
    ("cifar10", 64)])
def test_build_model_matches_reference(dataset, size):
    kw = dict(model="vit", dataset=dataset, image_size=size,
              num_classes=7, precision="bf16", remat=True)
    want = jax_loop.build_model(JaxConfig(**kw)).cfg
    got = loop.build_model(Config(**kw))
    assert isinstance(got, vit.VisionTransformer)
    for f in dataclasses.fields(vit.VitConfig):
        w, g = getattr(want, f.name), getattr(got.cfg, f.name)
        if f.name == "dtype":
            assert str(jnp.dtype(w)) == str(g).removeprefix("torch."), f
        else:
            assert g == w, f.name
    assert got.cfg.num_patches == want.num_patches
    assert got.encoder_cfg.max_positions == want.num_patches + 1
    assert got.l2_params() == []


def test_flops_match_reference():
    for jcfg, tcfg in ((jax_vit.VIT_TINY_CIFAR, vit.VIT_TINY_CIFAR),
                       (jax_vit.VIT_S16_IMAGENET, vit.VIT_S16_IMAGENET)):
        for batch in (8, 128):
            assert flops.vit_train_flops(tcfg, batch) == \
                jax_flops.vit_train_flops(jcfg, batch)
            assert flops.image_train_flops("vit", batch, tcfg) == \
                jax_flops.vit_train_flops(jcfg, batch)
    # without its configuration the ViT has no count, as the reference's
    # image_train_flops has none
    assert flops.image_train_flops("vit", 8) is None
    assert jax_flops.image_train_flops("vit", 8) is None


def _splits():
    return synthetic.image_classification(221, 16, size=32, channels=3,
                                          num_classes=10, seed=4)


def _run(ckpt_dir, **kw):
    """One run of the image loop on a tiny ViT (dropout 0.1), its trace
    lines kept."""
    _, tcfg = _cfgs(*GEOMETRIES["cifar10"], dropout=0.1)
    cfg = Config(model="vit", dataset="cifar10", image_size=32, epochs=1,
                 batch_size=8, log_every=4, fused_steps=4,
                 checkpoint_dir=ckpt_dir, **kw)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = loop.train(cfg, model=vit.VisionTransformer.from_seed(tcfg),
                         splits=_splits(), device="cpu")
    return res, [ln for ln in out.getvalue().splitlines()
                 if not ln.startswith("[timing]")]


def test_resume_bit_equal(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full, full_lines = _run(str(tmp_path / "full"))
        part = str(tmp_path / "part")
        with worker.stopping(worker.STOP):
            _, stop_lines = _run(part)
        assert checkpoint.latest_step(part) == worker.STOP
        res, res_lines = _run(part, resume=True)
    finally:
        torch.set_num_threads(n)
    assert res_lines[0] == f"[checkpoint] resumed from step {worker.STOP}"
    # the two runs' lines as one run prints them: the checkpoint notices
    # and the second session header dropped
    joined = [ln for i, ln in enumerate(stop_lines + res_lines)
              if not ln.startswith(("[checkpoint]", "[preemption]"))
              and not (i and ln.startswith("Process ID"))]
    assert joined == [ln for ln in full_lines
                      if not ln.startswith("[checkpoint]")]
    got, want = res.state, full.state
    for a, b in zip(tree_lib.leaves(got.model.param_tree())
                    + got.opt.velocity,
                    tree_lib.leaves(want.model.param_tree())
                    + want.opt.velocity):
        assert torch.equal(a, b)
    assert float(got.opt.step) == float(want.opt.step)
    assert res.history == [h for h in full.history if h[0] > worker.STOP]


@pytest.fixture
def tiny_vit(monkeypatch):
    """``build_model``'s ViT at the tiny widths."""
    monkeypatch.setattr(vit, "VIT_TINY_CIFAR", dataclasses.replace(
        vit.VIT_TINY_CIFAR, **WIDTHS))


def test_cli_and_bench_on_the_cpu(tmp_path, monkeypatch, tiny_vit):
    """``--model vit --dataset cifar10`` through ``cli.main`` on the
    first 120 / 32 rows of the synthetic CIFAR-10 (at the dataset's 32
    px, the CLI's default for it): the reference's trace lines; and the
    bench's line with the ViT's flops."""
    monkeypatch.setattr(loop, "load_dataset", lambda config, *_, **__:
                        cifar.load_splits(config.data_dir, 120, 32))
    argv = ["--model", "vit", "--dataset", "cifar10", "--device", "cpu",
            "--epochs", "1", "--data-dir", str(tmp_path), "--batch-size",
            "8", "--log-every", "5"]
    assert cli.config_from_args(cli.build_parser().parse_args(
        argv)).image_size == 32
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    lines = out.getvalue().splitlines()
    trace = [ln for ln in lines if " process at " in ln]
    assert lines[0] == "Process ID: 0  training session starts!"
    assert [int(ln.split()[3]) for ln in trace] == [5, 10, 12]
    assert lines[-1].startswith("[timing]")
    assert not os.listdir(tmp_path)
    res = bench.measure_train("vit", batch_size=4, steps=1, warmup=1,
                              device="cpu")
    assert res["image_shape"] == [32, 32, 3] and res["num_classes"] == 10
    assert res["model_flops_per_step"] == flops.vit_train_flops(
        vit.VIT_TINY_CIFAR, 4)
    assert np.isfinite(res["final_loss"]) and res["mfu_pct"] is None
    assert bench.IMAGE_SPECS["vit"]["defaults"][:2] == (128, 200)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        cli.main(["--model", "vit", "--dataset", "cifar10"])
    with pytest.raises(RuntimeError, match="no card"):
        bench.main(["--mode", "train", "--model", "vit"])
