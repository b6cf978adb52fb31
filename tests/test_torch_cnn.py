"""The port's CNN pieces against the JAX reference, on the CPU.

Integer and host logic must match exactly: the zero-flag ``Config`` and
the CLI's ``--fused-steps`` default, the synthetic MNIST bytes and the
splits at 1 and 4 shards, ``assemble_window``, the window schedule the
reference's windowed loop hands its prefetcher, ``eval_in_batches``
(the port's ``eval_sharded`` on one rank) with a tail window and
``shard_error_rates``, the staircase LR in float32 at every step across
decay boundaries, and the profile's ``conv`` category (cuDNN's
convolution kernels only).

Float parity, inputs normal x 0.3 from numpy, the reference's own
parameters carried across by ``convert.cnn_params_from_jax``:

- logits at image size 28 (the reference's init) and 30 (numpy
  parameters; the SAME pools pad there): float32 within 1e-5; bfloat16
  within max|logit| / 256, a bound the float32 logits miss;
- the max-pool alone at odd sizes: exact;
- loss and gradients with dropout 0 against ``jax.value_and_grad`` of
  the reference's ``make_loss_fn``: float32 within 1e-5 absolute +
  1e-4 relative (float32 convolutions summed in another order by
  another library); bfloat16 within the ``BF16_*`` bounds below, which
  the port's float32 gradients miss;
- three momentum updates against ``momentum_apply``: 1e-7 absolute.
"""

import contextlib
import dataclasses
import functools
import gzip
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu import cli as jax_cli
from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import mnist as jax_mnist
from mpi_tensorflow_tpu.data import prefetch as jax_prefetch
from mpi_tensorflow_tpu.models import cnn as jax_cnn
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import evaluation as jax_evaluation
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch import cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import mnist, prefetch
from mpi_tensorflow_torch.models import cnn, convert
from mpi_tensorflow_torch.train import evaluation, loop, optimizer, step
from mpi_tensorflow_torch.utils import profiling


def _inputs(n, size, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, size, size, 1)) * 0.3).astype(np.float32)
    return x, rng.integers(0, 10, size=n).astype(np.int64)


# bf16 against the reference's bf16, each the largest error a bound
# allows: logits to max|logit| / 256 (at most one bf16 ulp of the largest
# logit; measured 0.0093 at size 28 and 0.0024 at 30, against 0.035 and
# 0.011 for float32 logits); the weights' gradients to 1e-2 in relative
# norm (measured 9.5e-4 to 3.5e-3; float32's 4.5e-3 to 9.6e-2); the
# biases' to 0.1 (measured 4.6e-3 to 4.9e-2)
BF16_LOGITS_TOL = 1 / 256
BF16_WEIGHT_GRAD_TOL = 1e-2
BF16_BIAS_GRAD_TOL = 0.1

# XLA's optimisation passes take most of the reference's compile time on
# the CPU at this size; the arithmetic is the same without them
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(jitted):
    """``jitted`` (a ``jax.jit`` function), compiled at its first call
    with ``FAST_COMPILE``."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)
    return call


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    return jax.tree.map(np.asarray, _fast(jax.jit(jax_cnn.MnistCnn().init))(
        jax.random.key(seed)))


def _jax_params(seed=1):
    """The reference's init at image size 28, as numpy leaves (a fresh
    dict on each call)."""
    return dict(_jax_init(seed))


# ------------------------------------------------------ exact host logic

def test_zero_flag_config_matches_reference():
    want, got = JaxConfig(), Config()
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.num_channels == want.num_channels


@pytest.mark.parametrize("argv,fused", [
    ([], 50), (["--log-every", "10"], 10), (["--fused-steps", "1"], 1),
    (["--data-dir", "/x", "--early-stop-patience", "3", "--prefetch", "off",
      "--mesh", "data=1", "--epochs", "1", "--base-lr", "0.1"], 50),
    (["--sync", "avg50"], 1)])
def test_cli_config_and_fused_steps_default(argv, fused):
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.fused_steps == fused


@pytest.mark.parametrize("argv,error,match", [
    # ported: a data axis the world (one process here) cannot hold
    # raises, and avg50 on a data axis of one trains
    (["--mesh", "data=4"], ValueError, "needs 4 processes"),
    (["--sync", "avg50", "--mesh", "data=1", "--epochs", "1"], None,
     "0  process at  14 with test error"),
    (["--prefetch", "native"], NotImplementedError, "item 15"),  # 15c
    # ported: checkpoints (written at the trace point), a resume from an
    # empty directory (trains from step 0) and the metrics sink
    (["--checkpoint-dir", "{tmp}/ck", "--epochs", "1"], None,
     "0  process at  14 with test error"),
    (["--resume", "--checkpoint-dir", "{tmp}/empty", "--epochs", "1"], None,
     "0  process at  14 with test error"),
    (["--metrics-dir", "{tmp}/m", "--epochs", "1"], None,
     "0  process at  14 with test error"),
    # lamb is ported: on the CNN the reference's refusal
    (["--optimizer", "lamb"], SystemExit, "applies to the transformer"),
    # still not ported: the pipe mesh axis (item 14d; the model and seq
    # axes are ported for the transformers) and the native prefetcher on
    # the ResNet path (15c)
    (["--mesh", "data=1,pipe=2"], NotImplementedError, "item 14"),
    (["--model", "resnet20", "--dataset", "cifar10", "--prefetch",
      "native"], NotImplementedError, "item 15")])
def test_unported_values_raise_naming_their_item(argv, error, match,
                                                 mnist_dir, monkeypatch,
                                                 tmp_path):
    """Each value raises naming its ROADMAP item; a run that trains reads
    the 1200/256-row synthetic MNIST (15 steps of 64, one trace point)
    and leaves the checkpoint or metrics it was asked for."""
    monkeypatch.setattr(mnist, "load_splits", functools.partial(
        mnist.load_splits, train_n=1200, test_n=256))
    argv = [a.format(tmp=tmp_path) for a in argv] + [
        "--device", "cpu", "--data-dir", mnist_dir]
    if error is not None:
        with pytest.raises(error, match=match):
            cli.main(argv)
        return
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    assert match in out.getvalue() and "[timing]" in out.getvalue()
    if "--checkpoint-dir" in argv:
        ck = argv[argv.index("--checkpoint-dir") + 1]
        assert os.path.exists(os.path.join(ck, "ckpt_14.sharded",
                                           "meta.json"))
    if "--metrics-dir" in argv:
        tags = [json.loads(ln)["tag"] for ln in open(os.path.join(
            argv[argv.index("--metrics-dir") + 1], "metrics.jsonl"))]
        # one trace point: its span is the untimed first, so there is
        # no images/sec to write (the reference skips the NaN too)
        assert tags == ["eval/test_error_pct"]


def test_zero_flag_run_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback to the CPU: ``cuda`` without a card raises before any
    data is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        cli.main(["--data-dir", str(tmp_path / "d")])
    assert not os.path.exists(tmp_path / "d")


def test_synthetic_mnist_and_splits_byte_identical(monkeypatch, tmp_path):
    """The IDX payloads (gzip's header carries the write time) and every
    split array, byte for byte."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jd)
    jax_mnist._write_synthetic(jd, train_n=1200, test_n=256)
    write = mnist._write_synthetic
    monkeypatch.setattr(mnist, "_write_synthetic",
                        lambda d: write(d, train_n=1200, test_n=256))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        paths = mnist.ensure_data(td)          # absent: the synthetic set
    assert "synthetic" in out.getvalue()
    for name in mnist.FILES.values():
        with gzip.open(os.path.join(jd, name)) as a, \
                gzip.open(os.path.join(td, name)) as b:
            assert a.read() == b.read(), name
    assert mnist.ensure_data(td, verbose=False) == paths   # present: kept
    for k in (1, 4):
        want = jax_mnist.load_splits(jd, num_shards=k, train_n=1200,
                                     test_n=256)
        got = mnist.load_splits(td, num_shards=k, train_n=1200, test_n=256)
        for f in dataclasses.fields(mnist.Splits):
            w, g = getattr(want, f.name), getattr(got, f.name)
            assert w.dtype == g.dtype and w.shape == g.shape, f.name
            assert w.tobytes() == g.tobytes(), f.name
        for i in range(k):
            for w, g in zip(dataclasses.astuple(want.shard(k, i)),
                            dataclasses.astuple(got.shard(k, i))):
                assert w.tobytes() == g.tobytes()
    os.remove(paths["test_labels"])
    with pytest.raises(FileNotFoundError, match="test_labels"):
        mnist.ensure_data(td)


@pytest.mark.parametrize("t0,w,k,b", [(0, 1, 1, 8), (3, 11, 11, 8),
                                      (40, 5, 11, 6), (97, 3, 4, 5)])
def test_assemble_window_identical(t0, w, k, b):
    rng = np.random.default_rng(3)
    tr_d = rng.normal(size=(4, 50, 3, 2)).astype(np.float32)
    tr_l = rng.integers(0, 10, size=(4, 50)).astype(np.int64)
    want = jax_prefetch.assemble_window(tr_d, tr_l, t0, w, k, b)
    got = prefetch.assemble_window(tr_d, tr_l, t0, w, k, b)
    for a, g in zip(want, got):
        assert a.dtype == g.dtype and a.tobytes() == g.tobytes()


@pytest.mark.parametrize("train_rows,batch,epochs,log_every,fused", [
    (100, 4, 1, 10, 10), (100, 4, 2, 7, 3), (60, 8, 3, 5, 12)])
def test_window_schedule_is_the_reference_loops(monkeypatch, train_rows,
                                                batch, epochs, log_every,
                                                fused):
    """The windows (start, width) the reference's windowed loop hands its
    prefetcher, and its trace steps, with its device steps stubbed out
    (nothing is compiled: only the schedule is read)."""
    seen = {}

    def record(tr_d, tr_l, starts, widths, window_k, b, **kw):
        seen["windows"] = (list(starts), list(widths), window_k)
        return jax_prefetch.ThreadPrefetcher(tr_d, tr_l, starts, widths,
                                             window_k, b)

    monkeypatch.setattr(jax_prefetch, "make_prefetcher", record)
    monkeypatch.setattr(jax_step, "init_state",
                        lambda model, rng: jax_step.TrainState({}, None))
    monkeypatch.setattr(jax_step, "make_multi_train_step",
                        lambda *a, **kw: lambda s, *r: (s, {}))
    monkeypatch.setattr(
        jax_step, "make_multi_eval_step", lambda *a, **kw:
        lambda p, ms, w: np.full(w.shape[:2] + (10,), 0.1, np.float32))
    rng = np.random.default_rng(0)
    img = lambda n: rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    lbl = lambda n: rng.integers(0, 10, size=n).astype(np.int64)
    splits = jax_mnist.Splits(img(train_rows), lbl(train_rows), img(16),
                              lbl(16), img(8), lbl(8))
    cfg = JaxConfig(epochs=epochs, batch_size=batch, log_every=log_every,
                    fused_steps=fused, prefetch="thread")
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    res = jax_loop.train(cfg, splits=splits, mesh=mesh, verbose=False)
    starts, widths = loop.window_schedule(res.num_steps, log_every,
                                          fused + 1)
    assert seen["windows"] == (starts, widths, fused + 1)
    assert res.num_steps == epochs * train_rows // batch
    assert [t for t, _ in res.history] == [
        t for t in range(res.num_steps)
        if loop.is_trace_step(t, log_every, res.num_steps)]


def test_eval_in_batches_tail_and_shard_error_rates():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(37, 6)).astype(np.float32)
    labels = rng.integers(0, 4, size=37)
    w = rng.normal(size=(6, 4)).astype(np.float32)

    def predict(x):
        z = np.exp(np.asarray(x) @ w)
        return (z / z.sum(-1, keepdims=True)).astype(np.float32)

    want = jax_evaluation.eval_in_batches(predict, data, 8)
    got = evaluation.eval_sharded(predict, data, 8, 0, 1)   # one rank
    assert want.tobytes() == got.tobytes()
    for k in (1, 3, 4):
        assert (evaluation.shard_error_rates(got, labels, k)
                == jax_evaluation.shard_error_rates(want, labels, k))
    with pytest.raises(ValueError, match="larger than dataset"):
        evaluation.eval_sharded(predict, data[:5], 8, 0, 1)


@pytest.mark.parametrize("batch,decay_steps,steps", [
    (64, 1000, 900), (8, 1000, 400), (64, 50000, 1563), (64, 781, 700)])
def test_exponential_decay_float32_bit_equal(batch, decay_steps, steps):
    """Every step of the run, across decay boundaries, up to 57 decays
    (past them the two powers differ by an ulp; see train/optimizer)."""
    want = jax.jit(jax.vmap(jax_opt.reference_schedule(
        JaxConfig(batch_size=batch), decay_steps)))(
            jnp.arange(steps, dtype=jnp.float32))
    sched = optimizer.reference_schedule(Config(batch_size=batch),
                                         decay_steps)
    got = np.array([sched(np.float32(t)) for t in range(steps)])
    assert got.dtype == np.float32
    assert np.asarray(want).tobytes() == got.tobytes()
    assert len(np.unique(got)) == (steps - 1) * batch // decay_steps + 1


def test_momentum_update_matches_reference():
    rng = np.random.default_rng(7)
    shapes = [(5, 5, 1, 4), (4,), (9, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jp, js = p0, jax_opt.momentum_init(p0)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = optimizer.momentum_init(tp)
    for i, g in enumerate(grads):
        lr = np.float32(0.01) * np.float32(0.95) ** i
        jp, js = jax_opt.momentum_apply(jp, g, js, jnp.float32(lr), 0.9)
        optimizer.momentum_apply(tp, [torch.from_numpy(x) for x in g], ts,
                                 lr, 0.9)
    for w, g in zip(jp, tp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7,
                                   rtol=0)
    for w, g in zip(js.velocity, ts.velocity):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7,
                                   rtol=0)
    assert ts.step == np.float32(js.step) == np.float32(3.0)
    assert isinstance(ts.step, np.float32)


# ------------------------------------------------------- float parity

@pytest.mark.parametrize("size", [15, 7, 9, 28])
def test_max_pool_same_exact(size):
    x, _ = _inputs(2, size, seed=size)
    x = np.repeat(x, 3, axis=-1)
    want = np.asarray(jax_cnn.max_pool_2x2_same(x))
    got = cnn.max_pool_2x2_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.tobytes() == got.permute(0, 2, 3, 1).contiguous().numpy() \
        .tobytes()


@pytest.mark.parametrize("size", [28, 30])
def test_logits_match_reference(size):
    params = _jax_params()
    if size != 28:      # the reference's init is one row short at 30
        rng = np.random.default_rng(size)
        params["fc1_w"] = (rng.normal(size=(cnn.flat_dim(size), 512))
                           * 0.02).astype(np.float32)
    x, _ = _inputs(8, size)
    logits = {}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(_fast(jax.jit(jax_cnn.MnistCnn(
            image_size=size, compute_dtype=jdt).apply))(params, x))
        model = cnn.MnistCnn(convert.cnn_params_from_jax(params),
                             image_size=size, compute_dtype=dt)
        got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (8, 10)
        logits[dt] = got.detach().numpy(), want
    got, want = logits[torch.float32]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    got, want = logits[torch.bfloat16]
    tol = BF16_LOGITS_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the bound tells the precisions apart: float32 logits miss it
    assert np.abs(logits[torch.float32][0] - want).max() > tol


def test_loss_and_gradients_match_reference():
    params = _jax_params()
    x, y = _inputs(16, 28, seed=2)
    jcfg = JaxConfig(dropout_rate=0.0)
    loss_fn = jax_step.make_loss_fn(jax_cnn.MnistCnn(dropout_rate=0.0), jcfg)
    (want, _), grads = _fast(jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, x, y, jax.random.key(0)),
        has_aux=True)))(params)
    model = cnn.MnistCnn(convert.cnn_params_from_jax(params),
                         dropout_rate=0.0)
    got, state = step.make_loss_fn(model, Config(dropout_rate=0.0))(
        {}, torch.from_numpy(x), torch.from_numpy(y))
    assert state == {}
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=0)
    tree = model.param_tree()
    g = torch.autograd.grad(got, list(tree.values()))
    got_grads = convert.cnn_params_to_numpy(dict(zip(tree, g)))
    for k, w in grads.items():
        np.testing.assert_allclose(got_grads[k], np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_bf16_loss_and_gradients_match_reference():
    """bf16 compute on both sides, dropout 0: the loss within 5e-3, each
    weight's gradient within ``BF16_WEIGHT_GRAD_TOL`` of the reference's
    in relative norm, which the port's float32 gradients miss; each
    bias's within ``BF16_BIAS_GRAD_TOL``, since XLA on the CPU sums a
    bf16 bias gradient over the batch and the pixels in bf16 and PyTorch
    in float32."""
    params = _jax_params()
    x, y = _inputs(16, 28, seed=2)
    jcfg = JaxConfig(dropout_rate=0.0)
    loss_fn = jax_step.make_loss_fn(jax_cnn.MnistCnn(
        dropout_rate=0.0, compute_dtype=jnp.bfloat16), jcfg)
    (want, _), grads = _fast(jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, x, y, jax.random.key(0)),
        has_aux=True)))(params)
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        model = cnn.MnistCnn(convert.cnn_params_from_jax(params),
                             dropout_rate=0.0, compute_dtype=dt)
        loss, _ = step.make_loss_fn(model, Config(dropout_rate=0.0))(
            {}, torch.from_numpy(x), torch.from_numpy(y))
        tree = model.param_tree()
        g = torch.autograd.grad(loss, list(tree.values()))
        rel = {k: float(np.linalg.norm(v - np.asarray(grads[k]))
                        / np.linalg.norm(np.asarray(grads[k])))
               for k, v in convert.cnn_params_to_numpy(
                   dict(zip(tree, g))).items()}
        got[dt] = float(loss.detach()), rel
    loss, rel = got[torch.bfloat16]
    assert abs(loss - float(want)) <= 5e-3
    for k, r in rel.items():
        tol = BF16_WEIGHT_GRAD_TOL if k.endswith("_w") \
            else BF16_BIAS_GRAD_TOL
        assert r <= tol, (k, r, tol)
    _, rel32 = got[torch.float32]
    for k in ("conv1_w", "conv2_w", "fc1_w"):
        assert rel32[k] > BF16_WEIGHT_GRAD_TOL, (k, rel32[k])


def test_params_round_trip_and_l2_subset():
    params = _jax_params()
    model = cnn.MnistCnn(convert.cnn_params_from_jax(params))
    back = convert.cnn_params_to_numpy(model.param_tree())
    assert list(back) == list(cnn.NAMES) and sorted(back) == sorted(params)
    for k in params:
        assert back[k].tobytes() == params[k].tobytes(), k
    assert model.conv1_w.shape == (32, 1, 5, 5)
    assert [p.data_ptr() for p in model.l2_params()] == [
        getattr(model, k).data_ptr()
        for k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b")]


def test_init_bounds_and_bias_constants():
    model = cnn.MnistCnn.from_seed(1)
    shapes = {k: v.shape for k, v in _jax_params().items()}
    for k, p in convert.cnn_params_to_numpy(model.param_tree()).items():
        assert p.shape == shapes[k], k
        if k.endswith("_w"):
            assert np.abs(p).max() <= 0.2 and np.abs(p).max() > 0.15, k
            assert 0.07 < p.std() < 0.1, k     # 0.1 x 0.880 truncated
        else:
            assert np.all(p == (0.0 if k == "conv1_b" else np.float32(0.1)))
    again = cnn.MnistCnn.from_seed(1).param_tree()
    assert all(torch.equal(a, b) for a, b in zip(
        again.values(), model.param_tree().values()))


def test_dropout_in_training_only():
    model = cnn.MnistCnn.from_seed(2)
    x = torch.from_numpy(_inputs(32, 28)[0])
    eval_logits = model(x)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    a = model(x, train=True, generator=torch.Generator().manual_seed(3))
    b = model(x, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, eval_logits)
    assert torch.equal(eval_logits, model(x))


@pytest.mark.parametrize("name,want", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", "conv"),
    ("void cudnn::detail::dgrad_engine<float, 128, 6, 8, 3, 3, 5, false>",
     "conv"),
    ("void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>",
     "conv"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemm"
     "ConvolutionINS1_11threadblock22", "conv"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16",
     "other"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul")])
def test_kernel_category_conv_is_cudnn_convolutions_only(name, want):
    """The CNN's convolution kernels (names from its profile on the card)
    are ``conv``; another cuDNN kernel, such as its attention, is not."""
    assert profiling.kernel_category(name) == want
