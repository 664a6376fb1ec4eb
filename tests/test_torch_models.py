"""The PyTorch VGG, Inception V3 and MLP against horovod_tpu.models.

Each model's parameters are drawn with numpy from a seed in the tree
that the JAX package's init gives (`jax.eval_shape`; He-normal weights,
random biases, BN scales and shifts; the JAX inits, op by op, would
cost seconds each), carried over with models/convert, and run by both
packages on the same numpy batch made from a seed. Every array compared
must agree within TOL = 1e-4 of its largest magnitude (f32 through up
to ~100 layers, summed in different orders by XLA and PyTorch). The JAX
side runs under jax.jit: op by op, Inception's gradient would take over
a minute on a CPU.

Where f32 alone cannot meet that bar, the reference cannot either:
  * VGG-16 at 32², 10 classes, batch 2: logits, loss and every
    gradient in f32 and in f64 (both packages). A gradient is a
    discontinuous function of rounding: a pre-ReLU value within
    rounding of zero can land on either side in two summation orders
    and move every gradient below that layer by a few per cent (with
    the JAX init's seed-0 weights one value of s2c2 does). In f64 no
    value lies that close, so that check holds whatever the draw.
  * Inception V3 in train mode takes batch statistics, and at 75²,
    batch 2 (count-2 BNs in the C blocks; E[x²] − E[x]² in f32) the
    JAX model's own f32 result is not reproducible to 1e-4: a change
    of one ulp in its input moves its loss by more than 1%
    (test_jax_inception_train_mode_is_ill_conditioned_at_75). So the
    test holds (a) at 75², batch 2, 7 classes, in eval mode (running
    stats drawn from a seed): logits, loss and every gradient, which
    covers every conv, pad, pool, split and channel order forward and
    backward; and (b) in train mode at the model's own 299², batch 2,
    where the forward is better conditioned: logits, loss and every
    new BN stat. Train-mode gradients stay sensitive to rounding even
    at 299² in both packages, so they are not compared element by
    element; the train-mode BN's backward is
    ops/sync_batch_norm.batch_norm's, which tests/test_torch_resnet.py
    holds at 1e-4.
  * The MLP at 784-512-256-10, batch 4, f32: logits, loss, every
    gradient.

The parameter counts of the full-size models (VGG-16 at 224² with 1000
classes, Inception V3 with 1000) equal the JAX inits' as
`jax.eval_shape` reads them; the port builds those models on the meta
device, so no memory is spent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import inception as jinception
from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as tinception
from horovod_tpu_torch.models import mlp as tmlp
from horovod_tpu_torch.models import vgg as tvgg

TOL = 1e-4  # of the largest magnitude of each compared array


def _close(got, want, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * (np.max(np.abs(want)) + 1e-12), \
        (what, err, np.max(np.abs(want)))


def _np_tree(init, seed, dtype=np.float32):
    """`init`'s tree (its shapes by jax.eval_shape) filled from numpy:
    weights `w` He-normal over their fan-in, biases N(0, 0.05²), BN
    scales U(0.5, 1.5) and shifts N(0, 0.1²); stats means N(0, 0.1²)
    and vars U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = path[-1].key
        if key == "w":
            v = rng.standard_normal(s.shape) * \
                (2.0 / np.prod(s.shape[:-1])) ** 0.5
        elif key in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # b, bias, mean
            v = rng.normal(0.0, 0.05 if key == "b" else 0.1, s.shape)
        return jnp.asarray(v, np.float32 if key in ("mean", "var")
                           else dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _batch(n, size, classes, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    return x, rng.integers(0, classes, (n,))


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _flat_inception_stats(ns):
    """The port's nested new-stats tree as {state_dict name: tensor}."""
    out = {}
    for name, st in ns["stem"].items():
        out[f"stem.{name}.bn.mean"] = st["mean"]
        out[f"stem.{name}.bn.var"] = st["var"]
    for top, brs in ns.items():
        if top == "stem":
            continue
        for br, sts in brs.items():
            for i, st in enumerate(sts):
                out[f"{top}.{br}.{i}.bn.mean"] = st["mean"]
                out[f"{top}.{br}.{i}.bn.var"] = st["var"]
    return out


def _nll(logits, y):
    """The JAX models' loss_fn on their logits (horovod_tpu/models/
    vgg.py:81-86, inception.py, mlp.py): log-softmax in f32 (the MLP's
    in the logits' dtype, f32 here), the mean negative log-likelihood
    of the labels."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _jax_run(apply, y, params, grads: bool):
    """One jitted call of the JAX model: `apply(params)` gives (logits,
    aux); returns the logits, the loss, aux and, with `grads`, the
    gradients of the loss with respect to `params`. One forward in the
    compiled graph: the compile is most of the test's time."""
    def loss(p):
        logits, aux = apply(p)
        return _nll(logits, y), (logits, aux)

    def run(p):
        if not grads:
            lv, (lg, aux) = loss(p)
            return lg, lv, aux, None
        (lv, (lg, aux)), g = jax.value_and_grad(loss, has_aux=True)(p)
        return lg, lv, aux, g
    return jax.jit(run)(params)


def _vgg_run(depth, size, dtype, seed=0, grads=True):
    """The JAX VGG's logits, loss and gradients, and the port's, from
    the JAX init (10 classes, batch 2)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "f64": (jnp.float64, torch.float64)}[dtype]
    params = _np_tree(lambda k: jvgg.init(k, depth=depth, num_classes=10,
                                          image_size=size), seed, jdt)
    x, y = _batch(2, size, 10)
    x = x.astype(jdt)
    jx = jnp.asarray(x)
    logits, loss, _, g = _jax_run(
        lambda p: (jvgg.apply(p, jx, depth=depth), None), jnp.asarray(y),
        params, grads)

    model = tvgg.VGG(depth, num_classes=10, dtype=tdt, image_size=size)
    convert.load_jax_vgg(model, params)
    tl = tvgg.apply(model, torch.tensor(x))
    tloss = tvgg.loss_fn(model, (torch.tensor(x), torch.tensor(y)))
    out = dict(logits=(tl, logits), loss=(tloss, loss))
    if grads:
        tloss.backward()
        out["grads"] = (_grads(model), convert.vgg_from_jax(g))
    return out


@pytest.fixture(scope="module")
def vgg16():
    return {dt: _vgg_run(16, 32, dt) for dt in ("f32", "f64")}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_vgg16_logits_and_loss_match_jax(vgg16, dtype):
    _close(*vgg16[dtype]["logits"], "logits")
    _close(*vgg16[dtype]["loss"], "loss")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_vgg16_every_gradient_matches_jax(vgg16, dtype):
    got, want = vgg16[dtype]["grads"]
    assert set(got) == set(want) and len(got) == 16 * 2
    for name in sorted(want):
        _close(got[name], want[name], name)


@pytest.fixture(scope="module")
def vgg16_sgd():
    """Three steps of the benchmark's optimizer (SGD, lr 0.01 at one
    rank, momentum 0.9) on one repeated batch, as
    examples/synthetic_benchmark.py runs them, VGG-16 at 64², 1000
    classes, batch 2, f32, in both packages: the first step's logits
    and each step's loss."""
    import optax
    params = _np_tree(lambda k: jvgg.init(k, depth=16, num_classes=1000,
                                          image_size=64), 7)
    x, y = _batch(2, 64, 1000, seed=8)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    opt = optax.sgd(0.01, momentum=0.9)

    @jax.jit
    def step(p, st):
        (loss, logits), g = jax.value_and_grad(
            lambda p: (lambda lg: (_nll(lg, jy), lg))(
                jvgg.apply(p, jx, depth=16)), has_aux=True)(p)
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st, loss, logits

    p, st, want = params, opt.init(params), []
    for i in range(3):
        p, st, loss, logits = step(p, st)
        want.append(float(loss))
        if i == 0:
            want_logits = logits
    model = tvgg.VGG(16, num_classes=1000, image_size=64)
    convert.load_jax_vgg(model, params)
    got_logits = tvgg.apply(model, torch.tensor(x))
    sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    got = []
    for _ in range(3):
        sgd.zero_grad()
        loss = tvgg.loss_fn(model, (torch.tensor(x), torch.tensor(y)))
        loss.backward()
        sgd.step()
        got.append(loss.item())
    return dict(logits=(got_logits, want_logits), losses=(got, want))


def test_vgg16_flattens_nhwc_for_fc0(vgg16_sgd):
    """fc0's rows are (h, w, c): a feature map whose (h, w) cells differ
    gives fc0 the JAX model's input only when flattened NHWC. At 64² the
    last map is 2x2, so an NCHW flatten would permute 4 x 512 rows (at
    32² it is 1x1 and both orders agree)."""
    _close(*vgg16_sgd["logits"], "logits at 64²")


def test_vgg16_sgd_steps_track_jax_and_diverge_alike(vgg16_sgd):
    """The port's losses under the benchmark's optimizer follow the JAX
    model's step for step (1e-3 relative), and both blow up past 1e3
    (over a hundred times ln 1000, the untrained loss) by the third
    step: the divergence is the configuration's (VGG has no BN), not
    the port's. chip_smoke.py's finite-loss bar for VGG-16 therefore
    trains at lr 1e-4."""
    got, want = vgg16_sgd["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[2] > 1e3 and want[2] > 1e3


def test_vgg19_forward_matches_jax():
    params = _np_tree(lambda k: jvgg.init(k, depth=19, num_classes=10,
                                          image_size=32), 1)
    x, _ = _batch(2, 32, 10, seed=2)
    want = jax.jit(lambda p, x: jvgg.apply(p, x, depth=19))(
        params, jnp.asarray(x))
    model = tvgg.VGG(19, num_classes=10, image_size=32)
    convert.load_jax_vgg(model, params)
    _close(tvgg.apply(model, torch.tensor(x)), want, "logits")


def _inception_init(seed):
    """(params, stats) for 7 classes, drawn by _np_tree."""
    return _np_tree(lambda k: jinception.init(k, num_classes=7), seed)


@pytest.fixture(scope="module")
def inception_eval():
    """75², batch 2, 7 classes, eval mode: logits, loss, gradients."""
    params, stats = _inception_init(0)
    x, y = _batch(2, 75, 7)
    jx = jnp.asarray(x)
    logits, lj, _, gj = _jax_run(
        lambda p: jinception.apply(p, stats, jx, train=False),
        jnp.asarray(y), params, True)

    model = tinception.InceptionV3(num_classes=7)
    convert.load_jax_inception(model, params, stats)
    tl, _ = tinception.apply(model, torch.tensor(x), train=False)
    lt, _ = tinception.loss_fn(model, (torch.tensor(x), torch.tensor(y)),
                               train=False)
    lt.backward()
    want = {k: v for k, v in convert.inception_from_jax(gj, stats).items()
            if not k.endswith((".bn.mean", ".bn.var"))}
    return dict(logits=(tl, logits), loss=(lt, lj),
                grads=(_grads(model), want))


@pytest.fixture(scope="module")
def inception_train():
    """299², batch 2, 7 classes, train mode: logits, loss, new stats."""
    params, stats = _inception_init(1)
    x, y = _batch(2, 299, 7)
    jx = jnp.asarray(x)
    logits, lj, nsj, _ = _jax_run(
        lambda p: jinception.apply(p, stats, jx, train=True),
        jnp.asarray(y), params, False)

    model = tinception.InceptionV3(num_classes=7)
    convert.load_jax_inception(model, params, stats)
    with torch.no_grad():
        tl, _ = tinception.apply(model, torch.tensor(x))
        lt, nst = tinception.loss_fn(model,
                                     (torch.tensor(x), torch.tensor(y)))
    want = {k: v for k, v in convert.inception_from_jax(params, nsj).items()
            if k.endswith((".bn.mean", ".bn.var"))}
    return dict(logits=(tl, logits), loss=(lt, lj),
                stats=(_flat_inception_stats(nst), want))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_inception_logits_and_loss_match_jax(inception_eval, inception_train,
                                             mode):
    res = inception_eval if mode == "eval" else inception_train
    _close(*res["logits"], "logits")
    _close(*res["loss"], "loss")


def test_inception_every_gradient_matches_jax(inception_eval):
    got, want = inception_eval["grads"]
    assert set(got) == set(want) and len(got) == 94 * 3 + 2
    for name in sorted(want):
        _close(got[name], want[name], name)


def test_inception_every_new_bn_stat_matches_jax(inception_train):
    got, want = inception_train["stats"]
    assert set(got) == set(want) and len(got) == 94 * 2
    for name in sorted(want):
        _close(got[name], want[name], name)


def test_jax_inception_train_mode_is_ill_conditioned_at_75():
    """Why train-mode Inception is compared at 299²: at 75², batch 2, a
    one-ulp (2^-24) relative change of every input value moves the JAX
    model's own f32 train-mode loss by more than 1%, a hundred times
    the 1e-4 bar."""
    params, stats = _inception_init(0)
    x, y = _batch(2, 75, 7)
    sign = np.random.default_rng(3).choice([-1.0, 1.0], x.shape)
    x2 = (x * (1 + sign * 2.0 ** -24)).astype(np.float32)
    assert np.any(x2 != x)
    f = jax.jit(lambda x: jinception.loss_fn(
        params, stats, (x, jnp.asarray(y)), train=True)[0])
    l1, l2 = float(f(jnp.asarray(x))), float(f(jnp.asarray(x2)))
    assert abs(l1 - l2) > 1e-2 * abs(l1)


def test_inception_state_keeps_the_jax_keypaths():
    params, stats = _inception_init(2)
    state = convert.inception_from_jax(params, stats)
    names = set(tinception.InceptionV3(num_classes=7,
                                       device="meta").state_dict())
    assert names == set(state)
    assert {"stem.c0.w", "a0.b5x5.1.bn.scale", "c1.b3x3dbl.3.bn.var",
            "fc.w"} <= names


def test_inception_eval_mode_returns_the_running_stats(inception_eval):
    model = tinception.InceptionV3(num_classes=7)
    _, ns = tinception.apply(model, torch.zeros(1, 75, 75, 3), train=False)
    assert ns["a0"]["b5x5"][1]["var"] is model.a0.b5x5[1].bn.var


def test_mlp_matches_jax():
    params = _np_tree(jmlp.init, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 784)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    jx = jnp.asarray(x)
    logits, loss, _, grads = _jax_run(lambda p: (jmlp.apply(p, jx), None),
                                      jnp.asarray(y), params, True)
    model = tmlp.MLP()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert.mlp_from_jax(params).items()})
    _close(tmlp.apply(model, torch.tensor(x)), logits, "logits")
    tloss = tmlp.loss_fn(model, (torch.tensor(x), torch.tensor(y)))
    tloss.backward()
    _close(tloss, loss, "loss")
    want = convert.mlp_from_jax(grads)
    got = _grads(model)
    assert set(got) == set(want)
    for name in sorted(want):
        _close(got[name], want[name], name)


def _jax_count(tree):
    return sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ["vgg16", "vgg19", "inception3", "mlp"])
def test_full_size_parameter_counts_equal_the_jax_inits(name):
    key = jax.random.PRNGKey(0)
    if name.startswith("vgg"):
        depth = int(name[3:])
        want = _jax_count(jax.eval_shape(
            lambda k: jvgg.init(k, depth=depth, num_classes=1000,
                                image_size=224), key))
        model = tvgg.VGG(depth, num_classes=1000, image_size=224,
                         device="meta")
    elif name == "inception3":
        want = _jax_count(jax.eval_shape(
            lambda k: jinception.init(k, num_classes=1000)[0], key))
        model = tinception.InceptionV3(num_classes=1000, device="meta")
    else:
        want = _jax_count(jax.eval_shape(jmlp.init, key))
        model = tmlp.MLP(device="meta")
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    assert {p.device.type for p in model.parameters()} == {"meta"}
    if name == "vgg16":
        assert got == 138_357_544
    if name == "inception3":
        assert got == 23_834_568


@pytest.fixture()
def world_of_one(monkeypatch):
    """A fresh world of one on gloo in this process."""
    import horovod_tpu_torch as hvd
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
              "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT",
              "HOROVOD_AUTOTUNE", "HOROVOD_BUCKET_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("model,size", [("vgg16", 32), ("inception3", 75)])
def test_synthetic_benchmark_runs_the_model(world_of_one, capsys, model,
                                            size):
    """run_bench on the CPU, batch 2, one step: the model is named, its
    loss finite, and a rate printed."""
    from horovod_tpu_torch import synthetic_benchmark as sb
    args = sb.parse_args(["--model", model, "--device", "cpu",
                          "--batch-size", "2", "--image-size", str(size),
                          "--dtype", "float32", "--num-warmup-batches", "0",
                          "--num-iters", "1", "--num-batches-per-iter", "1"])
    ips = sb.run_bench(args)
    out = capsys.readouterr().out
    assert f"Model: {model}, batch 2/rank, {size}² images" in out
    assert "All losses finite: True" in out
    assert ips > 0


def test_synthetic_benchmark_defaults_inception_to_299():
    from horovod_tpu_torch import synthetic_benchmark as sb
    assert sb.parse_args(["--model", "inception3"]).image_size == 299
    assert sb.parse_args(["--model", "vgg19"]).image_size == 224
