"""The PyTorch package's training path as a whole, over two processes,
against the JAX package's data-parallel step.

Two spawned gloo workers (tests/torch_train_worker.py, a FileStore under
tmp_path) train the mini ResNet for 2 steps with HOROVOD_CONV_BLOCK=1:
sync-BN over the world, hvd.broadcast_parameters from rank 0,
hvd.DistributedOptimizer over SGD(momentum 0.9) with a 64 KiB fusion
threshold, so the gradients go out in many buckets; then
hvd.broadcast_optimizer_state overwrites rank 1's perturbed SGD state
with rank 0's. The JAX side runs
the same 2 steps as examples/synthetic_benchmark.py builds them: a
shard_map step on a 2-device CPU mesh, axis "hvd", with
reduce_gradients_in_jit and optax.sgd. Weights and running stats must
agree within 1e-4 of the largest magnitude (f32, two steps, sums in
different orders). The workers' eager collectives are held against
numpy exactly for Sum and within 1e-6 for Average.

Also the isolation of the package: no module of horovod_tpu_torch, and
not chip_smoke.py, imports jax or horovod_tpu, and hvd.init() without
a device on a host without CUDA raises.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import torch_train_worker
from torch_world_worker import spawn_world
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.ops.compression import Compression
from horovod_tpu.optim.optimizer import reduce_gradients_in_jit
from horovod_tpu_torch.models import convert

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 2


def _jax_train(params, stats, x, y, k):
    mesh = Mesh(np.array(jax.devices()[:k]), ("hvd",))
    opt = optax.sgd(0.01 * k, momentum=0.9)
    opt_state = opt.init(params)

    def local_step(params, stats, opt_state, batch):
        def loss(p):
            return jresnet.loss_fn(p, stats, batch, depth=8, train=True,
                                   axis_name="hvd")
        (l, ns), g = jax.value_and_grad(loss, has_aux=True)(params)
        g = reduce_gradients_in_jit(g, num_ranks=k,
                                    compression=Compression.none)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, ns, opt_state, lax.pmean(l, "hvd")

    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh, in_specs=(P(), P(), P(), P("hvd")),
        out_specs=(P(), P(), P(), P()), check_vma=False))
    batch = (jnp.asarray(x), jnp.asarray(y))
    for _ in range(STEPS):
        params, stats, opt_state, _ = step(params, stats, opt_state, batch)
    return params, stats


def _spawn_workers(tmp_path, state, x, y, k):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(k)]
    spawn_world(torch_train_worker.run,
                [(r, k, store, state, x, y, STEPS, outs[r])
                 for r in range(k)], tmp_path, deadline=240)
    return [dict(np.load(o)) for o in outs]


def test_two_process_training_matches_jax(tmp_path, monkeypatch):
    k = 2
    monkeypatch.setenv("HOROVOD_CONV_BLOCK", "1")
    jresnet.STAGE_BLOCKS[8] = (1, 1)
    try:
        params, stats = jresnet.init(jax.random.PRNGKey(0), depth=8,
                                     num_classes=10, dtype=jnp.float32)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 10, (4,))
        state0 = convert.from_jax(params, stats)
        res = _spawn_workers(tmp_path, state0, x, y, k)
        pj, sj = _jax_train(params, stats, x, y, k)
    finally:
        jresnet.STAGE_BLOCKS.pop(8, None)

    assert int(res[0]["n_buckets"]) > 4
    want = convert.from_jax(pj, sj)
    for r in range(k):
        got = {key[len("state/"):]: v for key, v in res[r].items()
               if key.startswith("state/")}
        assert set(got) == set(want)
        for name, v in got.items():
            a, b = np.asarray(want[name], np.float64), v.astype(np.float64)
            assert np.max(np.abs(a - b)) <= 1e-4 * (np.max(np.abs(a))
                                                     + 1e-9), name
        # training moved the weights away from the start
        assert not np.allclose(got["fc.w"], state0["fc.w"])
        np.testing.assert_array_equal(res[r]["opt/fc_momentum"],
                                      res[0]["opt/fc_momentum"])
        assert float(res[r]["opt/lr"]) == 0.01 * k

    ins = [res[r] for r in range(k)]
    total = sum(i["in/a"] for i in ins)
    for r in range(k):
        np.testing.assert_array_equal(res[r]["allreduce_sum"], total)
        np.testing.assert_array_equal(res[r]["async_sum"], total)
        np.testing.assert_allclose(res[r]["allreduce_avg"], total / k,
                                   rtol=1e-6, atol=1e-6)
        assert bool(res[r]["polled"])
        for i in range(3):
            g_total = sum(s[f"in/g{i}"] for s in ins)
            np.testing.assert_allclose(res[r][f"grouped/{i}"], g_total / k,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(res[r][f"bucketed/{i}"], g_total)
        np.testing.assert_array_equal(res[r]["broadcast"], ins[1]["in/a"])


# ---------------------------------------------------------------- isolation

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_imports_no_jax_by_ast():
    files = sorted(f for f in (ROOT / "horovod_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts)  # build outputs, not source
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "horovod_tpu", "optax",
                                "flax"), (f, mod)


def test_package_imports_no_jax_at_runtime():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.models.resnet,"
            " horovod_tpu_torch.models.convert, "
            "horovod_tpu_torch.synthetic_benchmark, "
            "horovod_tpu_torch.profile_step, horovod_tpu_torch.runner, "
            "horovod_tpu_torch.runner.launch, "
            "horovod_tpu_torch.runner.rendezvous, "
            "horovod_tpu_torch.runner.network, "
            "horovod_tpu_torch.runner.kv_ha, "
            "horovod_tpu_torch.runner.mpi_run, "
            "horovod_tpu_torch.runner.js_run, "
            "horovod_tpu_torch.runner.task_runner, "
            "horovod_tpu_torch.runner.results, "
            "horovod_tpu_torch.runner.hosts, "
            "horovod_tpu_torch.runner.safe_exec, "
            "horovod_tpu_torch.runner.secret, "
            "horovod_tpu_torch.common.config, "
            "horovod_tpu_torch.common.hvd_logging, "
            "horovod_tpu_torch.common.resilience, "
            "horovod_tpu_torch.ckpt, horovod_tpu_torch.checkpoint, "
            "horovod_tpu_torch.elastic, horovod_tpu_torch.elastic.driver, "
            "horovod_tpu_torch.elastic.resnet_check, "
            "horovod_tpu_torch.parallel, horovod_tpu_torch.parallel.mesh, "
            "horovod_tpu_torch.parallel.comm, "
            "horovod_tpu_torch.parallel.ring_attention, "
            "horovod_tpu_torch.parallel.ulysses, "
            "horovod_tpu_torch.models.transformer, "
            "horovod_tpu_torch.transformer_lm, "
            "horovod_tpu_torch.native, "
            "horovod_tpu_torch.observability.metrics, "
            "horovod_tpu_torch.observability.export, "
            "horovod_tpu_torch.observability.flight, "
            "horovod_tpu_torch.observability.tracing, "
            "horovod_tpu_torch.testing.faults, "
            "horovod_tpu_torch.core.consistency, "
            "horovod_tpu_torch.analysis.verifier, "
            "horovod_tpu_torch.frontends, horovod_tpu_torch.frontends.torch, "
            "horovod_tpu_torch.frontends.torch_elastic, "
            "horovod_tpu_torch.frontends.tensorflow, "
            "horovod_tpu_torch.frontends.tensorflow_elastic, "
            "horovod_tpu_torch.frontends.keras, "
            "horovod_tpu_torch.frontends.mxnet, horovod_tpu_torch.spark, "
            "horovod_tpu_torch.spark.params, horovod_tpu_torch.spark.store, "
            "horovod_tpu_torch.spark.util, horovod_tpu_torch.spark.backend, "
            "horovod_tpu_torch.spark.estimator, "
            "horovod_tpu_torch.spark.elastic, horovod_tpu_torch.ray;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu', 'optax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_init_without_cuda_raises():
    """With no CUDA device and no device='cpu', init refuses to run."""
    code = ("import torch, horovod_tpu_torch as hvd\n"
            "assert not torch.cuda.is_available()\n"
            "try:\n    hvd.init()\nexcept hvd.HorovodError as e:\n"
            "    print('raised', e)\nelse:\n    raise SystemExit(3)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "raised" in r.stdout, r.stdout + r.stderr
