"""The port stands alone and never falls back to the host on its own.

- No file of mxnet_tpu_torch/ (nor chip_smoke.py) imports jax or
  mxnet_tpu, by an AST scan, and importing the port in a fresh process
  (every module, the input pipeline's and those ``mx.data`` loads
  lazily included) leaves both out of sys.modules.
- The default context is gpu(0): without a CUDA device, an entry point
  given no ctx raises instead of computing on the host.
"""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module):
    return module is not None and module.split(".")[0] in FORBIDDEN


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    getattr(node.func, "attr", getattr(node.func, "id", "")) \
                    in ("import_module", "__import__"):
                names = [node.args[0].value]
            offenders += ["%s:%d %s" % (os.path.relpath(path, ROOT),
                                        node.lineno, n)
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mx\n"
        "import mxnet_tpu_torch.gluon.model_zoo.vision, "
        "mxnet_tpu_torch.serving, mxnet_tpu_torch.initializer, "
        "mxnet_tpu_torch.cached_op, mxnet_tpu_torch._native, "
        "mxnet_tpu_torch.ops.flash_attention, "
        "mxnet_tpu_torch.profile_serving, mxnet_tpu_torch.gluon.loss, "
        "mxnet_tpu_torch.parallel, mxnet_tpu_torch.profile_training, "
        "mxnet_tpu_torch.examples.train_imagenet, "
        "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.lr_scheduler, "
        "mxnet_tpu_torch.metric, mxnet_tpu_torch.callback, "
        "mxnet_tpu_torch.kvstore, mxnet_tpu_torch.gradient_compression, "
        "mxnet_tpu_torch.fused_update, mxnet_tpu_torch.engine, "
        "mxnet_tpu_torch.env, mxnet_tpu_torch.util, "
        "mxnet_tpu_torch.registry_util, mxnet_tpu_torch.telemetry, "
        "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.recordio, "
        "mxnet_tpu_torch.recordio_native, mxnet_tpu_torch.io, "
        "mxnet_tpu_torch.image, mxnet_tpu_torch.image.png, "
        "mxnet_tpu_torch.data, mxnet_tpu_torch.data.sharding, "
        "mxnet_tpu_torch.data.reader, mxnet_tpu_torch.data.decode, "
        "mxnet_tpu_torch.data.prefetch, mxnet_tpu_torch.data.pipeline, "
        "mxnet_tpu_torch.data.autoscale, mxnet_tpu_torch.gluon.data, "
        "mxnet_tpu_torch.gluon.data.vision, mxnet_tpu_torch.log, "
        "mxnet_tpu_torch.telemetry.watchdog, "
        "mxnet_tpu_torch.telemetry.healthplane, "
        "mxnet_tpu_torch.examples.gluon_image_classification, "
        "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.checkpoint.manager, "
        "mxnet_tpu_torch.checkpoint.preempt, "
        "mxnet_tpu_torch.checkpoint.state, mxnet_tpu_torch.checkpoint.guard, "
        "mxnet_tpu_torch.module, mxnet_tpu_torch.model, "
        "mxnet_tpu_torch.profiler, mxnet_tpu_torch.examples.train_resume, "
        "mxnet_tpu_torch.examples.train_mnist\n"
        "import mxnet_tpu_torch.data as d\n"
        "d.DataPipeline, d.DecodePool, d.DevicePrefetcher, d.RecordDataset, "
        "d.DecodeAutoscaler, d.stall_fraction\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_context_is_gpu0_and_tpu_aliases_gpu():
    assert mx.current_context() == mx.gpu(0)
    assert mx.tpu(1) == mx.gpu(1)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.ones((2,)).context == mx.cpu()
    assert mx.current_context() == mx.gpu(0)


@pytest.mark.parametrize("make", [
    lambda: mx.nd.zeros((2, 3)),
    lambda: mx.nd.array(np.ones((2, 3), np.float32)),
    lambda: mx.gluon.nn.Dense(2, in_units=3).initialize(),
    lambda: mx.serving.InferenceServer(lambda x: x, item_shape=(3,),
                                       max_batch=2, start=False),
    # Optimizer states with no context to follow go to the default one.
    lambda: mx.optimizer.get_updater(mx.optimizer.create("sgd")).set_states(
        __import__("pickle").dumps({0: np.ones((2,), np.float32)})),
])
def test_no_ctx_without_cuda_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_kernel_path_never_runs_the_plain_version_off_host():
    """A tensor that is not on the host is not sent to the plain
    version: an unsupported device raises."""
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_forward

    q = torch.empty((1, 1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention_forward(q, q, q)


def test_backward_never_runs_the_plain_version_off_host():
    """The gradient path sends a tensor that is not on the host to the
    kernels or raises; it never takes the plain backward."""
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_backward

    q = torch.empty((1, 1, 16, 8), device="meta")
    lse = torch.empty((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention_backward(q, q, q, q, lse, q)


def test_kernel_build_without_toolkit_raises():
    from mxnet_tpu_torch import _native

    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _native.build(["flash_attention_fwd"])
    with pytest.raises(RuntimeError, match="nvcc"):
        _native.build(["flash_attention_bwd"])
