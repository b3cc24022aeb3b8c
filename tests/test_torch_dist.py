"""parallel.dist, the launcher and the mesh over ranks, on the host.

Multi-rank cases run tests/torch_dist_prog.py through the port's
launcher (free ports, a timeout of at most 120 s, gloo, two threads a
rank). Also: the model store's empty-directory repair, and a server
process that never initialises CUDA.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as JP

from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import shard_params as jshard_params

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.parallel import Mesh, dist, shard_params

from torch_dist_prog import launch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DMLC = ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
         "DMLC_WORKER_ID", "DMLC_NUM_SERVER", "DMLC_ROLE")


@pytest.fixture
def no_contract(monkeypatch):
    for k in _DMLC:
        monkeypatch.delenv(k, raising=False)
    yield
    dist.shutdown()


def test_initialize_is_a_noop_without_a_contract(no_contract):
    assert dist.initialize() is False
    assert not dist.is_initialized()
    assert (dist.rank(), dist.num_processes()) == (0, 1)
    assert dist.local_slice(8) == (0, 8)
    dist.barrier()                          # no group: returns
    dist.shutdown()                         # idempotent
    dist.shutdown()


def test_initialize_is_a_noop_with_one_worker(no_contract, monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    assert dist.initialize(platform="cpu") is False
    assert dist.env_spec() == (None, 1, 0)


def test_initialize_refuses_what_the_port_does_not_run(no_contract):
    with pytest.raises(ValueError, match="one device per process"):
        dist.initialize(local_device_count=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.initialize(backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        dist.initialize(backend="mpi")


@pytest.mark.parametrize("n", [2, 4])
def test_group_agrees_on_rank_size_slices_and_meshes(n, tmp_path):
    launch(n, 0, "spmd_basic", tmp_path)
    outs = [np.load(tmp_path / ("basic_r%d.npz" % r)) for r in range(n)]
    per = 8 // n
    for r, o in enumerate(outs):
        assert int(o["rank"]) == r and int(o["n"]) == n
        assert list(o["slice"]) == [r * per, (r + 1) * per]
        assert bool(o["uneven_raised"])
        assert list(o["dp_shape"]) == [n]
        # A reseed repeats the rank's stream; the ranks' streams differ.
        np.testing.assert_array_equal(o["draw0"], o["draw1"])
        assert not bool(o["cuda_initialized"])
    assert not np.array_equal(outs[0]["draw0"], outs[1]["draw0"])
    if n == 4:
        for r, o in enumerate(outs):
            dp, sp = divmod(r, 2)
            assert list(o["m2_shape"]) == [2, 2]
            assert list(o["m2_coords"]) == [dp, sp]
            assert list(o["m2_dp_ranks"]) == [sp, 2 + sp]
            assert list(o["m2_sp_ranks"]) == [2 * dp, 2 * dp + 1]
            assert float(o["sp_sum"][0]) == 4 * dp + 1
            assert float(o["dp_sum"][0]) == 2 * sp + 2


def test_shard_params_gives_the_jax_specs():
    shapes = {"dense_weight": (64, 32), "dense_bias": (64,),
              "conv_weight": (32, 16, 3, 3), "small_weight": (4, 3),
              "odd_weight": (63, 32), "gamma": (16,)}
    jmesh = jmake_mesh({"dp": 4, "tp": 2})
    want = {n: tuple(s.spec) for n, s in
            jshard_params(jmesh, shapes).items()}
    mesh = Mesh([mx.cpu()], ("dp", "tp"), (4, 2))
    got = {n: tuple(s.spec) for n, s in shard_params(mesh, shapes).items()}
    assert got == want
    assert want["dense_weight"] == tuple(JP("tp", None))
    dp_only = Mesh([mx.cpu()], ("dp",), (8,))
    assert all(tuple(s.spec) == () for s in
               shard_params(dp_only, shapes).values())


def test_a_server_process_never_initialises_cuda(tmp_path):
    """Every role runs the same command: it records at exit whether
    CUDA was initialised, then imports the port (a server or scheduler
    runs its loop there and exits); the worker pushes through an
    optimizer so the server runs the updater, and after closing the
    store waits for the other roles' records (the launcher kills every
    role once the workers are gone)."""
    code = (
        "import atexit, os, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "out = os.environ['MXNET_TEST_OUT']\n"
        "role = os.environ['DMLC_ROLE']\n"
        "def rec():\n"
        "    path = os.path.join(out, role + '.txt')\n"
        "    with open(path + '.tmp', 'w') as f:\n"
        "        f.write(str(torch.cuda.is_initialized()))\n"
        "    os.replace(path + '.tmp', path)\n"
        "atexit.register(rec)\n"
        "sys.path.insert(0, %r)\n"
        "import mxnet_tpu_torch as mx\n"
        "import numpy as np\n"
        "kv = mx.kv.create('dist_sync')\n"
        "kv.set_optimizer(mx.optimizer.create('sgd', learning_rate=0.5))\n"
        "with mx.cpu():\n"
        "    kv.init(0, mx.nd.ones((4,)))\n"
        "    kv.push(0, mx.nd.ones((4,)))\n"
        "    o = mx.nd.zeros((4,))\n"
        "kv.pull(0, out=o)\n"
        "assert np.allclose(o.asnumpy(), 0.5), o.asnumpy()\n"
        "kv.close()\n"
        "import time\n"
        "deadline = time.time() + 30\n"
        "while time.time() < deadline and not all(os.path.exists(\n"
        "        os.path.join(out, r + '.txt')) for r in ('server', "
        "'scheduler')):\n"
        "    time.sleep(0.1)\n" % ROOT)
    from mxnet_tpu_torch.parallel.launch import launch_local

    codes, outs = launch_local(1, 1, [sys.executable, "-c", code],
                               env_extra={"MXNET_TEST_OUT": str(tmp_path)},
                               timeout=90, capture=True)
    assert codes == [0], outs
    import time

    deadline = time.time() + 30
    while time.time() < deadline and not all(
            (tmp_path / (r + ".txt")).exists()
            for r in ("server", "scheduler", "worker")):
        time.sleep(0.1)
    for role in ("server", "scheduler", "worker"):
        assert (tmp_path / (role + ".txt")).read_text() == "False", role


def test_model_store_reads_an_empty_directory_as_the_jax_package(
        monkeypatch, tmp_path):
    """MXNET_TPU_MODEL_ZOO_DIR="" names the working directory in both
    packages (os.environ.get with a default); unset, the default."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "resnet18_v1.params").write_bytes(b"")
    monkeypatch.setenv("MXNET_TPU_MODEL_ZOO_DIR", "")
    want = jstore.get_model_file("resnet18_v1")
    assert model_store.get_model_file("resnet18_v1") == want \
        == "resnet18_v1.params"
    for store in (jstore, model_store):
        with pytest.raises(FileNotFoundError):
            store.get_model_file("alexnet")
    monkeypatch.delenv("MXNET_TPU_MODEL_ZOO_DIR")
    with pytest.raises(FileNotFoundError, match=".mxnet_tpu"):
        model_store.get_model_file("resnet18_v1")
