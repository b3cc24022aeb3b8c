"""The multi-process group: one process per rank over torch.distributed.

Counterpart of ``mxnet_tpu/parallel/dist.py``. The launch contract is
the same (the ``DMLC_*`` variables that ``parallel/launch.py`` exports,
``dist.py:46-59`` there); where the JAX package joins
``jax.distributed`` and then sees one global device list, the port
forms a ``torch.distributed`` process group and keeps one device per
process. Collectives are explicit: :class:`~.mesh.Mesh` hands out the
group of each axis, and ``TrainStep``, ring attention and the Trainer
pass a group to every call.

Env contract (``python -m mxnet_tpu_torch.parallel.launch -n N -s 0``):

- ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` — the rendezvous address
  (rank 0 binds it: the group's ``tcp://`` store);
- ``DMLC_NUM_WORKER`` — the number of processes in the group;
- ``DMLC_WORKER_ID`` — this process's rank.

Backends: ``nccl`` when the process's context is a card, ``gloo`` on
the host (``initialize(backend=...)`` overrides the choice). A card
rank binds its device, ``gpu(rank % device_count)``, before it forms
the group. NCCL refuses two ranks of one communicator on one card;
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` and stages
them through the host itself.

One process (or no contract in the environment) is a no-op returning
False, as in the JAX package, unless a backend is asked for by name:
then a group of one is formed, which is how a single card runs the
collective path at world size 1. ``shutdown`` is idempotent and runs
at exit.
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as tdist

from .. import random as _random
from ..context import cpu, current_context, gpu

__all__ = ["initialize", "shutdown", "is_initialized", "rank",
           "num_processes", "barrier", "local_slice", "env_spec",
           "backend", "local_context"]

_state = {"initialized": False, "backend": None, "ctx": None}


def env_spec():
    """Read the DMLC_* contract: (coordinator, nproc, rank), None for
    anything unset."""
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    port = os.environ.get("DMLC_PS_ROOT_PORT")
    coord = "%s:%s" % (uri, port) if uri and port else None
    nproc = os.environ.get("DMLC_NUM_WORKER")
    rank_ = os.environ.get("DMLC_WORKER_ID")
    return (coord,
            int(nproc) if nproc is not None else None,
            int(rank_) if rank_ is not None else None)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_count=None, platform=None,
               backend=None):
    """Join (or skip) the multi-process group; True when a group was
    formed.

    Arguments default from the ``DMLC_*`` contract. ``platform``
    ("cpu"/"gpu") names the process's context, as the JAX package's
    pins its platform; the default is the current context. ``backend``
    ("nccl"/"gloo") defaults from that context; naming one forms a
    group even of one process. ``nccl`` without a card raises.
    ``local_device_count`` (the JAX package's virtual host devices)
    must be 1 or None: the port has one device per process."""
    if _state["initialized"]:
        return True
    if local_device_count is not None and int(local_device_count) != 1:
        raise ValueError(
            "local_device_count=%r: the port runs one device per process "
            "(the JAX package's virtual host devices have no torch "
            "counterpart); launch one process per device instead"
            % (local_device_count,))
    coord, nproc, rank_ = env_spec()
    coordinator_address = coordinator_address or coord
    num_processes = num_processes if num_processes is not None else nproc
    process_id = process_id if process_id is not None else rank_
    if platform is not None:
        ctx = {"cpu": cpu(), "gpu": gpu(), "cuda": gpu()}.get(
            str(platform).lower())
        if ctx is None:
            raise ValueError("platform must be 'cpu' or 'gpu', got %r"
                             % (platform,))
    else:
        ctx = current_context()
    if backend is None:
        if not num_processes or num_processes == 1:
            return False
        backend = "nccl" if ctx.device_type == "gpu" else "gloo"
    backend = str(backend).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    num_processes = int(num_processes or 1)
    if num_processes > 1 and (coordinator_address is None
                              or process_id is None):
        raise RuntimeError(
            "multi-process init needs a rendezvous address and a rank: set "
            "DMLC_PS_ROOT_URI/PORT + DMLC_WORKER_ID (parallel/launch.py "
            "-s 0 exports them) or pass them explicitly")
    process_id = int(process_id or 0)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='nccl' needs a CUDA device and none is present; "
                "the host takes backend='gloo'")
        ctx = gpu(process_id % torch.cuda.device_count())
        # Bind the rank's card before the communicator is formed.
        torch.cuda.set_device(ctx.torch_device)
    elif ctx.device_type == "gpu":
        ctx = gpu(process_id % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(ctx.torch_device)
    if coordinator_address is None:
        # A group of one needs no peer: any free port of this host.
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coordinator_address = "127.0.0.1:%d" % s.getsockname()[1]
        s.close()
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = ctx.torch_device
    tdist.init_process_group(
        backend, init_method="tcp://%s" % coordinator_address,
        world_size=num_processes, rank=process_id, **kwargs)
    _state.update(initialized=True, backend=backend, ctx=ctx)
    _random.set_rank(process_id)
    atexit.register(shutdown)
    return True


def shutdown():
    """Leave the process group (idempotent)."""
    if _state["initialized"]:
        _state.update(initialized=False, backend=None, ctx=None)
        _random.set_rank(0)
        if tdist.is_initialized():
            tdist.destroy_process_group()


def is_initialized():
    return _state["initialized"]


def backend():
    """The group's backend ("nccl"/"gloo"), None without a group."""
    return _state["backend"]


def local_context():
    """This rank's device as a Context (the current context without a
    group)."""
    return _state["ctx"] if _state["initialized"] else current_context()


def rank():
    """This process's index in the group (0 for single-process runs)."""
    return tdist.get_rank() if _state["initialized"] else 0


def num_processes():
    return tdist.get_world_size() if _state["initialized"] else 1


def barrier(name="mx_barrier"):
    """Block until every process reaches the same point (the ps-lite
    Barrier analogue). ``name`` is accepted for the JAX package's
    signature."""
    if not _state["initialized"]:
        return
    if _state["backend"] == "nccl":
        tdist.barrier(device_ids=[_state["ctx"].device_id])
    else:
        tdist.barrier()


def local_slice(n_rows):
    """The [start, stop) rows of a global batch this process feeds (the
    reference's num_parts/part_index partition)."""
    r, n = rank(), num_processes()
    if n_rows % n:
        raise ValueError("global batch %d not divisible by %d processes"
                         % (n_rows, n))
    per = n_rows // n
    return r * per, (r + 1) * per

