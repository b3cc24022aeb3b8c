"""Tensor parallelism: the port's TrainStep over ``tp`` meshes of ranks.

The port's ranks (4 for ``{"dp": 2, "tp": 2}``, 2 for ``{"dp": 1, "tp":
2}`` and ``{"dp": 2}``; gloo on the host, tests/torch_tp_prog.py) train
the ResNet basic block of tests/test_parallel.py's tp test and the
Dense-BN-Dense net from the same numpy weights and global batches as
the JAX package's TrainStep on its virtual CPU devices. The default rule
splits both convolutions, the block's dense weight and the first dense
weight of Dense-BN-Dense over ``tp``.

Tolerances: against the JAX package, tests/test_parallel.py's (losses
and full state rtol 2e-4, atol 1e-5); within the port, bit for bit
(``tp`` changes where a weight lives, not the arithmetic), except lbsgd,
whose norms sum their squares over ``tp``: its trust ratio moves by a
few units of the last place, so its first update is held within rtol
1e-6 and an atol of 1e-6 of each tensor's largest magnitude (an updated
weight near zero carries the ratio's rounding of the whole update;
later steps amplify the difference through BatchNorm); a checkpoint
restores bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.checkpoint import CheckpointManager as JCheckpointManager
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.parallel import Mesh, NamedSharding, P, shard_params

from torch_dist_prog import launch
from torch_tp_prog import (BATCH, JAX_STEPS, NETS, PROG, STEPS, VARIANTS,
                           dp_tp_rule)

torch.set_num_threads(2)

SHAPES = {"blk": ((4, 8, 8), 4), "dbd": ((4,), 2)}
JAX_TOL = {"rtol": 2e-4, "atol": 1e-5}


def _randomize(net, rng):
    for name, p in net.collect_params().items():
        if name.endswith("running_var") or name.endswith("gamma"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta", "bias")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))


def _jax_step(kind, weights, axes, variant="sgd", param_rule=None):
    jmx.random.seed(3)
    net = NETS[kind](jmx)
    net.initialize()
    for name, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[name]))
    family, opt, dtype = VARIANTS[variant]
    n = int(np.prod(list(axes.values())))
    return JTrainStep(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), family,
                      dict(opt), dtype=dtype, param_rule=param_rule,
                      mesh=jmake_mesh(axes, devices=jax.devices()[:n]))


def _jax_train(step, xs, ys):
    return np.array([float(jax.device_get(step(x, y)))
                     for x, y in zip(xs, ys)], np.float32)


def _host_state(step, tag):
    params, opt, aux = step.state_to_host()
    out = {}
    for n, v in params.items():
        out["%s:p:%s" % (tag, n)] = np.asarray(v)
        for i, s in enumerate(opt[n]):
            out["%s:s%d:%s" % (tag, i, n)] = np.asarray(s)
    for n, v in aux.items():
        out["%s:a:%s" % (tag, n)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then the tp4 and tp2 launches."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.RandomState(0)
    data = {"ckpt": str(d / "port_ckpt"), "jax_ckpt": str(d / "jax_ckpt")}
    weights = {}
    for kind, (shape, classes) in SHAPES.items():
        jmx.random.seed(1)
        net = NETS[kind](jmx)
        net.initialize()
        _randomize(net, rng)
        weights[kind] = {n: p.data().asnumpy()
                         for n, p in net.collect_params().items()}
        data.update({"%s:w:%s" % (kind, n): v
                     for n, v in weights[kind].items()})
        # Each quarter of a batch has its own mean, so statistics over a
        # rank's own rows would differ from the global batch's.
        shift = np.repeat(np.arange(4, dtype=np.float32), BATCH // 4)
        shift = shift.reshape((1, BATCH) + (1,) * len(shape))
        data[kind + ":x"] = (rng.rand(JAX_STEPS, BATCH, *shape)
                             .astype(np.float32) * 2 - 1 + shift)
        data[kind + ":y"] = rng.randint(0, classes, (JAX_STEPS, BATCH)) \
            .astype(np.float32)
    ref = {}
    for kind, rule in (("dbd", None), ("blk", None),
                       ("rule_blk", dp_tp_rule(JP))):
        net = kind.split("_")[-1]
        step = _jax_step(net, weights[net], {"dp": 2, "tp": 2},
                         param_rule=rule)
        ref[kind + ":loss"] = _jax_train(step, data[net + ":x"],
                                         data[net + ":y"])
        ref.update(_host_state(step, kind))
    # The JAX package's dp2 x tp4 save: one process, many chunks.
    xs, ys = data["blk:x"], data["blk:y"]
    step = _jax_step("blk", weights["blk"], {"dp": 2, "tp": 4})
    _jax_train(step, xs[:STEPS], ys[:STEPS])
    sd = step.state_dict(sharded=True)
    JCheckpointManager(data["jax_ckpt"]).save(STEPS, sd, sync=True)
    ref.update(_host_state(step, "jax_ckpt"))
    ref["jax_ckpt:next_loss"] = _jax_train(step, xs[STEPS:], ys[STEPS:])
    np.savez(d / "data.npz", **data)
    launch(4, 0, "tp4", d, data=d / "data.npz", prog=PROG)
    launch(2, 0, "tp2", d, data=d / "data.npz", prog=PROG)
    return {"tp4": [dict(np.load(d / ("tp4_r%d.npz" % r))) for r in range(4)],
            "tp2": [dict(np.load(d / ("tp2_r%d.npz" % r))) for r in range(2)],
            "ref": ref, "data": data, "weights": weights}


def _tagged(out, tag):
    pre = tag + ":"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _state(out, tag):
    return {k: v for k, v in _tagged(out, tag).items()
            if k.split(":")[0] in ("p", "a") or k.startswith("s")}


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="%s %s"
                                      % (what, k))


def _close(got, want, what, rtol, atol=0.0):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg="%s %s" % (what, k))


# -- placement by spec, against jax.device_put --------------------------------

@pytest.mark.parametrize("spec,shape", [
    (("tp", None), (8, 3)), ((None, "tp"), (3, 8)), ((("dp", "tp"),), (16,)),
    (("tp", "dp"), (4, 6)), ((), (5, 2)), ((("tp", "dp"), None), (8, 1))])
def test_bounds_and_primary_are_jaxs(spec, shape):
    jmesh = jmake_mesh({"dp": 2, "tp": 4})
    arr = jax.device_put(np.zeros(shape, np.float32),
                         JNamedSharding(jmesh, JP(*spec)))
    mesh = Mesh([None], ("dp", "tp"), (2, 4), ranks=range(8))
    s = NamedSharding(mesh, P(*spec))
    for sh in arr.addressable_shards:
        want = tuple((sl.start or 0, dim if sl.stop is None else sl.stop)
                     for sl, dim in zip(sh.index, shape))
        assert s.bounds(shape, rank=sh.device.id) == want
        assert s.holds_primary(rank=sh.device.id) == (sh.replica_id == 0)


def test_place_then_gather_is_the_full_value(runs):
    full = np.arange(48, dtype=np.float32).reshape(4, 12)
    for out in runs["tp4"]:
        for i in range(3):
            np.testing.assert_array_equal(out["place_gather:%d" % i], full)


def test_an_uneven_split_raises_as_device_put_does():
    jmesh = jmake_mesh({"dp": 2, "tp": 4})
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(np.zeros((6, 2)), JNamedSharding(jmesh, JP("tp")))
    mesh = Mesh([None], ("dp", "tp"), (2, 4), ranks=range(8))
    with pytest.raises(ValueError, match="divisible by 4"):
        NamedSharding(mesh, P("tp")).bounds((6, 2), rank=0)
    with pytest.raises(ValueError, match="lacks"):
        NamedSharding(mesh, P("sp")).bounds((8,), rank=0)


def test_an_inconsistent_mesh_raises_naming_its_sizes():
    with pytest.raises(ValueError, match=r"axis sizes multiply to 2"):
        Mesh([None], ("dp", "tp"), (1, 2)).validate()
    with pytest.raises(ValueError, match=r"multiply to 4"):
        NamedSharding(Mesh([None], ("dp", "tp"), (2, 2), ranks=range(2)),
                      P("tp")).bounds((4,), rank=0)
    assert Mesh([None], ("dp", "tp"), (1, 1)).local_slice(8) == (0, 8)
    mesh = Mesh([None], ("dp", "tp"), (2, 2), ranks=range(4))
    assert [mesh.coords(r) for r in (1, 2)] == [{"dp": 0, "tp": 1},
                                                {"dp": 1, "tp": 0}]


# -- the step against the JAX package's -------------------------------------

@pytest.mark.parametrize("kind", ["dbd", "blk", "rule_blk"])
def test_dp2tp2_matches_the_jax_dp2tp2_step(kind, runs):
    """The default rule, and (rule_blk) a rule that splits the weights
    over dp and tp together: their gradients are summed over dp in the
    gather's backward."""
    ref = runs["ref"]
    want = _tagged(ref, kind)
    want.pop("loss")
    tag = kind if kind.startswith("rule") else "jax_" + kind
    for out in runs["tp4"]:
        got = _tagged(out, tag)
        np.testing.assert_allclose(got.pop("loss"), ref[kind + ":loss"],
                                   **JAX_TOL)
        _close(got, want, kind, **JAX_TOL)
    # Every rank gathers the same full state.
    for out in runs["tp4"][1:]:
        _equal(_tagged(out, tag), _tagged(runs["tp4"][0], tag), kind)


@pytest.mark.parametrize("kind", ["dbd", "blk", "rule_blk"])
def test_each_rank_holds_its_block_of_split_state(kind, runs):
    net = kind.split("_")[-1]
    shapes = {n: v.shape for n, v in runs["weights"][net].items()
              if not n.endswith(("running_mean", "running_var"))}
    mesh = Mesh([None], ("dp", "tp"), (2, 2), ranks=range(4))
    specs = shard_params(mesh, shapes,
                         rule=dp_tp_rule(P) if net != kind else None)
    split = [n for n, s in specs.items() if s.axes]
    assert split, "the rule split nothing"
    want = sum(int(np.prod(shape)) // (2 ** len(specs[n].axes))
               for n, shape in shapes.items()) * 2   # weight + momentum
    full = sum(int(np.prod(shape)) for shape in shapes.values()) * 2
    for out in runs["tp4"]:
        assert tuple(out["held:" + kind]) == (want, full)


# -- within the port: bit for bit --------------------------------------------

def _hold_variant(got_out, got_tag, want_out, want_tag, variant):
    got, want = _tagged(got_out, got_tag), _tagged(want_out, want_tag)
    if variant == "lbsgd":
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=1e-6,
                atol=1e-6 * max(float(np.abs(w).max()), 1e-6), err_msg=k)
    else:
        _equal(got, want, variant)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tp2_is_the_single_device_step(variant, runs):
    for out in runs["tp2"]:
        _hold_variant(out, "tp2_" + variant, out, "single_" + variant,
                      variant)


def test_sync_to_net_writes_the_full_weights(runs):
    for out in runs["tp2"]:
        state = _tagged(out, "tp2_sgd")
        synced = _tagged(out, "sync")
        assert synced
        for n, v in synced.items():
            kind = "a:" if n.endswith(("running_mean", "running_var")) \
                else "p:"
            np.testing.assert_array_equal(v, state[kind + n], err_msg=n)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dp2tp2_is_the_dp2_step(variant, runs):
    want = runs["tp2"][0]
    for out in runs["tp4"]:
        _hold_variant(out, "bit_" + variant, want, "dp2_" + variant, variant)


def _hold_replicas(outs, tag, coords):
    """Each rank's own live state (tests/torch_tp_prog.py's
    ``live_arrays``): a replicated parameter, its optimizer state and
    the aux state equal on every rank, a split block equal on the ranks
    that share its ``tp`` index. `coords` gives each rank's tp index."""
    split = set(outs[0][tag + ":split"].tolist())
    assert split, "no parameter is split"
    lives = [{k: v for k, v in _state(o, tag).items() if ":" in k}
             for o in outs]
    for r, live in enumerate(lives):
        assert sorted(live) == sorted(lives[0])
        for k, v in live.items():
            same = [q for q in range(len(outs))
                    if k.split(":", 1)[1] not in split
                    or coords[q] == coords[r]]
            for q in same:
                np.testing.assert_array_equal(
                    v, lives[q][k], err_msg="rank %d vs %d: %s" % (r, q, k))
    for o in outs:
        np.testing.assert_array_equal(o[tag + ":loss"], outs[0][tag + ":loss"])


def test_replicas_stay_one_array_when_the_ranks_differ(runs):
    """The ranks at ``tp`` index 1 move their loss, gradients and
    BatchNorm statistics by 1e-3 before the step syncs them, as
    nondeterministic kernels move their last bits: every replica is
    still one array after the steps, on all four ranks."""
    _hold_replicas(runs["tp4"], "drift", [r % 2 for r in range(4)])


@pytest.mark.cuda
def test_replicas_stay_one_array_on_the_card_with_default_algorithms(
        tmp_path):
    """Two ranks on one card, cuDNN's default (not deterministic)
    algorithms: the replicated state is one array on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launch(2, 0, "card", tmp_path, prog=PROG)
    outs = [dict(np.load(tmp_path / ("card_r%d.npz" % r))) for r in range(2)]
    _hold_replicas(outs, "card", [0, 1])


# -- sharded checkpoints -----------------------------------------------------

def test_a_sharded_save_holds_each_block_once(runs):
    ckpt = runs["data"]["ckpt"]
    step_dir = os.path.join(ckpt, "step-%08d" % STEPS)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["process_count"] == 4
    mesh = Mesh([None], ("dp", "tp"), (2, 2), ranks=range(4))
    shapes = {n: v.shape for n, v in runs["weights"]["blk"].items()}
    specs = shard_params(mesh, {n: s for n, s in shapes.items()
                                if not n.endswith(("running_mean",
                                                   "running_var"))})
    seen = 0
    for key, entry in manifest["arrays"].items():
        section, name = (key.split("/") + [None])[:2]
        if section not in ("params", "opt", "aux"):
            continue
        seen += 1
        shape = shapes[name]
        assert tuple(entry["shape"]) == tuple(shape), key
        chunks = sorted(entry["chunks"], key=lambda c: c["shard"])
        if section != "aux" and specs[name].axes:
            # tp rank r of the dp-index-0 ranks (0 and 1) writes block r.
            assert [c["shard"] for c in chunks] == [0, 1], key
            for c in chunks:
                assert [tuple(i) for i in c["index"]] == list(
                    specs[name].bounds(shape, rank=c["shard"])), key
        else:
            assert [c["shard"] for c in chunks] == [0], key
            assert [tuple(i) for i in chunks[0]["index"]] == \
                [(0, d) for d in shape], key
    assert seen == len(shapes) + len(specs)   # params + momentum + aux


def _restored_state(state):
    out = {}
    for n, v in state["params"].items():
        out["p:" + n] = np.asarray(v)
    for n, st in state.get("opt", {}).items():
        for i, v in st.items():
            out["s%s:%s" % (i, n)] = np.asarray(v)
    for n, v in state.get("aux", {}).items():
        out["a:" + n] = np.asarray(v)
    return out


def test_the_stitched_restore_is_the_gathered_state(runs):
    step, state = CheckpointManager(runs["data"]["ckpt"]).restore()
    assert step == STEPS and state["num_update"] == STEPS
    gathered = _state(runs["tp4"][0], "ckpt")
    _equal(_restored_state(state), gathered, "stitched")
    # Restored on tp2 and on one device in the tp2 ranks: the same bits.
    for out in runs["tp2"]:
        _equal(_state(out, "restore_port"), gathered, "tp2 restore")
        _equal(_state(out, "restore_single"), gathered, "one-device restore")
        _equal(_state(out, "restore_params"), gathered, ".params restore")


def test_a_restore_takes_the_next_step(runs):
    # tp2 and one device take the same next step on the global batch;
    # dp2 x tp2 takes it with the statistics summed over dp.
    for out in runs["tp2"]:
        assert out["restore_port:next_loss"] == \
            out["restore_single:next_loss"]
    got = runs["tp2"][0]["restore_port:next_loss"]
    want = runs["tp4"][0]["ckpt:next_loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_the_port_save_restores_in_the_jax_package(runs):
    _, state = JCheckpointManager(runs["data"]["ckpt"]).restore()
    step = _jax_step("blk", runs["weights"]["blk"], {"dp": 2, "tp": 2})
    step.load_state_dict(state)
    assert step.num_update == STEPS
    xs, ys = runs["data"]["blk:x"], runs["data"]["blk:y"]
    got = _jax_train(step, xs[STEPS:], ys[STEPS:])
    np.testing.assert_allclose(got, runs["tp4"][0]["ckpt:next_loss"],
                               **JAX_TOL)


def test_the_jax_save_restores_in_the_port_tp2_step(runs):
    ref = runs["ref"]
    for out in runs["tp2"]:
        _equal(_state(out, "restore_jax"), _state(ref, "jax_ckpt"),
               "JAX dp2 x tp4 save on tp2")
        np.testing.assert_allclose(out["restore_jax:next_loss"],
                                   ref["jax_ckpt:next_loss"], **JAX_TOL)


@pytest.mark.cuda
def test_the_gather_on_cuda_over_a_gloo_group_of_one():
    """collectives.gather's all_gather and its backward on CUDA tensors
    through gloo (the backend the ranks sharing one card use)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel.launch import free_port

    tdist.init_process_group("gloo", init_method="tcp://localhost:%d"
                             % free_port(), world_size=1, rank=0)
    try:
        mesh = Mesh([None], ("dp", "tp"), (1, 1), ranks=[0])
        mesh._groups.update({None: tdist.group.WORLD,
                             "dp": tdist.group.WORLD,
                             "tp": tdist.group.WORLD})
        gen = torch.Generator(device="cuda").manual_seed(0)
        shards = [torch.randn(4, 3, device="cuda", generator=gen)
                  .requires_grad_(True) for _ in range(2)]
        specs = [NamedSharding(mesh, P("tp", None)),
                 NamedSharding(mesh, P(None, "dp"))]
        full = collectives.gather(shards, specs)
        heads = [torch.randn(4, 3, device="cuda", generator=gen)
                 for _ in range(2)]
        torch.autograd.backward(full, heads)
        for s, f, h in zip(shards, full, heads):
            assert f.device.type == "cuda" and torch.equal(f, s)
            assert torch.equal(s.grad, h)
    finally:
        tdist.destroy_process_group()
