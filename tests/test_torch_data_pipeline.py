"""``mxnet_tpu_torch.data`` against the JAX package's ``mxnet_tpu.data``,
on records made from a seed with numpy.

- ``epoch_order``/``shard_indices``/``shard_slice`` equal exactly for
  several ``(seed, epoch, shards)`` (both draw the Philox SeedSequence).
- ``RecordDataset``/``ShardedRecordStream`` read the same records in the
  same order; their checkpoints round-trip.
- ``DataPipeline`` batches equal the JAX package's exactly (rtol 0) with
  deterministic augmenters, at 1 and 3 decode threads; a ``state_dict``
  resume replays the remaining order.
- ``DecodePool``, ``DevicePrefetcher`` and ``PrefetchingIter`` relay
  worker errors to the consumer; ``DecodeAutoscaler`` and
  ``stall_fraction`` decide as the JAX package's do.
- ``place=True`` on the default (CUDA) context raises without a card;
  on the card (``cuda``-marked) a batch delivered through pinned staging
  and a side stream equals the host pass and is ordered after its copy.
- ``train_imagenet --data-train`` trains from a ``.rec`` on the host.
"""
import random
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import data as jdata

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import data
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.data import prefetch as port_prefetch

CPU = mx.cpu()


@pytest.mark.parametrize("n,shards", [(10, 1), (10, 3), (7, 8), (33, 4)])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 3), (12345, 1)])
def test_sharding_equals_jax(n, shards, seed, epoch):
    np.testing.assert_array_equal(
        data.epoch_order(n, epoch=epoch, seed=seed),
        jdata.epoch_order(n, epoch=epoch, seed=seed))
    for k in range(shards):
        np.testing.assert_array_equal(
            data.shard_indices(n, shards, k, epoch=epoch, seed=seed),
            jdata.shard_indices(n, shards, k, epoch=epoch, seed=seed))
    assert data.num_padded(n, shards) == jdata.num_padded(n, shards)
    seq = list(range(n))
    assert data.shard_slice(seq, shards, shards - 1) == \
        jdata.shard_slice(seq, shards, shards - 1)


def _write_rec(path, name="a", n=12, seed=0, side=(18, 22)):
    rng = np.random.RandomState(seed)
    rec, idx = str(path / (name + ".rec")), str(path / (name + ".idx"))
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, side + (3,), np.uint8)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(rng.randint(0, 10)), i, 0), img,
            img_fmt=".png"))
    w.close()
    return rec, idx


def test_record_dataset_and_stream_equal_jax(tmp_path):
    recs = [_write_rec(tmp_path, "a", n=5)[0],
            _write_rec(tmp_path, "b", n=7, seed=1)[0]]
    ds, jds = data.RecordDataset(recs), jdata.RecordDataset(recs)
    assert len(ds) == len(jds) == 12
    assert ds.fingerprint() == jds.fingerprint()
    assert [ds.read(i) for i in range(12)] == [jds.read(i) for i in range(12)]
    s = data.ShardedRecordStream(ds, num_shards=2, shard_index=1, seed=3)
    js = jdata.ShardedRecordStream(jds, num_shards=2, shard_index=1, seed=3)
    assert [s.next_raw() for _ in range(9)] == [js.next_raw() for _ in range(9)]
    state = s.state_dict()
    assert state == js.state_dict()
    s2 = data.ShardedRecordStream(ds, num_shards=2, shard_index=1, seed=3)
    s2.load_state_dict(state)
    assert [s2.next_raw() for _ in range(4)] == [s.next_raw() for _ in range(4)]
    with pytest.raises(ValueError, match="seed"):
        data.ShardedRecordStream(ds, num_shards=2, shard_index=1,
                                 seed=4).load_state_dict(state)


def _decoders(shape=(3, 16, 16)):
    kw = dict(mean=np.array([120.0, 110.0, 100.0]),
              std=np.array([60.0, 58.0, 57.0]))
    return (data.ImageRecordDecoder(shape, **kw),
            jdata.ImageRecordDecoder(shape, **kw))


def _host_batches(pipe, n):
    return [(b.data[0], b.label[0], b.pad, list(b.index)) for b in
            (next(pipe) for _ in range(n))]


@pytest.mark.parametrize("threads", [1, 3])
def test_pipeline_batches_equal_jax(tmp_path, threads):
    rec, _ = _write_rec(tmp_path, n=11)
    dec, jdec = _decoders()
    kw = dict(batch_size=4, shuffle=True, seed=5, num_shards=1,
              shard_index=0, decode_threads=threads, prefetch=2, place=False)
    with data.DataPipeline(rec, dec, **kw) as p, \
            jdata.DataPipeline(rec, jdec, **kw) as jp:
        got, want = _host_batches(p, 7), _host_batches(jp, 7)
        assert p.state_dict() == jp.state_dict()
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        assert gp == wp and gi == wi
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    assert [g[2] for g in got[:3]] == [0, 0, 1]


def test_pipeline_host_placement_gives_host_ndarrays(tmp_path):
    rec, _ = _write_rec(tmp_path, n=6)
    dec, _ = _decoders()
    kw = dict(batch_size=3, seed=1, decode_threads=2)
    with data.DataPipeline(rec, dec, place=False, **kw) as p, \
            data.DataPipeline(rec, dec, place=True, ctx=CPU, **kw) as q:
        for _ in range(3):
            a, b = next(p), next(q)
            assert isinstance(b.data[0], mx.nd.NDArray)
            assert b.data[0].context == CPU
            np.testing.assert_array_equal(b.data[0].asnumpy(), a.data[0])


def test_pipeline_resume_replays_remaining_order(tmp_path):
    rec, _ = _write_rec(tmp_path, n=10)
    dec, _ = _decoders()
    kw = dict(batch_size=3, seed=9, decode_threads=2, place=False)
    with data.DataPipeline(rec, dec, **kw) as p:
        whole = [list(next(p).index) for _ in range(8)]
    with data.DataPipeline(rec, dec, **kw) as p:
        for _ in range(3):
            next(p)
        state = p.state_dict()
    with data.DataPipeline(rec, dec, **kw) as q:
        q.load_state_dict(state)
        assert [list(next(q).index) for _ in range(5)] == whole[3:]
    with data.DataPipeline(rec, dec, **dict(kw, batch_size=2)) as bad:
        with pytest.raises(ValueError, match="batch_size"):
            bad.load_state_dict(state)


def test_pipeline_seeded_random_augs_equal_jax_single_threaded(tmp_path):
    rec, _ = _write_rec(tmp_path, n=6, side=(24, 28))
    kw = dict(rand_crop=True, rand_mirror=True)
    dec = data.ImageRecordDecoder((3, 16, 16), seed=21, **kw)
    jdec = jdata.ImageRecordDecoder((3, 16, 16), **kw)
    pkw = dict(batch_size=3, seed=2, num_shards=1, shard_index=0,
               decode_threads=1, prefetch=0, place=False)
    with data.DataPipeline(rec, dec, **pkw) as p:
        got = _host_batches(p, 4)
    random.seed(21)
    with jdata.DataPipeline(rec, jdec, **pkw) as jp:
        want = _host_batches(jp, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])


def test_place_on_the_default_context_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rec, _ = _write_rec(tmp_path, n=4)
    dec, _ = _decoders()
    with pytest.raises(RuntimeError, match="CUDA"):
        data.DataPipeline(rec, dec, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.DevicePrefetcher(iter([]), ctx=mx.gpu(0))


@pytest.mark.parametrize("ordered", [True, False])
def test_decode_pool_equals_jax_and_relays_errors(ordered):
    def fn(i):
        time.sleep(0.002 * (i % 3))
        if i == 13:
            raise KeyError("sample %d" % i)
        return i * i

    with data.DecodePool(fn, num_threads=3, ordered=ordered) as pool, \
            jdata.DecodePool(fn, num_threads=3, ordered=ordered) as jpool:
        got = list(pool.run(range(12)))
        want = list(jpool.run(range(12)))
        assert (got == want) if ordered else (sorted(got) == sorted(want))
        with pytest.raises(KeyError, match="sample 13"):
            list(pool.run(range(20)))
        assert pool.resize(5) == 5 and pool.inflight == 10


def test_device_prefetcher_order_error_and_close():
    def source():
        yield from range(5)
        raise OSError("storage went away")

    p = data.DevicePrefetcher(source(), depth=2, place=lambda b: b * 10)
    assert [next(p) for _ in range(5)] == [0, 10, 20, 30, 40]
    with pytest.raises(OSError, match="storage"):
        next(p)
    with pytest.raises(OSError):          # stays broken, never hangs
        next(p)
    p.close()
    p.close()
    assert not p._thread.is_alive()
    q = data.DevicePrefetcher(iter(range(100)), depth=1)
    assert next(q) == 0
    q.close(timeout=2.0)
    assert not q._thread.is_alive()
    with pytest.raises(StopIteration):
        next(q)


def test_pipeline_decode_error_surfaces(tmp_path):
    rec, _ = _write_rec(tmp_path, n=6)

    def bad(record):
        raise ValueError("corrupt record")

    with data.DataPipeline(rec, bad, batch_size=2, decode_threads=2,
                           place=False) as p:
        with pytest.raises(ValueError, match="corrupt"):
            next(p)


def test_autoscaler_decides_as_jax():
    class Pool:
        def __init__(self):
            self.num_threads = 2

        def resize(self, n):
            self.num_threads = n
            return n

    shares = [(3.0, 1.0), (3.0, 1.0), (0.1, 10.0), (0.5, 5.0), (0.0, 9.0),
              (0.0, 9.0), (0.0, 9.0), (5.0, 1.0)]
    a = data.DecodeAutoscaler(Pool(), min_workers=1, max_workers=4)
    ja = jdata.DecodeAutoscaler(Pool(), min_workers=1, max_workers=4)
    assert [a.observe(*s) for s in shares] == [ja.observe(*s) for s in shares]
    assert a.decisions == ja.decisions


def test_stall_fraction_equals_jax():
    events = [{"ph": "X", "name": "data::wait", "dur": 30.0},
              {"ph": "X", "name": "train_step::step", "dur": 70.0},
              {"ph": "X", "name": "train_step::data_put", "dur": 5.0},
              {"ph": "X", "name": "data::decode", "dur": 99.0},
              {"ph": "i", "name": "data::wait", "dur": 1e9}]
    assert data.stall_fraction(events) == jdata.stall_fraction(events) == 0.35
    assert data.stall_fraction([]) == 0.0


def test_train_step_records_the_spans_stall_fraction_reads():
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh
    from mxnet_tpu_torch.telemetry import trace

    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    step = TrainStep(net, gluon.loss.L2Loss(), "sgd",
                     {"learning_rate": 0.1},
                     mesh=make_mesh({"dp": 1}, devices=[CPU]))
    trace.clear()
    x = np.ones((2, 4), np.float32)
    p = data.DevicePrefetcher(iter([(x, x[:, :3])] * 3), depth=2)
    for xb, yb in p:
        step(xb, yb)
    p.close()
    names = {e["name"] for e in trace.chrome_trace()["traceEvents"]}
    assert {"data::wait", "train_step::step",
            "train_step::data_put"} <= names
    assert 0.0 <= data.stall_fraction() <= 1.0


def test_train_imagenet_from_a_rec_on_the_host(tmp_path):
    from mxnet_tpu_torch.examples import train_imagenet

    rec, _ = _write_rec(tmp_path, n=8, side=(36, 36))
    loss = train_imagenet.main([
        "--data-train", rec, "--device", "cpu", "--network", "resnet18",
        "--num-classes", "10", "--image-shape", "3,32,32", "--batch-size",
        "4", "--max-batches", "2"])
    assert np.isfinite(loss)
    with pytest.raises(SystemExit, match="data-train"):
        train_imagenet.main(["--device", "cpu"])


@pytest.mark.cuda
def test_pinned_stager_delivers_after_its_copy_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    host = [{"data": rng.rand(16, 3, 64, 64).astype(np.float32),
             "label": rng.rand(16).astype(np.float32), "ids": np.arange(16)}
            for _ in range(6)]
    stager = port_prefetch.PinnedStager(mx.gpu(0), slots=2)
    placed = [stager(b) for b in host]   # reuses both slots three times
    for want, item in zip(host, placed):
        got = port_prefetch.deliver(item)
        assert got["data"].is_cuda and got["ids"] is want["ids"]
        # Ordered after the copy on the consumer's stream.
        np.testing.assert_array_equal((got["data"] + 0).cpu().numpy(),
                                      want["data"])
        np.testing.assert_array_equal(got["label"].cpu().numpy(),
                                      want["label"])


@pytest.mark.cuda
def test_pipeline_on_the_card_equals_the_host_pass(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec, _ = _write_rec(tmp_path, n=20)
    dec, _ = _decoders()
    kw = dict(batch_size=4, seed=3, decode_threads=3, prefetch=2)
    with data.DataPipeline(rec, dec, place=False, **kw) as p, \
            data.DataPipeline(rec, dec, place=True, ctx=mx.gpu(0), **kw) as q:
        for _ in range(8):
            a, b = next(p), next(q)
            assert b.data[0].context == mx.gpu(0)
            np.testing.assert_array_equal(b.data[0].asnumpy(), a.data[0])


def test_threads_are_joined():
    before = threading.active_count()
    with data.DecodePool(lambda i: i, num_threads=2) as pool:
        assert list(pool.run(range(4))) == [0, 1, 2, 3]
    p = data.DevicePrefetcher(iter(range(3)))
    list(p)
    p.close()
    assert threading.active_count() <= before
