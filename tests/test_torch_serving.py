"""mxnet_tpu_torch.serving — the port's InferenceServer on the host.

Mirrors tests/test_serving.py: coalescing, one signature per bucket,
unpadding, queue-full and deadline shedding; and holds served outputs
against the JAX package (a ResNet-18 thumbnail net with weights carried
over, and the flash-attention op). Every server runs on ``ctx=mx.cpu()``
and is shut down in a finally block.
"""
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops.pallas_attention import flash_attention as jax_flash
from mxnet_tpu.serving import BucketPolicy as JaxBucketPolicy

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import params_from_numpy
from mxnet_tpu_torch.serving import (BucketPolicy, DeadlineExceededError,
                                     InferenceServer, QueueFullError)

torch.set_num_threads(2)

_W = np.arange(12, dtype=np.float32).reshape(4, 3)


def _dot_fn(w, x):
    return mx.nd.dot(x, w)


def _server(**kw):
    kw.setdefault("item_shape", (4,))
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_delay_ms", 10)
    return InferenceServer(_dot_fn, [_W], ctx=mx.cpu(), **kw)


@pytest.mark.parametrize("max_batch,buckets", [
    (32, None), (12, None), (1, None), (32, (8, 1, 32)), (8, (3, 5))])
def test_bucket_policy_matches_reference(max_batch, buckets):
    mine = BucketPolicy(max_batch=max_batch, buckets=buckets)
    ref = JaxBucketPolicy(max_batch=max_batch, buckets=buckets)
    assert mine.buckets == ref.buckets and mine.max_batch == ref.max_batch
    for rows in range(1, mine.max_batch + 1):
        assert mine.bucket_for(rows) == ref.bucket_for(rows)
    with pytest.raises(ValueError):
        mine.bucket_for(mine.max_batch + 1)


@pytest.fixture(scope="module")
def resnet_pair():
    """A JAX thumbnail ResNet-18 and the port's copy of its weights."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    jnet = jvision.resnet18_v1(classes=8, thumbnail=True)
    jnet.initialize()
    with jmx.autograd.pause():
        jnet(jmx.nd.array(x))
    for name, p in jnet.collect_params().items():
        if name.endswith(("running_mean", "beta")):
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
    with jmx.autograd.pause():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        net = vision.resnet18_v1(classes=8, thumbnail=True)
        net.initialize()
        params_from_numpy(net, {n: p.data().asnumpy() for n, p in
                                jnet.collect_params().items()},
                          prefix=jnet.prefix)
    net.hybridize()
    return net, x, want


def test_resnet_served_matches_direct_forward_and_jax(resnet_pair):
    """Concurrent submits coalesce into bucket calls whose rows equal a
    direct forward (and the JAX net); warmup runs one signature per
    bucket and serving adds none."""
    net, x, want = resnet_pair
    srv = InferenceServer(lambda d: net(d), item_shape=(3, 32, 32),
                          buckets=(1, 2, 4), max_delay_ms=20, ctx=mx.cpu())
    try:
        assert srv.compile_count == 3
        srv.pause()
        reqs = [x[0:1], x[1:3], x[3:4]]
        with ThreadPoolExecutor(3) as pool:
            futs = list(pool.map(srv.submit, reqs))
        srv.resume()
        outs = [f.result(timeout=60).asnumpy() for f in futs]
        assert srv.compile_count == 3
    finally:
        srv.shutdown()
    got = np.concatenate(outs)
    with mx.cpu(), mx.autograd.pause():
        direct = net(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert srv.stats()["buckets"][4]["batches"] == 1


def test_served_flash_attention_matches_jax_op():
    """The attention function of the port's serving path: fp32 requests
    packing (q, k, v), served through `nd.contrib.flash_attention`."""
    def attn(x):
        return mx.nd.contrib.flash_attention(x[:, 0], x[:, 1], x[:, 2],
                                             causal=True, block_q=16,
                                             block_k=16)

    rng = np.random.RandomState(2)
    reqs = [rng.randn(r, 3, 2, 32, 8).astype(np.float32) for r in (1, 2)]
    srv = InferenceServer(attn, item_shape=(3, 2, 32, 8), buckets=(1, 2, 4),
                          max_delay_ms=20, ctx=mx.cpu())
    try:
        srv.pause()
        futs = [srv.submit(r) for r in reqs]
        srv.resume()
        outs = [f.result(timeout=60).asnumpy() for f in futs]
    finally:
        srv.shutdown()
    for r, out in zip(reqs, outs):
        want = jax_flash(jnp.asarray(r[:, 0]), jnp.asarray(r[:, 1]),
                         jnp.asarray(r[:, 2]), causal=True, block_q=16,
                         block_k=16)
        np.testing.assert_allclose(out, np.asarray(want), rtol=2e-4,
                                   atol=2e-5)


def test_one_signature_per_bucket_and_warmup_idempotent():
    srv = _server(warmup=True, start=False)
    try:
        assert srv.compile_count == len(srv.policy.buckets)  # 1,2,4,8
        srv.warmup()
        assert srv.compile_count == len(srv.policy.buckets)
        srv.start()
        srv.pause()
        futs = [srv.submit(np.ones((1, 4), np.float32)) for _ in range(9)]
        srv.resume()
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=30).asnumpy(),
                                       np.ones((1, 4)) @ _W, rtol=1e-6)
        assert srv.compile_count == len(srv.policy.buckets)
        assert srv.metrics.total_batches <= 2
    finally:
        srv.shutdown()


def test_unpadding_slices_multi_row_requests():
    srv = _server(warmup=True)
    try:
        srv.pause()
        xa = np.random.rand(3, 4).astype(np.float32)
        xb = np.random.rand(2, 4).astype(np.float32)
        fa, fb = srv.submit(xa), srv.submit(xb)
        srv.resume()
        ya, yb = fa.result(timeout=30), fb.result(timeout=30)
        assert ya.shape == (3, 3) and yb.shape == (2, 3)
        np.testing.assert_allclose(ya.asnumpy(), xa @ _W, rtol=1e-5)
        np.testing.assert_allclose(yb.asnumpy(), xb @ _W, rtol=1e-5)
        assert srv.stats()["buckets"][8]["batches"] == 1
    finally:
        srv.shutdown()


def test_request_shape_validation():
    srv = _server(warmup=False, start=False)
    try:
        with pytest.raises(ValueError):
            srv.submit(np.ones((1, 5), np.float32))
        with pytest.raises(ValueError):
            srv.submit(np.ones((9, 4), np.float32))
    finally:
        srv.shutdown()


def test_queue_full_sheds_while_admitted_complete():
    srv = _server(warmup=True, max_queue=4)
    try:
        srv.pause()
        futs = [srv.submit(np.ones((1, 4), np.float32)) for _ in range(4)]
        with pytest.raises(QueueFullError):
            srv.submit(np.ones((1, 4), np.float32))
        srv.resume()
        for f in futs:
            assert f.result(timeout=30).shape == (1, 3)
        assert srv.metrics.total_shed == 1
        assert srv.stats()["shed"]["queue_full"] == 1
    finally:
        srv.shutdown()


def test_deadline_shedding_and_worker_survives():
    srv = _server(warmup=True)
    try:
        srv.pause()
        doomed = srv.submit(np.ones((1, 4), np.float32), timeout_ms=5)
        live = srv.submit(np.ones((1, 4), np.float32))
        time.sleep(0.05)
        srv.resume()
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=30)
        assert live.result(timeout=30).shape == (1, 3)
        assert srv.stats()["shed"]["deadline"] == 1
        assert srv.predict(np.ones((1, 4), np.float32)).shape == (1, 3)
        assert srv._batcher._thread.is_alive()
    finally:
        srv.shutdown()


def test_short_deadline_served_when_device_idle():
    srv = _server(warmup=True, max_delay_ms=300)
    try:
        out = srv.predict(np.ones((1, 4), np.float32), timeout_ms=60)
        assert out.shape == (1, 3)
        assert srv.stats()["shed"] == {}
    finally:
        srv.shutdown()


def test_submit_snapshots_caller_buffer():
    srv = _server(warmup=True)
    try:
        srv.pause()
        buf = np.ones((1, 4), np.float32)
        f1 = srv.submit(buf)
        buf[:] = 5.0
        f2 = srv.submit(buf)
        srv.resume()
        np.testing.assert_allclose(f1.result(timeout=30).asnumpy(),
                                   np.ones((1, 4)) @ _W, rtol=1e-5)
        np.testing.assert_allclose(f2.result(timeout=30).asnumpy(),
                                   np.full((1, 4), 5.0) @ _W, rtol=1e-5)
    finally:
        srv.shutdown()


def test_shutdown_without_drain_fails_queued():
    srv = _server(warmup=False)
    srv.pause()
    fut = srv.submit(np.ones((1, 4), np.float32))
    srv.shutdown(drain=False)
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)
    with pytest.raises(RuntimeError):
        srv.submit(np.ones((1, 4), np.float32))
