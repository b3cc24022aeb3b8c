"""Host probes behind two findings of the port's parity work (not a test;
run from the repository root)::

    JAX_PLATFORMS=cpu python tests/torch_parity_probes.py rmsprop_seed
    JAX_PLATFORMS=cpu python tests/torch_parity_probes.py fd_noise

``rmsprop_seed``: tests/test_torch_train_step.py's centered-RMSProp case
at ``MXNET_TEST_SEED=1992408341``, taken apart. It prints the step-1
gradients of both packages from the same weights (largest relative
difference per parameter), the optimizer states after steps 1, 2 and 3
(largest relative difference per state of BatchNorm's gamma), then the
update op alone on equal random inputs: how many elements of n the
jitted JAX op gives as one fused multiply-add (rounded once) and as two
roundings, and how many float32 ``sqrt`` and ``x / sqrt(y)`` results of
XLA on the CPU differ from torch's correctly rounded ones.

``fd_noise``: ``check_numeric_gradient``'s central differences of
``sum(flash_attention(q, k, v))`` at (1, 1, 16, 64) with the plain fp32
version on the host, against the float64 gradient, at steps of 1e-3 and
1e-2 (the largest error and the worst excess over atol 1e-3 + rtol 1e-2).
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SEED = 1992408341


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def rmsprop_seed():
    import jax
    import jax.numpy as jnp
    import torch

    np.random.seed(SEED)
    import mxnet_tpu as jmx

    jmx.random.seed(SEED)
    import mxnet_tpu_torch as mx
    import test_torch_train_step as T
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    torch.set_num_threads(2)
    jnet, net = T._pair(T._dense_bn_dense_nobias, (8, 4), 0)
    batches = T._batches(np.random.RandomState(1), 3, (8, 4), 2)
    x, y = batches[0]
    with jmx.autograd.record():
        jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jmx.nd.array(x)), jmx.nd.array(y)).backward()
    with mx.cpu(), mx.autograd.record():
        mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x)), mx.nd.array(y)).backward()
    jg = T._by_relative({n: p.grad().asnumpy() for n, p in
                         jnet.collect_params().items()
                         if p.grad_req != "null"}, jnet.prefix)
    tg = T._by_relative({n: p.grad().asnumpy() for n, p in
                         net.collect_params().items()
                         if p.grad_req != "null"}, net.prefix)
    for name in sorted(jg):
        print("step-1 gradient %-20s max relative difference %.3g"
              % (name, _rel(tg[name], jg[name])))
    opt = T.FAMILIES["rmsprop_centered"][1]
    for k in (1, 2, 3):
        np.random.seed(SEED)
        jmx.random.seed(SEED)
        jnet, net = T._pair(T._dense_bn_dense_nobias, (8, 4), 0)
        jstep, tstep, _, _ = T._steps(jnet, net, batches[:k], "rmsprop",
                                      opt)
        want = T._by_relative({n: [np.asarray(v) for v in s] for n, s in
                               jstep.state_to_host()[1].items()},
                              jnet.prefix)
        got = T._by_relative(tstep.state_to_host()[1], net.prefix)
        name = [n for n in want if "gamma" in n][0]
        print("after step %d, %s: n %.3g, g %.3g, delta %.3g" % (
            k, name, *[_rel(got[name][i], want[name][i])
                       for i in range(3)]))
    jf = jax.jit(lambda *a: jreg.get("rmspropalex_update").fn(
        *a, lr=0.01, gamma1=0.9, gamma2=0.9, epsilon=1e-8, wd=0.0,
        rescale_grad=1.0, clip_gradient=-1.0))
    rng = np.random.RandomState(0)
    f32 = np.float32
    two = fused = apart = total = 0
    for _ in range(50):
        scale = 10.0 ** rng.uniform(-4, 0)
        w = rng.randn(256).astype(f32)
        g = (rng.randn(256) * scale).astype(f32)
        gb = (rng.randn(256) * scale * 0.3).astype(f32)
        n = (gb.astype(np.float64) ** 2 * 2 + 1e-9).astype(f32)
        d = (rng.randn(256) * 1e-3).astype(f32)
        jn = np.asarray(jf(*map(jnp.asarray, (w, g, n, gb, d)))[1])
        tn = treg.get("rmspropalex_update").fn(
            *(torch.from_numpy(a.copy()) for a in (w, g, n, gb, d)),
            lr=0.01, gamma1=0.9, gamma2=0.9, epsilon=1e-8)[1].numpy()
        sq = ((f32(0.1) * g).astype(f32) * g).astype(f32)
        fused += int((jn == (np.float64(f32(0.9)) * n + sq).astype(f32))
                     .sum())
        two += int((tn == (f32(0.9) * n + sq).astype(f32)).sum())
        apart += int((jn != tn).sum())
        total += jn.size
    print("rmspropalex n over %d elements: the jitted JAX op is one "
          "rounding (a fused multiply-add) at %d, the port's op two "
          "roundings at %d; they differ at %d" % (total, fused, two, apart))
    x = (10.0 ** rng.uniform(-12, 2, 100000)).astype(f32)
    b = rng.randn(100000).astype(f32)
    js = np.asarray(jax.jit(jnp.sqrt)(x))
    jd = np.asarray(jax.jit(lambda a, c: c / jnp.sqrt(a))(x, b))
    ts = torch.sqrt(torch.from_numpy(x)).numpy()
    td = (torch.from_numpy(b) / torch.sqrt(torch.from_numpy(x))).numpy()
    print("XLA CPU float32 sqrt: %d of 100000 differ from torch's; "
          "x / sqrt(y): %d" % (int((js != ts).sum()), int((jd != td).sum())))


def fd_noise():
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    torch.set_num_threads(2)
    rng = np.random.default_rng(29)
    shape = (1, 1, 16, 64)
    qkv = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(3)]
    t = [torch.from_numpy(a).double().requires_grad_() for a in qkv]
    out = torch.softmax(t[0] @ t[1].transpose(-1, -2) / 8.0, -1) @ t[2]
    out.sum().backward()
    exact = [a.grad.numpy() for a in t]
    print("sum of the output: %.4f" % float(out.sum()))
    for eps in (1e-3, 1e-2):
        err, excess = 0.0, -np.inf
        for i, x in enumerate(qkv):
            for idx in np.ndindex(x.shape):
                vals = []
                for sign in (1, -1):
                    args = [a.copy() for a in qkv]
                    args[i][idx] += sign * eps
                    vals.append(float(fa.flash_attention_reference(
                        *map(torch.from_numpy, args))[0].sum()))
                num = (vals[0] - vals[1]) / (2 * eps)
                g = exact[i][idx]
                err = max(err, abs(num - g))
                excess = max(excess, abs(num - g) - (1e-3 + 1e-2 * abs(g)))
        print("step %g: largest error %.3g, worst excess over the "
              "tolerance %.3g" % (eps, err, excess))


if __name__ == "__main__":
    {"rmsprop_seed": rmsprop_seed, "fd_noise": fd_noise}[sys.argv[1]]()
