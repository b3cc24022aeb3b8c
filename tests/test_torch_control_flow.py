"""Control flow and the one graph interpreter of mxnet_tpu_torch against
the JAX package.

Every case of tests/test_contrib_control_flow.py has a counterpart here,
run through both packages on the same numpy inputs: ``nd.contrib``
foreach/while_loop/cond called imperatively, inside a hybridized block
(where the JAX package traces and ``while_loop`` pads its outputs to
``max_iterations`` rows) and under ``autograd.record()`` with gradients;
``sym.contrib`` graphs bound through the Executor, forward and backward.
Then what the port's design promises: a sub-graph is compiled into the
Executor's plan once per training mode, whatever the number of
iterations and consumed outputs; ``tojson()`` writes the sub-graphs as
opaque strings (no JSON round trip, as in the JAX package); and
``SymbolBlock`` runs the Executor's plan under ``record()``, with
BatchNorm's moving statistics reaching its parameters. fp32 throughout:
values within rtol 1e-5 / atol 1e-6 of the JAX package's, gradients
within rtol 1e-5 / atol 1e-5 (sums in another order).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor as _executor
from mxnet_tpu_torch.ops import control_flow as cf

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5
PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


def _both(fn):
    """fn(pkg) for the JAX package and the port: (jax result, port's)."""
    return fn(jmx), fn(mx)


# -- nd.contrib, imperative ---------------------------------------------------

def test_foreach_cumsum():
    def run(pkg):
        data = pkg.nd.array(np.arange(12).reshape(4, 3).astype(np.float32))

        def body(x, s):
            new_s = s + x
            return new_s * 1.0, new_s

        outs, final = pkg.nd.contrib.foreach(body, data, pkg.nd.zeros((3,)))
        return outs.asnumpy(), final.asnumpy()

    (jo, jf), (po, pf) = _both(run)
    _close(po, jo)
    _close(pf, jf)
    _close(po, np.cumsum(np.arange(12).reshape(4, 3), axis=0))


def test_foreach_multi_data_multi_state():
    an = np.arange(6).reshape(3, 2).astype(np.float32)

    def run(pkg):
        a, b = pkg.nd.array(an), pkg.nd.array(np.ones((3, 2), np.float32))

        def body(xs, states):
            xa, xb = xs
            t1, t2 = states
            return [xa + xb + t1, xa * t2], [t1 + xa, t2 * 2]

        outs, finals = pkg.nd.contrib.foreach(
            body, [a, b], [pkg.nd.zeros((2,)), pkg.nd.ones((2,))])
        return [o.asnumpy() for o in outs + finals]

    jax_res, port_res = _both(run)
    assert len(port_res) == 4
    for p, j in zip(port_res, jax_res):
        _close(p, j)


def _foreach_grad(pkg, data_np, w_np, unrolled):
    data, w = pkg.nd.array(data_np), pkg.nd.array(w_np)
    w.attach_grad()
    with pkg.autograd.record():
        if unrolled:
            s, outs = pkg.nd.zeros((1,)), []
            for t in range(data_np.shape[0]):
                o = data[t] * w
                s = s + o.sum()
                outs.append(o)
            outs = pkg.nd.stack(*outs, axis=0)
        else:
            outs, s = pkg.nd.contrib.foreach(
                lambda x, s: (x * w, s + (x * w).sum()), data,
                pkg.nd.zeros((1,)))
        loss = (outs * outs).sum() + s.sum()
    loss.backward()
    return w.grad.asnumpy()


def test_foreach_gradient_matches_unrolled_and_jax():
    rng = np.random.RandomState(0)
    data_np = rng.rand(5, 4).astype(np.float32)
    w_np = rng.rand(4).astype(np.float32)
    port = _foreach_grad(mx, data_np, w_np, unrolled=False)
    _close(port, _foreach_grad(mx, data_np, w_np, unrolled=True))
    _close(port, _foreach_grad(jmx, data_np, w_np, unrolled=False),
           atol=GRAD_ATOL)


def test_while_loop_imperative_exact_length():
    def run(pkg):
        outs, finals = pkg.nd.contrib.while_loop(
            lambda i, s: i < 5, lambda i, s: (i * 2.0, [i + 1, s + i]),
            [pkg.nd.array([0.0]), pkg.nd.array([0.0])], max_iterations=10)
        return outs.asnumpy(), [f.asnumpy() for f in finals]

    (jo, jf), (po, pf) = _both(run)
    assert po.shape == jo.shape == (5, 1)
    _close(po.reshape(-1), [0, 2, 4, 6, 8])
    for p, j in zip(pf, jf):
        _close(p, j)


def test_while_loop_counts_its_predicate_reads():
    before = cf.PREDICATE_READS[0]
    mx.nd.contrib.while_loop(lambda i: i < 3, lambda i: (i, [i + 1]),
                             [mx.nd.array([0.0])], max_iterations=10)
    assert cf.PREDICATE_READS[0] - before == 4   # 3 true, 1 false


def test_cond_imperative():
    def run(pkg, xv, yv):
        x, y = pkg.nd.array([xv]), pkg.nd.array([yv])
        return pkg.nd.contrib.cond(lambda: x.sum() < y.sum(),
                                   lambda: x * 2, lambda: y * 2).asnumpy()

    for xv, yv, want in ((2.0, 3.0, 4.0), (5.0, 3.0, 6.0)):
        _close(run(mx, xv, yv), run(jmx, xv, yv))
        _close(run(mx, xv, yv), [want])


def test_cond_records_gradient():
    def run(pkg, xv):
        x = pkg.nd.array([xv])
        x.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.contrib.cond(lambda: x.sum() > 0,
                                      lambda: x * x, lambda: x * 4)
        out.backward()
        return x.grad.asnumpy()

    for xv in (2.0, -1.5):
        _close(run(mx, xv), run(jmx, xv))


def test_foreach_empty_data():
    outs, final = mx.nd.contrib.foreach(lambda x, s: (x + s, s + 1),
                                        mx.nd.zeros((0, 3)),
                                        mx.nd.zeros((3,)))
    assert outs == []
    _close(final.asnumpy(), np.zeros(3))


# -- nd.contrib inside a hybridized block ------------------------------------

def _hybrid(pkg, fn):
    class Net(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, *xs):
            return fn(pkg, *xs)

    net = Net()
    net.hybridize()
    return net


def test_foreach_in_hybrid_block():
    def body(pkg, x):
        outs, _ = pkg.nd.contrib.foreach(
            lambda xt, s: (s + xt, s + xt), x, pkg.nd.zeros((2,)))
        return outs

    x = np.ones((4, 2), np.float32)
    port = _hybrid(mx, body)(mx.nd.array(x)).asnumpy()
    _close(port, _hybrid(jmx, body)(jmx.nd.array(x)).asnumpy())
    _close(port, np.cumsum(np.ones((4, 2)), axis=0))


def _padded_while(pkg, i0):
    outs, finals = pkg.nd.contrib.while_loop(
        lambda i: i < 5, lambda i: (i * 2.0, [i + 1]), [i0],
        max_iterations=8)
    return outs, finals


def test_while_loop_traced_padded():
    """Inside a hybridized call the outputs are padded to max_iterations
    rows with zeros, as the JAX package's traced while_loop gives them;
    called imperatively the same loop stacks 5 rows."""
    def loop(p, i0):
        outs, finals = _padded_while(p, i0)
        return outs, finals[0]

    def run(pkg):
        net = _hybrid(pkg, loop)
        return [o.asnumpy() for o in net(pkg.nd.array([0.0]))]

    (jo, jf), (po, pf) = _both(run)
    assert po.shape == jo.shape == (8, 1)
    _close(po.reshape(-1), [0, 2, 4, 6, 8, 0, 0, 0])
    _close(po, jo)
    _close(pf, jf)
    assert _padded_while(mx, mx.nd.array([0.0]))[0].shape == (5, 1)


def test_while_loop_traced_padded_no_step():
    """A loop whose predicate is false at once still gives
    max_iterations rows of zeros inside a hybridized call."""
    def run(pkg):
        net = _hybrid(pkg, lambda p, i0, v0: p.nd.contrib.while_loop(
            lambda i, v: i < 0, lambda i, v: (v * 2.0, [i + 1, v]),
            [i0, v0], max_iterations=3)[0])
        return net(pkg.nd.array([1.0]), pkg.nd.array([1.0, 2.0])).asnumpy()

    jo, po = _both(run)
    assert po.shape == jo.shape == (3, 2)
    _close(po, jo)


def test_while_loop_traced_gradient():
    """Gradients through a padded while_loop under record()."""
    w_np = np.array([0.5, -1.5, 2.0], np.float32)

    def run(pkg):
        net = _hybrid(pkg, lambda p, w: p.nd.contrib.while_loop(
            lambda i, s: i < 3, lambda i, s: (s * w, [i + 1, s * w + 1.0]),
            [p.nd.zeros((1,)), p.nd.ones((3,))], max_iterations=5)[0])
        w = pkg.nd.array(w_np)
        w.attach_grad()
        with pkg.autograd.record():
            out = net(w)
            loss = (out * out).sum()
        loss.backward()
        return out.asnumpy(), w.grad.asnumpy()

    (jo, jg), (po, pg) = _both(run)
    assert po.shape == (5, 3)
    _close(po, jo)
    _close(pg, jg, atol=GRAD_ATOL)


def test_cond_in_hybrid_block():
    def run(pkg, xv):
        net = _hybrid(pkg, lambda p, x: p.nd.contrib.cond(
            lambda: x.sum() > 0, lambda: x * 3, lambda: x - 1))
        return net(pkg.nd.array(xv)).asnumpy()

    for xv in ([1.0, 2.0], [-4.0, 1.0]):
        _close(run(mx, xv), run(jmx, xv))


# -- sym.contrib bound through the Executor ----------------------------------

def _sym_foreach(pkg):
    data, w, init = (pkg.sym.var(n) for n in ("data", "w", "init"))

    def body(x, s):
        h = pkg.sym.broadcast_mul(x, w) + s
        return h, h

    outs, final = pkg.sym.contrib.foreach(body, data, init)
    return pkg.sym.Group([outs, final])


def test_sym_foreach_bind_and_backward():
    data_np = np.arange(6).reshape(3, 2).astype(np.float32)
    w_np = np.array([2.0, 0.5], np.float32)

    def run(pkg):
        nd = pkg.nd
        ex = _sym_foreach(pkg).bind(
            pkg.cpu(), {"data": nd.array(data_np), "w": nd.array(w_np),
                        "init": nd.zeros((2,))},
            args_grad={"w": nd.zeros((2,))})
        res = [r.asnumpy() for r in ex.forward(is_train=True)]
        ex.backward(out_grads=[nd.ones((3, 2)), nd.zeros((2,))])
        return res, ex.grad_dict["w"].asnumpy()

    (jr, jg), (pr, pg) = _both(run)
    for p, j in zip(pr, jr):
        _close(p, j)
    _close(pg, jg, atol=GRAD_ATOL)
    _close(pg, sum(data_np[i] * (3 - i) for i in range(3)))


def _sym_while(pkg):
    i, s, w = (pkg.sym.var(n) for n in ("i", "s", "w"))
    outs, finals = pkg.sym.contrib.while_loop(
        lambda i_, s_: i_ < 4, lambda i_, s_: (s_ * w, [i_ + 1, s_ * w]),
        [i, s], max_iterations=6)
    return pkg.sym.Group([outs] + finals)


def test_sym_while_loop_bind_and_backward():
    """Padded outputs (6 rows, 4 executed), final vars, and the gradient
    of a captured weight."""
    w_np = np.array([0.5, 1.5], np.float32)

    def run(pkg):
        nd = pkg.nd
        ex = _sym_while(pkg).bind(
            pkg.cpu(), {"i": nd.array([0.0]), "s": nd.ones((2,)),
                        "w": nd.array(w_np)},
            args_grad={"w": nd.zeros((2,))},
            grad_req={"i": "null", "s": "null", "w": "write"})
        res = [r.asnumpy() for r in ex.forward(is_train=True)]
        ex.backward(out_grads=[nd.ones((6, 2)), nd.zeros((1,)),
                               nd.ones((2,))])
        return res, ex.grad_dict["w"].asnumpy()

    (jr, jg), (pr, pg) = _both(run)
    assert pr[0].shape == (6, 2)
    _close(pr[0][4:], np.zeros((2, 2)))
    _close(pr[1], [4.0])
    for p, j in zip(pr, jr):
        _close(p, j)
    _close(pg, jg, atol=GRAD_ATOL)


def test_sym_while_loop_infer_shape():
    for pkg in PKGS:
        _, out_shapes, _ = _sym_while(pkg).infer_shape(i=(1,), s=(2,),
                                                      w=(2,))
        assert [tuple(s) for s in out_shapes] == [(6, 2), (1,), (2,)]


def _sym_cond(pkg):
    a, b = pkg.sym.var("a"), pkg.sym.var("b")
    return pkg.sym.contrib.cond(
        lambda: pkg.sym.sum(a) > pkg.sym.sum(b),
        lambda: a * 2 * b, lambda: b * 3)


def test_sym_cond_bind_and_backward():
    for av in (4.0, 0.5):
        def run(pkg):
            nd = pkg.nd
            ex = _sym_cond(pkg).bind(
                pkg.cpu(), {"a": nd.array([av]), "b": nd.array([1.0])},
                args_grad={"a": nd.zeros((1,)), "b": nd.zeros((1,))})
            res = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(out_grads=[nd.ones((1,))])
            return res, ex.grad_dict["a"].asnumpy(), \
                ex.grad_dict["b"].asnumpy()

        jax_res, port_res = _both(run)
        for p, j in zip(port_res, jax_res):
            _close(p, j)
    assert port_res[0][0] == 3.0   # the else branch ran


def test_multi_output_node_evaluates_once(monkeypatch):
    """Output views share one evaluation: the body runs once per
    iteration for a forward that reads two outputs of the node, and the
    sub-graph is compiled into a plan once per training mode, not per
    iteration or per forward."""
    data, init = mx.sym.var("data"), mx.sym.var("init")
    outs, final = mx.sym.contrib.foreach(lambda x, s: (x + s, x + s),
                                         data, init)
    sub = outs._attrs["body"]
    calls = {"body": 0, "compile": 0}
    real_call, real_compile = cf.SymSubgraph.__call__, _executor._compile

    def counting_call(self, args, captured):
        calls["body"] += 1
        return real_call(self, args, captured)

    def counting_compile(*a, **k):
        calls["compile"] += 1
        return real_compile(*a, **k)

    grp = mx.sym.Group([outs, final])
    ex = grp.bind(mx.cpu(), {"data": mx.nd.ones((3, 2)),
                             "init": mx.nd.zeros((2,))})
    monkeypatch.setattr(cf.SymSubgraph, "__call__", counting_call)
    monkeypatch.setattr(_executor, "_compile", counting_compile)
    res = ex.forward()
    assert calls["body"] == 3
    _close(res[0].asnumpy()[-1], res[1].asnumpy())
    ex.forward()
    ex.forward(is_train=True)
    ex.forward(is_train=True)
    assert calls["body"] == 12
    # The outer graph and the body, each once per mode.
    assert calls["compile"] == 4 and sorted(sub._plans) == [False, True]


def test_control_flow_json_is_opaque():
    """tojson() writes each sub-graph as an opaque string (the same in
    every run); the loaded graph has strings where callables were, so it
    does not bind and run, as in the JAX package."""
    grp = _sym_foreach(mx)
    nodes = json.loads(grp.tojson())["nodes"]
    node = next(n for n in nodes if n["op"] == "_foreach")
    assert node["attrs"]["body"].startswith("SymSubgraph(")
    loaded = mx.sym.load_json(grp.tojson())
    ex = loaded.bind(mx.cpu(), {"data": mx.nd.ones((3, 2)),
                                "w": mx.nd.ones((2,)),
                                "init": mx.nd.zeros((2,))})
    with pytest.raises(TypeError):
        ex.forward()
    jnode = next(n for n in json.loads(_sym_foreach(jmx).tojson())["nodes"]
                 if n["op"] == "_foreach")
    assert isinstance(jnode["attrs"]["body"], str)


# -- SymbolBlock on the Executor's plan ---------------------------------------

def _bn_graph(pkg):
    data = pkg.sym.var("data")
    x = pkg.sym.FullyConnected(data, num_hidden=6, name="fc1")
    x = pkg.sym.BatchNorm(x, fix_gamma=False, eps=1e-5, momentum=0.8,
                          name="bn")
    x = pkg.sym.Activation(x, act_type="tanh", name="act")
    return pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")


def _bn_arrays(sym, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(5, 4))
    args = {n: (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("hybridize", [False, True])
def test_symbol_block_record_matches_executor(hybridize):
    """One graph, one set of weights: SymbolBlock under record() (train
    mode) and the Executor give the same outputs, the same parameter
    gradients and the same new BatchNorm moving statistics."""
    sym = _bn_graph(mx)
    args, aux = _bn_arrays(sym)
    head = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    ex = sym.bind(mx.cpu(), {n: mx.nd.array(v) for n, v in args.items()},
                  args_grad={n: mx.nd.zeros(v.shape) for n, v in args.items()
                             if n != "data"},
                  grad_req={n: "null" if n == "data" else "write"
                            for n in args},
                  aux_states={n: mx.nd.array(v) for n, v in aux.items()})
    want = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[mx.nd.array(head)])

    params = {n: mx.nd.array(v) for n, v in args.items() if n != "data"}
    params.update({n: mx.nd.array(v) for n, v in aux.items()})
    blk = mx.gluon.SymbolBlock(sym, mx.sym.var("data"), params=params)
    if hybridize:
        blk.hybridize()
    with mx.autograd.record():
        out = blk(mx.nd.array(args["data"]))
        loss = (out * mx.nd.array(head)).sum()
    loss.backward()
    _close(out.asnumpy(), want)
    for n in params:
        p = blk.collect_params()[n]
        if n in aux:
            _close(p.data().asnumpy(), ex.aux_dict[n].asnumpy())
            assert not np.allclose(p.data().asnumpy(), aux[n])
        else:
            _close(p.grad().asnumpy(), ex.grad_dict[n].asnumpy(),
                   atol=GRAD_ATOL)
    # Eval mode leaves the moving statistics alone.
    before = {n: blk.collect_params()[n].data().asnumpy() for n in aux}
    blk(mx.nd.array(args["data"]))
    for n in aux:
        _close(blk.collect_params()[n].data().asnumpy(), before[n], atol=0)


def test_symbol_block_matches_jax_symbol_block():
    """Eval forward of the same graph and weights through both packages'
    SymbolBlock."""
    outs = []
    for pkg in PKGS:
        sym = _bn_graph(pkg)
        args, aux = _bn_arrays(_bn_graph(mx))
        params = {n: pkg.nd.array(v) for n, v in args.items() if n != "data"}
        params.update({n: pkg.nd.array(v) for n, v in aux.items()})
        blk = pkg.gluon.SymbolBlock(sym, pkg.sym.var("data"), params=params)
        outs.append(blk(pkg.nd.array(args["data"])).asnumpy())
    _close(outs[1], outs[0])


def test_symbol_block_runs_control_flow():
    """A sym.contrib graph through SymbolBlock, trained under record():
    the captured weight gets the Executor's gradient."""
    data_np = np.arange(6).reshape(3, 2).astype(np.float32)
    w_np = np.array([2.0, 0.5], np.float32)
    grp = _sym_foreach(mx)
    blk = mx.gluon.SymbolBlock(
        grp, [mx.sym.var("data"), mx.sym.var("init")],
        params={"w": mx.nd.array(w_np)})
    with mx.autograd.record():
        outs, _ = blk(mx.nd.array(data_np), mx.nd.zeros((2,)))
        loss = outs.sum()
    loss.backward()
    _close(blk.collect_params()["w"].grad().asnumpy(),
           sum(data_np[i] * (3 - i) for i in range(3)))


@pytest.mark.cuda
def test_control_flow_on_card_matches_host():
    """sym.contrib while_loop and cond bound on the card and on the
    host: the same values and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w_np = np.array([0.5, 1.5], np.float32)
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        nd = mx.nd
        ex = _sym_while(mx).bind(
            ctx, {"i": nd.array([0.0], ctx=ctx), "s": nd.ones((2,), ctx=ctx),
                  "w": nd.array(w_np, ctx=ctx)},
            args_grad={"w": nd.zeros((2,), ctx=ctx)},
            grad_req={"i": "null", "s": "null", "w": "write"})
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward(out_grads=[nd.ones((6, 2), ctx=ctx),
                               nd.zeros((1,), ctx=ctx),
                               nd.ones((2,), ctx=ctx)])
        ex2 = _sym_cond(mx).bind(ctx, {"a": nd.array([4.0], ctx=ctx),
                                       "b": nd.array([1.0], ctx=ctx)})
        res.append(outs + [ex.grad_dict["w"].asnumpy(),
                           ex2.forward()[0].asnumpy()])
    for c, h in zip(res[1], res[0]):
        _close(c, h)
