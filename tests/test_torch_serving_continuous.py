"""Continuous batching of the port (``serving/continuous.py``) against the
JAX package's, on the same numpy weights and the same request schedule.

- ``PagedSlotAllocator`` hands out the same slots under one alloc/free
  script, with the same high-water marks and page counts;
- a small LSTM language model (vocabulary 50, embedding and hidden 16,
  two layers, the cells sliced from the RNN op's fused parameter vector;
  its prefill runs the padded prompt step by step and masks updates past
  the prompt's length) decodes the same tokens for every sequence through
  ``ModelGateway.submit_sequence`` in both packages. Its backend's
  ``compile_count`` after ``warm()`` is the JAX package's trace count
  (one step per page count, one row placement, one prefill per prompt
  bucket), and the run adds none;
- slot churn (70 sequences through 8 slots, a counter decoder whose
  tokens are known on the host) adds no signature, in both packages;
- a hot swap with a long sequence in flight finishes it on its
  admit-time generation, the next one on the new generation;
- a sequence past its deadline sheds mid-decode with the same counts.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.serving as jserving
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.ops.rnn_ops import rnn_param_layout

torch.set_num_threads(2)

PKGS = {"jax": (jmx, jserving, {}), "port": (mx, serving, {"ctx": mx.cpu()})}
V, E, H, LAYERS = 50, 16, 16, 2


def _arrays(pkg, kw, values):
    return [pkg.nd.array(v, **kw) for v in values]


# -- the allocator -------------------------------------------------------------

def _allocator_script(module):
    alloc = module.PagedSlotAllocator(10, 4)
    log = [alloc.num_pages]
    held = [alloc.alloc() for _ in range(7)]
    log += [list(held), alloc.high_water, alloc.pages_for(alloc.high_water)]
    for s in (5, 1, 6):
        alloc.free(s)
    log += [alloc.occupancy, alloc.high_water]
    log += [alloc.alloc() for _ in range(5)]
    log += [alloc.alloc(), alloc.occupancy, alloc.high_water,
            alloc.pages_for(alloc.high_water)]
    for s in range(10):
        alloc.free(s)
    log += [alloc.occupancy, alloc.high_water, alloc.alloc()]
    with pytest.raises(ValueError):
        alloc.free(9)
    return log


def test_paged_slot_allocator_hands_out_the_same_slots():
    got = _allocator_script(serving.continuous)
    assert got == _allocator_script(jserving.continuous)
    assert got[1] == [0, 1, 2, 3, 4, 5, 6]


# -- the LSTM language model ---------------------------------------------------

def lm_params(seed=0):
    rng = np.random.default_rng(seed)
    n = sum(int(np.prod(s)) for _, s, _ in rnn_param_layout(LAYERS, H, E))
    return [rng.standard_normal((V, E), np.float32),
            rng.standard_normal(n, np.float32) * 0.3,
            rng.standard_normal((V, H), np.float32) * 0.5,
            rng.standard_normal(V, np.float32) * 0.1]


def lm_fns(pkg):
    """(step, prefill) of the greedy LSTM LM over `pkg`'s nd ops: the
    state is (h, c), each (slots, LAYERS, H)."""
    nd = pkg.nd
    layout = {name: (shape, off)
              for name, shape, off in rnn_param_layout(LAYERS, H, E)}

    def w(flat, name):
        shape, off = layout[name]
        return nd.slice_axis(flat, axis=0, begin=off,
                             end=off + int(np.prod(shape))).reshape(shape)

    def core(emb, flat, fcw, fcb, h, c, tok):
        x = nd.Embedding(tok, emb, input_dim=V, output_dim=E)
        hs, cs = [], []
        for i in range(LAYERS):
            hl = nd.slice_axis(h, axis=1, begin=i, end=i + 1).reshape((-1, H))
            cl = nd.slice_axis(c, axis=1, begin=i, end=i + 1).reshape((-1, H))
            g = nd.FullyConnected(x, w(flat, "l%d_i2h_weight" % i),
                                  w(flat, "l%d_i2h_bias" % i),
                                  num_hidden=4 * H) + \
                nd.FullyConnected(hl, w(flat, "l%d_h2h_weight" % i),
                                  w(flat, "l%d_h2h_bias" % i),
                                  num_hidden=4 * H)
            gi, gf, gg, go = nd.split(g, num_outputs=4, axis=1)
            cl = nd.sigmoid(gf) * cl + nd.sigmoid(gi) * nd.tanh(gg)
            x = nd.sigmoid(go) * nd.tanh(cl)
            hs.append(x)
            cs.append(cl)
        logits = nd.FullyConnected(x, fcw, fcb, num_hidden=V)
        return nd.stack(*hs, axis=1), nd.stack(*cs, axis=1), logits

    def step(emb, flat, fcw, fcb, state, tokens, pos):
        h, c, logits = core(emb, flat, fcw, fcb, *state, tokens)
        return (h, c), nd.argmax(logits, axis=1)

    def prefill(emb, flat, fcw, fcb, prompt, length):
        h = nd.zeros((1, LAYERS, H), ctx=prompt.context)
        c = nd.zeros((1, LAYERS, H), ctx=prompt.context)
        keep = nd.zeros((1, V), ctx=prompt.context)
        lf = length.astype("float32")
        for t in range(int(prompt.shape[1])):
            tok = nd.slice_axis(prompt, axis=1, begin=t,
                                end=t + 1).reshape((1,))
            h2, c2, logits = core(emb, flat, fcw, fcb, h, c, tok)
            m = (lf > t).reshape((1, 1))
            m3 = m.reshape((1, 1, 1))
            h = nd.broadcast_mul(m3, h2) + nd.broadcast_mul(1 - m3, h)
            c = nd.broadcast_mul(m3, c2) + nd.broadcast_mul(1 - m3, c)
            keep = nd.broadcast_mul(m, logits) + nd.broadcast_mul(1 - m, keep)
        return (h, c), nd.argmax(keep, axis=1)

    return step, prefill


def _lm_spec(module, pkg, kw, name="lm"):
    step, prefill = lm_fns(pkg)
    return module.ModelSpec(
        name, params=_arrays(pkg, kw, lm_params()), max_batch=8,
        decode=module.DecodeConfig(step, state_shape=[(LAYERS, H)] * 2,
                                   init=prefill, page_slots=4, max_tokens=12,
                                   max_prompt_len=8), **kw)


def _lm_schedule(n=20, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, rng.integers(1, 9)).astype(np.int32),
             int(rng.integers(1, 13))) for _ in range(n)]


def _lm_run(key):
    pkg, module, kw = PKGS[key]
    gw = module.ModelGateway(**kw)
    try:
        gw.register(_lm_spec(module, pkg, kw))
        backend = gw._state("lm").backend
        warm = backend.compile_count
        futs = [gw.submit_sequence("lm", p, max_tokens=m)
                for p, m in _lm_schedule()]
        res = [f.result(timeout=60) for f in futs]
        stats = gw.stats()["lm"]["decode"]
        return {"tokens": [r.tokens for r in res],
                "generations": [r.generation for r in res],
                "warm": warm, "after": backend.compile_count,
                "describe": gw.registry.describe()["lm"],
                "stats_keys": sorted(stats)}
    finally:
        gw.shutdown()


def test_lstm_lm_decodes_the_same_tokens_with_the_same_trace_count():
    got, want = _lm_run("port"), _lm_run("jax")
    assert got["tokens"] == want["tokens"]
    assert [len(t) for t, (_, m) in zip(got["tokens"], _lm_schedule())] \
        == [m for _, m in _lm_schedule()]
    # 2 step page counts (buckets 1-4 -> 1 page, 8 -> 2), 1 row
    # placement (both state tensors are (2, 16) float32), 4 prefills.
    assert got["warm"] == want["warm"] == 7
    assert got["after"] == got["warm"] and want["after"] == want["warm"]
    assert got["generations"] == want["generations"] == [1] * 20
    assert got["describe"] == want["describe"]
    assert got["stats_keys"] == want["stats_keys"]


def test_each_sequence_decodes_as_it_does_alone():
    """Rows are independent: a sequence co-batched with others gets the
    tokens it gets alone in slot 0 (the port's backend, host)."""
    backend = _lm_spec(serving, mx, {"ctx": mx.cpu()}).build_backend()
    backend.warm()
    gw = serving.ModelGateway(ctx=mx.cpu())
    try:
        gw.register(_lm_spec(serving, mx, {"ctx": mx.cpu()}))
        sched = _lm_schedule(12, seed=5)
        futs = [gw.submit_sequence("lm", p, max_tokens=m) for p, m in sched]
        together = [f.result(timeout=60).tokens for f in futs]
    finally:
        gw.shutdown()
    tokens = np.zeros(8, np.int32)
    pos = np.zeros(8, np.int32)
    active = np.zeros(8, bool)
    active[0] = True
    for (prompt, m), got in zip(sched, together):
        tok = [backend.admit(0, prompt)]
        tokens[0] = tok[0]
        while len(tok) < m:
            tokens[0] = backend.step(backend.page_count(1), tokens, pos,
                                     active)[0]
            tok.append(int(tokens[0]))
        assert tok == got


# -- slot churn: a counter decoder ---------------------------------------------

def _counter_run(key, n=70):
    pkg, module, kw = PKGS[key]

    def step(w, state, tokens, pos):
        return state + w, tokens + 1

    gw = module.ModelGateway(**kw)
    try:
        gw.register(module.ModelSpec(
            "ctr", params=[pkg.nd.array(np.ones(4, np.float32), **kw)],
            max_batch=8, decode=module.DecodeConfig(
                step, state_shape=(4,), page_slots=2, max_tokens=9)))
        backend = gw._state("ctr").backend
        warm = backend.compile_count
        sched = [(int(k % 7) + 1, int(k % 9) + 1) for k in range(n)]
        futs = [gw.submit_sequence("ctr", [first], max_tokens=m)
                for first, m in sched]
        res = [f.result(timeout=60).tokens for f in futs]
        for (first, m), toks in zip(sched, res):
            assert toks == [first + 1 + i for i in range(m)]
        return warm, backend.compile_count, res
    finally:
        gw.shutdown()


def test_slot_churn_adds_no_signature():
    warm, after, got = _counter_run("port")
    jwarm, jafter, want = _counter_run("jax")
    assert got == want
    # 3 step page counts (buckets 1-2, 4, 8 over 2-slot pages), 1 place.
    assert (warm, after) == (jwarm, jafter) == (4, 4)


# -- hot swap and deadlines ----------------------------------------------------

def _swap_run(key):
    pkg, module, kw = PKGS[key]

    def step(w, state, tokens, pos):
        return state + w, tokens + 1

    gw = module.ModelGateway(**kw)
    try:
        gw.register(module.ModelSpec(
            "dec", params=[pkg.nd.array(np.ones(2, np.float32), **kw)],
            max_batch=4, decode=module.DecodeConfig(
                step, state_shape=(2,), page_slots=2, max_tokens=30)))
        long = gw.submit_sequence("dec", [0], max_tokens=600)
        time.sleep(0.02)
        swap = jserving.hot_swap if key == "jax" else serving.hot_swap
        new = swap(gw, "dec", params=[pkg.nd.array(np.zeros(2, np.float32),
                                                   **kw)])
        after = gw.generate("dec", [5], max_tokens=3)
        first = long.result(timeout=30)
        # A whole-sequence deadline that cannot be met sheds mid-decode.
        doomed = gw.submit_sequence("dec", [1], max_tokens=20000,
                                    timeout_ms=50)
        with pytest.raises(module.DeadlineExceededError):
            doomed.result(timeout=30)
        return {"new": new, "first": (first.generation, first.tokens),
                "after": (after.generation, after.tokens),
                "shed": gw.stats()["dec"]["shed"]}
    finally:
        gw.shutdown()


def test_hot_swap_drains_in_flight_sequences_and_deadlines_shed():
    got, want = _swap_run("port"), _swap_run("jax")
    assert got == want
    assert got["new"] == 2
    assert got["first"] == (1, list(range(1, 601)))
    assert got["after"] == (2, [6, 7, 8])
    assert got["shed"] == {"deadline:default": 1}
