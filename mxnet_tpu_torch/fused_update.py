"""Fused imperative update path: the multi-tensor optimizer apply.

Counterpart of ``mxnet_tpu/fused_update.py:394-856`` (``FusedApplier``).
The per-parameter loop of ``gluon.Trainer`` pays one optimizer-op
dispatch per parameter: five to ten kernel launches each, 161 tensors
in ResNet-50 v1. :class:`FusedApplier` coalesces a supported optimizer
family's update into one pass per ~25 MB chunk
(``MXNET_FUSED_BUCKET_MB``) of a (context, dtype) group of parameters.

How a chunk works here. The JAX package compiles one jitted executable
per chunk over a concatenation of the weights and slices new weights out
of it. The port keeps the chunk **flat between steps** instead:

- the weights of a chunk are views into one flat buffer (``flat_w``),
  installed in the parameters' NDArrays, so the layers read the buffer
  itself and the update writes it in place, under ``torch.no_grad()``;
- the optimizer state lives in flat buffers too (``flat_s``); the
  per-parameter entries of ``updater.states`` become :class:`_FlatView`
  NDArrays that materialize their slice on first read and detach onto a
  concrete tensor (marking the chunk stale) when something writes them;
- a step concatenates the chunk's gradients (one launch), runs the
  family's update body — the *same* functions of
  ``ops/optimizer_ops.py`` that the per-parameter loop dispatches —
  once over the flat vectors, and copies the results into the flat
  buffers (one launch per buffer). The launches per step scale with
  the number of chunks, not of parameters.

Bit identity. Every body is elementwise and built from single-rounding
ATen ops (``ops/optimizer_ops.py``), so an element meets the same ops
with the same operands whether it sits in a parameter's own tensor or
at some offset of a flat vector: the fused and the loop path agree bit
for bit at every size, on the host and on the card. The per-parameter
learning rates and weight decays — Python floats computed on the host
exactly as the loop computes them (Adam's bias-corrected ``lr_t``, the
``lr_mult``/``wd_mult`` multipliers) — ride as runtime tensors in the
chunk's hyperparameter dtype (the weight dtype, fp32 for master
weights), rounded once there; the loop path rounds its Python floats to
the same dtype (``optimizer_ops._c``). A chunk whose parameters share
one value gets a 0-d tensor, otherwise one value per element. The
global-norm clip's ``grad_scale`` is a 0-d runtime tensor in the
gradient dtype; ``rescale_grad`` is a Python float, as in the loop's op
attrs.
Each parameter's slice starts at a multiple of 16 elements; the gaps
hold zeros, which every supported body maps to zeros.

Multi-precision weights (float16/bfloat16 under ``multi_precision=True``)
ride the same table through :func:`_mp_spec`: the fp32 master is the
LAST flat state slot, the gradient widens to fp32, the base body runs in
fp32 and the low-precision weights are written as the master's cast —
what the loop's ``update_multi_precision`` does. ``Updater.get_states``
then sees exactly the ``(inner, master)`` tuple the loop writes.

Writes around the fused path are seen: a weight written elsewhere
(``set_data``, the ``fused=False`` loop, ``load_parameters``) bumps its
NDArray ``version``, a replaced state entry (``load_states``) fails the
identity check, and a written :class:`_FlatView` marks its chunk stale;
the next apply then re-flattens from the live values. As in the
reference's engine, a reader that holds a weight's NDArray sees the new
values and a bumped ``version`` after the apply; a raw tensor taken
from it (``NDArray.detach()`` shares storage) sees them too, since the
update is in place — copy (``NDArray.copy()``) to keep a snapshot. A
graph recorded before an apply cannot be differentiated after it
(torch's in-place check raises): step after ``backward``.

Families (``_spec_for``, the JAX package's table): SGD and NAG (with
and without momentum), Adam, RMSProp (plain and centered), AdaGrad,
AdaDelta, Signum and SignSGD. FTML, Nadam, Ftrl, DCASGD, SGLD, LBSGD and
Test take the per-parameter fallback, entry by entry, as there.

``num_compiles`` counts the chunk plans built (the counterpart of the
JAX package's executable-cache fills; ``mx_fused_apply_compiles_total``)
and ``mx_trainer_fused_dispatches`` the coalesced passes. Not ported
here: ``GradBucketer`` (the multi-context bucketed reduce, ROADMAP
Queue 1 item 7), the numeric grad guard (``open_guard_window``, item 9),
memstats (item 9) and the persistent compile cache (item 10).
"""
from __future__ import annotations

import torch

from . import env as _env
from .ndarray.ndarray import NDArray, _producer_stream
from .ops import registry as _reg
from .ops import optimizer_ops as _oo
from .telemetry import metrics as _tm
from .telemetry import trace as _trace

__all__ = ["FusedApplier", "bucket_bytes"]

_apply_compiles = _tm.REGISTRY.counter(
    "mx_fused_apply_compiles_total",
    "Fused multi-tensor optimizer-apply plans built (one per param-set "
    "signature — a climbing rate after warmup is a replanning storm)",
    labels=("optimizer",))
_fused_dispatches = _tm.REGISTRY.counter(
    "mx_trainer_fused_dispatches",
    "Coalesced passes on the fused imperative update path (one per "
    "chunk apply and per chunk flatten)")

# Each parameter's slice of a flat buffer starts at a multiple of this
# many elements, so every view is aligned for vectorized loads.
_ALIGN = 16


def bucket_bytes():
    """Chunk size in bytes (``MXNET_FUSED_BUCKET_MB``, default 25 MB)."""
    return int(_env.get("MXNET_FUSED_BUCKET_MB")) * (1 << 20)


def _pack_by_bytes(items, max_bytes, nbytes):
    """Greedy contiguous packing into runs of <= max_bytes (oversize
    singletons get their own run), the JAX package's packing policy."""
    out, cur, cur_bytes = [], [], 0
    for item in items:
        nb = nbytes(item)
        if cur and cur_bytes + nb > max_bytes:
            out.append(cur)
            cur, cur_bytes = [], 0
        cur.append(item)
        cur_bytes += nb
    if cur:
        out.append(cur)
    return out


def _dispatch(label, fn, *args, **span_attrs):
    """Run one coalesced pass, counted as a single dispatch."""
    _reg.DISPATCHES[0] += 1
    _fused_dispatches.inc()
    with _trace.span(label, **span_attrs):
        return fn(*args)


# -- optimizer family table ----------------------------------------------------
#
# Each entry maps an optimizer CLASS (exact type: subclasses such as
# LBSGD override `update` and must fall back) to a spec:
#   n_states : per-param state arity the body expects
#   statics  : hashable tuple of baked hyperparameters (part of the plan
#              signature)
#   body     : (w, g, states_tuple, lr, wd, rescale) ->
#              (new_w, new_states_tuple), built from the SAME
#              ops/optimizer_ops bodies the per-param loop dispatches
#   host_lr  : Python-float per-index learning rate, computed exactly as
#              the loop path computes it (Adam's bias-corrected lr_t)

def _spec_for(opt):
    from . import optimizer as om

    t = type(opt)
    clip = opt._clip()

    if t is om.SGD or t is om.NAG:
        mom = float(opt.momentum)
        mom_op = _oo._sgd_mom_update if t is om.SGD else _oo._nag_mom_update
        if mom != 0.0:
            def body(w, g, s, lr, wd, rs):
                nw, nm = mom_op(w, g, s[0], lr=lr, momentum=mom, wd=wd,
                                rescale_grad=rs, clip_gradient=clip)
                return nw, (nm,)
            return _Spec(t.__name__.lower(), 1, (mom, clip), body)

        def body(w, g, s, lr, wd, rs):
            return _oo._sgd_update(w, g, lr=lr, wd=wd, rescale_grad=rs,
                                   clip_gradient=clip), ()
        return _Spec(t.__name__.lower(), 0, (0.0, clip), body)

    if t is om.Adam:
        b1, b2, e = float(opt.beta1), float(opt.beta2), float(opt.epsilon)

        def body(w, g, s, lr, wd, rs):
            nw, nm, nv = _oo._adam_update(w, g, s[0], s[1], lr=lr, beta1=b1,
                                          beta2=b2, epsilon=e, wd=wd,
                                          rescale_grad=rs,
                                          clip_gradient=clip)
            return nw, (nm, nv)

        def host_lr(o, index, lr):
            # Adam.update's own Python-float arithmetic.
            ti = o._index_update_count[index]
            coef1 = 1.0 - b1 ** ti
            coef2 = 1.0 - b2 ** ti
            return lr * (coef2 ** 0.5) / coef1

        return _Spec("adam", 2, (b1, b2, e, clip), body, host_lr)

    if t is om.RMSProp:
        g1, g2 = float(opt.gamma1), float(opt.gamma2)
        e = float(opt.epsilon)
        cw = float(opt.clip_weights) if opt.clip_weights is not None else -1.0
        if opt.centered:
            def body(w, g, s, lr, wd, rs):
                nw, nn, ng, nd_ = _oo._rmspropalex_update(
                    w, g, s[0], s[1], s[2], lr=lr, gamma1=g1, gamma2=g2,
                    epsilon=e, wd=wd, rescale_grad=rs, clip_gradient=clip,
                    clip_weights=cw)
                return nw, (nn, ng, nd_)
            return _Spec("rmsprop_centered", 3, (g1, g2, e, clip, cw), body)

        def body(w, g, s, lr, wd, rs):
            nw, nn = _oo._rmsprop_update(w, g, s[0], lr=lr, gamma1=g1,
                                         epsilon=e, wd=wd, rescale_grad=rs,
                                         clip_gradient=clip, clip_weights=cw)
            return nw, (nn,)
        return _Spec("rmsprop", 1, (g1, e, clip, cw), body)

    if t is om.AdaGrad:
        e = float(opt.float_stable_eps)

        def body(w, g, s, lr, wd, rs):
            nw, nh = _oo._adagrad_update(w, g, s[0], lr=lr, epsilon=e, wd=wd,
                                         rescale_grad=rs, clip_gradient=clip)
            return nw, (nh,)
        return _Spec("adagrad", 1, (e, clip), body)

    if t is om.AdaDelta:
        rho, e = float(opt.rho), float(opt.epsilon)

        def body(w, g, s, lr, wd, rs):
            nw, nag, nad = _oo._adadelta_update(w, g, s[0], s[1], rho=rho,
                                                epsilon=e, wd=wd,
                                                rescale_grad=rs,
                                                clip_gradient=clip)
            return nw, (nag, nad)
        return _Spec("adadelta", 2, (rho, e, clip), body)

    if t is om.Signum or t is om.SignSGD:
        mom = float(opt.momentum)
        wd_lh = float(opt.wd_lh)
        if mom != 0.0:
            def body(w, g, s, lr, wd, rs):
                nw, nm = _oo._signum_update(w, g, s[0], lr=lr, momentum=mom,
                                            wd=wd, rescale_grad=rs,
                                            clip_gradient=clip, wd_lh=wd_lh)
                return nw, (nm,)
            return _Spec("signum", 1, (mom, clip, wd_lh), body)

        def body(w, g, s, lr, wd, rs):
            return _oo._signsgd_update(w, g, lr=lr, wd=wd, rescale_grad=rs,
                                       clip_gradient=clip), ()
        return _Spec("signsgd", 0, (clip,), body)

    return None


class _Spec:
    __slots__ = ("name", "n_states", "statics", "body", "host_lr", "mp",
                 "base_k")

    def __init__(self, name, n_states, statics, body, host_lr=None,
                 mp=False, base_k=None):
        self.name = name
        self.n_states = n_states
        self.statics = statics
        self.body = body
        self.host_lr = host_lr or (lambda opt, index, lr: lr)
        self.mp = mp
        self.base_k = n_states if base_k is None else base_k


def _mp_spec(spec):
    """Master-weight variant of a supported family: the fp32 master is
    the LAST flat state slot, the gradient widens to its dtype, the base
    body runs there, and the weight is the master's cast — the loop's
    ``update_multi_precision``, elementwise."""
    base_body, base_k = spec.body, spec.n_states

    def body(w, g, s, lr, wd, rs):
        inner, w32 = tuple(s[:base_k]), s[base_k]
        new_w32, new_inner = base_body(w32, g.to(w32.dtype), inner,
                                       lr, wd, rs)
        return new_w32, tuple(new_inner) + (new_w32,)

    return _Spec("mp_" + spec.name, base_k + 1, ("mp",) + spec.statics,
                 body, spec.host_lr, mp=True, base_k=base_k)


class _FlatView(NDArray):
    """Optimizer-state NDArray backed by a slice of its chunk's flat
    state buffer. The slice is made on first read and follows the
    buffer's in-place updates; a write (the loop path's ``out=``
    commit, ``load_states``) detaches the view onto the written tensor
    and marks the chunk stale, so the next fused apply re-flattens from
    the updater's states."""

    __slots__ = ("_chunk", "_kind", "_off", "_size", "_vshape",
                 "_concrete")

    def __init__(self, chunk, kind, off, size, shape, ctx):
        # NDArray.__init__ is skipped on purpose: it assigns _data,
        # which for a view means "detach".
        self._chunk = chunk
        self._kind = kind
        self._off = off
        self._size = size
        self._vshape = shape
        self._concrete = None
        self._ctx = ctx
        self._stream = None
        self._grad = None
        self._grad_req = "null"
        self._ag_retired = []
        self._recorded = False
        self.version = 0

    @property
    def _data(self):
        if self._concrete is None:
            flat = self._chunk.flat_s[self._kind]
            self._concrete = flat[self._off:self._off + self._size] \
                .view(self._vshape)
        return self._concrete

    @_data.setter
    def _data(self, value):
        self._concrete = value
        self._chunk.stale = True


class _ApplyChunk:
    """One chunk's plan (shapes, offsets) and its flat buffers."""

    __slots__ = ("shapes", "sizes", "offsets", "total", "n", "k", "mp",
                 "base_k", "pads", "zeros", "flat_w", "flat_s", "weights",
                 "wver", "views", "state_objs", "stale", "hyp_host", "lr_t",
                 "wd_t", "scale_t")

    def __init__(self, shapes, k):
        self.shapes = shapes
        self.sizes = [int(torch.Size(s).numel()) for s in shapes]
        self.offsets, off = [], 0
        for size in self.sizes:
            self.offsets.append(off)
            off += -(-size // _ALIGN) * _ALIGN
        self.total = off
        # Zero-gap lengths after each parameter (0 where none).
        self.pads = [(self.offsets[i + 1] if i + 1 < len(self.sizes)
                      else self.total) - self.offsets[i] - self.sizes[i]
                     for i in range(len(self.sizes))]
        self.zeros = {}     # (pad, dtype, device) -> zero gap filler
        self.n = len(shapes)
        self.k = k
        self.mp = False
        self.base_k = k
        self.flat_w = None
        self.flat_s = [None] * k
        self.weights = None
        self.wver = None
        self.views = []
        self.state_objs = []
        self.stale = True
        self.hyp_host = None
        self.lr_t = self.wd_t = self.scale_t = None

    def cat(self, tensors, dtype):
        """The chunk's flat vector of `tensors` (one launch), zeros in
        the gaps."""
        parts = []
        for t, pad in zip(tensors, self.pads):
            parts.append(t.reshape(-1))
            if pad:
                key = (pad, dtype, t.device)
                z = self.zeros.get(key)
                if z is None:
                    z = self.zeros[key] = torch.zeros(pad, dtype=dtype,
                                                      device=t.device)
                parts.append(z)
        return torch.cat(parts)

    def hyp(self, old, values, dtype, device):
        """A runtime tensor of per-parameter values: 0-d when they are
        all equal (refilled in place where `old` is one), else one value
        per element (zero in the gaps). Filling launches a kernel with
        the value: no host-to-device copy, and the buffer stays put."""
        vals = [_oo._c(v, dtype) for v in values]
        if all(v == vals[0] for v in vals):
            if old is not None and old.dim() == 0 and old.dtype == dtype:
                return old.fill_(vals[0])
            return torch.full((), vals[0], dtype=dtype, device=device)
        per, counts = [], []
        for v, size, pad in zip(vals, self.sizes, self.pads):
            per += [v, 0.0]
            counts += [size, pad]
        return torch.repeat_interleave(
            torch.tensor(per, dtype=dtype, device=device),
            torch.tensor(counts, device=device), output_size=self.total)


class FusedApplier:
    """Multi-tensor optimizer apply over an :class:`optimizer.Updater`.

    One instance per Trainer; it shares the updater's state dict (the
    entries become :class:`_FlatView` slices of the flat state), so
    ``save_states``/``load_states`` and ``fused=False`` see exactly the
    state the loop path would have written.

    ``apply(entries)`` with ``entries = [(index, weight, grad)]`` runs
    the fused passes and returns the entries it could NOT handle
    (unsupported optimizer family, non-floating weight, unrecognized
    state layout) for the caller's per-parameter fallback loop.
    """

    def __init__(self, updater):
        self.updater = updater
        self._chunks = {}       # signature -> _ApplyChunk
        # Steady-state plan cache keyed per entry-index run: the
        # (index, weight, grad) objects are identity-stable across steps,
        # so grouping and chunking collapse to one O(n) identity sweep.
        self._plans = {}
        self.num_compiles = 0
        # The JAX package's numeric guard hook; the guard itself is
        # ROADMAP Queue 1 item 9, so it stays None here.
        self.grad_guard = None

    # -- eligibility ----------------------------------------------------------

    @staticmethod
    def _state_tuple(state, n_states):
        """Normalize an updater state entry to the n-tuple of NDArrays
        the body expects, or None if the layout doesn't match."""
        if n_states == 0:
            return () if state is None or state == () else None
        if n_states == 1:
            return (state,) if isinstance(state, NDArray) else None
        if isinstance(state, (list, tuple)) and len(state) == n_states and \
                all(isinstance(s, NDArray) for s in state):
            return tuple(state)
        return None

    def _state_tuple_mp(self, state, base_k):
        """``(inner_state, master)`` to the flat ``inner... + (master,)``
        tuple of the mp body, or None when the layout doesn't match."""
        if not (isinstance(state, (list, tuple)) and len(state) == 2):
            return None
        inner, master = state
        if not isinstance(master, NDArray):
            return None
        inner_t = self._state_tuple(inner, base_k)
        if inner_t is None:
            return None
        return inner_t + (master,)

    def _state_for(self, state, ch):
        if ch.mp:
            return self._state_tuple_mp(state, ch.base_k)
        return self._state_tuple(state, ch.k)

    # -- one plan per (family, statics, shapes) signature ----------------------

    def _build_chunk(self, spec, sig, shapes):
        ch = _ApplyChunk(tuple(shapes), spec.n_states)
        ch.mp = spec.mp
        ch.base_k = spec.base_k
        self._chunks[sig] = ch
        self.num_compiles += 1
        _apply_compiles.labels(optimizer=spec.name).inc()
        return ch

    def _flatten(self, ch, ws, sts):
        """(Re)build the chunk's flat weight and state buffers from the
        live values and point the weights and the updater's state
        entries at them."""
        from . import autograd

        wdt = ws[0]._data.dtype
        with torch.no_grad():
            ch.flat_w = _dispatch("trainer::fused_flatten", ch.cat,
                                  [w._data for w in ws], wdt,
                                  kind="weights", params=ch.n)
            for j in range(ch.k):
                ch.flat_s[j] = _dispatch(
                    "trainer::fused_flatten", ch.cat,
                    [st[j]._data for st in sts], sts[0][j]._data.dtype,
                    kind="state%d" % j, params=ch.n)
        for w, off, size, shape in zip(ws, ch.offsets, ch.sizes, ch.shapes):
            old = w._data
            view = ch.flat_w[off:off + size].view(shape)
            if w._grad is not None:
                # A marked variable: the view is its new leaf; the old
                # one stays reachable for a pending backward.
                autograd._retire(w, old)
                view.requires_grad_(old.is_floating_point())
            w._data = view
            w._stream = _producer_stream(view)
            # Same values, new storage: a write for every other chunk
            # that recorded this weight's version.
            w.version += 1
        ch.weights = ws
        ch.wver = [w.version for w in ws]

    def _install_views(self, ch, group, states):
        ch.views, ch.state_objs = [], []
        if not ch.k:
            return
        ctx = ch.weights[0].context
        for i, e in enumerate(group):
            views = tuple(
                _FlatView(ch, j, ch.offsets[i], ch.sizes[i], ch.shapes[i],
                          ctx) for j in range(ch.k))
            if ch.mp:
                # The (inner_state, master) nesting of the loop path.
                inner = views[:ch.base_k]
                inner_obj = None if ch.base_k == 0 else \
                    inner[0] if ch.base_k == 1 else inner
                obj = (inner_obj, views[ch.base_k])
            else:
                obj = views[0] if ch.k == 1 else views
            states[e[0]] = obj
            ch.views.append(views)
            ch.state_objs.append(obj)

    def _sync_chunk(self, ch, group, states):
        """Keep the flat buffers when nothing wrote around the fused path
        since the last apply (NDArray versions, state-entry identity, no
        written view); otherwise re-flatten from the LIVE updater states
        (a load_states in between must win). Returns False when the live
        state layout no longer fits the family (caller falls back)."""
        ws = [e[1] for e in group]
        fresh = (not ch.stale and ch.flat_w is not None
                 and ch.weights is not None
                 and all(a is b for a, b in zip(ch.weights, ws))
                 and all(w.version == v for w, v in zip(ws, ch.wver)))
        if fresh and ch.k:
            fresh = all(states[e[0]] is so
                        for e, so in zip(group, ch.state_objs))
        if fresh:
            return True
        sts = [self._state_for(states[e[0]], ch) for e in group]
        if any(s is None for s in sts):
            return False
        self._flatten(ch, ws, sts)
        self._install_views(ch, group, states)
        ch.hyp_host = None
        ch.stale = False
        return True

    def _run_chunk(self, spec, ch, group, opt, grad_scale=None):
        """Sync + apply + commit one chunk. Returns [] or the group's
        (index, weight, grad) triples when it must fall back."""
        from . import engine as _engine

        if not self._sync_chunk(ch, group, self.updater.states):
            return [(e[0], e[1], e[2]) for e in group]
        lrs, wds = [], []
        for e in group:
            index = e[0]
            # Host-side bookkeeping in loop-path order: count first, then
            # the per-index lr/wd (Adam's lr_t in Python floats).
            opt._update_count(index)
            lrs.append(spec.host_lr(opt, index, opt._get_lr(index)))
            wds.append(opt._get_wd(index))
        flat_w = ch.flat_w
        device = flat_w.device
        # The loop path computes in the master's dtype under mp.
        hdt = torch.float32 if ch.mp else flat_w.dtype
        last_lrs, last_wds = ch.hyp_host or (None, None)
        if lrs != last_lrs:
            ch.lr_t = ch.hyp(ch.lr_t, lrs, hdt, device)
        if wds != last_wds:
            ch.wd_t = ch.hyp(ch.wd_t, wds, hdt, device)
        ch.hyp_host = (lrs, wds)
        rescale = float(opt.rescale_grad)
        flat_s = ch.flat_s

        def apply():
            g = ch.cat([e[2]._data for e in group], group[0][2]._data.dtype)
            if grad_scale is not None:
                ch.scale_t = ch.hyp(ch.scale_t, [grad_scale], g.dtype,
                                    device)
                g = g * ch.scale_t
            new_w, new_s = spec.body(flat_w, g, tuple(flat_s), ch.lr_t,
                                     ch.wd_t, rescale)
            flat_w.copy_(new_w)
            for buf, ns in zip(flat_s, new_s):
                buf.copy_(ns)

        with torch.no_grad():
            _dispatch("trainer::fused_apply", apply, optimizer=spec.name,
                      params=len(group))
        wver = []
        for e in group:
            w = e[1]
            w.version += 1
            wver.append(w.version)
        ch.wver = wver
        if _engine.is_naive():
            _engine.wait_for_var(flat_w)
        return []

    # -- public ----------------------------------------------------------------

    def open_guard_window(self):
        """The JAX package's numeric-guard window. The guard is ROADMAP
        Queue 1 item 9; with none installed there is nothing to arm."""
        if self.grad_guard is not None:
            raise NotImplementedError(
                "the numeric grad guard (telemetry.numerics) is not ported "
                "yet: ROADMAP Queue 1 item 9")

    close_guard_window = open_guard_window

    def apply(self, entries, grad_scale=None):
        """Fused-apply ``[(index, weight, grad)]``; returns the subset of
        entries that must take the per-parameter fallback loop.

        ``grad_scale``: optional runtime scalar multiplying every gradient
        (the Trainer's global-norm clip), rounded to the gradient dtype
        as the Trainer's loop path rounds it."""
        opt = self.updater.optimizer
        base_spec = _spec_for(opt)
        if base_spec is None or not entries:
            return list(entries)
        self.open_guard_window()
        pk = (len(entries), entries[0][0], entries[-1][0])
        plan = self._plans.get(pk)
        if plan is not None and plan[0] == base_spec.name \
                and plan[1] == base_spec.statics \
                and len(entries) == plan[2] \
                and all(e[0] == p[0] and e[1] is p[1] and e[2] is p[2]
                        for e, p in zip(entries, plan[3])):
            pending = list(plan[5])
            for spec, ch, group in plan[4]:
                pending.extend(self._run_chunk(spec, ch, group, opt,
                                               grad_scale))
            return pending

        states = self.updater.states
        mp_spec = None
        pending, groups = [], {}
        for index, weight, grad in entries:
            if index not in states:
                # The creation seam of Updater.__call__, so the loop path
                # and checkpoints see identical state layouts.
                states[index] = opt.create_state_multi_precision(
                    index, weight)
                self.updater.states_synced[index] = True
            if not weight._data.is_floating_point():
                pending.append((index, weight, grad))
                continue
            spec = None
            if self._state_tuple(states[index], base_spec.n_states) \
                    is not None:
                spec = base_spec
            elif getattr(opt, "multi_precision", False):
                if mp_spec is None:
                    mp_spec = _mp_spec(base_spec)
                if self._state_tuple_mp(states[index],
                                        mp_spec.base_k) is not None:
                    spec = mp_spec
            if spec is None:
                pending.append((index, weight, grad))
                continue
            gk = (weight._ctx, weight._data.dtype, grad._data.dtype)
            groups.setdefault((spec, gk), []).append((index, weight, grad))

        max_bytes = bucket_bytes()
        chunks = []
        for (spec, gk), group in groups.items():
            itemsize = gk[1].itemsize
            for part in _pack_by_bytes(
                    group, max_bytes,
                    lambda e: (e[1].size or 1) * itemsize):
                shapes = tuple(e[1].shape for e in part)
                # The indices belong to the signature: a chunk owns its
                # parameters' storage.
                sig = (spec.name, spec.statics, gk, shapes,
                       tuple(e[0] for e in part))
                ch = self._chunks.get(sig)
                if ch is None:
                    ch = self._build_chunk(spec, sig, shapes)
                chunks.append((spec, ch, part))
        while len(self._plans) > 64:
            self._plans.pop(next(iter(self._plans)))
        self._plans[pk] = (base_spec.name, base_spec.statics, len(entries), list(entries), chunks,
                           list(pending))
        pending = list(pending)
        for spec, ch, part in chunks:
            pending.extend(self._run_chunk(spec, ch, part, opt, grad_scale))
        return pending
