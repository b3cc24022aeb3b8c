"""The port's detection examples on the host, and the SSD slice as a
whole against the JAX package.

- ``train_ssd`` at the JAX package's test size (128 scenes, 8 epochs,
  b16: ``tests/test_examples_tools.py``) prints ``final-loss`` and its
  loss falls. Its recall is not compared: the JAX test of it is unsteady.
- ``train_rcnn`` prints its ``rpn_loss`` and ``rois`` lines.
- The slice: the example's ``SSDNet`` built in both packages, the JAX
  net's weights carried across (``gluon.utils.params_from_numpy``); the
  forward, ``MultiBoxTarget``, the loss, one ``gluon.Trainer`` step (SGD
  with momentum; the JAX Trainer with ``fused=False``) and
  ``MultiBoxDetection`` after it agree with the JAX package's. Values
  within RTOL and ATOL_REL * max|want| (fp32 in both), targets and the
  kept detections equal; the updated weights within UPDATE_RTOL of the
  update, plus one ulp of the weight (fp32 convolutions sum in another
  order in each package, and each rounds the new weight to fp32).
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.examples import train_ssd
from mxnet_tpu_torch.gluon.utils import params_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
RTOL, ATOL_REL = 1e-5, 1e-6
UPDATE_RTOL = 1e-4


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_ssd", os.path.join(ROOT, "examples", "train_ssd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, what, rtol=RTOL, atol_rel=ATOL_REL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def test_train_ssd_prints_final_loss_and_its_loss_falls(capsys):
    args = train_ssd.parse_args(["--num-examples", "128", "--num-epochs", "8",
                                 "--batch-size", "16", "--device", "cpu"])
    out = train_ssd.train(args)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("final-loss")]
    assert len(line) == 1
    assert float(line[0].split()[1]) == round(out["last"], 4)
    assert np.isfinite(out["last"]) and out["last"] < out["first"]


def test_train_rcnn_prints_rois_and_rpn_loss():
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.train_rcnn",
         "--steps", "6", "--batch-size", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "rois" in res.stdout and "rpn_loss" in res.stdout


def _ssd_loss_jax(cls_preds, loc_preds, box_t, box_m, cls_t):
    """The loss of examples/train_ssd.py, as it writes it."""
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    cls_loss = ce(cls_preds.reshape((-1, 2)), cls_t.reshape((-1,))).mean()
    adiff = ((loc_preds - box_t) * box_m).abs()
    loc_loss = jmx.nd.where(adiff > 1.0, adiff - 0.5,
                            0.5 * adiff * adiff).mean()
    return cls_loss + loc_loss


def test_the_ssd_slice_matches_jax():
    jex = _jax_example()
    x, y = jex.synthetic_scenes(8, 32, np.random.RandomState(0))
    opt = {"learning_rate": 0.05, "momentum": 0.9}

    jnet = jex.SSDNet(num_classes=1, num_anchors=3)
    jnet.initialize(jmx.init.Xavier())
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    jnet(jx)
    weights = {p.name: p.data().asnumpy()
               for p in jnet.collect_params().values()}
    tnet = train_ssd.SSDNet(num_classes=1, num_anchors=3)
    tnet.initialize(ctx=CPU)
    tx, ty = mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU)
    tnet(tx)
    params_from_numpy(tnet, weights, prefix=jnet.prefix)

    jtrainer = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt),
                              fused=False)
    ttrainer = gluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    with jautograd.record():
        janchors, jcls, jloc = jnet(jx)
        with jautograd.pause():
            jtargets = jmx.nd.contrib.MultiBoxTarget(
                janchors, jy, jcls.transpose((0, 2, 1)), overlap_threshold=0.5)
        jloss = _ssd_loss_jax(jcls, jloc, *jtargets)
    jloss.backward()
    jtrainer.step(1)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        tanchors, tcls, tloc = tnet(tx)
        with autograd.pause():
            ttargets = mx.nd.contrib.MultiBoxTarget(
                tanchors, ty, tcls.transpose((0, 2, 1)), overlap_threshold=0.5)
        tloss = train_ssd.ssd_loss(tcls, tloc, *ttargets, ce)
    tloss.backward()
    ttrainer.step(1)

    for what, g, w in (("anchors", tanchors, janchors), ("cls", tcls, jcls),
                       ("loc", tloc, jloc), ("loss", tloss, jloss)):
        _close(g.asnumpy(), w.asnumpy(), what)
    for what, g, w in zip(("box_target", "box_mask", "cls_target"),
                          ttargets, jtargets):
        if what == "box_target":
            _close(g.asnumpy(), w.asnumpy(), what)
        else:
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    jnew = {p.name: p.data().asnumpy()
            for p in jnet.collect_params().values()}
    tnew = {n: p.data().asnumpy() for n, p in tnet.collect_params().items()}
    from mxnet_tpu_torch.gluon.utils import relative_names

    jrel = relative_names(list(jnew), jnet.prefix)
    trel = relative_names(list(tnew), tnet.prefix)
    jby = {jrel[n]: (weights[n], v) for n, v in jnew.items()}
    for name, v in tnew.items():
        before, want = jby[trel[name]]
        # The update itself, relative to its own size, give or take one
        # unit in the last place of the stored weights: each package
        # rounds before + update to fp32, and their updates differ in
        # the last bits, so the two roundings may land one ulp apart.
        got_up, want_up = v - before, want - before
        ulp = np.spacing(np.maximum(np.abs(v), np.abs(want)))
        atol = UPDATE_RTOL * max(float(np.abs(want_up).max()), 1e-30) + ulp
        bad = np.abs(got_up - want_up) > atol + UPDATE_RTOL * np.abs(want_up)
        assert not bad.any(), (name + " update", int(bad.sum()),
                               float(np.abs(got_up - want_up)[bad].max()))

    janchors, jcls, jloc = jnet(jx)
    tanchors, tcls, tloc = tnet(tx)
    jdet = jmx.nd.contrib.MultiBoxDetection(
        jcls.softmax(axis=-1).transpose((0, 2, 1)), jloc, janchors,
        nms_threshold=0.45, threshold=0.01).asnumpy()
    tdet = mx.nd.contrib.MultiBoxDetection(
        tcls.softmax(axis=-1).transpose((0, 2, 1)), tloc, tanchors,
        nms_threshold=0.45, threshold=0.01).asnumpy()
    np.testing.assert_array_equal(tdet[..., 0] >= 0, jdet[..., 0] >= 0)
    _close(tdet, jdet, "MultiBoxDetection", rtol=1e-4, atol_rel=1e-5)
