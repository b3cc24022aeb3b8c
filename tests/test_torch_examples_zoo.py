"""The port's copies of the examples that the layers, losses and model
zoo of the core surface's second half unblock, run in-process on the
host at the JAX package's test sizes (``tests/test_examples_tools.py``)
or smaller: each prints its keys and its loss falls. And
``train_imagenet.build_net`` builds every network it lists.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples import (adversarial_fgsm, bi_lstm_sort,
                                      cnn_text_classification, neural_style,
                                      train_autoencoder, train_ctc_ocr,
                                      train_fcn_segmentation, train_gan,
                                      train_imagenet, train_multi_task)

torch.set_num_threads(2)

CPU = mx.cpu()


def _falls(values):
    return np.isfinite(values[-1]) and values[-1] < values[0]


def test_train_gan(capsys):
    out = train_gan.run(epochs=2, batches=4, batch_size=16, ctx=CPU)
    text = capsys.readouterr().out
    assert "d_loss" in text and "fake mean" in text
    # An untrained discriminator outputs ~0: 2 ln 2 per (real, fake) pair.
    assert out["d_loss"][-1] < 2 * np.log(2)


def test_train_autoencoder(capsys):
    out = train_autoencoder.run(epochs=5, ctx=CPU)
    assert "recon_loss" in capsys.readouterr().out
    assert out["recon_loss"][-1] < 0.75 * out["recon_loss"][0]


def test_train_fcn_segmentation(capsys):
    out = train_fcn_segmentation.run(epochs=6, ctx=CPU)
    assert "mean-IoU" in capsys.readouterr().out
    assert _falls(out["loss"]) and out["mean_iou"][-1] >= 0.5


def test_cnn_text_classification(capsys):
    out = cnn_text_classification.run(epochs=3, train=1024, ctx=CPU)
    assert "val-acc" in capsys.readouterr().out
    assert _falls(out["loss"]) and out["val_acc"][-1] >= 0.85


def test_train_ctc_ocr(capsys):
    out = train_ctc_ocr.run(steps=40, batch_size=16, ctx=CPU)
    text = capsys.readouterr().out
    assert "ctc_loss" in text and "exact-sequence" in text
    assert out["ctc_loss"][-1] < 0.9 * out["ctc_loss"][0]


def test_neural_style(capsys):
    out = neural_style.run(steps=40, ctx=CPU)
    assert "total loss" in capsys.readouterr().out
    assert out["loss"][-1] < 0.7 * out["loss"][0]


def test_adversarial_fgsm(capsys):
    out = adversarial_fgsm.run(epochs=3, train=256, test=128, ctx=CPU)
    assert "adversarial accuracy" in capsys.readouterr().out
    assert _falls(out["loss"]) and out["adv_acc"] < out["clean_acc"] - 0.1


def test_train_multi_task(capsys):
    out = train_multi_task.run(epochs=4, ctx=CPU)
    text = capsys.readouterr().out
    assert "quad-acc" in text and "xpos-mae" in text
    assert _falls(out["loss"])


def test_bi_lstm_sort(capsys):
    out = bi_lstm_sort.run(steps=100, batch_size=16, ctx=CPU)
    assert "sorted-position accuracy" in capsys.readouterr().out
    assert _falls(out["perplexity"]) and out["accuracy"] >= 0.5


def test_main_parses_the_jax_arguments(capsys):
    """The command line of the JAX counterpart, plus ``--device cpu``."""
    out = train_gan.main(["--epochs", "1", "--batches", "2",
                          "--batch-size", "8", "--device", "cpu"])
    assert "d_loss" in capsys.readouterr().out and len(out["d_loss"]) == 1


@pytest.mark.parametrize("network", train_imagenet._NETWORKS)
def test_train_imagenet_builds_every_network(network):
    side = 299 if network == "inception-v3" else 64
    with CPU, mx.autograd.pause():
        net = train_imagenet.build_net(network, 10, ctx=CPU)
        out = net(mx.nd.ones((1, 3, side, side)))
    assert out.shape == (1, 10)
