"""Contrib losses: NCE (noise-contrastive estimation).

Counterpart of ``mxnet_tpu/gluon/contrib/loss.py`` (reference:
example/nce-loss/, nce.py:nce_loss and its LSTM/word2vec scripts, which
ship NCE as example code built from primitive ops; here it is a reusable
Gluon loss).

NCE sidesteps the full-vocabulary softmax: for each position, score the
true class plus k noise samples with the output embedding matrix and
train a binary classifier true-vs-noise (Gutmann & Hyvarinen 2010). The
scoring is one small gather and a batched dot: no |V|-wide matmul.
"""
from __future__ import annotations

from ..loss import Loss, _apply_weighting

__all__ = ["NCELoss"]


class NCELoss(Loss):
    """Noise-contrastive estimation over an output embedding.

    Parameters
    ----------
    num_sampled : int
        Noise samples per true label (reference nce-loss scripts use
        5-25).
    num_classes : int
        Vocabulary size (for the uniform noise distribution).

    Inputs to ``forward``: `embed` (B, D) hidden vectors, `weight`
    (V, D) output embedding, `bias` (V,), `label` (B,) int targets,
    `noise` (B, num_sampled) pre-sampled noise class ids (sampling stays
    outside the loss, on the data path, as the reference samples).
    """

    def __init__(self, num_sampled=5, num_classes=None, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.num_sampled = num_sampled        # documented sampling width
        self.num_classes = num_classes        # noise distribution support

    def hybrid_forward(self, F, embed, weight, bias, label, noise,
                       sample_weight=None):
        lab = label.reshape((-1,))
        w_true = F.take(weight, lab)                           # (B, D)
        b_true = F.take(bias, lab)                             # (B,)
        s_true = (embed * w_true).sum(axis=1) + b_true
        w_noise = F.take(weight, noise)                        # (B, k, D)
        b_noise = F.take(bias, noise)                          # (B, k)
        s_noise = (embed.expand_dims(axis=1) * w_noise).sum(axis=2) \
            + b_noise                                          # (B, k)
        # binary logistic, stable log-sigmoid form:
        # -log sigmoid(s) = softplus(-s); -log(1-sigmoid(s)) = softplus(s)
        loss = F.Activation(-s_true, act_type="softrelu") \
            + F.Activation(s_noise, act_type="softrelu").sum(axis=1)
        return _apply_weighting(F, loss, self._weight, sample_weight)
