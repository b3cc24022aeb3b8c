"""Contrib operators: the CTC loss.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py:17-124`` (reference:
src/operator/contrib/ctc_loss.cc, warp-ctc derived). The rest of that
file (FFT, count sketch, index copy, adaptive pooling, bilinear resize)
is ROADMAP Queue 1 item 11c.

``ctc_loss`` has two routes, chosen by the device of ``pred``:

- on the host, the plain version: the JAX package's log-space alpha
  recursion, vectorized over the batch and looped over time, with the
  gradient from autograd through the loop;
- on a CUDA card, ATen's CUDA CTC (``F.ctc_loss``; the JAX package
  computes this op in XLA, not in a Pallas kernel), with the blank index
  and the label padding translated to its convention. It runs its
  recursion in float64 over the log-softmax: in fp32 the log-space sums
  of a 100-frame sequence carry an absolute error of ~eps * |log p|,
  which put fp32 gradients 2x past the ``nn`` family's limit against
  float64 on an H100, and float64 costs the card little here.

Both give the JAX package's value where no alignment exists (the label,
with a blank between repeated symbols, needs more frames than the
sequence has): ``-_NEG_INF`` = 1e30, with a zero gradient, not ``inf``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["ctc_loss"]

_NEG_INF = -1e30


def _logsumexp3(a, b, c):
    """log(e^a + e^b + e^c), ``_NEG_INF`` where all three are below half
    of it. The discarded branch is made a finite log(1), so that its
    gradient is not 0/0 (as in the JAX package)."""
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= _NEG_INF / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    total = (torch.exp(a - m_safe) + torch.exp(b - m_safe)
             + torch.exp(c - m_safe))
    total = torch.where(dead, torch.ones_like(total), total)
    out = m_safe + torch.log(total)
    return torch.where(dead, torch.full_like(out, _NEG_INF), out)


def _ctc_plain(logp, lab, label_len, pred_len, blank):
    """-log p(label | logp) per sequence by the alpha recursion over the
    extended label (blanks between and around the symbols); the alpha of
    a sequence is frozen past its own length."""
    T, N, _ = logp.shape
    S = 2 * lab.shape[1] + 1
    dev = logp.device
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    s_idx = torch.arange(S, device=dev)
    s_valid = s_idx[None, :] < (2 * label_len + 1)[:, None]
    emit = torch.gather(logp, 2, ext[None].expand(T, N, S))
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext], dim=1)[:, :S]
    allow_skip = (s_idx[None, :] >= 2) & (ext != blank) & (ext != ext_m2)
    neg = torch.full((N, 2), _NEG_INF, dtype=logp.dtype, device=dev)
    first = (s_idx[None, :] == 0) | ((s_idx[None, :] == 1)
                                     & (label_len > 0)[:, None])
    alpha = torch.where(first, emit[0], neg[:, :1])
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha], dim=1)[:, :S]
        a2 = torch.where(allow_skip, torch.cat([neg, alpha], dim=1)[:, :S],
                         neg[:, :1])
        new = _logsumexp3(alpha, a1, a2) + emit[t]
        new = torch.where(s_valid, new, neg[:, :1])
        alpha = torch.where((t < pred_len)[:, None], new, alpha)
    end = (2 * label_len).clamp(max=S - 1)
    last_blank = torch.gather(alpha, 1, end[:, None])[:, 0]
    last_label = torch.where(
        label_len > 0,
        torch.gather(alpha, 1, (end - 1).clamp(min=0)[:, None])[:, 0],
        neg[:, 0])
    return -_logsumexp3(last_blank, last_label, neg[:, 0])


def _ctc_cuda(logp, lab, label_len, pred_len, blank):
    """The same loss through ATen's CTC, its recursion in float64. Rows
    with no alignment get the plain version's value and a zero gradient
    (``zero_infinity``)."""
    T, N, _ = logp.shape
    if lab.shape[1] == 0:  # ATen wants a target column to index
        lab = torch.full((N, 1), 1 if blank == 0 else 0, dtype=torch.int64,
                         device=logp.device)
    in_len = pred_len.clamp(1, T)  # frame 0 always counts, as in the plain
    width = torch.arange(lab.shape[1], device=lab.device)
    repeats = ((lab[:, 1:] == lab[:, :-1])
               & (width[None, 1:] < label_len[:, None])).sum(dim=1)
    impossible = in_len < label_len + repeats
    nll = F.ctc_loss(logp.double(), lab, in_len, label_len, blank=blank,
                     reduction="none", zero_infinity=True).to(logp.dtype)
    return torch.where(impossible, torch.full_like(nll, -_NEG_INF), nll)


@register("ctc_loss", aliases=("CTCLoss", "_contrib_ctc_loss",
                               "_contrib_CTCLoss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None,
             use_data_lengths=None, use_label_lengths=None,
             blank_label="last"):
    """CTC negative log-likelihood, (N,).

    pred : (T, N, C) unnormalized activations; log-softmax is taken
        inside, in fp32 (float64 for a float64 `pred`).
    label : (N, L). ``blank_label="last"``: the blank is C-1, labels are
        zero-based and padded with -1. ``"first"``: the blank is 0,
        labels are 1-based and padded with 0.
    pred_lengths, label_lengths : (N,) or None (T frames; the count of
        valid labels in each row).
    """
    T, N, C = pred.shape
    dtype = torch.float64 if pred.dtype == torch.float64 else torch.float32
    if pred.device.type == "meta":
        return torch.empty((N,), dtype=dtype, device=pred.device)
    logp = torch.log_softmax(pred.to(dtype), dim=-1)
    label = label.to(torch.int64)
    if blank_label == "last":
        blank = C - 1
        valid = label >= 0
        lab = torch.where(valid, label, torch.zeros_like(label))
    else:
        blank = 0
        valid = label > 0
        lab = torch.where(valid, label, torch.ones_like(label))
    if label_lengths is None:
        label_len = valid.sum(dim=1)
    else:
        label_len = label_lengths.to(device=pred.device, dtype=torch.int64)
    if pred_lengths is None:
        pred_len = torch.full((N,), T, dtype=torch.int64, device=pred.device)
    else:
        pred_len = pred_lengths.to(device=pred.device, dtype=torch.int64)
    if pred.is_cuda:
        return _ctc_cuda(logp, lab, label_len, pred_len, blank)
    return _ctc_plain(logp, lab, label_len, pred_len, blank)
