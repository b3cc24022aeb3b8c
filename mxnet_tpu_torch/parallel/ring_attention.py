"""Ring attention: exact attention over a sequence split on the sp ranks.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py`` (Liu et al.,
Ring Attention; blockwise online-softmax accumulation as in
FlashAttention). The sequence axis is split over the ranks of a group;
K/V blocks rotate around the ring, one ``batch_isend_irecv`` a step,
and after n-1 rotations every Q block has attended to the whole
sequence. The block math is the JAX package's: the same fp32 online
softmax as its ``_accumulate_block`` (``:35-55`` there), with blocks
wholly in a rank's future skipped under ``causal`` and the last held
block accumulated outside the loop, so its rotation is never sent.

Entry points:

- :func:`ring_attention` on the local sequence block, over an explicit
  group. Point-to-point messages are not differentiable in PyTorch (the
  JAX ``ppermute`` is), so it is a ``torch.autograd.Function``: the
  forward saves the block's output and log-sum-exp, and the backward
  runs the ring again, rotating K/V together with their dK/dV
  accumulators, so that each gradient arrives home after n rotations.
- :func:`ring_self_attention` over a mesh of ranks: the batch is split
  over ``dp`` (if present), the sequence over ``sp``; it returns the
  assembled result on every rank, and gradients with respect to the
  global inputs.
- :func:`blockwise_attention`: the same math on one device, scanned
  over K/V blocks.

Backends: NCCL sends CUDA tensors; gloo sends host tensors only, so a
CUDA tensor on a gloo group is staged through the host: that route is
counted in ``HOST_STAGED`` (one per message) and never taken under
NCCL.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

__all__ = ["ring_attention", "ring_self_attention", "blockwise_attention",
           "HOST_STAGED"]

_NEG = -1e30

# Point-to-point messages of CUDA tensors staged through the host (a
# gloo group); NCCL groups never stage.
HOST_STAGED = 0


def _accumulate_block(q, k, v, scale, m, l, acc, mask=None):
    """One online-softmax step (the JAX package's, in torch).

    q: (..., Tq, D); k/v: (..., Tk, D); m/l: (..., Tq); acc like q.
    mask (Tq, Tk) True = attend; masked probabilities are zeroed, so a
    fully masked row keeps its running (m, l, acc)."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = p * mask
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("...qk,...kd->...qd",
                                                   p, v)
    return m_new, l_new, acc_new


def _causal_mask(t, device):
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _rotate(tensors, group):
    """Send each tensor to the next rank of the ring and receive the
    previous rank's; returns the received tensors."""
    global HOST_STAGED
    ranks = tdist.get_process_group_ranks(group)
    n = len(ranks)
    me = tdist.get_rank(group=group)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    stage = tdist.get_backend(group) == "gloo" and \
        any(t.is_cuda for t in tensors)
    send = [t.detach().contiguous() for t in tensors]
    if stage:
        send = [t.cpu() for t in send]
        HOST_STAGED += 2 * len(send)
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(tdist.P2POp(tdist.isend, s, nxt, group))
        ops.append(tdist.P2POp(tdist.irecv, r, prv, group))
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        recv = [r.to(t.device) for r, t in zip(recv, tensors)]
    return recv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n = tdist.get_world_size(group=group)
        idx = tdist.get_rank(group=group)
        t_local = q.shape[-2]
        q32 = q.float()
        m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        acc = torch.zeros_like(q32)
        mask = _causal_mask(t_local, q.device) if causal else None
        kb, vb = k, v
        for step in range(n):
            src = (idx - step) % n
            # Blocks wholly in this rank's future are all masked: skip.
            if not causal or src <= idx:
                m, l, acc = _accumulate_block(
                    q32, kb.float(), vb.float(), scale, m, l, acc,
                    mask if causal and src == idx else None)
            if step < n - 1:
                kb, vb = _rotate([kb, vb], group)
        lsum = torch.clamp(l, min=1e-30)
        out = acc / lsum[..., None]
        lse = m + torch.log(lsum)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n = tdist.get_world_size(group=group)
        idx = tdist.get_rank(group=group)
        q32 = q.float()
        do = grad.float()
        delta = (do * out).sum(dim=-1)
        mask = _causal_mask(q.shape[-2], q.device) if causal else None
        dq = torch.zeros_like(q32)
        kb, vb = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            src = (idx - step) % n
            if not causal or src <= idx:
                k32, v32 = kb.float(), vb.float()
                s = torch.einsum("...qd,...kd->...qk", q32, k32) * scale
                p = torch.exp(s - lse[..., None])
                if causal and src == idx:
                    p = p * mask
                dv = dv + torch.einsum("...qk,...qd->...kd", p, do)
                dp = torch.einsum("...qd,...kd->...qk", do, v32)
                ds = p * (dp - delta[..., None])
                dq = dq + torch.einsum("...qk,...kd->...qd", ds, k32) * scale
                dk = dk + torch.einsum("...qk,...qd->...kd", ds, q32) * scale
            # The accumulators travel with their block: after the n-th
            # rotation each is home, on the rank its K/V came from.
            if step < n - 1:
                kb, vb, dk, dv = _rotate([kb, vb, dk, dv], group)
            else:
                dk, dv = _rotate([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def ring_attention(q, k, v, group=None, causal=False, scale=None):
    """Exact attention over a sequence split on `group` (default: the
    whole process group). q, k, v are this rank's LOCAL sequence blocks,
    (batch, heads, T_local, head_dim), block i on the group's rank i.
    Returns the local output block; differentiable."""
    if group is None:
        group = tdist.group.WORLD
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, bool(causal), float(scale))


def _block_slices(mesh, shape, sp_axis, dp_axis):
    b, _, t, _ = shape
    sp = mesh.axis_size(sp_axis)
    if t % sp:
        raise ValueError("sequence length %d not divisible by %d sp ranks"
                         % (t, sp))
    ts = t // sp
    i = mesh.axis_index(sp_axis)
    tsl = slice(i * ts, (i + 1) * ts)
    bsl = slice(0, b)
    if dp_axis in mesh.axis_names:
        dp = mesh.axis_size(dp_axis)
        if b % dp:
            raise ValueError("batch %d not divisible by %d dp ranks"
                             % (b, dp))
        bs = b // dp
        j = mesh.axis_index(dp_axis)
        bsl = slice(j * bs, (j + 1) * bs)
    return bsl, tsl


def _sum_over(t, groups):
    for g in groups:
        tdist.all_reduce(t, group=g)
    return t


class _Scatter(torch.autograd.Function):
    """This rank's block of a global tensor; the gradient of the global
    tensor is assembled from every rank's block."""

    @staticmethod
    def forward(ctx, x, bsl, tsl, groups):
        ctx.shape, ctx.bsl, ctx.tsl, ctx.groups = x.shape, bsl, tsl, groups
        return x[bsl, :, tsl].contiguous()

    @staticmethod
    def backward(ctx, grad):
        full = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        full[ctx.bsl, :, ctx.tsl] = grad
        return _sum_over(full, ctx.groups), None, None, None


class _Assemble(torch.autograd.Function):
    """The global tensor from every rank's block (zero-padded blocks
    summed: exact); the gradient of a block is its slice."""

    @staticmethod
    def forward(ctx, x, shape, bsl, tsl, groups):
        ctx.bsl, ctx.tsl = bsl, tsl
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full[bsl, :, tsl] = x
        return _sum_over(full, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.bsl, :, ctx.tsl].contiguous(), None, None, None, \
            None


def ring_self_attention(mesh, q, k, v, causal=False, scale=None,
                        sp_axis="sp", dp_axis="dp"):
    """Ring attention over a mesh of ranks: the batch is split over
    `dp_axis` (if present) and the sequence over `sp_axis`; q, k, v are
    the global (batch, heads, T, head_dim) tensors, the same on every
    rank. Returns the assembled global result on every rank; the
    gradients with respect to q, k and v are the global ones."""
    if not getattr(mesh, "over_ranks", False):
        raise ValueError("ring_self_attention needs a mesh over the ranks "
                         "of parallel.dist (make_mesh after "
                         "dist.initialize)")
    bsl, tsl = _block_slices(mesh, q.shape, sp_axis, dp_axis)
    groups = [mesh.group(sp_axis)]
    if dp_axis in mesh.axis_names and mesh.axis_size(dp_axis) > 1:
        groups.append(mesh.group(dp_axis))
    ql, kl, vl = (_Scatter.apply(a, bsl, tsl, groups) for a in (q, k, v))
    out = ring_attention(ql, kl, vl, mesh.group(sp_axis), causal, scale)
    return _Assemble.apply(out, q.shape, bsl, tsl, groups)


def blockwise_attention(q, k, v, block=128, causal=False, scale=None):
    """Memory-tiled exact attention on one device: the online-softmax
    accumulation scanned over K/V blocks of `block` keys."""
    b, h, tq, d = q.shape
    tk = k.shape[2]                     # cross-attention: tk may != tq
    scale = scale if scale is not None else d ** -0.5
    block = min(block, tk)
    if tk % block:
        raise ValueError("sequence length %d not divisible by block %d"
                         % (tk, block))
    q32 = q.float()
    m = torch.full((b, h, tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(q32)
    q_pos = torch.arange(tq, device=q.device)
    for j in range(tk // block):
        kj = k[:, :, j * block:(j + 1) * block].float()
        vj = v[:, :, j * block:(j + 1) * block].float()
        mask = None
        if causal:
            k_pos = j * block + torch.arange(block, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _accumulate_block(q32, kj, vj, scale, m, l, acc, mask)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
