"""Sequence-parallel (time-sharded) context encoding over the ranks of a
mesh axis (counterpart of egopose_tpu/parallel/seqpar.py).

The convolutional context pass (the TemporalConvNet inside VideoStateNet /
VideoRegNet) is sharded along TIME: each rank encodes a contiguous chunk
of frames after a halo exchange of the net's receptive field with its
neighbours on the axis, then the chunks are gathered along the axis, so
every rank of the axis holds the whole output.  A dilated conv stack is
position-local, so the sharded pass equals the unsharded one: the zero
halos at the global edges coincide with the convolutions' zero padding,
and the nets' ``t_mask`` keeps the fake edge frames at zero after every
layer.

Both exchanges are differentiable (``torch.autograd.Function`` with the
adjoint written out), so the encode can run inside a loss: the halo's
gradient returns to the rank that owns those frames and is added there;
the gather's gradient keeps this rank's own slice, because the loss after
the gather runs on every rank of the axis alike.  The context net's
parameter gradients are then partial per rank and are summed over the
axis (rl/ppo.py).  Recurrent context nets (LSTM) are sequential in time
and are rejected.
"""
from __future__ import annotations

import torch

from . import mesh as meshlib


def tcn_halo(num_channels, kernel_size: int, causal: bool) -> tuple[int, int]:
    """Per-side receptive field of a TemporalConvNet (models/tcn.py): block i
    runs two kernel-``k`` convs at dilation 2**i, each reaching (k-1)*d/2 per
    side (non-causal) or (k-1)*d into the past (causal)."""
    left = right = 0
    for i in range(len(num_channels)):
        d = 2 ** i
        if causal:
            left += 2 * (kernel_size - 1) * d
        else:
            left += (kernel_size - 1) * d
            right += (kernel_size - 1) * d
    return left, right


class _Halo(torch.autograd.Function):
    """This rank's chunk with ``left`` frames of the previous rank's tail
    before it and ``right`` frames of the next rank's head after it (zeros
    at the axis' ends).  Backward: each halo's gradient goes back to its
    owner and is added to that rank's chunk gradient."""

    @staticmethod
    def forward(ctx, xl, mesh, axis, dim, left, right):
        n, r = mesh.size(axis), mesh.rank(axis)
        chunk = xl.shape[dim]
        ctx.args = (mesh, axis, dim, left, right, n, r, chunk)
        parts = []
        if left:
            tails = meshlib.all_gather(
                mesh, xl.narrow(dim, chunk - left, left), axis)
            parts.append(tails[r - 1] if r > 0 else torch.zeros_like(
                tails[0]))
        parts.append(xl)
        if right:
            heads = meshlib.all_gather(mesh, xl.narrow(dim, 0, right), axis)
            parts.append(heads[r + 1] if r < n - 1 else torch.zeros_like(
                heads[0]))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, left, right, n, r, chunk = ctx.args
        gx = g.narrow(dim, left, chunk).clone()
        if left:
            # rank r + 1's left halo is this rank's tail
            back = meshlib.all_gather(mesh, g.narrow(dim, 0, left), axis)
            if r < n - 1:
                gx.narrow(dim, chunk - left, left).add_(back[r + 1])
        if right:
            back = meshlib.all_gather(
                mesh, g.narrow(dim, left + chunk, right), axis)
            if r > 0:
                gx.narrow(dim, 0, right).add_(back[r - 1])
        return gx, None, None, None, None, None


class _Gather(torch.autograd.Function):
    """Every rank's chunk concatenated along ``dim``; backward keeps this
    rank's slice of the upstream gradient."""

    @staticmethod
    def forward(ctx, xl, mesh, axis, dim):
        ctx.args = (mesh.rank(axis), xl.shape[dim], dim)
        return torch.cat(meshlib.all_gather(mesh, xl, axis), dim)

    @staticmethod
    def backward(ctx, g):
        r, chunk, dim = ctx.args
        return g.narrow(dim, r * chunk, chunk), None, None, None


def encode_time_sharded(mesh, apply_fn, x, halo_left: int, halo_right: int,
                        axis: str = "data", time_axis: int = 1):
    """Run a position-local sequence net time-sharded over ``axis``.

    ``apply_fn(w, t_mask)`` maps a tensor with time on ``time_axis`` to an
    output with the SAME time length; ``halo_left``/``halo_right`` bound
    its receptive field per side.  ``t_mask`` (length = w's time extent,
    or None on the one-rank path) flags positions inside the true
    sequence: the net must keep activations at masked-out positions ZERO
    after every neighbourhood op.  ``x`` is the whole sequence, the same
    on every rank of the axis; returns the full-length output, equal to
    ``apply_fn(x, None)``, on each of them.  Under DP x SP a rank's lanes
    are already its data shard, and the exchange rides the ``axis`` group
    of its data slice (the JAX function's ``batch_axes`` has no
    counterpart).
    """
    n = mesh.size(axis)
    if n == 1:
        return apply_fn(x, None)
    t_len = x.shape[time_axis]
    pad = (-t_len) % n
    if pad:
        widths = [0, 0] * (x.dim() - 1 - time_axis) + [0, pad]
        x = torch.nn.functional.pad(x, widths)
    chunk = x.shape[time_axis] // n
    if chunk < max(halo_left, halo_right):
        raise ValueError(
            f"time chunk {chunk} < halo ({halo_left},{halo_right}): the "
            f"halo exchange only reaches mesh neighbours; use fewer devices "
            f"or longer sequences")
    r = mesh.rank(axis)
    xl = x.narrow(time_axis, r * chunk, chunk)
    xh = _Halo.apply(xl, mesh, axis, time_axis, halo_left, halo_right)
    gidx = r * chunk - halo_left + torch.arange(xh.shape[time_axis],
                                                device=x.device)
    t_mask = ((gidx >= 0) & (gidx < t_len)).to(x.dtype)
    out = apply_fn(xh, t_mask).narrow(time_axis, halo_left, chunk)
    out = _Gather.apply(out.contiguous(), mesh, axis, time_axis)
    return out.narrow(time_axis, 0, t_len) if pad else out


def _tcn_halo_of(net) -> tuple[int, int]:
    param = net.v_net_param or {}
    return tcn_halo(param.get("size", [64, net.v_hdim]),
                    param.get("kernel_size", 3), net.causal)


def vsnet_encode_sp(mesh, vs_net, windows, axis: str = "data"):
    """VideoStateNet context pass, time-sharded: (N, W, feat) windows ->
    (N, W - 2*v_margin, v_hdim), equal to ``vs_net(windows)``.  Only TCN
    context nets are position-local; LSTM is rejected."""
    if vs_net.v_net_type != "tcn":
        raise ValueError(
            "sequence-parallel context encoding requires a TCN context net "
            f"(got {vs_net.v_net_type!r}: recurrent nets are sequential in "
            "time)")
    halo_l, halo_r = _tcn_halo_of(vs_net)
    # the inner conv stack only -- margin trimming happens after the
    # exchange (trimming per shard would drop interior frames)
    out = encode_time_sharded(mesh, vs_net.encode_raw, windows, halo_l,
                              halo_r, axis=axis)
    return out[:, vs_net.v_margin:-vs_net.v_margin]


def vregnet_apply_sp(mesh, reg_net, x, train: bool = False,
                     axis: str = "data"):
    """VideoRegNet forward, time-sharded: (T, B, ...) frames/features ->
    (T, B, out_dim), equal to ``reg_net(x)`` in eval mode.  The CNN, MLP
    and output head are per-frame (receptive field 0); only the TCN
    temporal net needs the halo, so the whole model is position-local."""
    if train:
        raise ValueError(
            "sequence-parallel statereg forward is inference-only: "
            "train=True would need per-shard dropout masks, and independent "
            "per-shard masks could not equal the unsharded training forward "
            "this function promises -- run training forwards unsharded")
    if reg_net.v_net_type != "tcn":
        raise ValueError(
            "sequence-parallel statereg forward requires a TCN temporal net "
            f"(got {reg_net.v_net_type!r}: recurrent nets are sequential in "
            "time)")
    halo_l, halo_r = _tcn_halo_of(reg_net)
    return encode_time_sharded(mesh, reg_net, x, halo_l, halo_r, axis=axis,
                               time_axis=0)
