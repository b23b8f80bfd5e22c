"""The LSTM's time loop as the CUDA kernels K6 (csrc/lstm.cu).

``recurrence(xg, wt, reverse)`` runs one or two LSTM directions over their
input projections, computed beforehand as one matmul over all steps:
``xg`` (T, B, ndir 4H) holds x W_ih^T + b_ih + b_hh of each direction side
by side, ``wt`` (ndir, H, 4H) each direction's W_hh^T, and ``reverse[d]``
walks direction d from step T-1 down.  It returns h (T, B, ndir H), the
directions side by side, from a zero carry; the gates are in
torch.nn.LSTMCell's (i, f, g, o) order.

Its autograd Function works under torch.autograd and under torch.func's
transforms.  Reverse mode (backward, torch.func.grad and vjp): the backward
kernel gives the pre-activation gate gradients dg, which are xg's
gradient, and W_hh^T's is one batched matmul of the shifted outputs with
dg; x's, W_ih's and the biases' follow from the projection's own autograd.
Forward mode (torch.func.jvp): the tangent kernel walks the recurrence
linearised at the forward's gates and c, from xg's tangent plus one
batched matmul of the shifted outputs with W_hh^T's tangent.  The backward
and tangent kernels have no derivatives of their own, so forward over
reverse (a jvp of a grad), reverse over forward and double backward raise.

The kernels take CUDA tensors alone: there is no plain version here (the
CPU runs models/rnn.py's loop of cells) and no fallback; a dtype or shape
the kernels do not take raises.  Where W_hh lives and how many batch rows
a thread takes are the library's decision (``occupancy`` reports it).
``launches`` counts the kernels' launches, forward, backward and tangent,
one a pass of both directions.
"""
from __future__ import annotations

import ctypes

import torch

from ..physics import nvcc

# Launch count of the kernels: incremented once per launch, nowhere else.
launches = 0

MAX_HID = 256   # the largest H the kernels take (csrc/lstm.cu)
KINDS = {"fwd": 0, "bwd": 1, "jvp": 2}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(nvcc.build("lstm.cu"))
        for kind in ("fwd", "bwd", "jvp"):
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"egopose_lstm_{kind}_{sfx}")
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                    + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.egopose_lstm_occupancy.argtypes = [ctypes.c_int] * 5 \
            + [ctypes.POINTER(ctypes.c_int)]
        lib.egopose_lstm_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def occupancy(batch: int, hid: int, ndir: int, dtype,
              kind: str = "fwd") -> dict:
    """One kernel's resources on the current card at a launch of B, H and
    ``ndir`` directions (``kind``: fwd, bwd or jvp): blocks per SM,
    registers per thread, shared bytes per block, spill bytes, batch rows
    per block and per thread, whether W_hh sits in shared memory."""
    out = (ctypes.c_int * 7)()
    err = _load().egopose_lstm_occupancy(
        int(dtype == torch.float64), KINDS[kind], batch, hid, ndir, out)
    if err != 0:
        raise RuntimeError(f"lstm occupancy query failed: error {err}")
    return dict(blocks_per_sm=out[0], registers=out[1], shared_bytes=out[2],
                local_bytes=out[3], rows_per_block=out[4],
                w_in_shared=bool(out[5]), rows_per_thread=out[6])


def _mask(reverse) -> int:
    return sum(1 << d for d, r in enumerate(reverse) if r)


def _check(xg, w_shape, tensors, reverse):
    """(T, B, ndir, H) of a launch over ``xg`` (T, B, ndir 4H) and W_hh^T
    of shape ``w_shape`` (ndir, H, 4H); raises on what the kernels do not
    take.  ``tensors`` must share xg's dtype and device, contiguous."""
    ndir = len(reverse)
    hid = w_shape[1] if len(w_shape) == 3 else 0
    if xg.dim() != 3 or ndir not in (1, 2) or len(w_shape) != 3 \
            or w_shape[0] != ndir or not 1 <= hid <= MAX_HID \
            or w_shape[2] != 4 * hid or xg.shape[2] != ndir * 4 * hid:
        raise ValueError(
            f"expected xg (T, B, ndir 4H) and W_hh^T (ndir, H, 4H) for 1 or "
            f"2 directions and H in 1..{MAX_HID}, got {tuple(xg.shape)} and "
            f"{tuple(w_shape)} for {ndir} direction(s)")
    if xg.dtype not in (torch.float32, torch.float64) or not xg.is_cuda \
            or any(x.dtype != xg.dtype or x.device != xg.device
                   or not x.is_contiguous() for x in (xg, *tensors)):
        got = [(x.dtype, str(x.device), x.is_contiguous())
               for x in (xg, *tensors)]
        raise ValueError(f"expected contiguous float32 or float64 CUDA "
                         f"tensors of one dtype on one device, got {got}")
    return xg.shape[0], xg.shape[1], ndir, hid


def _launch(kind, ptrs, like, t, b, hid, reverse):
    """One launch of a kernel (``kind``) over five pointers."""
    global launches
    sfx = "f64" if like.dtype == torch.float64 else "f32"
    err = getattr(_load(), f"egopose_lstm_{kind}_{sfx}")(
        *ptrs, t, b, hid, len(reverse), _mask(reverse),
        torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"lstm {kind} kernel launch failed: error {err} (a CUDA error "
            "code; -1: a shape the kernel does not take, -2: more shared "
            "memory than a block may use)")
    launches += 1


def forward_cuda(xg, wt, reverse, keep: bool):
    """The forward kernel: (y, gates, c), gates and c only with ``keep``
    (else None)."""
    t, b, ndir, hid = _check(xg, wt.shape, (wt,), reverse)
    y = xg.new_empty(t, b, ndir * hid)
    gates = torch.empty_like(xg) if keep else None
    c = torch.empty_like(y) if keep else None
    if t and b:
        _launch("fwd", (xg.data_ptr(), wt.data_ptr(), y.data_ptr(),
                        gates.data_ptr() if keep else None,
                        c.data_ptr() if keep else None),
                xg, t, b, hid, reverse)
    return y, gates, c


def backward_cuda(dy, w, gates, c, reverse):
    """The backward kernel: dg (T, B, ndir 4H) from dy (T, B, ndir H), W_hh
    (ndir, 4H, H) and the forward's gates and c."""
    t, b, ndir, hid = _check(gates, w.transpose(1, 2).shape, (dy, w, c),
                             reverse)
    if not dy.shape == c.shape == (t, b, ndir * hid):
        raise ValueError(f"expected dy and c (T, B, ndir H) beside gates "
                         f"{tuple(gates.shape)}, got {tuple(dy.shape)} and "
                         f"{tuple(c.shape)}")
    dg = torch.empty_like(gates)
    if t and b:
        _launch("bwd", (dy.data_ptr(), w.data_ptr(), gates.data_ptr(),
                        c.data_ptr(), dg.data_ptr()), gates, t, b, hid,
                reverse)
    return dg


def tangent_cuda(tg, wt, gates, c, reverse):
    """The tangent kernel: dh (T, B, ndir H) from the tangent of the
    pre-activation gates outside the carry, tg (T, B, ndir 4H), W_hh^T
    (ndir, H, 4H) and the forward's gates and c."""
    t, b, ndir, hid = _check(tg, wt.shape, (wt, gates, c), reverse)
    if not gates.shape == tg.shape or c.shape != (t, b, ndir * hid):
        raise ValueError(f"expected gates (T, B, ndir 4H) and c (T, B, "
                         f"ndir H) beside tg {tuple(tg.shape)}, got "
                         f"{tuple(gates.shape)} and {tuple(c.shape)}")
    dh = c.new_empty(c.shape)
    if t and b:
        _launch("jvp", (tg.data_ptr(), wt.data_ptr(), gates.data_ptr(),
                        c.data_ptr(), dh.data_ptr()), tg, t, b, hid, reverse)
    return dh


def _shifted(y, reverse, hid):
    """Each step's carry h before it, in its direction's walk (zero at the
    walk's start): (T B, ndir, H)."""
    yv = y.view(y.shape[0], y.shape[1], len(reverse), hid)
    hp = torch.zeros_like(yv)
    for d, rev in enumerate(reverse):
        if rev:
            hp[:-1, :, d] = yv[1:, :, d]
        else:
            hp[1:, :, d] = yv[:-1, :, d]
    return hp.view(-1, len(reverse), hid)


class _FirstOrder(torch.autograd.Function):
    """A kernel of K6 inside another's derivative (torch.func hands a
    derivative rule wrapped tensors; a Function's forward gets them
    unwrapped), with no derivative of its own."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def _refuse(*_):
        raise RuntimeError(
            "K6's backward and tangent kernels have no derivatives of their "
            "own: forward over reverse (torch.func.jvp of a grad: TRPO with "
            "use_fim False), reverse over forward and double backward "
            "through an LSTM on CUDA are not taken")

    backward = jvp = _refuse


class _GateGrad(_FirstOrder):
    @staticmethod
    def forward(dy, wt, gates, c, reverse):
        return backward_cuda(dy.contiguous(), wt.transpose(1, 2).contiguous(),
                             gates, c, reverse)


class _Tangent(_FirstOrder):
    @staticmethod
    def forward(tg, wt, gates, c, reverse):
        return tangent_cuda(tg.contiguous(), wt.contiguous(), gates, c,
                            reverse)


class _Recurrence(torch.autograd.Function):
    @staticmethod
    def forward(xg, wt, reverse):
        return forward_cuda(xg.contiguous(), wt.contiguous(), reverse,
                            keep=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, wt, reverse = inputs
        y, gates, c = output
        ctx.reverse = reverse
        ctx.mark_non_differentiable(gates, c)
        ctx.set_materialize_grads(False)    # no zero gradients of gates, c
        ctx.save_for_backward(wt, y, gates, c)
        ctx.save_for_forward(wt, y, gates, c)

    @staticmethod
    def backward(ctx, dy, _dgates, _dc):
        if dy is None:
            return None, None, None
        wt, y, gates, c = ctx.saved_tensors
        ndir, hid = wt.shape[0], wt.shape[1]
        dg = _GateGrad.apply(dy, wt, gates, c, ctx.reverse)
        dwt = None
        if ctx.needs_input_grad[1]:
            hp = _shifted(y, ctx.reverse, hid)
            dwt = torch.bmm(hp.permute(1, 2, 0),
                            dg.reshape(-1, ndir, 4 * hid).transpose(0, 1))
        return dg, dwt, None

    @staticmethod
    def jvp(ctx, dxg, dwt, _):
        wt, y, gates, c = ctx.saved_tensors
        ndir, hid = wt.shape[0], wt.shape[1]
        tg = torch.zeros_like(gates) if dxg is None else dxg
        if dwt is not None:
            hp = _shifted(y, ctx.reverse, hid)
            tg = tg + torch.bmm(hp.transpose(0, 1), dwt).transpose(0, 1) \
                .reshape(gates.shape)
        return _Tangent.apply(tg, wt, gates, c, ctx.reverse), None, None


def recurrence(xg: torch.Tensor, wt: torch.Tensor, reverse) -> torch.Tensor:
    """h (T, B, ndir H) of the directions' recurrences on the card (module
    docstring).  Keeps the gates and c, for backward and for tangents, only
    where grad mode is on."""
    reverse = tuple(bool(r) for r in reverse)
    if torch.is_grad_enabled():
        return _Recurrence.apply(xg, wt, reverse)[0]
    return forward_cuda(xg.contiguous(), wt.contiguous(), reverse,
                        keep=False)[0]
