"""Batched forward kinematics: the plain version ``fk`` (the counterpart
of the JAX engine's) and the CUDA kernel K5.

Port of egopose_tpu/physics/fk_pallas.py: the Pallas kernel ``_fk_kernel``
(body ``_fk_compute``, launched by ``fk_batched_tpu``) becomes the
hand-written CUDA C++ kernel in ``csrc/fk.cu``, one warp per environment:
the model's tables, a flat per-hinge schedule built here (``build_tables``),
are staged in shared memory, each body's transform relative to its parent
is formed off the walk, and the walk composes them along each body's
ancestor path.

``fk_batched`` dispatches on the tensor's device: a CUDA batch launches the
kernel, a CPU batch runs ``fk``.  There is no fallback from CUDA to the
plain version: a dtype or shape the kernel does not take raises.  Which
engine paths take which FK is stated in physics/engine.py.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import quat as Q
from . import nvcc
from .model import PhysicsModel

# Launch count of the kernel: incremented once per launch, nowhere else.
launches = 0

# Field order of the ``FkDims`` struct in csrc/fk.cu.
DIM_FIELDS = ("nb nd nq nh n_int n_float i_path_off i_path_idx i_hinge_off "
              "i_hdof i_hqadr i_hpar f_body_pos f_body_ipos f_haxis "
              "f_hanchor").split()
WARPS = 4             # environments (warps) per block (csrc/fk.cu)

_lib = None


def reset_launches():
    global launches
    launches = 0


class Kin(NamedTuple):
    """World-frame kinematic state of all bodies (batched)."""
    xpos: torch.Tensor    # (B,nb,3) body frame origins
    xquat: torch.Tensor   # (B,nb,4) body frame orientations
    com: torch.Tensor     # (B,nb,3) body coms (world)
    s: torch.Tensor       # (B,nd,6) joint motion subspaces (world)


def fk(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """World pose of every body + joint motion subspaces (a loop over tree
    depth, batched within a level).  Within a body, hinges apply
    sequentially about their local axis/anchor (MuJoCo)."""
    nb, nd = m.nbody, m.ndof
    bsz = qpos.shape[0]
    dt = qpos.dtype
    qpos_pad = torch.cat([qpos, qpos.new_zeros(bsz, 1)], 1)
    # one dummy tail row so padded slots write nowhere
    xpos = qpos.new_zeros(bsz, nb + 1, 3)
    xquat = qpos.new_zeros(bsz, nb + 1, 4)
    xquat[..., 0] = 1.0
    s = qpos.new_zeros(bsz, nd + 1, 6)

    root_q = Q.quat_normalize(qpos[:, 3:7])
    r0t = Q.quat_to_mat(root_q).transpose(-1, -2)     # rows = local axes
    xpos[:, 0] = qpos[:, :3]
    xquat[:, 0] = root_q
    s[:, 0:3, 3:] = torch.eye(3, dtype=dt, device=qpos.device)
    s[:, 3:6, :3] = r0t
    s[:, 3:6, 3:] = Q.cross(qpos[:, None, :3].expand(bsz, 3, 3), r0t)

    for body, parent, bodypos, axis, anchor, qidx, didx in m.levels:
        wq = xquat[:, parent]                          # (B,n,4)
        wt = xpos[:, parent] + Q.quat_rotate(wq, bodypos)
        for k in range(3):                             # hinge slots
            a = axis[:, k]
            c = anchor[:, k]
            angle = qpos_pad[:, qidx[:, k]]            # (B,n)
            axis_w = Q.quat_rotate(wq, a)
            anchor_w = wt + Q.quat_rotate(wq, c)
            s[:, didx[:, k]] = torch.cat([axis_w, Q.cross(anchor_w, axis_w)],
                                         -1)
            wq = Q.quat_mul(wq, Q.axis_angle_to_quat(a, angle))
            wt = anchor_w - Q.quat_rotate(wq, c)
        xpos[:, body] = wt
        xquat[:, body] = wq
    xpos, xquat, s = xpos[:, :nb], xquat[:, :nb], s[:, :nd]
    com = xpos + Q.quat_rotate(xquat, m.body_ipos)
    return Kin(xpos=xpos, xquat=xquat, com=com, s=s)


def build_tables(m: PhysicsModel):
    """Per-model kernel tables: (dims dict, int32 table, float64 table).
    Per body, the range of its hinges and its ancestor path from the root's
    first child down to itself (CSR); per hinge, in body order and each
    body's hinge order, its dof, its qpos address, the parent of its body,
    its axis and anchor; and the body offsets and com offsets.  The kernel
    stages both tables whole in shared memory."""
    nb, nd = m.nbody, m.ndof
    parent = np.array(m.parent, np.int64)
    dof_body = np.array(m.dof_body, np.int64)
    if nb < 2 or nd < 6 or (parent[1:] >= np.arange(1, nb)).any() \
            or (dof_body[:6] != 0).any() or (dof_body[6:] == 0).any():
        raise NotImplementedError(
            "the FK kernel needs a free root (dofs 0-5 on body 0), hinges "
            "on the other bodies, and every body after its parent")
    hinges = [[d for d in range(6, nd) if dof_body[d] == b]
              for b in range(nb)]
    paths = []
    for b in range(nb):
        path = []
        while b > 0:
            path.append(b)
            b = int(parent[b])
        paths.append(path[::-1])
    qadr = np.zeros(nd, np.int64)
    for *_, qidx, didx in m.levels:
        for q, d in zip(qidx.cpu().numpy().ravel(), didx.cpu().numpy().ravel()):
            if d < nd:
                qadr[d] = q
    hdof = [d for h in hinges for d in h]
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()
    path_off = np.cumsum([0] + [len(p) for p in paths])
    ints = [("path_off", path_off), ("path_idx", [b for p in paths for b in p]),
            ("hinge_off", np.cumsum([0] + [len(h) for h in hinges])),
            ("hdof", hdof), ("hqadr", qadr[hdof]),
            ("hpar", parent[dof_body[hdof]])]
    floats = [("body_pos", f64(m.body_pos)), ("body_ipos", f64(m.body_ipos)),
              ("haxis", f64(m.dof_axis)[hdof]),
              ("hanchor", f64(m.dof_anchor)[hdof])]
    dims = dict(nb=nb, nd=nd, nq=m.nq, nh=len(hdof))
    itab, off = [], 0
    for name, a in ints:
        dims["i_" + name] = off
        a = np.asarray(a, np.int64).ravel()
        itab.append(a)
        off += a.size
    dims["n_int"] = off
    ftab, off = [], 0
    for name, a in floats:
        dims["f_" + name] = off
        a = np.asarray(a, np.float64).ravel()
        ftab.append(a)
        off += a.size
    dims["n_float"] = off
    return (dims, np.concatenate(itab).astype(np.int32),
            np.concatenate(ftab))


def block_bytes(dims: dict, itemsize: int) -> int:
    """Shared memory of one block (csrc/fk.cu's block_bytes): the float
    table, WARPS environments' values and the int table."""
    nb, nd = dims["nb"], dims["nd"]
    per = dims["nq"] + 4 * dims["nh"] + 17 * nb + 6 * nd
    return (dims["n_float"] + WARPS * per) * itemsize + 4 * dims["n_int"]


def _device_tables(m: PhysicsModel, device, dtype):
    key = ("fk", str(device), dtype)
    if key not in m.kernel_cache:
        dims, itab, ftab = build_tables(m)
        m.kernel_cache[key] = (
            (ctypes.c_int * len(DIM_FIELDS))(*[int(dims[f])
                                               for f in DIM_FIELDS]),
            torch.as_tensor(itab).to(device),
            torch.as_tensor(ftab).to(device=device, dtype=dtype))
    return m.kernel_cache[key]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(nvcc.build("fk.cu"))
        for name in ("egopose_fk_f32", "egopose_fk_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int] \
                + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.egopose_fk_occupancy.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.egopose_fk_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def occupancy(m: PhysicsModel, dtype) -> dict:
    """The kernel's resources on the current card for ``m``: blocks per
    SM, registers per thread, shared bytes per block, spill bytes,
    environments per block."""
    dims, _, _ = build_tables(m)
    out = (ctypes.c_int * 5)()
    err = _load().egopose_fk_occupancy(
        (ctypes.c_int * len(DIM_FIELDS))(*[int(dims[f]) for f in DIM_FIELDS]),
        len(DIM_FIELDS), int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"fk occupancy query failed: error {err}")
    return dict(blocks_per_sm=out[0], registers=out[1], shared_bytes=out[2],
                local_bytes=out[3], systems_per_block=out[4])


def fk_cuda(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """Launch the kernel: qpos (B,nq), a contiguous CUDA tensor of the
    model's float dtype -> Kin of new tensors."""
    global launches
    if qpos.dtype not in (torch.float32, torch.float64) \
            or qpos.dtype != m.dtype:
        raise ValueError(f"expected the model's dtype {m.dtype} (float32 or "
                         f"float64), got {qpos.dtype}")
    if not qpos.is_cuda or qpos.device != m.device or qpos.dim() != 2 \
            or qpos.shape[0] < 1 or qpos.shape[1] != m.nq \
            or not qpos.is_contiguous():
        raise ValueError(
            f"expected a contiguous CUDA tensor (B>=1, {m.nq}) on {m.device}, "
            f"got {tuple(qpos.shape)} on {qpos.device} (contiguous: "
            f"{qpos.is_contiguous()})")
    dims, itab, ftab = _device_tables(m, qpos.device, qpos.dtype)
    bsz, nb, nd = qpos.shape[0], m.nbody, m.ndof
    xpos = qpos.new_empty(bsz, nb, 3)
    xquat = qpos.new_empty(bsz, nb, 4)
    com = qpos.new_empty(bsz, nb, 3)
    s = qpos.new_empty(bsz, nd, 6)
    fn = _load().egopose_fk_f64 if qpos.dtype == torch.float64 \
        else _load().egopose_fk_f32
    err = fn(dims, len(DIM_FIELDS), itab.data_ptr(), ftab.data_ptr(),
             qpos.data_ptr(), xpos.data_ptr(), xquat.data_ptr(),
             com.data_ptr(), s.data_ptr(), bsz,
             torch.cuda.current_stream(qpos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fk kernel launch failed: error {err} (a CUDA error code; -1: "
            "dims mismatch, -2: the model needs more shared memory than the "
            "kernel takes)")
    launches += 1
    return Kin(xpos=xpos, xquat=xquat, com=com, s=s)


def fk_batched(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """World pose of every body + joint motion subspaces (Kin): the kernel
    on CUDA, fk on the CPU."""
    if not qpos.is_cuda:
        return fk(m, qpos)
    return fk_cuda(m, qpos.contiguous())
