"""The substep-resident stable-PD control step as one CUDA kernel launch.

Port of egopose_tpu/physics/substep_pallas.py: ``_substep_kernel`` (reached
through ``_substep_tpu`` and ``make_substep_step``) becomes the hand-written
CUDA C++ kernel in ``csrc/substep.cu``, one thread block per environment,
running all ``n_frames`` substeps of one 30 Hz control step with the lane's
working set in shared memory.  This module builds the kernel's per-model
tables (the counterpart of ``_build_static`` / ``_packed_consts`` /
``_packed_pair_consts`` and of ldl_pallas's ancestor lists), compiles the
kernel with nvcc at first use, and launches it through ctypes.

Dispatch (engine.pd_control_step, the counterpart of make_substep_step):
with ``ContactParams.substep_resident`` (the default) a CUDA batch runs the
kernel at any B >= 1; a CPU batch runs the plain split path
(engine.pd_control_step_split).  There is no fallback from CUDA to the
plain version: a model the kernel does not support raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import engine, nvcc
from .model import PhysicsModel

# Launch count of the kernel: incremented once per launch, nowhere else.
launches = 0

# Field order of the ``Dims`` struct in csrc/substep.cu (ints only).
DIM_FIELDS = (
    "nb nd nq nu ncp npair nbpair k kp c3 nnz nlevel "
    "n_frames prep_refresh iters "
    "i_parent i_dof_body i_hinge0 i_nhinge i_lvl_off i_lvl_body "
    "i_path_off i_path_idx i_vp_off i_vp_idx i_desc_off i_desc_idx "
    "i_anc_off i_anc_idx i_ent_row i_banc i_cp_body "
    "i_p_b1 i_p_b2 i_bp_seg i_bp_box "
    "f_body_pos f_body_ipos f_mass f_inertia f_axis f_anchor "
    "f_armature f_damping f_stiffness f_lo f_hi f_limited f_gear "
    "f_gravity f_cp_local f_cp_radius f_cp_mu "
    "f_p_a1 f_p_b1 f_p_a2 f_p_b2 f_p_rsum f_p_rdiff "
    "f_bp_a f_bp_b f_bp_rseg f_bp_pos f_bp_quat f_bp_half f_scal").split()

MAX_ROWS = 32         # contact rows: the kernel's sweep runs in one warp


def reset_launches():
    global launches
    launches = 0


def supports(m: PhysicsModel) -> bool:
    """The kernel assumes one actuator per hinge dof in dof order (every
    create_humanoid model, the EgoPose humanoid included) and at least one
    hinge dof -- the JAX kernel's condition (substep_pallas.py:55-62)."""
    return m.ndof > 6 and tuple(m.actuator_dof) == tuple(range(6, m.ndof))


def _csr(rows):
    """Ragged int lists -> (offsets (n+1,), flat indices)."""
    off = np.zeros(len(rows) + 1, np.int64)
    off[1:] = np.cumsum([len(r) for r in rows])
    idx = np.array([i for r in rows for i in r], np.int64)
    return off, idx


def dof_anc_lists(anc_mask: np.ndarray) -> tuple:
    """Per-dof ancestor lists of the compressed LDL^T (ldl_pallas.py:38-46):
    anc[d] = ascending dofs j < d with M[d,j] structurally nonzero."""
    n = anc_mask.shape[0]
    return tuple(tuple(int(j) for j in range(d)
                       if anc_mask[d, j] or anc_mask[j, d]) for d in range(n))


def build_tables(m: PhysicsModel, params: engine.ContactParams):
    """Per-model kernel tables: (dims dict without the per-call fields,
    int32 table, float64 table).  The kernel loops over these; nothing of
    the model is baked into its code."""
    if not supports(m):
        raise NotImplementedError(
            "the CUDA control-step kernel needs one actuator per hinge dof "
            "in dof order; the stable-PD split path for other actuator "
            "layouts runs on the CPU only (on the card it would hold K1's "
            "plain version against itself)")
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()
    nb, nd, nq, nu = m.nbody, m.ndof, m.nq, m.nu
    parent = np.array(m.parent, np.int64)
    dof_body = np.array(m.dof_body, np.int64)
    anc = f64(m.anc_mask) > 0.5
    body_dof = f64(m.body_dof_mask) > 0.5          # (nb,nd)
    desc = f64(m.body_desc_mask) > 0.5             # (nb,nb)
    vp = f64(m.vp_mask) > 0.5                      # (nd,nd)
    banc = desc.T.astype(np.int64)                 # banc[b,a]: a anc-or-self

    hinge0 = np.zeros(nb, np.int64)
    nhinge = np.zeros(nb, np.int64)
    for d in range(6, nd):
        b = dof_body[d]
        if nhinge[b] == 0:
            hinge0[b] = d
        elif hinge0[b] + nhinge[b] != d:
            raise NotImplementedError("a body's hinge dofs must be "
                                      "contiguous")
        nhinge[b] += 1
    depth = np.zeros(nb, np.int64)
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
    lvl_off, lvl_body = _csr([[b for b in range(1, nb) if depth[b] == lv]
                              for lv in range(1, int(depth.max()) + 1)])
    path_off, path_idx = _csr([np.nonzero(body_dof[b])[0] for b in range(nb)])
    vp_off, vp_idx = _csr([np.nonzero(vp[d])[0] for d in range(nd)])
    desc_off, desc_idx = _csr([np.nonzero(desc[b])[0] for b in range(nb)])
    anc_lists = dof_anc_lists(anc)
    # the factorization's aligned prefix updates need nested lists:
    # for j = anc[d][s], anc[j] == anc[d][:s] (ldl_pallas.py:19-25)
    for d in range(nd):
        for s, j in enumerate(anc_lists[d]):
            if anc_lists[j] != anc_lists[d][:s]:
                raise NotImplementedError("dof ancestor lists do not nest")
    anc_off, anc_idx = _csr(anc_lists)
    ent_row = np.repeat(np.arange(nd), np.diff(anc_off))
    k = min(params.max_contacts, m.ncpoint)
    kp = min(params.max_pair_contacts, m.npair + m.nbpair)
    c3 = 3 * k + kp
    if c3 > MAX_ROWS or k < 1:
        raise NotImplementedError(
            f"the kernel's one-warp sweep takes 1..{MAX_ROWS} contact rows "
            f"with at least one floor row, got {c3}")

    ints = [("parent", parent), ("dof_body", dof_body), ("hinge0", hinge0),
            ("nhinge", nhinge), ("lvl_off", lvl_off), ("lvl_body", lvl_body),
            ("path_off", path_off), ("path_idx", path_idx),
            ("vp_off", vp_off), ("vp_idx", vp_idx),
            ("desc_off", desc_off), ("desc_idx", desc_idx),
            ("anc_off", anc_off), ("anc_idx", anc_idx),
            ("ent_row", ent_row), ("banc", banc),
            ("cp_body", m.cpoint_body.cpu().numpy()),
            ("p_b1", m.pair_body1.cpu().numpy()),
            ("p_b2", m.pair_body2.cpu().numpy()),
            ("bp_seg", m.bpair_body_seg.cpu().numpy()),
            ("bp_box", m.bpair_body_box.cpu().numpy())]
    p = params
    floats = [("body_pos", f64(m.body_pos)), ("body_ipos", f64(m.body_ipos)),
              ("mass", f64(m.body_mass)), ("inertia", f64(m.body_inertia)),
              ("axis", f64(m.dof_axis)), ("anchor", f64(m.dof_anchor)),
              ("armature", f64(m.dof_armature)),
              ("damping", f64(m.dof_damping)),
              ("stiffness", f64(m.dof_stiffness)),
              ("lo", f64(m.jnt_range)[:, 0]), ("hi", f64(m.jnt_range)[:, 1]),
              ("limited", f64(m.jnt_limited_f)),
              ("gear", f64(m.actuator_gear)), ("gravity", f64(m.gravity)),
              ("cp_local", f64(m.cpoint_local)),
              ("cp_radius", f64(m.cpoint_radius)),
              ("cp_mu", f64(m.cpoint_mu)),
              ("p_a1", f64(m.pair_a1)), ("p_b1", f64(m.pair_b1)),
              ("p_a2", f64(m.pair_a2)), ("p_b2", f64(m.pair_b2)),
              ("p_rsum", f64(m.pair_rsum)), ("p_rdiff", f64(m.pair_rdiff)),
              ("bp_a", f64(m.bpair_a)), ("bp_b", f64(m.bpair_b)),
              ("bp_rseg", f64(m.bpair_rseg)),
              ("bp_pos", f64(m.bpair_boxpos)),
              ("bp_quat", f64(m.bpair_boxquat)),
              ("bp_half", f64(m.bpair_half)),
              ("scal", np.array([m.timestep, p.margin, p.beta, p.slop,
                                 p.klim, p.blim, p.relax]))]
    dims = dict(nb=nb, nd=nd, nq=nq, nu=nu, ncp=m.ncpoint, npair=m.npair,
                nbpair=m.nbpair, k=k, kp=kp, c3=c3, nnz=len(anc_idx),
                nlevel=len(lvl_off) - 1, iters=int(p.iters))
    itab, off = [], 0
    for name, a in ints:
        dims["i_" + name] = off
        a = np.asarray(a, np.int64).ravel()
        itab.append(a)
        off += a.size
    ftab, off = [], 0
    for name, a in floats:
        dims["f_" + name] = off
        a = np.asarray(a, np.float64).ravel()
        ftab.append(a)
        off += a.size
    return (dims, np.concatenate(itab).astype(np.int32),
            np.concatenate(ftab))


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

_lib = None


def build(verbose: bool = False) -> str:
    """Compile csrc/substep.cu with nvcc (route (b): plain C interface,
    loaded with ctypes) unless the library for this source exists."""
    return nvcc.build("substep.cu", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name in ("egopose_substep_f32", "egopose_substep_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int] \
                + [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_tables(m: PhysicsModel, params, device, dtype):
    key = (params, str(device), dtype)
    if key not in m.kernel_cache:
        dims, itab, ftab = build_tables(m, params)
        m.kernel_cache[key] = (
            dims, torch.as_tensor(itab).to(device),
            torch.as_tensor(ftab).to(device=device, dtype=dtype))
    return m.kernel_cache[key]


def pd_control_step_cuda(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd, tlim,
                         n_frames: int,
                         params: engine.ContactParams = engine.DEFAULT_CONTACT):
    """Launch the kernel: qpos (B,nq), qvel (B,nd), ctrl/jkp/jkd/tlim
    (B,nu), all contiguous CUDA tensors of one float dtype -> (qpos',
    qvel'), new tensors."""
    global launches
    bsz = qpos.shape[0]
    dtype = qpos.dtype
    shapes = ((qpos, m.nq), (qvel, m.ndof), (ctrl, m.nu), (jkp, m.nu),
              (jkd, m.nu), (tlim, m.nu))
    if dtype not in (torch.float32, torch.float64) or bsz < 1:
        raise ValueError(f"unsupported dtype/batch {dtype}, B={bsz}")
    for t, w in shapes:
        if not t.is_cuda or t.device != qpos.device or t.dtype != dtype \
                or tuple(t.shape) != (bsz, w) or not t.is_contiguous():
            raise ValueError(
                f"expected a contiguous {dtype} CUDA tensor of shape "
                f"({bsz}, {w}) on {qpos.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dims, itab, ftab = _device_tables(m, params, qpos.device, dtype)
    dims = dict(dims, n_frames=int(n_frames),
                prep_refresh=max(1, int(params.prep_refresh)))
    dim_arr = (ctypes.c_int * len(DIM_FIELDS))(
        *[int(dims[f]) for f in DIM_FIELDS])
    qpos_out = torch.empty_like(qpos)
    qvel_out = torch.empty_like(qvel)
    fn = _load().egopose_substep_f64 if dtype == torch.float64 \
        else _load().egopose_substep_f32
    err = fn(dim_arr, len(DIM_FIELDS), itab.data_ptr(), ftab.data_ptr(),
             qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(),
             jkp.data_ptr(), jkd.data_ptr(), tlim.data_ptr(),
             qpos_out.data_ptr(), qvel_out.data_ptr(), bsz,
             torch.cuda.current_stream(qpos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"substep kernel launch failed: error {err} (a CUDA error code; "
            "-1: dims mismatch, -2: the model needs more shared memory than "
            "a block may use)")
    launches += 1
    return qpos_out, qvel_out
