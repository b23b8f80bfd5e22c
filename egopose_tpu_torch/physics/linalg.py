"""Batched solves of the physics substep: the CUDA kernels K2, K3 and K4
and their plain versions.

Port of egopose_tpu/physics/linalg_pallas.py, each Pallas kernel a
hand-written CUDA C++ kernel:

- K2, ``_cho_solve_kernel_blocked`` (launched by ``_batched_spd_solve_tpu``
  from the ``custom_vmap`` rule of ``spd_solve``): the dense SPD solve, in
  ``csrc/spd_solve.cu``, one warp per system;
- K3, ``_fused_contact_kernel`` (``_fused_contact_tpu``): factor, the
  Delassus operator and the projected-Jacobi sweep -> v_new, in
  ``csrc/fused_contact.cu``, one warp per system, solving forward only
  (Z = L^-1 [dt qfrc | J^T], D = Z_c^T Z_c, one back substitution);
- K4, ``_pd_fused_kernel`` (``_pd_fused_tpu``): one stable-PD substep's
  PD solve, torque clamp, dynamics solve and sweep -> v_new, in the same
  file, two warps per system that factor the PD and the dynamics systems
  side by side.  K2, K3 and K4 share the one-warp factor of
  ``csrc/cholesky.cuh``.

``spd_solve``, ``fused_contact`` and ``pd_fused`` dispatch on the tensors'
device: a CUDA batch launches the kernel, a CPU batch runs the plain
version.  There is no fallback from CUDA to the plain version: a dtype or
size a kernel does not take raises.  physics/engine.py states which path
runs which kernel; called directly, its stable-PD split path
(engine.pd_control_step_split, K1's plain version) solves with
``spd_solve_plain`` on every device.
"""
from __future__ import annotations

import ctypes

import torch

from . import nvcc

# Launch counts of the kernels: each incremented once per launch of its
# kernel, nowhere else.  ``launches`` is K2's.
launches = 0
fused_contact_launches = 0
pd_fused_launches = 0

_libs = {}


def reset_launches():
    """Zero the launch counts of K2, K3 and K4."""
    global launches, fused_contact_launches, pd_fused_launches
    launches = fused_contact_launches = pd_fused_launches = 0


def spd_solve_plain(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense SPD solve A X = rhs, (B,n,n), (B,n,r) -> (B,n,r)."""
    return torch.cholesky_solve(rhs, torch.linalg.cholesky(a))


def contact_sweep_blocks(jf, w, target, mu, v_pred, iters, relax):
    """Projected-Jacobi sweep in block row order given the Delassus columns
    W = Minv J^T (B,nd,c): friction box on the first 3K rows, lambda >= 0 on
    the trailing frictionless pair rows.  Returns the post-contact
    velocity."""
    k = mu.shape[-1]
    c = jf.shape[1]
    a = jf @ w                                          # (B,c,c)
    bhat = (jf @ v_pred[..., None])[..., 0] - target
    # Gershgorin (row-sum) preconditioner keeps the sweep a contraction
    diag = torch.sum(torch.abs(a), -1) + 1.0e-9
    lam = v_pred.new_zeros(v_pred.shape[0], c)
    for _ in range(iters):
        g = (a @ lam[..., None])[..., 0] + bhat
        lam = lam - relax * g / diag
        ln = torch.clamp(lam[:, 2 * k:3 * k], min=0.0)
        lim = mu * ln
        parts = [torch.clamp(lam[:, :k], -lim, lim),
                 torch.clamp(lam[:, k:2 * k], -lim, lim), ln]
        if c > 3 * k:
            parts.append(torch.clamp(lam[:, 3 * k:], min=0.0))
        lam = torch.cat(parts, 1)
    return v_pred + (w @ lam[..., None])[..., 0]


def fused_contact_plain(a, qfrc, qvel, jf, target, mu, dt, iters, relax):
    """Fused dynamics + contact solve (the batched _fused_contact_single):
    a (B,n,n), qfrc/qvel (B,n), jf (B,c,n) in block row order, target (B,c),
    mu (B,k) -> v_new (B,n)."""
    sol = spd_solve_plain(a, torch.cat([qfrc[..., None],
                                        jf.transpose(1, 2)], 2))
    qacc, w = sol[..., 0], sol[..., 1:]
    v_pred = qvel + dt * qacc
    return contact_sweep_blocks(jf, w, target, mu, v_pred, iters, relax)


def pd_fused_plain(mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf,
                   target, mu, dt, iters, relax):
    """Fused stable-PD substep (the batched _pd_fused_single): mmat
    (B,n,n); kdd (B,n,2) = [jkd_full, dof_damping]; rhspd/e/jkp/jkd/tlim/
    gear/qfb/qvel (B,n); jf (B,c,n); target (B,c); mu (B,k) -> v_new (B,n)."""
    a_pd = mmat + dt * torch.diag_embed(kdd[..., 0])
    qacc = spd_solve_plain(a_pd, rhspd[..., None])[..., 0]
    torque = -jkp * e - jkd * (qvel + dt * qacc)
    torque = torch.clamp(torque, -tlim, tlim)
    qfrc = qfb + torque * gear
    a_dyn = mmat + dt * torch.diag_embed(kdd[..., 1])
    return fused_contact_plain(a_dyn, qfrc, qvel, jf, target, mu, dt, iters,
                               relax)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# K3's and K4's stage-clock build (``clocks=`` of their CUDA wrappers): per
# warp, clock64() at the start and at the end of each stage it runs, in
# the order of FUSED_STAGES (csrc/fused_contact.cu, ``ST_*``).
CLOCKS_DEFINE = "EGOPOSE_STAGE_CLOCKS"
FUSED_STAGES = ("start", "load", "factor", "gram", "wait", "z0", "prep",
                "sweep", "velocity", "pd_factor", "pd_back", "torque")


def fused_stage_cycles(clocks: torch.Tensor) -> torch.Tensor:
    """Stamps (warps, len(FUSED_STAGES)) of the stage-clock build -> the
    cycles of each stage per warp: a stage's stamp minus the warp's
    previous stamp (its stages run one after another); 0 for a stage the
    warp does not run and for ``start``."""
    t = clocks.to(torch.float64)
    ran = clocks != 0
    order = torch.where(ran, t, torch.full_like(t, float("inf"))).argsort(1)
    ts = t.gather(1, order)
    prev = torch.cat([ts[:, :1], ts[:, :-1]], 1)
    cyc = torch.where(ran.gather(1, order), ts - prev, torch.zeros_like(ts))
    return torch.zeros_like(t).scatter(1, order, cyc)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "spd_solve.cu": {"egopose_spd_solve": [_P] * 3 + [_I] * 3 + [_P]},
    "fused_contact.cu": {
        "egopose_fused_contact": [_P] * 7 + [_I] * 5 + [_D] * 2 + [_P],
        "egopose_pd_fused": [_P] * 14 + [_I] * 5 + [_D] * 2 + [_P]},
}


def _kernel(source: str, name: str, dtype: torch.dtype, defines=()):
    """The C entry ``name`` of ``source`` (built with ``defines``) for
    ``dtype`` (None: an entry without a dtype suffix), built at first
    use."""
    key = (source, tuple(defines))
    if key not in _libs:
        lib = ctypes.CDLL(nvcc.build((source, tuple(defines))))
        for stem, argtypes in _SIGNATURES[source].items():
            for sfx in ("_f32", "_f64"):
                fn = getattr(lib, stem + sfx)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[key] = lib
    if dtype is None:
        return getattr(_libs[key], name)
    sfx = "_f64" if dtype == torch.float64 else "_f32"
    return getattr(_libs[key], name + sfx)


_OCC_KEYS = ("blocks_per_sm", "registers", "shared_bytes", "local_bytes",
             "systems_per_block", "warps_per_system")


def _occupancy(source, name, sizes, dtype):
    fn = _kernel(source, name, None)
    fn.argtypes = [_I] * (len(sizes) + 1) + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * 6)(0, 0, 0, 0, 0, 1)
    _raise_on(fn(*sizes, int(dtype == torch.float64), out), name)
    return dict(zip(_OCC_KEYS, out))


def spd_solve_occupancy(n: int, r: int, dtype) -> dict:
    """K2's resources on the current card for (n, r): blocks per SM,
    registers per thread, shared bytes per block, spill bytes, systems
    per block (one warp each)."""
    return _occupancy("spd_solve.cu", "egopose_spd_solve_occupancy", (n, r),
                      dtype)


def fused_contact_occupancy(n: int, c: int, k: int, dtype) -> dict:
    """K3's resources on the current card for (n, c, k), as
    spd_solve_occupancy."""
    return _occupancy("fused_contact.cu", "egopose_fused_contact_occupancy",
                      (n, c, k), dtype)


def pd_fused_occupancy(n: int, c: int, k: int, dtype) -> dict:
    """K4's resources on the current card for (n, c, k), as
    spd_solve_occupancy (two warps per system)."""
    return _occupancy("fused_contact.cu", "egopose_pd_fused_occupancy",
                      (n, c, k), dtype)


def _check(what: str, shapes):
    """Every (tensor, shape) pair: a contiguous CUDA tensor of the first
    tensor's float dtype and device with exactly that shape."""
    t0 = shapes[0][0]
    if t0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: unsupported dtype {t0.dtype}")
    for t, shape in shapes:
        if not t.is_cuda or t.device != t0.device or t.dtype != t0.dtype \
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{what}: expected a contiguous {t0.dtype} CUDA tensor of "
                f"shape {tuple(shape)} on {t0.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: error {err} (a CUDA error code; "
            "-1: unsupported sizes, -2: the system needs more shared memory "
            "than a block may use)")


def _contact_sizes(what, jf, mu):
    if jf.dim() != 3 or mu.dim() != 2:
        raise ValueError(f"{what}: expected jf (B,c,n) and mu (B,k), got "
                         f"{tuple(jf.shape)} and {tuple(mu.shape)}")
    bsz, c, n = jf.shape
    k = mu.shape[1]
    if bsz < 1 or n < 1 or c < 1 or 3 * k > c:
        raise ValueError(f"{what}: needs B >= 1, n >= 1 and c >= 3k >= 0 "
                         f"contact rows, got B={bsz}, n={n}, c={c}, k={k}")
    return bsz, n, c, k


def spd_solve_cuda(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Launch K2: a (B,n,n), rhs (B,n,r), contiguous CUDA tensors of one
    float dtype -> X (B,n,r), a new tensor."""
    global launches
    if a.dim() != 3 or rhs.dim() != 3 or a.shape[1] != a.shape[2] \
            or rhs.shape[:2] != a.shape[:2] or a.shape[0] < 1 \
            or rhs.shape[2] < 1 or a.shape[1] < 1:
        raise ValueError(f"expected a (B,n,n) and rhs (B,n,r), got "
                         f"{tuple(a.shape)} and {tuple(rhs.shape)}")
    _check("spd_solve", [(a, a.shape), (rhs, rhs.shape)])
    bsz, n, r = rhs.shape
    x = torch.empty_like(rhs)
    fn = _kernel("spd_solve.cu", "egopose_spd_solve", a.dtype)
    _raise_on(fn(a.data_ptr(), rhs.data_ptr(), x.data_ptr(), bsz, n, r,
                 torch.cuda.current_stream(a.device).cuda_stream),
              "spd_solve")
    launches += 1
    return x


def _fused_entry(name, dtype, clocks, warps):
    """The C entry of K3 or K4; with ``clocks`` (an int64 CUDA tensor
    (``warps``, len(FUSED_STAGES))), the stage-clock build's, writing its
    stamps there."""
    if clocks is None:
        return _kernel("fused_contact.cu", name, dtype)
    defines = (CLOCKS_DEFINE,)
    if clocks.dtype != torch.int64 or not clocks.is_cuda \
            or not clocks.is_contiguous() \
            or tuple(clocks.shape) != (warps, len(FUSED_STAGES)):
        raise ValueError(f"clocks: a contiguous ({warps}, "
                         f"{len(FUSED_STAGES)}) int64 CUDA tensor")
    fn = _kernel("fused_contact.cu", "egopose_fused_clocks", None, defines)
    fn.argtypes = [_P]
    fn.restype = _I
    _raise_on(fn(clocks.data_ptr()), name)
    return _kernel("fused_contact.cu", name, dtype, defines)


def fused_contact_cuda(a, qfrc, qvel, jf, target, mu, dt, iters, relax,
                       clocks=None):
    """Launch K3 (arguments as fused_contact_plain; contiguous CUDA tensors
    of one float dtype) -> v_new (B,n), a new tensor.  With ``clocks`` (B,
    len(FUSED_STAGES)) int64, the stage-clock build, stamping there."""
    global fused_contact_launches
    bsz, n, c, k = _contact_sizes("fused_contact", jf, mu)
    _check("fused_contact", [(a, (bsz, n, n)), (qfrc, (bsz, n)),
                             (qvel, (bsz, n)), (jf, (bsz, c, n)),
                             (target, (bsz, c)), (mu, (bsz, k))])
    out = torch.empty_like(qvel)
    fn = _fused_entry("egopose_fused_contact", a.dtype, clocks, bsz)
    _raise_on(fn(a.data_ptr(), qfrc.data_ptr(), qvel.data_ptr(),
                 jf.data_ptr(), target.data_ptr(), mu.data_ptr(),
                 out.data_ptr(), bsz, n, c, k, int(iters), float(dt),
                 float(relax),
                 torch.cuda.current_stream(a.device).cuda_stream),
              "fused_contact")
    fused_contact_launches += 1
    return out


def pd_fused_cuda(mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf,
                  target, mu, dt, iters, relax, clocks=None):
    """Launch K4 (arguments as pd_fused_plain; contiguous CUDA tensors of
    one float dtype) -> v_new (B,n), a new tensor.  With ``clocks`` (2 B,
    len(FUSED_STAGES)) int64 (row 2 b: the PD warp of system b, 2 b + 1
    its dynamics warp), the stage-clock build, stamping there."""
    global pd_fused_launches
    bsz, n, c, k = _contact_sizes("pd_fused", jf, mu)
    vecs = (rhspd, e, jkp, jkd, tlim, gear, qfb, qvel)
    _check("pd_fused", [(mmat, (bsz, n, n)), (kdd, (bsz, n, 2))]
           + [(v, (bsz, n)) for v in vecs]
           + [(jf, (bsz, c, n)), (target, (bsz, c)), (mu, (bsz, k))])
    out = torch.empty_like(qvel)
    fn = _fused_entry("egopose_pd_fused", mmat.dtype, clocks, 2 * bsz)
    _raise_on(fn(mmat.data_ptr(), kdd.data_ptr(),
                 *[v.data_ptr() for v in vecs], jf.data_ptr(),
                 target.data_ptr(), mu.data_ptr(), out.data_ptr(), bsz, n, c,
                 k, int(iters), float(dt), float(relax),
                 torch.cuda.current_stream(mmat.device).cuda_stream),
              "pd_fused")
    pd_fused_launches += 1
    return out


# ---------------------------------------------------------------------------
# dispatch on the device
# ---------------------------------------------------------------------------

def spd_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A X = rhs for a batch of SPD systems: the kernel on CUDA, the plain
    version on the CPU."""
    if not a.is_cuda:
        return spd_solve_plain(a, rhs)
    return spd_solve_cuda(a.contiguous(), rhs.contiguous())


def fused_contact(a, qfrc, qvel, jf, target, mu, dt, iters, relax):
    """Fused dynamics + contact solve -> v_new: K3 on CUDA, the plain
    version on the CPU."""
    if not a.is_cuda:
        return fused_contact_plain(a, qfrc, qvel, jf, target, mu, dt, iters,
                                   relax)
    return fused_contact_cuda(*[t.contiguous() for t in
                                (a, qfrc, qvel, jf, target, mu)],
                              dt, iters, relax)


def pd_fused(mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf,
             target, mu, dt, iters, relax):
    """Fused stable-PD substep -> v_new: K4 on CUDA, the plain version on
    the CPU."""
    args = (mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf, target,
            mu)
    if not mmat.is_cuda:
        return pd_fused_plain(*args, dt, iters, relax)
    return pd_fused_cuda(*[t.contiguous() for t in args], dt, iters, relax)
