"""Batched dense SPD solve: the CUDA kernel K2 and its plain version.

Port of egopose_tpu/physics/linalg_pallas.py:163-227: the Pallas kernel
``_cho_solve_kernel_blocked`` (launched by ``_batched_spd_solve_tpu`` from
the ``custom_vmap`` rule of ``spd_solve``) becomes the hand-written CUDA C++
kernel in ``csrc/spd_solve.cu``, one thread block per system.

``spd_solve`` dispatches on the tensors' device: a CUDA batch launches the
kernel, a CPU batch runs ``spd_solve_plain``.  There is no fallback from
CUDA to the plain version: a dtype or size the kernel does not take raises.
The torque-mode substep (engine.step_raw) solves through ``spd_solve``; the
stable-PD split path (engine.pd_control_step_split, K1's plain version)
keeps ``spd_solve_plain`` on every device.
"""
from __future__ import annotations

import ctypes

import torch

from . import nvcc

# Launch count of the kernel: incremented once per launch, nowhere else.
launches = 0

_lib = None


def reset_launches():
    global launches
    launches = 0


def spd_solve_plain(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense SPD solve A X = rhs, (B,n,n), (B,n,r) -> (B,n,r)."""
    return torch.cholesky_solve(rhs, torch.linalg.cholesky(a))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(nvcc.build("spd_solve.cu"))
        for name in ("egopose_spd_solve_f32", "egopose_spd_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def spd_solve_cuda(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a (B,n,n), rhs (B,n,r), contiguous CUDA tensors of
    one float dtype -> X (B,n,r), a new tensor."""
    global launches
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {a.dtype}")
    if a.dim() != 3 or rhs.dim() != 3 or a.shape[1] != a.shape[2] \
            or rhs.shape[:2] != a.shape[:2] or a.shape[0] < 1 \
            or rhs.shape[2] < 1 or a.shape[1] < 1:
        raise ValueError(f"expected a (B,n,n) and rhs (B,n,r), got "
                         f"{tuple(a.shape)} and {tuple(rhs.shape)}")
    for t in (a, rhs):
        if not t.is_cuda or t.device != a.device or t.dtype != a.dtype \
                or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous {a.dtype} CUDA tensors on {a.device}, "
                f"got {t.dtype} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")
    bsz, n, r = rhs.shape
    x = torch.empty_like(rhs)
    fn = _load().egopose_spd_solve_f64 if a.dtype == torch.float64 \
        else _load().egopose_spd_solve_f32
    err = fn(a.data_ptr(), rhs.data_ptr(), x.data_ptr(), bsz, n, r,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"spd_solve kernel launch failed: error {err} (a CUDA error "
            "code; -2: the system needs more shared memory than a block may "
            "use)")
    launches += 1
    return x


def spd_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A X = rhs for a batch of SPD systems: the kernel on CUDA, the plain
    version on the CPU."""
    if not a.is_cuda:
        return spd_solve_plain(a, rhs)
    return spd_solve_cuda(a.contiguous(), rhs.contiguous())
