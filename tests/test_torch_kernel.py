"""The CUDA kernels against their plain PyTorch versions on the card: K1,
the control step (csrc/substep.cu), and K2, the batched SPD solve
(csrc/spd_solve.cu).  Needs an NVIDIA GPU and nvcc: marked ``cuda`` and skipped without
them.  Imports no JAX, so it runs on a machine that has only the port:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q

(--noconftest: the suite's conftest imports JAX, which a machine with only
the port may lack.)
"""
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,r", [(torch.float64, 3), (torch.float64, 2),
                                     (torch.float32, 3)])
def test_kernel_matches_plain_on_card(card, dtype, r):
    from egopose_tpu_torch.physics import engine, model, substep
    from egopose_tpu_torch.physics.spec import parse_mjcf
    spec = parse_mjcf(XML)
    m = model.build_model(spec, dtype=dtype, device=card)
    rng = np.random.RandomState(3)
    bsz = 16
    q = np.zeros((bsz, spec.nq))
    q[:, 2] = 0.935
    q[:, 3] = 1.0
    q[:, 7:] = rng.uniform(-0.3, 0.3, (bsz, spec.nq - 7))
    v = rng.normal(0, 0.5, (bsz, spec.ndof))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (bsz, spec.nu))
    gains = [np.full(spec.nu, g) for g in (300.0, 30.0, 100.0)]
    t = lambda x: torch.tensor(x, dtype=dtype, device=card)
    params = engine.DEFAULT_CONTACT._replace(prep_refresh=r)
    before = substep.launches
    qk, vk = engine.pd_control_step(
        m, t(q), t(v), t(ctrl), *map(t, gains), 15, params)
    assert substep.launches == before + 1
    qp, vp = engine.pd_control_step_split(m, t(q), t(v), t(ctrl),
                                          *map(t, gains), 15, params)
    torch.cuda.synchronize()
    assert torch.isfinite(qk).all() and torch.isfinite(vk).all()
    dq, dv = (qk - qp).double(), (vk - vp).double()
    if dtype == torch.float64:
        assert dq.abs().max() <= 1e-9 and dv.abs().max() <= 1e-9
    else:
        assert dq.pow(2).mean().sqrt() <= 1e-6
        assert dv.pow(2).mean().sqrt() <= 1e-4


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(card):
    from egopose_tpu_torch.physics import engine, model, substep
    from egopose_tpu_torch.physics.spec import parse_mjcf
    m = model.build_model(parse_mjcf(XML), dtype=torch.float32, device=card)
    z = lambda *s: torch.zeros(*s, device=card)
    args = [z(2, 59), z(2, 58), z(2, 52), z(2, 52), z(2, 52), z(2, 52)]
    with pytest.raises(ValueError):
        substep.pd_control_step_cuda(m, z(2, 58), *args[1:], 15,
                                     engine.DEFAULT_CONTACT)
    with pytest.raises(ValueError):
        substep.pd_control_step_cuda(m, args[0].double(), *args[1:], 15,
                                     engine.DEFAULT_CONTACT)


def _spd_systems(bsz, n, r, dtype, device, seed):
    """SPD systems with condition numbers ~1e3: A = G G^T / n + 0.05 I."""
    rng = np.random.RandomState(seed)
    g = rng.randn(bsz, n, n)
    a = g @ g.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
    rhs = rng.randn(bsz, n, r)
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return t(a), t(rhs)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 4, 1024])
@pytest.mark.parametrize("r", [1, 25])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spd_solve_matches_plain_on_card(card, dtype, r, bsz):
    """f64: max-abs kernel - plain <= 1e-9 max|X|.  f32: the kernel's
    error against the float64 solution is at most 4x the plain float32
    version's (both Cholesky solves, summed in other orders)."""
    from egopose_tpu_torch.physics import linalg
    a, rhs = _spd_systems(bsz, 58, r, dtype, card, seed=bsz + r)
    before = linalg.launches
    x = linalg.spd_solve(a, rhs)
    assert linalg.launches == before + 1
    plain = linalg.spd_solve_plain(a, rhs)
    torch.cuda.synchronize()
    assert x.shape == rhs.shape and x.dtype == dtype
    assert torch.isfinite(x).all()
    if dtype == torch.float64:
        assert (x - plain).abs().max() <= 1e-9 * plain.abs().max()
    else:
        ref = linalg.spd_solve_plain(a.double(), rhs.double())
        err_k = (x.double() - ref).abs().max()
        err_p = (plain.double() - ref).abs().max()
        assert err_k <= 4 * err_p


@pytest.mark.cuda
def test_spd_solve_rejects_bad_inputs(card):
    from egopose_tpu_torch.physics import linalg
    a, rhs = _spd_systems(2, 8, 3, torch.float32, card, seed=0)
    for bad_a, bad_rhs in ((a.half(), rhs.half()),            # dtype
                           (a, rhs.double()),                  # mixed
                           (a[:, :7], rhs),                    # not square
                           (a, rhs[:1]),                       # batch
                           (a.transpose(1, 2), rhs),           # layout
                           (a.cpu(), rhs)):                    # device
        with pytest.raises(ValueError):
            linalg.spd_solve_cuda(bad_a, bad_rhs)
    big = torch.eye(400, device=card, dtype=torch.float64).expand(1, -1, -1)
    with pytest.raises(RuntimeError, match="shared memory"):
        linalg.spd_solve_cuda(big.contiguous(),
                              torch.ones(1, 400, 1, device=card,
                                         dtype=torch.float64))
