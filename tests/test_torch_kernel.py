"""The CUDA kernels against their plain PyTorch versions on the card: K1,
the control step (csrc/substep.cu; its sparse branch, and its dense branch
with ContactParams.sparse_ldl=False against the split path at R=1), K2, the batched SPD solve
(csrc/spd_solve.cu), K3 and K4, the fused contact solve and the fused
stable-PD substep (csrc/fused_contact.cu), and K5, forward kinematics
(csrc/fk.cu), also under the wild metrics' 2D projection
(utils/pose2d.py).  Needs an NVIDIA GPU and nvcc: marked ``cuda`` and
skipped without them.  Imports no JAX, so it runs on a machine that has
only the port:

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


def _k1_states(spec, bsz, seed, lift=0.0):
    """Standing poses with random hinges and velocities: the feet touch the
    floor (active floor rows) unless ``lift`` raises the root."""
    rng = np.random.RandomState(seed)
    q = np.zeros((bsz, spec.nq))
    q[:, 2] = 0.935 + lift
    q[:, 3] = 1.0
    q[:, 7:] = rng.uniform(-0.3, 0.3, (bsz, spec.nq - 7))
    v = rng.normal(0, 0.5, (bsz, spec.ndof))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (bsz, spec.nu))
    return q, v, ctrl


def _hold_k1(card, dtype, bsz, r, seed, lift=0.0, dense=False):
    """One control step through K1 against the plain split path: f64
    max-abs <= 1e-9, f32 RMS qpos <= 1e-6 and qvel <= 1e-4.  With
    ``dense`` K1's dense branch runs (given prep_refresh r, which it
    ignores) against the split path at R=1."""
    from egopose_tpu_torch.physics import engine, model, substep
    from egopose_tpu_torch.physics.spec import parse_mjcf
    spec = parse_mjcf(XML)
    m = model.build_model(spec, dtype=dtype, device=card)
    q, v, ctrl = _k1_states(spec, bsz, seed, lift)
    gains = [np.full(spec.nu, g) for g in (300.0, 30.0, 100.0)]
    t = lambda x: torch.tensor(x, dtype=dtype, device=card)
    params = engine.DEFAULT_CONTACT._replace(prep_refresh=r,
                                             sparse_ldl=not dense)
    before = (substep.launches, substep.dense_launches)
    qk, vk = engine.pd_control_step(
        m, t(q), t(v), t(ctrl), *map(t, gains), 15, params)
    assert (substep.launches, substep.dense_launches) == (
        before[0] + (not dense), before[1] + dense)
    qp, vp = engine.pd_control_step_split(
        m, t(q), t(v), t(ctrl), *map(t, gains), 15,
        params._replace(prep_refresh=1) if dense else params)
    torch.cuda.synchronize()
    assert torch.isfinite(qk).all() and torch.isfinite(vk).all()
    dq, dv = (qk - qp).double(), (vk - vp).double()
    if dtype == torch.float64:
        assert dq.abs().max() <= 1e-9 and dv.abs().max() <= 1e-9
    else:
        assert dq.pow(2).mean().sqrt() <= 1e-6
        assert dv.pow(2).mean().sqrt() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("bsz", [1, 4, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_batches_and_cadences_on_card(card, dtype, bsz, r):
    """B = 1 and 4 (the eval's latency shapes), 1024 (training's one-wave
    batch) at prep-refresh R = 1, 2 (a remainder group) and 3."""
    _hold_k1(card, dtype, bsz, r, seed=bsz + r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_without_active_contacts_on_card(card, dtype):
    """Every lane 1 m above the floor: no contact row is active, so the
    kernel skips every column of Y and every row of the sweep."""
    _hold_k1(card, dtype, 8, 3, seed=9, lift=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 4, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_kernel_matches_plain_on_card(card, dtype, bsz):
    """K1's dense branch (sparse_ldl=False), given prep_refresh=3, against
    the split path at R=1 (its plain version: the dense branch refreshes
    its prep every substep), with K1's bars."""
    _hold_k1(card, dtype, bsz, 3, seed=30 + bsz, dense=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_kernel_without_active_contacts_on_card(card, dtype):
    """Every lane 1 m above the floor: W, the Delassus matrix and the
    sweep have no active row."""
    _hold_k1(card, dtype, 8, 3, seed=9, lift=1.0, dense=True)


def _dense_inputs(card, dtype, bsz, seed):
    from egopose_tpu_torch.physics import model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    spec = parse_mjcf(XML)
    m = model.build_model(spec, dtype=dtype, device=card)
    q, v, ctrl = _k1_states(spec, bsz, seed)
    t = lambda x: torch.tensor(x, dtype=dtype, device=card)
    gains = [t(np.full((bsz, spec.nu), g)) for g in (300.0, 30.0, 100.0)]
    return m, (t(q), t(v), t(ctrl), *gains)


@pytest.mark.cuda
def test_dense_kernel_reads_the_lower_triangle_on_card(card):
    """poison_upper (the kernel's poison build) fills the square that holds
    both factors (A_dyn's lower triangle, A_pd's upper one) with NaN before
    every assembly, so every
    entry of the square must be written anew each substep; after the
    assembly it fills every other value of the block with NaN too, but
    those of the arrays live into the factors (q, v, J^T, tgt, mu, the PD
    column), so no stage from the factors on may read the prep's dead
    arrays, which the square and the solve's arrays overlay, or a value
    it has not yet written.  The output is bit-equal to the main build's
    (B=9, f64)."""
    from egopose_tpu_torch.physics import engine, substep
    m, args = _dense_inputs(card, torch.float64, 9, 12)
    params = engine.DEFAULT_CONTACT._replace(sparse_ldl=False)
    clean = substep.pd_control_step_cuda(m, *args, 15, params)
    poisoned = substep.pd_control_step_cuda(m, *args, 15, params,
                                            poison_upper=True)
    torch.cuda.synchronize()
    for a, b in zip(clean, poisoned):
        assert torch.isfinite(b).all() and torch.equal(a, b)


@pytest.mark.cuda
def test_dense_kernel_refuses_what_it_cannot_take_on_card(card):
    """A CUDA batch the dense branch cannot take raises
    NotImplementedError (no plain fallback): 36 contact rows, more than
    its one-warp sweep holds."""
    from egopose_tpu_torch.physics import engine, substep
    m, (q, v, ctrl, kp, kd, tl) = _dense_inputs(card, torch.float32, 2, 4)
    params = engine.DEFAULT_CONTACT._replace(sparse_ldl=False,
                                             max_contacts=10)
    before = substep.dense_launches
    with pytest.raises(NotImplementedError, match="contact rows"):
        engine.pd_control_step(m, q, v, ctrl, kp[0], kd[0], tl[0], 15, params)
    assert substep.dense_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_occupancy_on_card(card, dtype):
    """The dense branch's block: the layout's bytes (23,980 f32, 47,808
    f64 for the humanoid), 64 registers at most and 8 blocks per SM in
    float (one wave at B=1024 on 132 SMs), 4 in double."""
    from egopose_tpu_torch.physics import engine, model, substep
    from egopose_tpu_torch.physics.spec import parse_mjcf
    m = model.build_model(parse_mjcf(XML), dtype=dtype, device=card)
    params = engine.DEFAULT_CONTACT._replace(sparse_ldl=False)
    dims, _, _ = substep.build_tables(m, params)
    occ = substep.occupancy(m, dtype, params=params)
    size = torch.tensor([], dtype=dtype).element_size()
    assert occ["shared_bytes"] == substep.smem_bytes(dims, size)
    assert occ["blocks_per_sm"] >= (8 if dtype == torch.float32 else 4)
    if dtype == torch.float32:
        assert occ["registers"] <= 64


@pytest.mark.cuda
def test_dense_stage_clocks_on_card(card):
    """The stage-clock build's dense branch holds K1's f32 bars and stamps
    its stages (prep, factor, gram, torque, z0, residual, sweep, velocity,
    integrate), none of the sparse branch's own."""
    from egopose_tpu_torch.physics import engine, substep
    m, args = _dense_inputs(card, torch.float32, 6, 8)
    params = engine.DEFAULT_CONTACT._replace(sparse_ldl=False)
    clocks = torch.zeros(6, len(substep.STAGES), dtype=torch.int64,
                         device=card)
    qk, vk = substep.pd_control_step_cuda(m, *args, 15, params, clocks=clocks)
    qp, vp = engine.pd_control_step_split(
        m, *args[:3], *[g[0] for g in args[3:]], 15,
        params._replace(prep_refresh=1))
    torch.cuda.synchronize()
    assert (qk - qp).double().pow(2).mean().sqrt() <= 1e-6
    assert (vk - vp).double().pow(2).mean().sqrt() <= 1e-4
    ran = {n for i, n in enumerate(substep.STAGES)
           if bool((clocks[:, i] > 0).all())}
    assert ran == set(substep.STAGES) - {"inverse", "y", "delassus", "pd",
                                         "dyn_solve"}


@pytest.mark.cuda
@pytest.mark.parametrize("flags,want", [
    (dict(prep_refresh=3), dict(k2=30)),
    (dict(fused_solver=True), dict(k2=15, k3=15, k5=15))],
    ids=["split", "fused_solver"])
def test_split_path_on_card_runs_the_kernels(card, flags, want):
    """pd_control_step with substep_resident and pd_fused off: the split
    path solves through K2 (and with fused_solver through K3, its FK through
    K5) on the card, and agrees with the same step on the CPU in f64."""
    from egopose_tpu_torch.physics import engine, fk, linalg, model, substep
    from egopose_tpu_torch.physics.spec import parse_mjcf
    spec = parse_mjcf(XML)
    rng = np.random.RandomState(5)
    bsz = 8
    q = np.zeros((bsz, spec.nq))
    q[:, 2] = 0.935
    q[:, 3] = 1.0
    q[:, 7:] = rng.uniform(-0.3, 0.3, (bsz, spec.nq - 7))
    v = rng.normal(0, 0.5, (bsz, spec.ndof))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (bsz, spec.nu))
    gains = [np.full(spec.nu, g) for g in (300.0, 30.0, 100.0)]
    params = engine.DEFAULT_CONTACT._replace(substep_resident=False, **flags)
    out = {}
    for dev in (card, torch.device("cpu")):
        m = model.build_model(spec, dtype=torch.float64, device=dev)
        t = lambda x: torch.tensor(x, dtype=torch.float64, device=dev)
        before = dict(k1=substep.launches, k2=linalg.launches,
                      k3=linalg.fused_contact_launches,
                      k4=linalg.pd_fused_launches, k5=fk.launches)
        out[dev.type] = engine.pd_control_step(
            m, t(q), t(v), t(ctrl), *map(t, gains), 15, params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = dict(k1=substep.launches, k2=linalg.launches,
                         k3=linalg.fused_contact_launches,
                         k4=linalg.pd_fused_launches, k5=fk.launches)
            assert {k: after[k] - before[k] for k in after} == {
                k: want.get(k, 0) for k in after}
    (qk, vk), (qc, vc) = out["cuda"], out["cpu"]
    assert torch.isfinite(qk).all() and torch.isfinite(vk).all()
    assert (qk.cpu() - qc).abs().max() <= 1e-9
    assert (vk.cpu() - vc).abs().max() <= 1e-8


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
@pytest.mark.parametrize("r", [1, 25, 32, 33])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 58, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spd_solve_sizes_on_card(card, dtype, n, r):
    """Sizes around the warp's 32 lanes (rows in the factor, columns in the
    substitutions) and beyond two passes (n = 100), 257 systems (four per
    block, the last block holding one): the bars of
    test_spd_solve_matches_plain_on_card."""
    from egopose_tpu_torch.physics import linalg
    a, rhs = _spd_systems(257, n, r, dtype, card, seed=n * 100 + r)
    before = linalg.launches
    x = linalg.spd_solve(a, rhs)
    assert linalg.launches == before + 1
    plain = linalg.spd_solve_plain(a, rhs)
    torch.cuda.synchronize()
    assert x.shape == rhs.shape and torch.isfinite(x).all()
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


# ---------------------------------------------------------------------------
# K3, K4: the fused contact solve and the fused stable-PD substep
# ---------------------------------------------------------------------------

def _contact_system(bsz, n, c, k, dtype, device, seed):
    """Random SPD systems and contact rows (the JAX tests' recipe)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, n, n)
    a = np.einsum("bij,bkj->bik", x, x) / n + np.eye(n)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return (t(a), t(rng.randn(bsz, n)), t(rng.randn(bsz, n)),
            t(rng.randn(bsz, c, n) * 0.3), t(np.abs(rng.randn(bsz, c)) * 0.1),
            t(np.abs(rng.randn(bsz, k)) + 0.2))


def _pd_system(bsz, n, c, k, dtype, device, seed):
    a, qfrc, qvel, jf, target, mu = _contact_system(bsz, n, c, k, dtype,
                                                    device, seed)
    rng = np.random.RandomState(seed + 100)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    kdd = t(np.abs(rng.randn(bsz, n, 2)) * 50)
    rhspd, e, jkp, jkd = (t(rng.randn(bsz, n) * s) for s in (1, 0.1, 300, 30))
    tlim, gear = t(np.abs(rng.randn(bsz, n)) * 50), t(np.ones((bsz, n)))
    return (a, kdd, rhspd, e, jkp.abs(), jkd.abs(), tlim, gear, qfrc, qvel,
            jf, target, mu)


def _hold(got, plain, dtype, ref64):
    """f64: max-abs kernel - plain <= 1e-9 max|v|.  f32: the kernel's error
    against the float64 result of the same inputs is at most 4x the plain
    float32 version's."""
    assert got.shape == plain.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    if dtype == torch.float64:
        assert (got - plain).abs().max() <= 1e-9 * plain.abs().max()
    else:
        err_k = (got.double() - ref64).abs().max()
        err_p = (plain.double() - ref64).abs().max()
        assert err_k <= 4 * err_p


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,c,k", [(1, 24, 6), (64, 24, 6), (16, 48, 16),
                                     (8, 30, 8)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_contact_matches_plain_on_card(card, dtype, bsz, c, k):
    from egopose_tpu_torch.physics import linalg
    args = _contact_system(bsz, 58, c, k, dtype, card, seed=bsz + c)
    before = linalg.fused_contact_launches
    got = linalg.fused_contact(*args, 1 / 450, 10, 1.0)
    assert linalg.fused_contact_launches == before + 1
    plain = linalg.fused_contact_plain(*args, 1 / 450, 10, 1.0)
    ref = linalg.fused_contact_plain(*[x.double() for x in args], 1 / 450,
                                     10, 1.0)
    torch.cuda.synchronize()
    _hold(got, plain, dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,c,k", [(1, 24, 6), (64, 24, 6), (16, 48, 16)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pd_fused_matches_plain_on_card(card, dtype, bsz, c, k):
    from egopose_tpu_torch.physics import linalg
    args = _pd_system(bsz, 58, c, k, dtype, card, seed=bsz + c)
    before = linalg.pd_fused_launches
    got = linalg.pd_fused(*args, 1 / 450, 10, 1.0)
    assert linalg.pd_fused_launches == before + 1
    plain = linalg.pd_fused_plain(*args, 1 / 450, 10, 1.0)
    ref = linalg.pd_fused_plain(*[x.double() for x in args], 1 / 450, 10,
                                1.0)
    torch.cuda.synchronize()
    _hold(got, plain, dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(24, 6), (33, 11), (48, 16), (6, 0),
                                 (64, 16), (70, 0)])
@pytest.mark.parametrize("bsz", [1, 5, 64, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_contact_sizes_on_card(card, dtype, bsz, c, k):
    """K3 (one warp per system, four per block) at batches that leave the
    last block partly filled, rows below, at and above the warp's 32 lanes
    (two Z columns and two sweep rows per lane), more Z columns than the
    two per lane that ride on the factor (c >= 64), and pair rows only
    (k=0): the bars of _hold."""
    from egopose_tpu_torch.physics import linalg
    args = _contact_system(bsz, 58, c, k, dtype, card, seed=7 * bsz + c)
    before = linalg.fused_contact_launches
    got = linalg.fused_contact(*args, 1 / 450, 10, 1.0)
    assert linalg.fused_contact_launches == before + 1
    plain = linalg.fused_contact_plain(*args, 1 / 450, 10, 1.0)
    ref = linalg.fused_contact_plain(*[x.double() for x in args], 1 / 450,
                                     10, 1.0)
    torch.cuda.synchronize()
    _hold(got, plain, dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(24, 6), (48, 16), (70, 20)])
@pytest.mark.parametrize("bsz", [1, 5, 64, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pd_fused_sizes_on_card(card, dtype, bsz, c, k):
    """K4 (two warps per system joined on a named barrier, four systems
    per block) at batches that leave the last block partly filled, and
    with more Z columns than the two per lane that ride on the factor
    (c = 70): the bars of _hold."""
    from egopose_tpu_torch.physics import linalg
    args = _pd_system(bsz, 58, c, k, dtype, card, seed=7 * bsz + c)
    before = linalg.pd_fused_launches
    got = linalg.pd_fused(*args, 1 / 450, 10, 1.0)
    assert linalg.pd_fused_launches == before + 1
    plain = linalg.pd_fused_plain(*args, 1 / 450, 10, 1.0)
    ref = linalg.pd_fused_plain(*[x.double() for x in args], 1 / 450, 10,
                                1.0)
    torch.cuda.synchronize()
    _hold(got, plain, dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k3", "k4"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_without_iterations_on_card(card, dtype, which):
    """iters = 0: lam stays 0 and v_new is v_pred (B=5, c=24, k=6)."""
    from egopose_tpu_torch.physics import linalg
    make, cuda, plain = {
        "k3": (_contact_system, linalg.fused_contact,
               linalg.fused_contact_plain),
        "k4": (_pd_system, linalg.pd_fused, linalg.pd_fused_plain)}[which]
    args = make(5, 58, 24, 6, dtype, card, seed=11)
    got = cuda(*args, 1 / 450, 0, 1.0)
    want = plain(*args, 1 / 450, 0, 1.0)
    ref = plain(*[x.double() for x in args], 1 / 450, 0, 1.0)
    torch.cuda.synchronize()
    _hold(got, want, dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_occupancy_on_card(card, dtype):
    """K3's and K4's resources, from the per-system layout the launcher
    uses (csrc/fused_contact.cu, Sys<size_t>): one float64 system at c=48,
    k=16 fits a block; at the humanoid's shape (n=58, c=24, k=6) a block
    holds whole systems, K3 runs one warp per system and, in float32,
    takes <= 24 KB per system and B=1024 in one wave; K4 two warps per
    system."""
    from egopose_tpu_torch.physics import linalg
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for occupancy, warps in ((linalg.fused_contact_occupancy, 1),
                             (linalg.pd_fused_occupancy, 2)):
        wide = occupancy(58, 48, 16, torch.float64)
        assert wide["systems_per_block"] >= 1 and wide["blocks_per_sm"] >= 1
        occ = occupancy(58, 24, 6, dtype)
        assert occ["warps_per_system"] == warps
        assert occ["blocks_per_sm"] >= 1
        one, rest = divmod(occ["shared_bytes"], occ["systems_per_block"])
        assert rest == 0
        if warps == 1 and dtype == torch.float32:
            assert one <= 24 * 1024
            blocks = -(-1024 // occ["systems_per_block"])
            assert blocks <= occ["blocks_per_sm"] * sms


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k3", "k4"])
def test_fused_read_the_lower_triangle_on_card(card, which):
    """K3 and K4 factor the lower triangle of A (M), as the plain version's
    Cholesky does: garbage in the strict upper triangle changes nothing
    (B=9, f64, K4's PD factor stored transposed in the upper half of its
    square)."""
    from egopose_tpu_torch.physics import linalg
    make, cuda, plain = {
        "k3": (_contact_system, linalg.fused_contact,
               linalg.fused_contact_plain),
        "k4": (_pd_system, linalg.pd_fused, linalg.pd_fused_plain)}[which]
    args = list(make(9, 58, 24, 6, torch.float64, card, seed=13))
    upper = torch.triu(torch.ones(58, 58, dtype=torch.bool, device=card), 1)
    args[0] = torch.where(upper, args[0] + 1e3, args[0])
    got = cuda(*args, 1 / 450, 10, 1.0)
    want = plain(*args, 1 / 450, 10, 1.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-9 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k3", "k4"])
def test_fused_stage_clocks_on_card(card, which):
    """The stage-clock build (csrc/fused_contact.cu, EGOPOSE_STAGE_CLOCKS)
    holds the bars of _hold, and stamps every stage of its warps: K3 load
    to velocity; K4's PD warp load, pd_factor, pd_back, torque, its
    dynamics warp load to velocity with the barrier wait and z0."""
    from egopose_tpu_torch.physics import linalg
    make, run, plain = {
        "k3": (_contact_system, linalg.fused_contact_cuda,
               linalg.fused_contact_plain),
        "k4": (_pd_system, linalg.pd_fused_cuda, linalg.pd_fused_plain)}[which]
    args = make(9, 58, 24, 6, torch.float32, card, seed=5)
    warps = 9 if which == "k3" else 18
    clocks = torch.zeros(warps, len(linalg.FUSED_STAGES), dtype=torch.int64,
                         device=card)
    got = run(*args, 1 / 450, 10, 1.0, clocks=clocks)
    want = plain(*args, 1 / 450, 10, 1.0)
    ref = plain(*[x.double() for x in args], 1 / 450, 10, 1.0)
    torch.cuda.synchronize()
    _hold(got, want, torch.float32, ref)
    cyc = linalg.fused_stage_cycles(clocks.cpu())
    ran = lambda rows: {name for i, name in enumerate(linalg.FUSED_STAGES)
                        if bool((cyc[rows, i] > 0).all())}
    contact = {"load", "factor", "gram", "prep", "sweep", "velocity"}
    if which == "k3":
        assert ran(slice(None)) == contact
    else:
        assert ran(slice(0, None, 2)) == {"load", "pd_factor", "pd_back",
                                          "torque"}
        assert ran(slice(1, None, 2)) == contact | {"wait", "z0"}


@pytest.mark.cuda
def test_fused_wrappers_reject_bad_inputs(card):
    from egopose_tpu_torch.physics import linalg
    args = list(_contact_system(2, 8, 6, 2, torch.float32, card, seed=0))
    for i, bad in ((0, args[0].cpu()), (1, args[1].double()),
                   (0, args[0].transpose(1, 2)), (4, args[4][:, :5])):
        with pytest.raises(ValueError):
            linalg.fused_contact_cuda(*args[:i], bad, *args[i + 1:],
                                      1 / 450, 10, 1.0)
    with pytest.raises(ValueError, match="c >= 3k"):
        linalg.fused_contact_cuda(*args[:5], torch.ones(2, 3, device=card),
                                  1 / 450, 10, 1.0)
    big = _contact_system(1, 200, 24, 6, torch.float64, card, seed=1)
    with pytest.raises(RuntimeError, match="shared memory"):
        linalg.fused_contact_cuda(*big, 1 / 450, 10, 1.0)
    pd = list(_pd_system(2, 8, 6, 2, torch.float32, card, seed=0))
    with pytest.raises(ValueError):
        linalg.pd_fused_cuda(*pd[:1], pd[1][..., :1].contiguous(), *pd[2:],
                             1 / 450, 10, 1.0)
    with pytest.raises(RuntimeError, match="shared memory"):
        linalg.pd_fused_cuda(*_pd_system(1, 200, 24, 6, torch.float64, card,
                                         seed=1), 1 / 450, 10, 1.0)


# ---------------------------------------------------------------------------
# K5: forward kinematics
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 5, 300, 1023])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fk_matches_plain_on_card(card, dtype, bsz):
    """f64: every output within 1e-10 of engine.fk; f32 within 1e-5; B=1,
    5 and 1023 leave the last block of four environments partly filled."""
    from egopose_tpu_torch.physics import engine, fk, model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    m = model.build_model(parse_mjcf(XML), dtype=dtype, device=card)
    rng = np.random.RandomState(bsz)
    q = np.zeros((bsz, m.nq))
    q[:, :3] = rng.randn(bsz, 3)
    q[:, 3:7] = rng.randn(bsz, 4)
    q[:, 7:] = rng.uniform(-1.5, 1.5, (bsz, m.nq - 7))
    qt = torch.tensor(q, dtype=dtype, device=card)
    before = fk.launches
    got = fk.fk_batched(m, qt)
    assert fk.launches == before + 1
    want = engine.fk(m, qt)
    torch.cuda.synchronize()
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for name, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert (g - w).abs().max() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fk_occupancy_on_card(card, dtype):
    """K5's block: the reckoned bytes (fk.block_bytes), four
    environments."""
    from egopose_tpu_torch.physics import fk, model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    m = model.build_model(parse_mjcf(XML), dtype=dtype, device=card)
    dims, _, _ = fk.build_tables(m)
    occ = fk.occupancy(m, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    assert occ["shared_bytes"] == fk.block_bytes(dims, size)
    assert occ["systems_per_block"] == fk.WARPS
    assert occ["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_fk_wrapper_rejects_bad_inputs(card):
    from egopose_tpu_torch.physics import fk, model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    m = model.build_model(parse_mjcf(XML), dtype=torch.float32, device=card)
    q = torch.zeros(3, m.nq, device=card)
    for bad in (q.cpu(), q.double(), q[:, :58], q.t()):
        with pytest.raises(ValueError):
            fk.fk_cuda(m, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("flip", [False, True])
def test_pose2d_projection_on_card(card, dtype, tol, flip):
    """utils/pose2d.py's project_traj on a model on the card (one K5
    launch for every frame) against the CPU float64 projection of the same
    frames: image coordinates of a camera 10 m from the hips (~0.1 in
    size)."""
    from egopose_tpu_torch.physics import fk, model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    from egopose_tpu_torch.utils.pose2d import Pose2DContext
    spec = parse_mjcf(XML)
    rng = np.random.RandomState(5)
    q = np.zeros((380, spec.nq))
    q[:, :3] = rng.randn(380, 3)
    q[:, 2] = 0.9
    q[:, 3:7] = rng.randn(380, 4)
    q[:, 7:] = rng.uniform(-0.5, 0.5, (380, spec.nq - 7))
    ref = Pose2DContext(model.build_model(spec, dtype=torch.float64),
                        spec).project_traj(q, flip)
    ctx = Pose2DContext(model.build_model(spec, dtype=dtype, device=card),
                        spec)
    before = fk.launches
    got = ctx.project_traj(q, flip)
    assert fk.launches == before + 1
    assert got.shape == ref.shape == (380, ctx.nbody, 2)
    assert np.isfinite(got).all() and np.abs(got - ref).max() <= tol


@pytest.mark.cuda
def test_gen_expert_features_on_card(card):
    """envs.gen_expert_features on a float64 model on the card (one K5
    launch for the take's 600 frames) against the same function on the CPU
    model: every feature within 1e-9."""
    from egopose_tpu_torch import envs
    from egopose_tpu_torch.physics import fk, model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    from egopose_tpu_torch.utils.config import EgoMimicConfig, make_env_params
    spec = parse_mjcf(XML)
    cfg = EgoMimicConfig(None, cfg_dict={"obs_coord": "heading"})
    rng = np.random.RandomState(8)
    t = np.arange(600)[:, None] / 30.0
    q = np.zeros((600, spec.nq))
    q[:, :2] = 0.3 * t
    q[:, 2] = 0.9 + 0.02 * np.sin(t[:, 0])
    ang = 0.5 * np.sin(0.4 * t[:, 0])
    q[:, 3], q[:, 6] = np.cos(ang / 2), np.sin(ang / 2)
    q[:, 7:] = 0.4 * np.sin(t * rng.uniform(0.5, 2, spec.nq - 7)
                            + rng.uniform(0, 6, spec.nq - 7))
    feats = []
    for dev in ("cpu", card):
        m = model.build_model(spec, dtype=torch.float64, device=dev)
        p = make_env_params(cfg, spec, obs_dim=115, dtype=torch.float64,
                            device=dev)
        qt = torch.as_tensor(q, device=dev)
        before = fk.launches
        feats.append(envs.gen_expert_features(
            m, p, envs.make_body_tables(spec, dev), qt, 1 / 30))
        assert fk.launches == before + (dev != "cpu")
    torch.cuda.synchronize()
    ref, got = feats
    assert sorted(got) == sorted(ref) and got["len"] == ref["len"] == 600
    for key in ref:
        if key != "len":
            assert got[key].is_cuda and got[key].dtype == torch.float64
            err = float((got[key].cpu() - ref[key]).abs().max())
            assert err <= 1e-9, (key, err)
