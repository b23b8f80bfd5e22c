"""K1's dense branch (ContactParams.sparse_ldl=False) on the CPU, without a
card:

- the port's ContactParams has the JAX package's fields, in its order and
  with its defaults, sparse_ldl included;
- on the CPU both engines ignore the flag, so the port's pd_control_step
  with sparse_ldl=False equals the JAX engine's CPU step (the split path
  at the given prep_refresh) at R=1 and R=3, float64 to 1e-9, on
  contact-rich states made with numpy, with the subject_03 gains;
- the contact-loaded dof ranges equal the JAX kernel's ``sup_segs``
  (substep_pallas._build_static), and the dense branch's launch refreshes
  the prep every substep whatever prep_refresh says;
- the dense shared-memory layout overlays only arrays whose live stages
  are disjoint, its size is the reckoned one, and 8 blocks fit an SM;
- the bit table of M's structure the dense square is assembled from holds
  the ancestor lists exactly;
- a model or parameters the dense branch cannot take raise
  NotImplementedError.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from egopose_tpu.physics import build_model as jbuild, engine as je
from egopose_tpu.physics import substep_pallas as SP
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu_torch.physics import engine as te, model as tmodel, substep
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
B = 3
DENSE = te.DEFAULT_CONTACT._replace(sparse_ldl=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Both engines' humanoid, B contact-rich states (feet 3-10 mm into the
    floor, arms flailing) and the subject_03 gains, all from numpy."""
    spec = jparse(XML)
    jm = jbuild(spec, dtype=jnp.float64)
    tm = tmodel.build_model(tparse(XML), dtype=torch.float64)
    rng = np.random.RandomState(17)
    q = np.zeros((B, spec.nq))
    tilt = rng.normal(0, 0.03, (B, 3))
    q[:, 3:7] = np.c_[np.ones(B), 0.5 * tilt]
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.15, 0.15, (B, spec.nq - 7))
    for side in ("Right", "Left"):
        for ax in "xyz":
            q[:, 7 + spec.jnt_names.index(f"{side}Arm_{ax}")] += \
                rng.uniform(-1.2, 1.2, B)
    kin = te.fk(tm, torch.tensor(q))
    pts = kin.xpos[:, tm.cpoint_body] + te.Q.quat_rotate(
        kin.xquat[:, tm.cpoint_body], tm.cpoint_local)
    low = torch.amin(pts[..., 2] - tm.cpoint_radius, 1).numpy()
    q[:, 2] -= low + rng.uniform(0.003, 0.010, B)
    v = rng.normal(0, 0.5, (B, spec.ndof))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (B, spec.nu))
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    jp = list(zip(*cfg["joint_params"]))
    mult = cfg["jkp_multiplier"]
    gains = (np.array(jp[1], float) * mult, np.array(jp[2], float) * mult,
             np.array(jp[5], float))
    return spec, jm, tm, q, v, ctrl, gains


def test_contact_params_match_jax():
    assert te.ContactParams._fields == je.ContactParams._fields
    assert te.ContactParams._field_defaults == je.ContactParams._field_defaults
    assert te.ContactParams().sparse_ldl is True
    assert DENSE.substep_resident and not DENSE.sparse_ldl


@pytest.mark.parametrize("r", [1, 3])
def test_dense_flag_is_ignored_on_the_cpu(world, r):
    """Off the kernel both engines run the split path at prep_refresh R,
    sparse_ldl=False or not (the JAX step through make_substep_step's CPU
    rule, the port's through pd_control_step's CPU dispatch)."""
    spec, jm, tm, q, v, ctrl, (kp, kd, tl) = world
    pj = je.DEFAULT_CONTACT._replace(sparse_ldl=False, prep_refresh=r)
    assert pj.substep_resident
    step = jax.jit(jax.vmap(lambda a, b, c: je.pd_control_step(
        jm, a, b, c, jnp.asarray(kp), jnp.asarray(kd), jnp.asarray(tl), 15,
        pj)))
    qj, vj = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    args = [torch.tensor(x) for x in (q, v, ctrl, kp, kd, tl)]
    qt, vt = te.pd_control_step(tm, *args, 15,
                                DENSE._replace(prep_refresh=r))
    assert torch.isfinite(qt).all() and torch.isfinite(vt).all()
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-9)
    # and the flag changes nothing on the CPU
    qs, vs = te.pd_control_step(tm, *args, 15,
                                te.DEFAULT_CONTACT._replace(prep_refresh=r))
    assert torch.equal(qs, qt) and torch.equal(vs, vt)


def test_support_segments_match_jax(world):
    """The dofs the TPU kernel's dense branch sums J W over (the dense
    branch's bound in chip_smoke.py counts J v over them): the JAX
    kernel's sup_segs.  No branch of the CUDA kernel reads them: its
    dense branch never forms J W, so its int table does not carry them."""
    _, jm, tm, *_ = world
    want = SP._build_static(jm, je.DEFAULT_CONTACT._replace(
        sparse_ldl=False))["sup_segs"]
    got = substep.support_segments(tm)
    assert got == tuple(tuple(int(x) for x in s) for s in want)
    for params in (DENSE, te.DEFAULT_CONTACT):
        dims, _, _ = substep.build_tables(tm, params)
        assert dims["i_dmask"] == dims["i_fac_row"] + dims["n_fac"] + 1


def test_dense_dims_refresh_every_substep(world):
    """The dense branch's Dims: its own mode and layout, no tree-factor
    tables, and prep_refresh 1 in every launch whatever the params say
    (substep_pallas.py:739); the sparse branch keeps its cadence."""
    _, _, tm, *_ = world
    for r in (1, 3):
        dense, _, _ = substep.build_tables(tm, DENSE._replace(prep_refresh=r))
        sparse, _, _ = substep.build_tables(
            tm, te.DEFAULT_CONTACT._replace(prep_refresh=r))
        assert dense["dense"] == 1 and sparse["dense"] == 0
        assert dense["n_fac"] == 0 and sparse["n_fac"] > 0
        assert dense["lda"] % 2 == 1 and dense["lda"] >= tm.ndof + 1
        field = substep.DIM_FIELDS.index("prep_refresh")
        assert substep._dim_array(dense, 15, DENSE._replace(
            prep_refresh=r))[field] == 1
        assert substep._dim_array(sparse, 15, te.DEFAULT_CONTACT._replace(
            prep_refresh=r))[field] == r
        poison = substep.DIM_FIELDS.index("poison")
        assert substep._dim_array(dense, 15, DENSE)[poison] == 0
        assert substep._dim_array(dense, 15, DENSE, True)[poison] == 1


def test_dense_shared_layout(world):
    """Arrays of the dense block whose live stages overlap share no bytes;
    the size is the reckoned one for the humanoid (nd=58, lda=59, c=24):
    in the mass stage, the peak, one 58 x 59 square holding both factors
    (3,422 values) beside J^T (1,392), the CRBA rows and motion subspaces
    it is assembled from (696), the body forces (126) and q, v, tgt, mu,
    bias and the PD column (263); the Delassus matrix (576) and the
    solve's vectors overlay the dead prep later: 5,957 values and 38 ints,
    23,980 B in float and 47,808 B in double.  With the 1 KB an H100
    reserves per block, 9 float blocks fit an SM's 228 KB, and 64
    registers a thread (__launch_bounds__(128, 8)) allow 8: 8 blocks per
    SM, one wave at B=1024 on 132 SMs; 4 in double."""
    _, _, tm, *_ = world
    dims, _, _ = substep.build_tables(tm, DENSE)
    stage = {n: i for i, n in enumerate(substep.LIVE_STAGES_DENSE)}
    spans = [(dims["l_" + n], dims["l_" + n] + size(dims), stage[a],
              stage[b], n) for n, size, a, b in substep.SMEM_ARRAYS_DENSE]
    for i, (o1, e1, a1, b1, n1) in enumerate(spans):
        assert 0 <= o1 <= e1 <= dims["l_total"]
        for o2, e2, a2, b2, n2 in spans[i + 1:]:
            if a1 <= b2 and a2 <= b1:                    # live together
                assert e1 <= o2 or e2 <= o1, (n1, n2)
    live = lambda s: sum(e - o for o, e, a, b, _ in spans if a <= s <= b)
    assert max(range(len(stage)), key=live) == stage["mass"]
    assert live(stage["mass"]) == 5899 <= dims["l_total"]
    assert (dims["l_total"], dims["l_ints"]) == (5957, 38)
    assert substep.smem_bytes(dims, 4) == 23980
    assert substep.smem_bytes(dims, 8) == 47808
    per_sm, reserved, regs = 228 * 1024, 1024, 65536
    by_smem = per_sm // (substep.smem_bytes(dims, 4) + reserved)
    by_regs = regs // (substep.NT * 64)
    assert (by_smem, by_regs) == (9, 8)
    assert -(-1024 // (min(by_smem, by_regs) * 132)) == 1      # one wave
    assert per_sm // (substep.smem_bytes(dims, 8) + reserved) == 4
    # the sparse branch's layout is untouched by the dense one
    sparse, _, _ = substep.build_tables(tm, te.DEFAULT_CONTACT)
    assert substep.smem_bytes(sparse, 4) == 24044


def test_dense_mask_holds_the_ancestor_lists(world):
    """dense_mask's bit j of row i is set exactly where j is in row i's
    ancestor list (M's entries below the diagonal that are not
    structurally zero), and the dense branch's table carries it."""
    _, _, tm, *_ = world
    anc = substep.dof_anc_lists(tm.anc_mask.numpy() > 0.5)
    bits = substep.dense_mask(anc).astype(np.int64) & 0xFFFFFFFF
    words = (tm.ndof + 31) // 32
    got = [[j for j in range(tm.ndof)
            if bits[i * words + j // 32] >> (j % 32) & 1]
           for i in range(tm.ndof)]
    assert got == [list(a) for a in anc]
    dims, itab, _ = substep.build_tables(tm, DENSE)
    assert (itab[dims["i_dmask"]:dims["i_dmask"] + tm.ndof * words]
            == substep.dense_mask(anc)).all()


def test_dense_branch_refuses_what_it_cannot_take(world):
    """More contact rows than the one-warp sweep holds, or an actuator
    layout the kernel does not take: NotImplementedError, in the dense
    branch as in the sparse one."""
    _, _, tm, *_ = world
    with pytest.raises(NotImplementedError, match="contact rows"):
        substep.build_tables(tm, DENSE._replace(max_contacts=10))
    bad = tmodel.build_model(tparse(XML), dtype=torch.float64)
    object.__setattr__(bad, "actuator_dof", tuple(reversed(bad.actuator_dof)))
    with pytest.raises(NotImplementedError,
                       match="one actuator per hinge dof"):
        substep.build_tables(bad, DENSE)
