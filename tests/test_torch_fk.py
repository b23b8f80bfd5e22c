"""Forward kinematics of egopose_tpu_torch (physics/fk.py, kernel K5)
against the JAX package's lane-major FK, float64 on the CPU:

- fk.fk_batched on the CPU (its plain version, engine.fk) against the
  Pallas kernel's body _fk_compute and the level-batched _fk_compute_lvl,
  run as plain JAX ops (as tests/test_fk_pallas.py does; interpret mode
  would take minutes), at 1e-12 on every output;
- the kernel's tables (fk.build_tables: a flat per-hinge schedule)
  walked in numpy in csrc/fk.cu's stages (the hinges' rotations, each
  body's transform relative to its parent, the composition along each
  body's ancestor path, the s rows from each hinge's parent pose)
  reproduce engine.fk and the JAX package's _fk_compute and
  _fk_compute_lvl at 1e-12, so the layout the kernel reads is checked here
  too, and the block's shared bytes are the reckoned ones;
- the CUDA wrapper refuses what the kernel does not take.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.physics import build_model as jbuild
from egopose_tpu.physics.fk_pallas import (_build_topo, _fk_compute,
                                           _fk_compute_lvl)
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu_torch.physics import engine, fk, model as tmodel
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-12


@pytest.fixture(scope="module")
def world():
    """tests/test_fk_pallas.py's states (random root orientation, hinges
    at 0.3 rad RMS) plus one unnormalised root quaternion."""
    jm = jbuild(jparse(XML), dtype=jnp.float64)
    tm = tmodel.build_model(tparse(XML), dtype=torch.float64)
    rng = np.random.RandomState(0)
    b = 5
    q = np.tile(np.concatenate([[0.1, -0.2, 0.91, 1, 0, 0, 0],
                                np.zeros(52)]), (b, 1))
    q[:, 3:7] = rng.randn(b, 4)
    q[:4, 3:7] /= np.linalg.norm(q[:4, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.3 * rng.randn(b, 52)
    return jm, tm, q


@pytest.mark.parametrize("ref", [_fk_compute, _fk_compute_lvl],
                         ids=["fk_compute", "fk_compute_lvl"])
def test_fk_batched_matches_jax_lane_major_fk(world, ref):
    jm, tm, q = world
    want = ref(jnp.asarray(q.T), _build_topo(jm), jnp.float64)
    got = fk.fk_batched(tm, torch.tensor(q))
    assert isinstance(got, engine.Kin)
    for name, g, w in zip(got._fields, got, want):
        # lane-major (rows, comp, B) -> (B, rows, comp)
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(2, 0, 1),
                                   rtol=0, atol=TOL, err_msg=name)


def _qrot(q, v):
    t = 2.0 * np.cross(q[1:], v)
    return v + q[0] * t + np.cross(q[1:], t)


def _qmul(a, b):
    return np.array([
        a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
        a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
        a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
        a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0]])


def _walk_tables(dims, itab, ftab, q):
    """csrc/fk.cu's stages for one environment, reading only the tables."""
    i = lambda name, n: itab[dims["i_" + name]:dims["i_" + name] + n]
    f = lambda name, n: ftab[dims["f_" + name]:dims["f_" + name] + 3 * n] \
        .reshape(n, 3)
    nb, nd, nh = dims["nb"], dims["nd"], dims["nh"]
    path_off, hinge_off = i("path_off", nb + 1), i("hinge_off", nb + 1)
    path_idx = i("path_idx", path_off[-1])
    hdof, hqadr, hpar = i("hdof", nh), i("hqadr", nh), i("hpar", nh)
    body_pos, body_ipos = f("body_pos", nb), f("body_ipos", nb)
    haxis, hanchor = f("haxis", nh), f("hanchor", nh)
    wq, wt, s = np.zeros((nb, 4)), np.zeros((nb, 3)), np.zeros((nd, 6))
    wq[0] = q[3:7] / max(np.sqrt(np.sum(q[3:7] ** 2)), 1e-12)
    wt[0] = q[:3]
    # every hinge's rotation
    rh = [np.r_[np.cos(0.5 * q[hqadr[h]]), haxis[h] * np.sin(0.5 * q[hqadr[h]])]
          for h in range(nh)]
    # each body's transform relative to its parent; each hinge's axis and
    # anchor in the parent's frame
    lq, lt = np.zeros((nb, 4)), np.zeros((nb, 3))
    for b in range(1, nb):
        rq, rt = np.array([1.0, 0, 0, 0]), body_pos[b].copy()
        for h in range(hinge_off[b], hinge_off[b + 1]):
            anchor = rt + _qrot(rq, hanchor[h])
            s[hdof[h]] = np.r_[_qrot(rq, haxis[h]), anchor]
            rq = _qmul(rq, rh[h])
            rt = anchor - _qrot(rq, hanchor[h])
        lq[b], lt[b] = rq, rt
    # the walk along each body's ancestor path
    for b in range(1, nb):
        bq, bt = wq[0].copy(), wt[0].copy()
        for a in path_idx[path_off[b]:path_off[b + 1]]:
            bt = bt + _qrot(bq, lt[a])
            bq = _qmul(bq, lq[a])
        wq[b], wt[b] = bq, bt
    # the s rows: the root's, then each hinge's from its parent's pose
    for r in range(3):
        s[r] = 0.0
        s[r, 3 + r] = 1.0
        aw = _qrot(wq[0], np.eye(3)[r])
        s[3 + r] = np.r_[aw, np.cross(wt[0], aw)]
    for h in range(nh):
        p, row = hpar[h], s[hdof[h]]
        aw = _qrot(wq[p], row[:3])
        anw = wt[p] + _qrot(wq[p], row[3:])
        s[hdof[h]] = np.r_[aw, np.cross(anw, aw)]
    com = wt + np.stack([_qrot(wq[b], body_ipos[b]) for b in range(nb)])
    return wt, wq, com, s


def test_kernel_tables_walk_matches_engine_fk(world):
    _, tm, q = world
    dims, itab, ftab = fk.build_tables(tm)
    assert set(fk.DIM_FIELDS) == set(dims)
    assert itab.dtype == np.int32 and ftab.dtype == np.float64
    assert (dims["nb"], dims["nd"], dims["nh"]) == (21, 58, 52)
    assert (dims["n_int"], dims["n_float"]) == (itab.size, ftab.size)
    want = engine.fk(tm, torch.tensor(q))
    for lane in range(q.shape[0]):
        got = _walk_tables(dims, itab, ftab, q[lane])
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g, w[lane].numpy(), rtol=0, atol=TOL,
                                       err_msg=f"lane {lane} {name}")


@pytest.mark.parametrize("ref", [_fk_compute, _fk_compute_lvl],
                         ids=["fk_compute", "fk_compute_lvl"])
def test_kernel_tables_walk_matches_jax_lane_major_fk(world, ref):
    """The same walk against the Pallas kernel's body and the level-batched
    FK it replaces, lane-major (rows, comp, B)."""
    jm, tm, q = world
    dims, itab, ftab = fk.build_tables(tm)
    want = ref(jnp.asarray(q.T), _build_topo(jm), jnp.float64)
    for lane in range(q.shape[0]):
        got = _walk_tables(dims, itab, ftab, q[lane])
        for name, g, w in zip(engine.Kin._fields, got, want):
            np.testing.assert_allclose(g, np.asarray(w)[..., lane], rtol=0,
                                       atol=TOL, err_msg=f"lane {lane} {name}")


def test_kernel_block_bytes(world):
    """A block of four environments: the staged tables (438 floats, 285
    ints) and per environment qpos, the hinges' rotations, the bodies'
    relative transforms and the staged outputs (972 values): 18,444 B in
    float, 35,748 B in double, within the 48 KB a block takes without
    opting in."""
    _, tm, _ = world
    dims, _, _ = fk.build_tables(tm)
    assert (dims["n_float"], dims["n_int"]) == (438, 285)
    assert fk.block_bytes(dims, 4) == 18444
    assert fk.block_bytes(dims, 8) == 35748 <= 48 * 1024


def test_fk_cuda_refuses_what_the_kernel_does_not_take(world):
    _, tm, q = world
    with pytest.raises(ValueError, match="CUDA"):
        fk.fk_cuda(tm, torch.tensor(q))
    with pytest.raises(ValueError, match="dtype"):
        fk.fk_cuda(tm, torch.tensor(q, dtype=torch.float32))
