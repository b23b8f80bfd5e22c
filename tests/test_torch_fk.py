"""Forward kinematics of egopose_tpu_torch (physics/fk.py, kernel K5)
against the JAX package's lane-major FK, float64 on the CPU:

- fk.fk_batched on the CPU (its plain version, engine.fk) against the
  Pallas kernel's body _fk_compute and the level-batched _fk_compute_lvl,
  run as plain JAX ops (as tests/test_fk_pallas.py does; interpret mode
  would take minutes), at 1e-12 on every output;
- the kernel's tables (fk.build_tables) walked in numpy in csrc/fk.cu's
  order reproduce engine.fk at 1e-12, so the layout the kernel reads is
  checked here too;
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
    """csrc/fk.cu's walk for one environment, reading only the tables."""
    i = lambda name, n: itab[dims["i_" + name]:dims["i_" + name] + n]
    f = lambda name, n: ftab[dims["f_" + name]:dims["f_" + name] + 3 * n] \
        .reshape(n, 3)
    nb, nd, nl = dims["nb"], dims["nd"], dims["nlevel"]
    parent, lvl_off = i("parent", nb), i("lvl_off", nl + 1)
    lvl_body = i("lvl_body", lvl_off[-1])
    bdof_off = i("bdof_off", nb + 1)
    bdof_idx, qadr = i("bdof_idx", bdof_off[-1]), i("qadr", nd)
    body_pos, body_ipos = f("body_pos", nb), f("body_ipos", nb)
    axis, anchor = f("axis", nd), f("anchor", nd)
    wq, wt, s = np.zeros((nb, 4)), np.zeros((nb, 3)), np.zeros((nd, 6))
    wq[0] = q[3:7] / max(np.sqrt(np.sum(q[3:7] ** 2)), 1e-12)
    wt[0] = q[:3]
    for r in range(3):
        s[r, 3 + r] = 1.0
        aw = _qrot(wq[0], np.eye(3)[r])
        s[3 + r] = np.r_[aw, np.cross(wt[0], aw)]
    for lv in range(nl):
        for b in lvl_body[lvl_off[lv]:lvl_off[lv + 1]]:
            bq = wq[parent[b]]
            bt = wt[parent[b]] + _qrot(bq, body_pos[b])
            for d in bdof_idx[bdof_off[b]:bdof_off[b + 1]]:
                aw = _qrot(bq, axis[d])
                anw = bt + _qrot(bq, anchor[d])
                s[d] = np.r_[aw, np.cross(anw, aw)]
                half = 0.5 * q[qadr[d]]
                bq = _qmul(bq, np.r_[np.cos(half), axis[d] * np.sin(half)])
                bt = anw - _qrot(bq, anchor[d])
            wq[b], wt[b] = bq, bt
    com = wt + np.stack([_qrot(wq[b], body_ipos[b]) for b in range(nb)])
    return wt, wq, com, s


def test_kernel_tables_walk_matches_engine_fk(world):
    _, tm, q = world
    dims, itab, ftab = fk.build_tables(tm)
    assert set(fk.DIM_FIELDS) == set(dims)
    assert itab.dtype == np.int32 and ftab.dtype == np.float64
    assert (dims["nb"], dims["nd"], dims["nlevel"]) == (21, 58, 8)
    want = engine.fk(tm, torch.tensor(q))
    for lane in range(q.shape[0]):
        got = _walk_tables(dims, itab, ftab, q[lane])
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g, w[lane].numpy(), rtol=0, atol=TOL,
                                       err_msg=f"lane {lane} {name}")


def test_fk_cuda_refuses_what_the_kernel_does_not_take(world):
    _, tm, q = world
    with pytest.raises(ValueError, match="CUDA"):
        fk.fk_cuda(tm, torch.tensor(q))
    with pytest.raises(ValueError, match="dtype"):
        fk.fk_cuda(tm, torch.tensor(q, dtype=torch.float32))
