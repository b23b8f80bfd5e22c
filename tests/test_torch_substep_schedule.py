"""The level schedules and the shared-memory layout of K1 (csrc/substep.cu),
checked on the CPU without a card:

- the tree LDL^T factor (by elimination-tree levels), L^-1 in L's slots
  (row by row) and the products with it (one gather per dof for L^-T and
  for L^-1, and per dof and contact column for Y = L^-T J^T), walked in
  numpy in the kernel's order from ``substep.build_tables``' tables,
  reproduce the JAX package's ``ldl_pallas.ldl_factor`` / ``ldl_solve`` /
  ``ldl_tsolve`` on the humanoid's CRBA mass matrices at seeded states,
  float64 to 1e-12, for the PD and the dynamics systems;
- the kernel's rewrite of the contact residual and of the velocity update
  (no stored Jacobian, one L^-1 product) equals the dense formulas;
- arrays of the block's shared memory whose live stages overlap share no
  bytes, and the float32 block fits 27 KB (8 blocks per SM);
- no two threads write one value within a factor pass.
"""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.physics.ldl_pallas import (anc_segments, ldl_factor,
                                            ldl_solve, ldl_tsolve,
                                            rows_from_dense)
from egopose_tpu_torch.physics import engine, model as tmodel, substep
from egopose_tpu_torch.physics.spec import parse_mjcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-12
B = 3


@pytest.fixture(scope="module")
def world():
    """The model, its kernel tables, and (B, nd, nd) PD and dynamics
    matrices M + dt diag(kd) and M + dt diag(damping) at seeded states."""
    spec = parse_mjcf(XML)
    m = tmodel.build_model(spec, dtype=torch.float64)
    dims, itab, _ = substep.build_tables(m, engine.DEFAULT_CONTACT)
    rng = np.random.RandomState(7)
    q = np.zeros((B, spec.nq))
    q[:, 2] = 0.9
    q[:, 3:7] = rng.randn(B, 4)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.8, 0.8, (B, spec.nq - 7))
    mm = engine.crba(m, engine.fk(m, torch.tensor(q))).numpy()
    dt = m.timestep
    kd = np.r_[np.zeros(6), rng.uniform(10, 60, spec.ndof - 6)]
    systems = {"pd": mm + dt * np.diag(kd),
               "dyn": mm + dt * np.diag(m.dof_damping.numpy())}
    return m, dims, itab, systems


def _compressed(dims, itab, a):
    """Dense (nd, nd) -> compressed slots (nnz,) and diagonal (nd,)."""
    nd, nnz = dims["nd"], dims["nnz"]
    off = itab[dims["i_anc_off"]:][:nd + 1]
    idx = itab[dims["i_anc_idx"]:][:nnz]
    row = itab[dims["i_ent_row"]:][:nnz]
    return a[row, idx].copy(), np.diag(a).copy(), off, idx


def kernel_factor(dims, itab, rows, diag):
    """csrc/substep.cu's tree factor, pass by pass, thread by thread, in
    the kernel's item order: rows -> L's rows, returns invd."""
    nd, nnz, nt = dims["nd"], dims["nnz"], substep.NT
    height = itab[dims["i_height"]:][:nd]
    invd = np.where(height == 0, 1 / np.maximum(diag, 1e-12), np.nan)
    npass = dims["n_fac"]
    row = itab[dims["i_fac_row"]:][:npass + 1]
    ta = itab[dims["i_fac_a"]:][:row[-1] * nt].reshape(-1, nt)
    tb = itab[dims["i_fac_b"]:][:row[-1] * nt].reshape(-1, nt)
    val = np.concatenate([rows, diag])     # slot or nnz + diagonal
    for p in range(npass):
        for th in range(nt):
            acc = 0.0
            for r in range(row[p], row[p + 1]):
                a, b = int(ta[r, th]), int(tb[r, th])
                if a < 0:
                    continue
                tgt, k = a & 0x1FFF, (a >> 16) & 0x7F
                if a & substep.FA_SCALE:
                    val[tgt] *= invd[k]
                    continue
                e1, e2 = b & 0xFFFF, b >> 16
                if a & substep.FA_FIRST:
                    acc = val[tgt]
                acc -= (val[e1] * invd[k]) * val[e2]
                if a & substep.FA_LAST:
                    val[tgt] = acc
                    if a & substep.FA_FINAL:
                        invd[tgt - nnz] = 1 / max(acc, 1e-12)
    return val[:nnz], invd


def _ints(dims, itab, name, n):
    return itab[dims["i_" + name]:][:n].astype(np.int64)


def kernel_inverse(dims, itab, lrows):
    """L^-1 in L's slots, row by row as the kernel forms it (each row on
    its own thread): Linv[k][s] = -(L[k][s] + sum_{s<t<depth k}
    Linv[k][t] * L[anc[k][t]][s]), s from depth k - 1 down to 0."""
    nd, nnz = dims["nd"], dims["nnz"]
    off = _ints(dims, itab, "anc_off", nd + 1)
    abase = _ints(dims, itab, "anc_base", nnz)
    li = np.full(nnz, np.nan)
    for k in range(nd):
        b, dl = off[k], off[k + 1] - off[k]
        for sl in range(dl - 1, -1, -1):
            acc = lrows[b + sl]
            for t in range(sl + 1, dl):
                acc += li[b + t] * lrows[abase[b + t] + sl]
            li[b + sl] = -acc
    return li


def kernel_y(dims, itab, li, jt):
    """Y = L^-T J^T: per dof j and column, J^T[j] plus a gather over
    column j of L^-1."""
    nd, nnz = dims["nd"], dims["nnz"]
    coff = _ints(dims, itab, "col_off", nd + 1)
    cslot = _ints(dims, itab, "col_slot", nnz)
    crow = _ints(dims, itab, "col_row", nnz)
    return np.array([jt[j] + li[cslot[coff[j]:coff[j + 1]]]
                     @ jt[crow[coff[j]:coff[j + 1]]] for j in range(nd)])


def kernel_half(dims, itab, li, invd, b):
    """D^-1 L^-T b, one gather over a column of L^-1 per dof."""
    nd, nnz = dims["nd"], dims["nnz"]
    coff = _ints(dims, itab, "col_off", nd + 1)
    cslot = _ints(dims, itab, "col_slot", nnz)
    crow = _ints(dims, itab, "col_row", nnz)
    return np.array([invd[j] * (b[j] + li[cslot[coff[j]:coff[j + 1]]]
                                @ b[crow[coff[j]:coff[j + 1]]])
                     for j in range(nd)])


def kernel_forward(dims, itab, li, z):
    """L^-1 z, one gather over a row of L^-1 per dof."""
    nd, nnz = dims["nd"], dims["nnz"]
    off = _ints(dims, itab, "anc_off", nd + 1)
    idx = _ints(dims, itab, "anc_idx", nnz)
    return np.array([z[k] + li[off[k]:off[k + 1]] @ z[idx[off[k]:off[k + 1]]]
                     for k in range(nd)])


def kernel_solve(dims, itab, li, invd, b):
    """The substeps' solve through L^-1."""
    return kernel_forward(dims, itab, li, kernel_half(dims, itab, li, invd, b))


def jax_factor(m, systems, name):
    """ldl_pallas on the B matrices as lanes: (rows (nnz, B), invd
    (nd, B)) in the compressed order, and the ancestor lists."""
    anc = substep.dof_anc_lists(m.anc_mask.numpy() > 0.5)
    a = systems[name]
    mrows, dvals = rows_from_dense(jnp.asarray(a.transpose(1, 2, 0)),
                                   anc_segments(anc), m.ndof)
    invd = ldl_factor(mrows, dvals, anc)
    flat = jnp.concatenate([r for r in mrows if r is not None], 0)
    return mrows, np.asarray(flat), np.asarray(jnp.concatenate(invd, 0)), anc


@pytest.mark.parametrize("name", ["pd", "dyn"])
def test_level_factor_and_solve_match_jax_ldl(world, name):
    m, dims, itab, systems = world
    mrows, jrows, jinvd, anc = jax_factor(m, systems, name)
    rng = np.random.RandomState(11)
    b = rng.randn(B, m.ndof)
    xv = [jnp.asarray(b[:, d][None, :]) for d in range(m.ndof)]
    invd_list = [jnp.asarray(jinvd[d:d + 1]) for d in range(m.ndof)]
    ldl_solve(mrows, invd_list, anc, xv)
    jx = np.concatenate([np.asarray(x) for x in xv], 0)       # (nd, B)
    for lane in range(B):
        rows, diag, _, _ = _compressed(dims, itab, systems[name][lane])
        lrows, invd = kernel_factor(dims, itab, rows, diag)
        np.testing.assert_allclose(lrows, jrows[:, lane], rtol=0, atol=TOL)
        np.testing.assert_allclose(invd, jinvd[:, lane], rtol=TOL, atol=0)
        li = kernel_inverse(dims, itab, lrows)
        x = kernel_solve(dims, itab, li, invd, b[lane])
        np.testing.assert_allclose(x, jx[:, lane], rtol=0,
                                   atol=TOL * np.abs(jx).max())
        np.testing.assert_allclose(
            systems[name][lane] @ x, b[lane], rtol=0, atol=1e-9)


def test_transposed_solve_on_columns_matches_jax(world):
    """Y = L^-T J^T, the prep's product over contact columns."""
    m, dims, itab, systems = world
    mrows, jrows, _, anc = jax_factor(m, systems, "dyn")
    jt = np.random.RandomState(12).randn(m.ndof, 24)
    for lane in range(B):
        lrows = jrows[:, lane]
        want = [jnp.asarray(jt[d][:, None]) for d in range(m.ndof)]
        ldl_tsolve([r[:, lane:lane + 1] if r is not None else None
                    for r in mrows], anc, want)
        want = np.concatenate([np.asarray(w) for w in want], 1).T
        got = kernel_y(dims, itab, kernel_inverse(dims, itab, lrows), jt)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max())


def test_residual_and_velocity_rewrite_match_dense(world):
    """The kernel keeps Y = L^-T J^T, not J: J v_pred = Y^T (L v + D^-1 z)
    with z = L^-T (dt qfrc), and v_new = v + L^-1 D^-1 (z + Y lam) equals
    v + M^-1 (dt qfrc + J^T lam) of the split path."""
    m, dims, itab, systems = world
    a = systems["dyn"][0]
    rows, diag, off, idx = _compressed(dims, itab, a)
    lrows, invd = kernel_factor(dims, itab, rows, diag)
    li = kernel_inverse(dims, itab, lrows)
    rng = np.random.RandomState(13)
    nd = m.ndof
    jf = rng.randn(24, nd)
    jf[5] = 0.0                                          # an inactive row
    v, b, lam = rng.randn(nd), rng.randn(nd), rng.randn(24)
    y = kernel_y(dims, itab, li, jf.T.copy())
    assert not y[:, 5].any()
    lv = v.copy()
    for d in range(nd):
        lv[d] += lrows[off[d]:off[d + 1]] @ v[idx[off[d]:off[d + 1]]]
    u = kernel_half(dims, itab, li, invd, b)
    ainv_b = np.linalg.solve(a, b)
    np.testing.assert_allclose(y.T @ (lv + u), jf @ (v + ainv_b), rtol=0,
                               atol=1e-10)
    x = kernel_forward(dims, itab, li, u + invd * (y @ lam))
    np.testing.assert_allclose(v + x, v + np.linalg.solve(a, b + jf.T @ lam),
                               rtol=0, atol=1e-10)



def test_shared_layout_overlays_only_disjoint_live_ranges(world):
    m, dims, _, _ = world
    stage = {n: i for i, n in enumerate(substep.LIVE_STAGES)}
    spans = [(dims["l_" + n], dims["l_" + n] + size(dims), stage[a],
              stage[b], n) for n, size, a, b in substep.SMEM_ARRAYS]
    for i, (o1, e1, a1, b1, n1) in enumerate(spans):
        assert 0 <= o1 <= e1 <= dims["l_total"]
        for o2, e2, a2, b2, n2 in spans[i + 1:]:
            if a1 <= b2 and a2 <= b1:                    # live together
                assert e1 <= o2 or e2 <= o1, (n1, n2)
    ints = [(dims["l_" + n], dims["l_" + n] + size(dims))
            for n, size in substep.SMEM_INTS]
    assert ints[-1][1] == dims["l_ints"]
    assert all(e <= o for (_, e), (o, _) in zip(ints, ints[1:]))
    f32 = substep.smem_bytes(dims, 4)
    assert f32 <= 27 * 1024, f32
    # the overlay is what makes it fit: the sum of all arrays does not
    assert sum(size(dims) for _, size, _, _ in substep.SMEM_ARRAYS) * 4 \
        > 27 * 1024


def test_dims_struct_matches_field_list():
    src = open(os.path.join(REPO, "egopose_tpu_torch", "csrc",
                            "substep.cu")).read()
    body = re.search(r"struct Dims \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"\b([a-z]\w*)\b", body.replace("int ", " "))
    assert fields == list(substep.DIM_FIELDS)


def test_schedule_levels_and_lane_ownership(world):
    """The humanoid's elimination tree: height 28, five limbs at the lowest
    heights; within a factor pass every value is written by one thread
    only, and the pass reads only the rows of its own height's dofs, which
    no thread of the pass writes."""
    m, dims, itab, _ = world
    anc = substep.dof_anc_lists(m.anc_mask.numpy() > 0.5)
    height, depth = substep.tree_levels(anc)
    sizes = [height.count(h) for h in range(max(height) + 1)]
    assert sizes == [5, 5, 5, 5, 5, 5, 4, 2, 2, 2] + [1] * 18
    assert dims["n_fac"] == 29
    nt, nnz = substep.NT, dims["nnz"]
    row = _ints(dims, itab, "fac_row", dims["n_fac"] + 1)
    ta = _ints(dims, itab, "fac_a", row[-1] * nt).reshape(-1, nt)
    tb = _ints(dims, itab, "fac_b", row[-1] * nt).reshape(-1, nt)
    off = _ints(dims, itab, "anc_off", m.ndof + 1)
    for p in range(dims["n_fac"]):
        writer, read_rows = {}, set()
        for th in range(nt):
            for a, b in zip(ta[row[p]:row[p + 1], th], tb[row[p]:row[p + 1],
                                                          th]):
                if a < 0:
                    continue
                tgt, k = a & 0x1FFF, (a >> 16) & 0x7F
                assert writer.setdefault(tgt, th) == th
                if not a & substep.FA_SCALE:
                    assert height[k] == p
                    read_rows.add(k)
                    for e in (b & 0xFFFF, b >> 16):
                        assert off[k] <= e < off[k + 1]
        # no thread writes a row the pass reads
        written = {int(np.searchsorted(off, t, "right")) - 1 if t < nnz
                   else t - nnz for t in writer}
        assert not written & read_rows
    # the column lists of L^-1 hold every slot once, each in its ancestor's
    # column, and anc_base points at each slot's ancestor's row
    nnz = dims["nnz"]
    cslot = _ints(dims, itab, "col_slot", nnz)
    coff = _ints(dims, itab, "col_off", m.ndof + 1)
    crow = _ints(dims, itab, "col_row", nnz)
    idx = _ints(dims, itab, "anc_idx", nnz)
    row_of = _ints(dims, itab, "ent_row", nnz)
    assert sorted(cslot) == list(range(nnz))
    for j in range(m.ndof):
        sl = cslot[coff[j]:coff[j + 1]]
        assert (idx[sl] == j).all() and (row_of[sl] == crow[coff[j]:
                                                             coff[j + 1]]).all()
    abase = _ints(dims, itab, "anc_base", nnz)
    assert (abase == off[idx]).all()
