"""The substep-resident stable-PD control step as one CUDA kernel launch.

Port of egopose_tpu/physics/substep_pallas.py: ``_substep_kernel`` (reached
through ``_substep_tpu`` and ``make_substep_step``) becomes the hand-written
CUDA C++ kernel in ``csrc/substep.cu``, one thread block per environment,
running all ``n_frames`` substeps of one 30 Hz control step with the lane's
working set in shared memory.  This module builds the kernel's per-model
tables (the counterpart of ``_build_static`` / ``_packed_consts`` /
``_packed_pair_consts`` and of ldl_pallas's ancestor lists), the level
schedule of its tree LDL^T (``factor_schedule``) and the tables of its
products with L^-1 (``inverse_tables``) and
its shared-memory layout (``smem_layout``, arrays overlaid where their live
stages do not overlap), compiles the kernel with nvcc at first use, and
launches it through ctypes.  ``occupancy`` reads the kernel's registers
and blocks per SM on the card; ``pd_control_step_cuda(..., clocks=...)``
runs its stage-clock build.

The kernel has two branches, as the TPU kernel has: by default
(``ContactParams.sparse_ldl``) it solves the PD and dynamics systems by
the sparse tree LDL^T above, with the prep refreshed every
``prep_refresh`` substeps; with ``sparse_ldl=False`` it runs the TPU
kernel's dense branch (substep_pallas.py:739-830): the prep every substep
whatever ``prep_refresh`` says, the dense M in both triangles of one
square, two dense Cholesky factors side by side, and the contact solve
forward only (Y = L^-1 J^T riding on the dynamics factor, the Delassus
matrix Y^T Y, one back substitution), which is the TPU branch's
W = A_dyn^-1 J^T and J W in another association.  The branches are two
instantiations of one kernel source with their own shared layouts
(``SMEM_ARRAYS``, ``SMEM_ARRAYS_DENSE``) and launch counts (``launches``,
``dense_launches``).

Dispatch (engine.pd_control_step, the counterpart of make_substep_step):
with ``ContactParams.substep_resident`` (the default) a CUDA batch runs the
kernel at any B >= 1; a CPU batch runs the plain split path
(engine.pd_control_step_split), which ignores ``sparse_ldl``; at
prep_refresh=1 it is the plain version of the dense branch.  There is no
fallback from CUDA to the plain version: a model the kernel does not
support raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import engine, nvcc
from .model import PhysicsModel

# Launch counts of the kernel's sparse and dense branches: each
# incremented once per launch of its branch, nowhere else.
launches = 0
dense_launches = 0

# Arrays of one block's shared memory (csrc/substep.cu), in allocation
# order: (name, size, first stage, last stage) with the size a function of
# the dims and the stages those of LIVE_STAGES.  smem_layout places each
# array at the lowest offset that overlaps no array live at the same time.
LIVE_STAGES = ("load fk narrowphase select dynamics mass factor inverse y "
               "delassus substeps").split()
SMEM_ARRAYS = (
    ("q", lambda d: d["nq"], "load", "substeps"),
    ("v", lambda d: d["nd"], "load", "substeps"),
    ("mpd", lambda d: d["nnz"], "mass", "substeps"),
    ("mdyn", lambda d: d["nnz"], "mass", "substeps"),
    ("ipd", lambda d: d["nd"], "mass", "substeps"),
    ("idyn", lambda d: d["nd"], "mass", "substeps"),
    ("bias", lambda d: d["nd"], "mass", "substeps"),
    ("lidyn", lambda d: d["nnz"], "inverse", "substeps"),
    ("y", lambda d: d["nd"] * d["c3"], "select", "substeps"),
    ("tgt", lambda d: d["c3"], "select", "substeps"),
    ("mu", lambda d: d["k"], "select", "substeps"),
    ("xpos", lambda d: 3 * d["nb"], "fk", "mass"),
    ("xquat", lambda d: 4 * d["nb"], "fk", "mass"),
    ("s", lambda d: 6 * d["nd"], "fk", "mass"),
    ("pall", lambda d: 3 * d["ncp"], "narrowphase", "select"),
    ("phiall", lambda d: d["ncp"], "narrowphase", "select"),
    ("pphi", lambda d: d["npair"] + d["nbpair"], "narrowphase", "select"),
    ("pn", lambda d: 3 * (d["npair"] + d["nbpair"]), "narrowphase",
     "select"),
    ("pp", lambda d: 3 * (d["npair"] + d["nbpair"]), "narrowphase",
     "select"),
    ("selphi", lambda d: d["k"] + d["kp"], "narrowphase", "select"),
    ("com", lambda d: 3 * d["nb"], "dynamics", "mass"),
    ("ic", lambda d: 6 * d["nb"], "dynamics", "mass"),
    ("io", lambda d: 6 * d["nb"], "dynamics", "dynamics"),
    ("smom", lambda d: 3 * d["nb"], "dynamics", "mass"),
    ("sio", lambda d: 6 * d["nb"], "dynamics", "mass"),
    ("smass", lambda d: d["nb"], "dynamics", "mass"),
    ("sq", lambda d: 6 * d["nd"], "dynamics", "mass"),
    ("cj", lambda d: 6 * d["nd"], "dynamics", "mass"),
    ("fcrb", lambda d: 6 * d["nd"], "dynamics", "mass"),
    ("fb", lambda d: 6 * d["nb"], "dynamics", "mass"),
    ("dpd", lambda d: d["nd"], "mass", "factor"),
    ("ddyn", lambda d: d["nd"], "mass", "factor"),
    ("lipd", lambda d: d["nnz"], "inverse", "inverse"),
    ("abase", lambda d: d["nnz"], "inverse", "inverse"),     # ints
    ("jt", lambda d: d["nd"] * d["c3"], "y", "y"),
    ("g", lambda d: d["c3"] * d["c3"], "delassus", "substeps"),
    ("gid", lambda d: d["c3"], "delassus", "substeps"),
    ("rhs", lambda d: d["nd"], "substeps", "substeps"),
    ("z", lambda d: d["nd"], "substeps", "substeps"),
    ("u", lambda d: d["nd"], "substeps", "substeps"),
    ("w", lambda d: d["nd"], "substeps", "substeps"),
    ("lam", lambda d: d["c3"], "substeps", "substeps"),
)
# The dense branch's arrays.  Per substep: the prep; the square of both
# factors (A_dyn's in the lower triangle, A_pd's in the upper), assembled
# in the mass stage once the CRBA/RNEA intermediates it overlays are dead;
# the PD column (xpd); J^T, which becomes Y = L^-1 J^T in place, and J v
# (jq); the dynamics column (xdyn: dt qfrc, z0, then v_new); the Delassus
# matrix Y^T Y (g) and the sweep's vectors.  The prep arrays as in the
# sparse branch, each ending where the dense branch last reads it.
LIVE_STAGES_DENSE = ("load fk narrowphase select dynamics mass factor gram "
                     "torque solve").split()
_PREP_DENSE_LAST = dict(xpos="dynamics", xquat="dynamics", s="mass",
                        com="dynamics", ic="dynamics", io="dynamics",
                        smom="dynamics", sio="dynamics", smass="dynamics",
                        sq="dynamics", cj="dynamics", fcrb="mass", fb="mass")
_PREP = tuple((n, size, first, _PREP_DENSE_LAST.get(n, last))
              for n, size, first, last in SMEM_ARRAYS
              if n in ("xpos xquat s pall phiall pphi pn pp selphi com ic "
                       "io smom sio smass sq cj fcrb fb").split())
SMEM_ARRAYS_DENSE = (
    ("q", lambda d: d["nq"], "load", "solve"),
    ("v", lambda d: d["nd"], "load", "solve"),
    ("jt", lambda d: d["nd"] * d["c3"], "select", "solve"),
    ("tgt", lambda d: d["c3"], "select", "solve"),
    ("mu", lambda d: d["k"], "select", "solve"),
    ("asq", lambda d: d["nd"] * d["lda"], "mass", "solve"),
    ("bias", lambda d: d["nd"], "mass", "mass"),
    ("rpd", lambda d: d["nd"], "factor", "gram"),
    ("rdyn", lambda d: d["nd"], "factor", "solve"),
    ("xpd", lambda d: d["nd"], "mass", "torque"),
    ("jq", lambda d: d["c3"], "factor", "solve"),
    ("xdyn", lambda d: d["nd"], "torque", "solve"),
) + _PREP + (
    ("g", lambda d: d["c3"] * d["c3"], "gram", "solve"),
    ("gid", lambda d: d["c3"], "torque", "solve"),
    ("lam", lambda d: d["c3"], "solve", "solve"),
)
# Every array name of either branch, in the order of Dims' l_ fields.
SMEM_NAMES = tuple(a[0] for a in SMEM_ARRAYS) + tuple(
    a[0] for a in SMEM_ARRAYS_DENSE
    if a[0] not in {b[0] for b in SMEM_ARRAYS})
# int arrays after the float ones: the selected floor and pair candidates,
# the active contact rows, their count and their bit mask
SMEM_INTS = (("sel", lambda d: d["k"] + d["kp"]),
             ("act", lambda d: d["c3"]), ("nact", lambda d: 1),
             ("amask", lambda d: 1))

# Field order of the ``Dims`` struct in csrc/substep.cu (ints only).
DIM_FIELDS = (
    "nb nd nq nu ncp npair nbpair k kp c3 nnz nlevel "
    "n_frames prep_refresh iters dense lda "
    "i_parent i_dof_body i_hinge0 i_nhinge i_lvl_off i_lvl_body "
    "i_path_off i_path_idx i_vp_off i_vp_idx i_desc_off i_desc_idx "
    "i_anc_off i_anc_idx i_ent_row i_banc i_cp_body "
    "i_p_b1 i_p_b2 i_bp_seg i_bp_box "
    "i_height i_fac_a i_fac_b i_fac_row i_col_off i_col_slot i_col_row "
    "i_anc_base n_fac i_dmask "
    "f_body_pos f_body_ipos f_mass f_inertia f_axis f_anchor "
    "f_armature f_damping f_stiffness f_lo f_hi f_limited f_gear "
    "f_gravity f_cp_local f_cp_radius f_cp_mu "
    "f_p_a1 f_p_b1 f_p_a2 f_p_b2 f_p_rsum f_p_rdiff "
    "f_bp_a f_bp_b f_bp_rseg f_bp_pos f_bp_quat f_bp_half f_scal").split() \
    + ["l_" + a for a in SMEM_NAMES] + ["l_" + a[0] for a in SMEM_INTS] \
    + ["l_total", "l_ints", "poison"]

NT = 128              # threads per block (csrc/substep.cu)
MAX_ROWS = 32         # contact rows: the kernel's sweep runs in one warp

# Stages of the stage-clock build (enum Stage in csrc/substep.cu), in order.
STAGES = ("load fk dynamics narrowphase select factor inverse y delassus pd "
          "torque dyn_solve residual sweep velocity integrate store "
          "gram z0").split()
CLOCKS_DEFINE = "EGOPOSE_STAGE_CLOCKS"
# The build whose dense branch honours Dims.poison (pd_control_step_cuda's
# poison_upper): the main build carries no poison code, which cost the
# dense branch 7% at B = 1024 though it never ran (PERF.md section 6).
POISON_DEFINE = "EGOPOSE_POISON"


def reset_launches():
    global launches, dense_launches
    launches = dense_launches = 0


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


def smem_layout(dims: dict, dense: bool = False) -> dict:
    """Offsets of the block's shared arrays (SMEM_ARRAYS, or with ``dense``
    SMEM_ARRAYS_DENSE, in elements of the float type; SMEM_INTS, in ints
    after them) as ``l_<name>``, plus ``l_total`` floats and ``l_ints``
    ints; the other branch's arrays get offset 0.  First fit: each array
    goes at the lowest offset where it overlaps no placed array whose
    stages overlap its own, so arrays live only in the prep share bytes
    with the later stages' arrays."""
    stages, arrays = (LIVE_STAGES_DENSE, SMEM_ARRAYS_DENSE) if dense \
        else (LIVE_STAGES, SMEM_ARRAYS)
    stage = {n: i for i, n in enumerate(stages)}
    placed, out = [], {"l_" + n: 0 for n in SMEM_NAMES}
    for name, size, first, last in arrays:
        n, lo, hi = size(dims), stage[first], stage[last]
        busy = sorted((o, o + sz) for o, sz, a, b in placed
                      if a <= hi and lo <= b)
        off = 0
        for a, b in busy:
            if off + n <= a:
                break
            off = max(off, b)
        placed.append((off, n, lo, hi))
        out["l_" + name] = off
    out["l_total"] = max(o + n for o, n, _, _ in placed)
    off = 0
    for name, size in SMEM_INTS:
        out["l_" + name] = off
        off += size(dims)
    out["l_ints"] = off
    return out


def smem_bytes(dims: dict, itemsize: int) -> int:
    """Dynamic shared memory of one block for a float of ``itemsize``."""
    return dims["l_total"] * itemsize + 4 * dims["l_ints"]


# ---------------------------------------------------------------------------
# the level schedule of the tree LDL^T and the tables of L^-1 (csrc/substep.cu)
# ---------------------------------------------------------------------------
#
# Dof j is an ancestor of dof k in the elimination tree when j is in
# anc[k]; the tree's parent of k is anc[k][-1].  ``height`` counts from the
# leaves (0), ``depth`` from the root (depth[k] == len(anc[k])).  Dofs of
# one height depend on none of each other in the factor.
#
# A factor item is two ints (a, b): a = target | first << 13 | last << 14 |
# final << 15 | k << 16 | scale << 23, b = e1 | e2 << 16.  target < nnz is
# the compressed slot, nnz + j the diagonal of dof j; the update is
# target -= (rows[e1] * invd[k]) * rows[e2] (ldl_pallas.ldl_factor's);
# ``final`` marks the last update of a diagonal, whose reciprocal the same
# thread then stores; a ``scale`` item multiplies slot ``target`` of an
# earlier level's row by invd[k].  NT items per table row.
FA_FIRST, FA_LAST, FA_FINAL, FA_SCALE = 1 << 13, 1 << 14, 1 << 15, 1 << 23


def tree_levels(anc: tuple):
    """(height, depth) of every dof of the elimination tree."""
    n = len(anc)
    height = [0] * n
    for k in range(n - 1, -1, -1):
        if anc[k]:
            p = anc[k][-1]
            height[p] = max(height[p], height[k] + 1)
    return height, [len(a) for a in anc]


def _pack(levels, width, pad):
    """Lay out each level's groups (lists of items that one lane runs in a
    row) over ``width`` lanes, longest group first onto the least loaded
    lane.  Returns (table (rows, width) of items, row offset per level)."""
    rows, row_off = [], [0]
    for groups in levels:
        lanes = [[] for _ in range(width)]
        for g in sorted(groups, key=len, reverse=True):
            min(lanes, key=len).extend(g)
        nrow = max((len(x) for x in lanes), default=0)
        for r in range(nrow):
            rows.append([x[r] if r < len(x) else pad for x in lanes])
        row_off.append(len(rows))
    return rows, row_off


def inverse_tables(anc: tuple, anc_off) -> dict:
    """Tables of the products with L^-1, which has L's compressed slots
    (the tree factor has no fill, and a row's ancestor list holds all its
    ancestors): ``col_off``/``col_slot``/``col_row`` the slots of each
    column j (the entries (k, j) of L^-1 with j an ancestor of k) and
    their rows k, for x <- L^-T b as one gather per dof, and ``anc_base``
    the first slot of each slot's ancestor's row (anc_off[anc_idx[e]]),
    for forming L^-1's rows."""
    n = len(anc)
    cols = [[] for _ in range(n)]
    for k in range(n):
        for sl, j in enumerate(anc[k]):
            cols[j].append((int(anc_off[k]) + sl, k))
    col_off, _ = _csr(cols)
    flat = [e for c in cols for e in c]
    return dict(col_off=col_off,
                col_slot=np.array([e for e, _ in flat], np.int64),
                col_row=np.array([k for _, k in flat], np.int64),
                anc_base=np.array([anc_off[j] for a in anc for j in a],
                                  np.int64))


def factor_schedule(anc: tuple, anc_off, nnz: int):
    """The factor's item tables (a, b) of shape (rows, NT) and the row
    offset of each pass: pass h updates every entry of the rows above the
    dofs of height h (gathering over those dofs), and scales the rows of
    height h-1; one extra pass scales the top level's rows."""
    height, depth = tree_levels(anc)
    n, top = len(anc), max(height)
    passes = []
    for h in range(top + 2):
        ks = [k for k in range(n) if height[k] == h]
        groups = []
        for j in sorted({j for k in ks for j in anc[k]}):
            contrib = [k for k in ks if j in anc[k]]
            dj = depth[j]
            for t in range(dj + 1):            # t == dj: the diagonal
                target = nnz + j if t == dj else int(anc_off[j]) + t
                g = []
                for i, k in enumerate(contrib):
                    e1 = int(anc_off[k]) + dj
                    e2 = int(anc_off[k]) + t
                    a = target | k << 16 | (FA_FIRST if i == 0 else 0)
                    if i == len(contrib) - 1:
                        a |= FA_LAST
                        if t == dj and height[j] == h + 1:
                            a |= FA_FINAL
                    g.append((a, e1 | e2 << 16))
                groups.append(g)
        for k in (x for x in range(n) if height[x] == h - 1):
            groups.extend([[(int(anc_off[k]) + sl | k << 16 | FA_SCALE, 0)]
                           for sl in range(depth[k])])
        passes.append(groups)
    rows, row_off = _pack(passes, NT, (-1, 0))
    tab = np.array(rows, np.int64).reshape(-1, NT, 2)
    return tab[..., 0], tab[..., 1], np.array(row_off, np.int64)


def support_segments(m: PhysicsModel) -> tuple:
    """The dofs that any contact candidate (floor point or body pair) can
    load, as ascending maximal (start, end) ranges: J's columns are
    structurally zero elsewhere (substep_pallas.py's ``sup_segs``, over
    which the TPU kernel's dense branch sums J W; chip_smoke.py counts
    J v over them in the dense branch's bound)."""
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()
    pdm = np.concatenate([f64(m.point_dof_mask), np.abs(f64(m.pair_dof_mask)),
                          np.abs(f64(m.bpair_dof_mask))], axis=1)
    segs = []
    for j in np.nonzero(pdm.sum(1) > 0)[0]:
        if segs and segs[-1][1] == j:
            segs[-1][1] = int(j) + 1
        else:
            segs.append([int(j), int(j) + 1])
    return tuple((a, b) for a, b in segs)


def dense_mask(anc: tuple) -> np.ndarray:
    """The dense branch's structure of M: bit j of row i (words of 32
    bits, (nd + 31) // 32 per row, as int32) is set where j is in anc[i],
    the entries below the diagonal that are not structurally zero."""
    n = len(anc)
    words = (n + 31) // 32
    bits = np.zeros((n, words), np.int64)
    for i, a in enumerate(anc):
        for j in a:
            bits[i, j // 32] |= 1 << (j % 32)
    return np.where(bits >= 1 << 31, bits - (1 << 32), bits).ravel()


def build_tables(m: PhysicsModel, params: engine.ContactParams):
    """Per-model kernel tables for the branch ``params.sparse_ldl`` picks:
    (dims dict without the per-call fields, int32 table, float64 table).
    The kernel loops over these; nothing of the model is baked into its
    code."""
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
    dense = not params.sparse_ldl
    anc_off, anc_idx = _csr(anc_lists)
    ent_row = np.repeat(np.arange(nd), np.diff(anc_off))
    if nd > NT:
        raise NotImplementedError(
            f"the kernel takes at most {NT} dofs, got {nd}")
    height, _ = tree_levels(anc_lists)
    none = np.zeros(0, np.int64)
    if dense:          # the tree factor's tables are the sparse branch's
        inv = dict(col_off=none, col_slot=none, col_row=none, anc_base=none)
        fac_a, fac_b, fac_row = none, none, np.zeros(1, np.int64)
        dmask = dense_mask(anc_lists)
    else:
        # the factorization's aligned prefix updates need nested lists:
        # for j = anc[d][s], anc[j] == anc[d][:s] (ldl_pallas.py:19-25)
        for d in range(nd):
            for s, j in enumerate(anc_lists[d]):
                if anc_lists[j] != anc_lists[d][:s]:
                    raise NotImplementedError(
                        "dof ancestor lists do not nest")
        if len(anc_idx) + nd >= 1 << 13:
            raise NotImplementedError(
                f"the tree factor's tables take at most "
                f"{(1 << 13) - nd - 1} compressed slots, got {len(anc_idx)}")
        inv = inverse_tables(anc_lists, anc_off)
        fac_a, fac_b, fac_row = factor_schedule(anc_lists, anc_off,
                                                len(anc_idx))
        dmask = none
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
            ("bp_box", m.bpair_body_box.cpu().numpy()),
            ("height", height),
            ("fac_a", fac_a), ("fac_b", fac_b), ("fac_row", fac_row),
            ("dmask", dmask)] \
        + list(inv.items())
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
                nlevel=len(lvl_off) - 1, iters=int(p.iters),
                n_fac=len(fac_row) - 1, dense=int(dense), lda=(nd + 1) | 1,
                poison=0)
    dims.update(smem_layout(dims, dense))
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

_libs = {}
_DIMS = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]


def build(verbose: bool = False) -> str:
    """Compile csrc/substep.cu with nvcc (route (b): plain C interface,
    loaded with ctypes) unless the library for this source exists."""
    return nvcc.build("substep.cu", verbose)


def _load(define: str | None = None):
    """The kernel's library; with ``define`` its stage-clock build
    (CLOCKS_DEFINE) or its poison build (POISON_DEFINE)."""
    if define not in _libs:
        lib = ctypes.CDLL(nvcc.build(("substep.cu", (define,)))
                          if define else build())
        clocks = define == CLOCKS_DEFINE
        names = ("egopose_substep_clocks_f32",) if clocks else \
            ("egopose_substep_f32", "egopose_substep_f64")
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = _DIMS + [ctypes.c_void_p] * (11 if clocks else 10) \
                + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.egopose_substep_occupancy.argtypes = _DIMS + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.egopose_substep_occupancy.restype = ctypes.c_int
        _libs[define] = lib
    return _libs[define]


def _device_tables(m: PhysicsModel, params, device, dtype):
    # ``params`` holds sparse_ldl: each branch has its tables and layout
    key = (params, str(device), dtype)
    if key not in m.kernel_cache:
        dims, itab, ftab = build_tables(m, params)
        m.kernel_cache[key] = (
            dims, torch.as_tensor(itab).to(device),
            torch.as_tensor(ftab).to(device=device, dtype=dtype))
    return m.kernel_cache[key]


def _dim_array(dims, n_frames, params, poison=False):
    """The Dims struct of one launch; the dense branch refreshes its prep
    every substep whatever ``prep_refresh`` says, as the TPU kernel's."""
    r = 1 if dims["dense"] else max(1, int(params.prep_refresh))
    dims = dict(dims, n_frames=int(n_frames), prep_refresh=r,
                poison=int(poison))
    return (ctypes.c_int * len(DIM_FIELDS))(
        *[int(dims[f]) for f in DIM_FIELDS])


def occupancy(m: PhysicsModel, dtype, n_frames: int = 15,
              params: engine.ContactParams = engine.DEFAULT_CONTACT) -> dict:
    """The kernel's resources on the current card for ``m`` in the branch
    ``params.sparse_ldl`` picks: blocks per SM, registers per thread,
    shared bytes per block, spill bytes."""
    dims, _, _ = build_tables(m, params)
    out = (ctypes.c_int * 4)()
    err = _load().egopose_substep_occupancy(
        _dim_array(dims, n_frames, params), len(DIM_FIELDS),
        int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: error {err}")
    return dict(blocks_per_sm=out[0], registers=out[1], shared_bytes=out[2],
                local_bytes=out[3])


def pd_control_step_cuda(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd, tlim,
                         n_frames: int,
                         params: engine.ContactParams = engine.DEFAULT_CONTACT,
                         clocks=None, poison_upper: bool = False):
    """Launch the kernel, in the branch ``params.sparse_ldl`` picks: qpos
    (B,nq), qvel (B,nd), ctrl/jkp/jkd/tlim (B,nu), all contiguous CUDA
    tensors of one float dtype -> (qpos', qvel'), new tensors.  With
    ``clocks``, a (B, len(STAGES)) int64 CUDA tensor, the stage-clock build
    runs instead (float32 only) and fills it with each stage's cycles; it
    is not counted as a launch.  ``poison_upper`` (dense branch; the
    kernel's POISON_DEFINE build, counted as a launch) fills the
    square of both factors with NaN before every assembly, and after it
    every value of the block but those of the arrays live into the
    factors: the outputs stay finite and unchanged only if every entry a
    factor reads is written anew each substep and no stage from the
    factors on reads the dead prep or a value before writing it."""
    global launches, dense_launches
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
    dim_arr = _dim_array(dims, n_frames, params, poison_upper)
    qpos_out = torch.empty_like(qpos)
    qvel_out = torch.empty_like(qvel)
    ptrs = [itab.data_ptr(), ftab.data_ptr(), qpos.data_ptr(),
            qvel.data_ptr(), ctrl.data_ptr(), jkp.data_ptr(), jkd.data_ptr(),
            tlim.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr()]
    stream = torch.cuda.current_stream(qpos.device).cuda_stream
    if clocks is not None:
        if dtype != torch.float32 or clocks.dtype != torch.int64 \
                or tuple(clocks.shape) != (bsz, len(STAGES)) \
                or clocks.device != qpos.device or not clocks.is_contiguous():
            raise ValueError("clocks: a contiguous (B, len(STAGES)) int64 "
                             "tensor beside float32 inputs")
        err = _load(CLOCKS_DEFINE).egopose_substep_clocks_f32(
            dim_arr, len(DIM_FIELDS), *ptrs, clocks.data_ptr(), bsz, stream)
        if err != 0:
            raise RuntimeError(f"stage-clock launch failed: error {err}")
        return qpos_out, qvel_out
    lib = _load(POISON_DEFINE if poison_upper else None)
    fn = lib.egopose_substep_f64 if dtype == torch.float64 \
        else lib.egopose_substep_f32
    err = fn(dim_arr, len(DIM_FIELDS), *ptrs, bsz, stream)
    if err != 0:
        raise RuntimeError(
            f"substep kernel launch failed: error {err} (a CUDA error code; "
            "-1: dims mismatch, -2: the model needs more shared memory than "
            "a block may use)")
    if dims["dense"]:
        dense_launches += 1
    else:
        launches += 1
    return qpos_out, qvel_out
