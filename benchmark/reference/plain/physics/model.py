"""PhysicsModel: a ModelSpec compiled into tensors on one device
(counterpart of egopose_tpu/physics/model.py).

Tree topology (parents, dof->body map) is kept as static Python data;
numeric parameters and 0/1 topology masks are tensors of the model's dtype
on its device.  The numpy pair/contact-point construction is a copy of the
JAX package's, so both packages enumerate the same 186 collision pairs in
the same order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spec import ModelSpec

# segment-box narrowphase: fixed golden-section budget, shared by the split
# path (engine.pair_candidates) and the CUDA kernel (csrc/substep.cu) so
# both produce identical contacts.
GOLDEN_EVALS = 10
_GR = 0.6180339887498949  # 1/phi


def golden_min01(sdist, like: torch.Tensor):
    """Branchless batched golden-section minimization of ``sdist`` over
    t in [0,1] (shape and dtype of ``like``): returns the best interior
    point."""
    a = torch.zeros_like(like)
    b = torch.ones_like(like)
    c = b - _GR * (b - a)
    d = a + _GR * (b - a)
    fc = sdist(c)
    fd = sdist(d)
    for _ in range(GOLDEN_EVALS - 2):
        take = fc < fd                       # minimum lies in [a, d]
        a = torch.where(take, a, c)
        b = torch.where(take, d, b)
        x_keep = torch.where(take, c, d)     # surviving interior point
        f_keep = torch.where(take, fc, fd)
        x_new = torch.where(take, b - _GR * (b - a), a + _GR * (b - a))
        f_new = sdist(x_new)
        c = torch.where(take, x_new, x_keep)
        d = torch.where(take, x_keep, x_new)
        fc = torch.where(take, f_new, f_keep)
        fd = torch.where(take, f_keep, f_new)
    return torch.where(fc < fd, c, d)


def _candidate_points_np(spec: ModelSpec):
    """Contact candidates vs the floor plane: sphere centers, capsule
    endpoints, box corners -- (body, local pos, radius, mu) per point."""
    from .spec import GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX
    pts = []
    for g in range(spec.ngeom):
        b = int(spec.geom_body[g])
        t = int(spec.geom_type[g])
        gs = spec.geom_size[g]
        if t == GEOM_SPHERE:
            offs = [np.zeros(3)]
            rad = gs[0]
        elif t == GEOM_CAPSULE:
            offs = [np.array([0.0, 0.0, s * gs[1]]) for s in (-1.0, 1.0)]
            rad = gs[0]
        elif t == GEOM_BOX:
            offs = [np.array([sx * gs[0], sy * gs[1], sz * gs[2]])
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            rad = 0.0
        else:
            continue
        from .spec import _quat_to_mat_np
        rm = _quat_to_mat_np(spec.geom_quat[g])
        # friction combination: MuJoCo takes the max of the two geoms'
        # sliding friction; the floor has friction 1.0 in the EgoPose model
        mu = max(float(spec.geom_friction[g][0]), float(spec.floor_friction[0]))
        for o in offs:
            pts.append((b, spec.geom_pos[g] + rm @ o, rad, mu))
    body = np.array([p[0] for p in pts], dtype=np.int32)
    local = np.stack([p[1] for p in pts])
    radius = np.array([p[2] for p in pts])
    mu = np.array([p[3] for p in pts])
    return body, local, radius, mu


def _geom_segment_np(spec: ModelSpec, g: int):
    """Body-frame segment representation of a sphere/capsule geom:
    (endpoint_a (3,), endpoint_b (3,), radius).  None for other types."""
    from .spec import GEOM_SPHERE, GEOM_CAPSULE
    from .spec import _quat_to_mat_np
    t = int(spec.geom_type[g])
    if t == GEOM_SPHERE:
        return spec.geom_pos[g].copy(), spec.geom_pos[g].copy(), \
            float(spec.geom_size[g][0])
    if t == GEOM_CAPSULE:
        rm = _quat_to_mat_np(spec.geom_quat[g])
        off = rm @ np.array([0.0, 0.0, float(spec.geom_size[g][1])])
        return spec.geom_pos[g] - off, spec.geom_pos[g] + off, \
            float(spec.geom_size[g][0])
    return None


def _limb_regions(spec: ModelSpec) -> np.ndarray:
    """Anatomical region label per body, from topology alone: a body's
    region root is its highest ancestor whose parent is the root or a
    branching body (>=2 children).  On the EgoPose humanoid this yields
    {Hips}, {Spine..Spine3}, {Neck,Head}, the two arm chains and the two
    leg chains -- the natural co-activation groups for contact-pair
    selection (two simultaneous self-contacts almost always involve
    different region pairs)."""
    nb = spec.nbody
    nchild = np.zeros(nb, dtype=int)
    for b in range(1, nb):
        nchild[spec.parent[b]] += 1
    region = np.zeros(nb, dtype=np.int64)
    for b in range(1, nb):
        a = b
        while spec.parent[a] != 0 and nchild[spec.parent[a]] < 2:
            a = spec.parent[a]
        region[b] = a
    # relabel to dense 0..R-1 (root keeps its own region)
    uniq = {r: i for i, r in enumerate(sorted(set(region.tolist())))}
    return np.array([uniq[r] for r in region.tolist()])


PAIR_BLOCK_MAX = 16  # max pairs per selection block (runs longer than this
                     # split; keeps per-block reductions 1-2 sublane tiles)


def _pair_blocks_np(classes) -> tuple:
    """Contiguous (start, end) selection blocks over a CLASS-SORTED pair
    list: one block per run of equal class ids, long runs split at
    PAIR_BLOCK_MAX.  Used by the two-stage (block argmax -> top-KP over
    block winners) contact-pair selection in engine.contact_blocks and the
    resident kernel."""
    blocks = []
    i, n = 0, len(classes)
    while i < n:
        j = i
        while j < n and classes[j] == classes[i]:
            j += 1
        for a in range(i, j, PAIR_BLOCK_MAX):
            blocks.append((a, min(a + PAIR_BLOCK_MAX, j)))
        i = j
    # merge small adjacent blocks (class-sorted order keeps merged classes
    # anatomically similar); bounds block count without losing granularity
    # on the big classes
    merged = []
    for a, b in blocks:
        if merged and (b - merged[-1][0]) <= PAIR_BLOCK_MAX // 2:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return tuple(merged)


def _collision_pairs_np(spec: ModelSpec):
    """Enumerate body-body geom pairs using MuJoCo's collision filter
    (mj_collision semantics): different bodies, bodies not parent-child,
    (contype1 & conaffinity2) | (contype2 & conaffinity1) nonzero.  On the
    EgoPose humanoid this enables everything except leg-vs-leg (legs/feet
    carry contype/conaffinity 1 and 2, humanoid_1205_v1.xml:112-130) and
    adjacent links.

    Splits into two shape classes: segment-segment (sphere/capsule pairs)
    and segment-box (the feet boxes vs upper-body geoms).  Box-box pairs do
    not occur in the model family (the two feet are in disjoint contact
    groups) and are skipped.  All body-body pairs in the reference model are
    condim=1 (frictionless, humanoid_1205_v1.xml:11), so pair contacts are
    resolved normal-only; a condim>=3 body-body pair would also be resolved
    frictionless (documented deviation)."""
    from .spec import GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX
    segseg = []
    segbox = []
    segtypes = (GEOM_SPHERE, GEOM_CAPSULE)
    region = _limb_regions(spec)
    for g1 in range(spec.ngeom):
        for g2 in range(g1 + 1, spec.ngeom):
            b1, b2 = int(spec.geom_body[g1]), int(spec.geom_body[g2])
            if b1 == b2:
                continue
            if spec.parent[b1] == b2 or spec.parent[b2] == b1:
                continue
            ct1, ca1 = int(spec.geom_contype[g1]), int(spec.geom_conaffinity[g1])
            ct2, ca2 = int(spec.geom_contype[g2]), int(spec.geom_conaffinity[g2])
            if not ((ct1 & ca2) or (ct2 & ca1)):
                continue
            t1, t2 = int(spec.geom_type[g1]), int(spec.geom_type[g2])
            if t1 in segtypes and t2 in segtypes:
                a1, e1, r1 = _geom_segment_np(spec, g1)
                a2, e2, r2 = _geom_segment_np(spec, g2)
                segseg.append((b1, b2, a1, e1, a2, e2, r1, r2))
            elif GEOM_BOX in (t1, t2) and (t1 in segtypes or t2 in segtypes):
                gs, gb = (g1, g2) if t2 == GEOM_BOX else (g2, g1)
                bs, bb = int(spec.geom_body[gs]), int(spec.geom_body[gb])
                a, e, r = _geom_segment_np(spec, gs)
                segbox.append((bs, bb, a, e, r, spec.geom_pos[gb],
                               spec.geom_quat[gb], spec.geom_size[gb]))
            # box-box / plane pairs: none in the model family, skipped
    # sort by anatomical region-pair class so selection blocks are
    # contiguous runs (_pair_blocks_np); stable within a class
    klass = lambda p: (min(region[p[0]], region[p[1]]),
                       max(region[p[0]], region[p[1]]))
    segseg.sort(key=klass)
    segbox.sort(key=klass)
    return (segseg, segbox,
            _pair_blocks_np([klass(p) for p in segseg]),
            _pair_blocks_np([klass(p) for p in segbox]))

@dataclasses.dataclass(eq=False)
class PhysicsModel:
    """Static topology (python ints/tuples) + numeric tensors on one
    device.  Field meanings follow egopose_tpu.physics.model.PhysicsModel."""
    nbody: int
    ndof: int
    nq: int
    nu: int
    ngeom: int
    ncpoint: int
    npair: int
    nbpair: int
    parent: tuple
    dof_body: tuple
    actuator_dof: tuple
    dtype: torch.dtype
    device: torch.device
    body_pos: torch.Tensor
    body_mass: torch.Tensor
    body_ipos: torch.Tensor
    body_inertia: torch.Tensor
    dof_axis: torch.Tensor
    dof_anchor: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_stiffness: torch.Tensor
    jnt_range: torch.Tensor
    jnt_limited_f: torch.Tensor
    gravity: torch.Tensor
    actuator_gear: torch.Tensor
    timestep: float
    anc_mask: torch.Tensor        # (nd,nd) body(j) anc-or-self of body(i)
    body_dof_mask: torch.Tensor   # (nb,nd) dof d on the path root->body b
    body_desc_mask: torch.Tensor  # (nb,nb) c in subtree of b (incl.)
    vp_mask: torch.Tensor         # (nd,nd) velocity-product frame mask
    point_dof_mask: torch.Tensor  # (nd,K) contact point k in dof d's subtree
    # level-batched FK tables (padded entries index the dummy tail row)
    levels: tuple                 # per level: (body, parent, bodypos, axis,
                                  #   anchor, qpos_idx, dof_idx)
    cpoint_body: torch.Tensor
    cpoint_local: torch.Tensor
    cpoint_radius: torch.Tensor
    cpoint_mu: torch.Tensor
    pair_body1: torch.Tensor
    pair_body2: torch.Tensor
    pair_a1: torch.Tensor
    pair_b1: torch.Tensor
    pair_a2: torch.Tensor
    pair_b2: torch.Tensor
    pair_rsum: torch.Tensor
    pair_rdiff: torch.Tensor
    pair_dof_mask: torch.Tensor   # (nd,P) signed
    bpair_body_seg: torch.Tensor
    bpair_body_box: torch.Tensor
    bpair_a: torch.Tensor
    bpair_b: torch.Tensor
    bpair_rseg: torch.Tensor
    bpair_boxpos: torch.Tensor
    bpair_boxquat: torch.Tensor
    bpair_half: torch.Tensor
    bpair_dof_mask: torch.Tensor  # (nd,Pb) signed
    # per-model derived data for the CUDA kernel (physics/substep.py)
    kernel_cache: dict = dataclasses.field(default_factory=dict)


def build_model(spec: ModelSpec, dtype=torch.float32,
                device="cpu") -> PhysicsModel:
    """Compile a host ModelSpec into a PhysicsModel on ``device``."""
    device = torch.device(device)
    nd = spec.ndof
    anc = spec.dof_ancestor_mask()                      # (nd,nd) bool
    body_anc = spec.ancestors_inclusive()               # (nb,nb) bool
    body_dof = body_anc[:, spec.dof_body]               # (nb,nd)

    # velocity-product frame mask (which dofs' velocities move dof d's axis)
    vp = anc.copy()
    for d in range(nd):
        if d < 3:
            vp[d, :] = False
        elif d < 6:
            vp[d, :] = False
            vp[d, 0:6] = True
        else:
            for e in range(6, nd):
                if spec.dof_body[e] == spec.dof_body[d] and e > d:
                    vp[d, e] = False

    cp_body, cp_local, cp_radius, cp_mu = _candidate_points_np(spec)
    point_dof = body_anc[cp_body][:, spec.dof_body].T   # (nd,K)

    segseg, segbox, _, _ = _collision_pairs_np(spec)
    body_dof_f = body_anc[:, spec.dof_body].astype(np.float64)
    npair, nbpair = len(segseg), len(segbox)
    stack = lambda rows, w: np.stack(rows) if rows else np.zeros((0, w))
    p_b1 = np.array([p[0] for p in segseg], dtype=np.int64)
    p_b2 = np.array([p[1] for p in segseg], dtype=np.int64)
    p_dm = (body_dof_f[p_b1] - body_dof_f[p_b2]).T if npair \
        else np.zeros((nd, 0))
    bp_bs = np.array([p[0] for p in segbox], dtype=np.int64)
    bp_bb = np.array([p[1] for p in segbox], dtype=np.int64)
    bp_dm = (body_dof_f[bp_bs] - body_dof_f[bp_bb]).T if nbpair \
        else np.zeros((nd, 0))

    # level-batched FK tables
    nb = spec.nbody
    depth = np.zeros(nb, dtype=int)
    for b in range(1, nb):
        depth[b] = depth[spec.parent[b]] + 1
    nlevel = int(depth.max())
    body_hinges = [[d for d in range(6, nd) if spec.dof_body[d] == b]
                   for b in range(nb)]
    arr = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=dtype)
    iarr = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    levels = []
    for k in range(nlevel):
        lv = [b for b in range(1, nb) if depth[b] == k + 1]
        n = len(lv)
        l_axis = np.zeros((n, 3, 3))
        l_axis[..., 2] = 1.0  # pad axis = z (angle 0 -> identity)
        l_anchor = np.zeros((n, 3, 3))
        l_qpos = np.full((n, 3), spec.nq, dtype=np.int64)
        l_dof = np.full((n, 3), nd, dtype=np.int64)
        for i, b in enumerate(lv):
            for s, d in enumerate(body_hinges[b]):
                if s >= 3:
                    raise ValueError("more than 3 hinges per body")
                l_axis[i, s] = spec.dof_axis[d]
                l_anchor[i, s] = spec.dof_anchor[d]
                l_qpos[i, s] = d + 1
                l_dof[i, s] = d
        levels.append((iarr(lv), iarr([spec.parent[b] for b in lv]),
                       arr(spec.body_pos[lv]), arr(l_axis), arr(l_anchor),
                       iarr(l_qpos), iarr(l_dof)))

    return PhysicsModel(
        nbody=nb, ndof=nd, nq=spec.nq, nu=spec.nu, ngeom=spec.ngeom,
        ncpoint=len(cp_body), npair=npair, nbpair=nbpair,
        parent=tuple(int(x) for x in spec.parent),
        dof_body=tuple(int(x) for x in spec.dof_body),
        actuator_dof=tuple(int(x) for x in spec.actuator_dof),
        dtype=dtype, device=device,
        body_pos=arr(spec.body_pos), body_mass=arr(spec.body_mass),
        body_ipos=arr(spec.body_ipos), body_inertia=arr(spec.body_inertia),
        dof_axis=arr(spec.dof_axis), dof_anchor=arr(spec.dof_anchor),
        dof_armature=arr(spec.dof_armature),
        dof_damping=arr(spec.dof_damping),
        dof_stiffness=arr(spec.dof_stiffness),
        jnt_range=arr(np.where(np.isfinite(spec.jnt_range),
                               spec.jnt_range, 0.0)
                      if spec.jnt_range.size else np.zeros((0, 2))),
        jnt_limited_f=arr(spec.jnt_limited.astype(np.float64)),
        gravity=arr(spec.gravity), actuator_gear=arr(spec.actuator_gear),
        timestep=float(spec.timestep),
        anc_mask=arr(anc), body_dof_mask=arr(body_dof),
        body_desc_mask=arr(body_anc.T), vp_mask=arr(vp),
        point_dof_mask=arr(point_dof), levels=tuple(levels),
        cpoint_body=iarr(cp_body), cpoint_local=arr(cp_local),
        cpoint_radius=arr(cp_radius), cpoint_mu=arr(cp_mu),
        pair_body1=iarr(p_b1), pair_body2=iarr(p_b2),
        pair_a1=arr(stack([p[2] for p in segseg], 3)),
        pair_b1=arr(stack([p[3] for p in segseg], 3)),
        pair_a2=arr(stack([p[4] for p in segseg], 3)),
        pair_b2=arr(stack([p[5] for p in segseg], 3)),
        pair_rsum=arr([p[6] + p[7] for p in segseg]),
        pair_rdiff=arr([p[6] - p[7] for p in segseg]),
        pair_dof_mask=arr(p_dm),
        bpair_body_seg=iarr(bp_bs), bpair_body_box=iarr(bp_bb),
        bpair_a=arr(stack([p[2] for p in segbox], 3)),
        bpair_b=arr(stack([p[3] for p in segbox], 3)),
        bpair_rseg=arr([p[4] for p in segbox]),
        bpair_boxpos=arr(stack([p[5] for p in segbox], 3)),
        bpair_boxquat=arr(stack([p[6] for p in segbox], 4)),
        bpair_half=arr(stack([p[7] for p in segbox], 3)),
        bpair_dof_mask=arr(bp_dm),
    )
