"""MJCF model specification: parse -> numpy ModelSpec.

A frozen copy of the parsing half of egopose_tpu_torch/physics/spec.py.
Handles the reference's legacy global-coordinate MJCF as well as
local-coordinate MJCF and computes body inertials from geoms
(``inertiafromgeom``).

Supported subset (everything the EgoPose humanoid family uses): free root +
hinge joints, sphere/capsule/box body geoms, one world plane, motors on
joints, per-joint armature/damping/stiffness/range.
"""
from __future__ import annotations

import dataclasses
import io
import os
import xml.etree.ElementTree as ET

import numpy as np

GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_PLANE = 0, 1, 2, 3
_GEOM_NAMES = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE, "box": GEOM_BOX,
               "plane": GEOM_PLANE}


@dataclasses.dataclass
class ModelSpec:
    """Static humanoid model description (host-side numpy)."""
    # bodies (world excluded; index 0 = root body)
    nbody: int
    body_names: list
    parent: np.ndarray          # (nb,) int, -1 for root
    body_pos: np.ndarray        # (nb,3) frame offset in parent frame
    # inertial (computed from geoms, density-based)
    body_mass: np.ndarray       # (nb,)
    body_ipos: np.ndarray       # (nb,3) com in body frame
    body_inertia: np.ndarray    # (nb,3,3) about com, body frame
    # dofs: 6 free-root dofs (3 trans + 3 rot) then one per hinge, MuJoCo order
    ndof: int
    nq: int
    dof_body: np.ndarray        # (nd,) body index
    dof_axis: np.ndarray        # (nd,3) hinge axis in body frame (zeros for free)
    dof_anchor: np.ndarray      # (nd,3) hinge anchor in body frame
    dof_armature: np.ndarray    # (nd,)
    dof_damping: np.ndarray     # (nd,)
    dof_stiffness: np.ndarray   # (nd,)
    jnt_names: list             # hinge joint names, in dof order (nd-6)
    jnt_range: np.ndarray       # (nd-6,2) radians
    jnt_limited: np.ndarray     # (nd-6,) bool
    # body geoms
    ngeom: int
    geom_body: np.ndarray       # (ng,)
    geom_type: np.ndarray       # (ng,)
    geom_pos: np.ndarray        # (ng,3) in body frame
    geom_quat: np.ndarray       # (ng,4) wxyz in body frame
    geom_size: np.ndarray       # (ng,3)
    geom_friction: np.ndarray   # (ng,3)
    geom_contype: np.ndarray    # (ng,)
    geom_conaffinity: np.ndarray  # (ng,)
    geom_condim: np.ndarray     # (ng,) contact dimensionality (1=frictionless)
    # floor
    floor_friction: np.ndarray  # (3,)
    # actuators
    nu: int
    actuator_names: list
    actuator_dof: np.ndarray    # (nu,) dof index
    actuator_gear: np.ndarray   # (nu,)
    actuator_ctrlrange: np.ndarray  # (nu,2)
    # options
    timestep: float
    gravity: np.ndarray         # (3,)

    # ---- derived helpers -------------------------------------------------
    def ancestors_inclusive(self) -> np.ndarray:
        """(nb,nb) bool: anc[b, a] True iff a is b or an ancestor of b."""
        nb = self.nbody
        anc = np.zeros((nb, nb), dtype=bool)
        for b in range(nb):
            a = b
            while a >= 0:
                anc[b, a] = True
                a = self.parent[a]
        return anc

    def dof_ancestor_mask(self) -> np.ndarray:
        """(nd,nd) bool: mask[i, j] True iff body(j) is body(i) or its ancestor."""
        anc = self.ancestors_inclusive()
        return anc[self.dof_body][:, self.dof_body]

    def body_qposaddr(self) -> dict:
        """name -> (start, end) qpos address of the body's hinge dofs.
        Mirrors utils/tools.py:55-68 used for expert/body indexing."""
        out = {}
        for b, name in enumerate(self.body_names):
            dofs = np.where(self.dof_body == b)[0]
            dofs = dofs[dofs >= 6]
            if dofs.size:
                out[name] = (int(dofs[0]) + 1, int(dofs[-1]) + 2)  # qpos = dof + 1
        out[self.body_names[0]] = (0, 7)
        return out


# ---------------------------------------------------------------------------
# geom inertia (exact solid formulas, matching MuJoCo inertiafromgeom)
# ---------------------------------------------------------------------------

def geom_mass_inertia(gtype: int, size: np.ndarray, density: float):
    """Return (mass, inertia diag (3,) about geom com in geom frame)."""
    if gtype == GEOM_SPHERE:
        r = size[0]
        m = density * 4.0 / 3.0 * np.pi * r ** 3
        i = 0.4 * m * r * r
        return m, np.array([i, i, i])
    if gtype == GEOM_CAPSULE:
        r, h = size[0], size[1]  # h = half-length of cylinder part, axis = z
        m_cyl = density * np.pi * r * r * (2 * h)
        m_hs = density * 2.0 / 3.0 * np.pi * r ** 3  # per hemisphere
        izz = 0.5 * m_cyl * r * r + 2 * (0.4 * m_hs * r * r)
        # hemisphere com at 3r/8 from flat face; transverse I about own com
        d = h + 3.0 * r / 8.0
        i_hs_cm = (83.0 / 320.0) * m_hs * r * r
        ixx = m_cyl * (3 * r * r + (2 * h) ** 2) / 12.0 + 2 * (i_hs_cm + m_hs * d * d)
        return m_cyl + 2 * m_hs, np.array([ixx, ixx, izz])
    if gtype == GEOM_BOX:
        sx, sy, sz = size  # half-sizes
        m = density * 8.0 * sx * sy * sz
        return m, m / 3.0 * np.array([sy * sy + sz * sz, sx * sx + sz * sz,
                                      sx * sx + sy * sy])
    raise ValueError(f"no inertia for geom type {gtype}")


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# ---------------------------------------------------------------------------
# MJCF parsing
# ---------------------------------------------------------------------------

def _fl(s, default=None, n=None):
    if s is None:
        return default
    v = np.array([float(x) for x in s.split()])
    if n is not None and v.size < n:
        v = np.concatenate([v, np.zeros(n - v.size)])
    return v


def parse_mjcf(path_or_str: str, density: float = 1000.0) -> ModelSpec:
    """Parse an MJCF file (or XML string) into a ModelSpec.

    Handles both ``coordinate="global"`` (the reference's format) and local
    coordinates.  Includes are ignored (they only carry visual assets for the
    EgoPose models).
    """
    if os.path.exists(path_or_str):
        tree = ET.parse(path_or_str)
        root = tree.getroot()
    else:
        root = ET.parse(io.StringIO(path_or_str)).getroot()

    compiler = root.find("compiler")
    degrees = compiler is None or compiler.get("angle", "degree") == "degree"
    global_coords = compiler is not None and compiler.get("coordinate") == "global"
    ang = (lambda x: np.deg2rad(x)) if degrees else (lambda x: x)

    # defaults (single-level default block is all the reference uses)
    jnt_def = {"damping": 0.0, "armature": 0.0, "stiffness": 0.0, "limited": "true"}
    geom_def = {"contype": 1, "conaffinity": 1, "condim": 3,
                "friction": np.array([1.0, 0.005, 0.0001])}
    dnode = root.find("default")
    if dnode is not None:
        jd = dnode.find("joint")
        if jd is not None:
            for k in ("damping", "armature", "stiffness"):
                if jd.get(k):
                    jnt_def[k] = float(jd.get(k))
            if jd.get("limited"):
                jnt_def["limited"] = jd.get("limited")
        gd = dnode.find("geom")
        if gd is not None:
            for k in ("contype", "conaffinity", "condim"):
                if gd.get(k):
                    geom_def[k] = int(gd.get(k))
            if gd.get("friction"):
                geom_def["friction"] = _fl(gd.get("friction"), n=3)

    opt = root.find("option")
    timestep = float(opt.get("timestep", 0.002)) if opt is not None else 0.002
    gravity = _fl(opt.get("gravity"), np.array([0.0, 0.0, -9.81]), 3) if opt is not None \
        else np.array([0.0, 0.0, -9.81])

    bodies = []       # dicts
    geoms = []
    joints = []       # hinge joints in dof order
    floor_friction = np.array([1.0, 0.005, 0.0001])
    free_armature = 0.0

    def walk(elem, parent_idx, parent_gpos):
        nonlocal floor_friction, free_armature
        for child in elem:
            if child.tag == "geom" and parent_idx is None:
                if child.get("type") == "plane":
                    floor_friction = _fl(child.get("friction"), floor_friction, 3)
                continue
            if child.tag != "body":
                continue
            gpos = _fl(child.get("pos"), np.zeros(3), 3)  # global frame pos
            bpos = gpos - parent_gpos if global_coords else gpos
            bidx = len(bodies)
            bodies.append({
                "name": child.get("name", f"body{bidx}"),
                "parent": parent_idx if parent_idx is not None else -1,
                "pos": bpos, "gpos": gpos if global_coords else None,
                "joints": [],
            })
            for j in child.findall("joint"):
                jtype = j.get("type", "hinge")
                jpos = _fl(j.get("pos"), np.zeros(3), 3)
                if global_coords:
                    jpos = jpos - gpos
                if jtype == "free":
                    free_armature = float(j.get("armature", 0.0))
                    bodies[bidx]["free"] = True
                    continue
                assert jtype == "hinge", f"unsupported joint type {jtype}"
                rng = _fl(j.get("range"), np.zeros(2), 2)
                limited = j.get("limited", jnt_def["limited"]) == "true"
                joints.append({
                    "name": j.get("name", f"jnt{len(joints)}"),
                    "body": bidx,
                    "axis": _fl(j.get("axis"), np.array([0.0, 0.0, 1.0]), 3),
                    "pos": jpos,
                    "range": ang(rng) if limited else np.array([-np.inf, np.inf]),
                    "limited": limited,
                    "armature": float(j.get("armature", jnt_def["armature"])),
                    "damping": float(j.get("damping", jnt_def["damping"])),
                    "stiffness": float(j.get("stiffness", jnt_def["stiffness"])),
                })
            for g in child.findall("geom"):
                gtype = _GEOM_NAMES[g.get("type", "sphere")]
                size = _fl(g.get("size"), np.zeros(3), 3)
                quat = _fl(g.get("quat"), np.array([1.0, 0.0, 0.0, 0.0]), 4)
                quat = quat / np.linalg.norm(quat)
                if g.get("fromto") is not None:
                    ft = _fl(g.get("fromto"), n=6)
                    p0, p1 = ft[:3], ft[3:]
                    if global_coords:
                        p0, p1 = p0 - gpos, p1 - gpos
                    mid = 0.5 * (p0 + p1)
                    d = p1 - p0
                    L = np.linalg.norm(d)
                    # rotation taking z to d/L
                    z = np.array([0.0, 0.0, 1.0])
                    dn = d / L
                    c = np.cross(z, dn)
                    s = np.linalg.norm(c)
                    w = 1.0 + np.dot(z, dn)
                    if w < 1e-12:  # antiparallel
                        quat = np.array([0.0, 1.0, 0.0, 0.0])
                    else:
                        quat = np.array([w, *c])
                        quat = quat / np.linalg.norm(quat)
                    gpos_l = mid
                    size = np.array([size[0], L / 2.0, 0.0])
                else:
                    gpos_l = _fl(g.get("pos"), np.zeros(3), 3)
                    if global_coords:
                        gpos_l = gpos_l - gpos
                geoms.append({
                    "body": bidx, "type": gtype, "pos": gpos_l, "quat": quat,
                    "size": size,
                    "friction": _fl(g.get("friction"), geom_def["friction"], 3),
                    "contype": int(g.get("contype", geom_def["contype"])),
                    "conaffinity": int(g.get("conaffinity", geom_def["conaffinity"])),
                    "condim": int(g.get("condim", geom_def["condim"])),
                })
            walk(child, bidx, gpos)

    wb = root.find("worldbody")
    walk(wb, None, np.zeros(3))

    nb = len(bodies)
    assert bodies[0].get("free"), "root body must have a free joint"

    # inertials from geoms
    mass = np.zeros(nb)
    ipos = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for b in range(nb):
        gs = [g for g in geoms if g["body"] == b]
        m_tot, com = 0.0, np.zeros(3)
        for g in gs:
            m, _ = geom_mass_inertia(g["type"], g["size"], density)
            m_tot += m
            com += m * g["pos"]
        com = com / m_tot if m_tot > 0 else com
        itot = np.zeros((3, 3))
        for g in gs:
            m, idiag = geom_mass_inertia(g["type"], g["size"], density)
            R = _quat_to_mat_np(g["quat"])
            ic = R @ np.diag(idiag) @ R.T
            r = g["pos"] - com
            itot += ic + m * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        mass[b], ipos[b], inertia[b] = m_tot, com, itot

    nd = 6 + len(joints)
    dof_body = np.zeros(nd, dtype=np.int32)
    dof_axis = np.zeros((nd, 3))
    dof_anchor = np.zeros((nd, 3))
    dof_armature = np.zeros(nd)
    dof_damping = np.zeros(nd)
    dof_stiffness = np.zeros(nd)
    dof_armature[3:6] = free_armature
    for i, j in enumerate(joints):
        d = 6 + i
        dof_body[d] = j["body"]
        dof_axis[d] = j["axis"] / np.linalg.norm(j["axis"])
        dof_anchor[d] = j["pos"]
        dof_armature[d] = j["armature"]
        dof_damping[d] = j["damping"]
        dof_stiffness[d] = j["stiffness"]

    # actuators
    act = root.find("actuator")
    act_names, act_dof, act_gear, act_cr = [], [], [], []
    jname_to_dof = {j["name"]: 6 + i for i, j in enumerate(joints)}
    if act is not None:
        for m in act:
            jn = m.get("joint")
            act_names.append(m.get("name", jn))
            act_dof.append(jname_to_dof[jn])
            act_gear.append(float(m.get("gear", "1").split()[0]))
            cr = _fl(m.get("ctrlrange"), np.array([-1.0, 1.0]), 2)
            act_cr.append(cr)

    return ModelSpec(
        nbody=nb,
        body_names=[b["name"] for b in bodies],
        parent=np.array([b["parent"] for b in bodies], dtype=np.int32),
        body_pos=np.stack([b["pos"] for b in bodies]),
        body_mass=mass, body_ipos=ipos, body_inertia=inertia,
        ndof=nd, nq=nd + 1,
        dof_body=dof_body, dof_axis=dof_axis, dof_anchor=dof_anchor,
        dof_armature=dof_armature, dof_damping=dof_damping,
        dof_stiffness=dof_stiffness,
        jnt_names=[j["name"] for j in joints],
        jnt_range=np.stack([j["range"] for j in joints]) if joints else np.zeros((0, 2)),
        jnt_limited=np.array([j["limited"] for j in joints], dtype=bool),
        ngeom=len(geoms),
        geom_body=np.array([g["body"] for g in geoms], dtype=np.int32),
        geom_type=np.array([g["type"] for g in geoms], dtype=np.int32),
        geom_pos=np.stack([g["pos"] for g in geoms]),
        geom_quat=np.stack([g["quat"] for g in geoms]),
        geom_size=np.stack([g["size"] for g in geoms]),
        geom_friction=np.stack([g["friction"] for g in geoms]),
        geom_contype=np.array([g["contype"] for g in geoms], dtype=np.int32),
        geom_conaffinity=np.array([g["conaffinity"] for g in geoms], dtype=np.int32),
        geom_condim=np.array([g["condim"] for g in geoms], dtype=np.int32),
        floor_friction=floor_friction,
        nu=len(act_names),
        actuator_names=act_names,
        actuator_dof=np.array(act_dof, dtype=np.int32),
        actuator_gear=np.array(act_gear),
        actuator_ctrlrange=np.stack(act_cr) if act_cr else np.zeros((0, 2)),
        timestep=timestep, gravity=gravity,
    )


# ---------------------------------------------------------------------------
# local-coordinate MJCF export (for the MuJoCo golden oracle + visualization)
# ---------------------------------------------------------------------------
