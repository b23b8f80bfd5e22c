"""Skeleton parsing (ASF/BVH) and MuJoCo model generation (counterpart of
egopose_tpu/mocap/skeleton.py, numpy only).

The emitted MJCF uses *local* coordinates (MuJoCo >= 2.3.4 dropped global
coordinates), so generated humanoids load in the port's engine and in
MuJoCo C alike.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np

from .bvh import Bvh


def _euler_matrix_sxyz(ax, ay, az):
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx  # extrinsic x-y-z


class Bone:
    def __init__(self):
        self.id = None
        self.name = None
        self.orient = np.identity(3)
        self.dof_index = []
        self.channels = []
        self.lb = []
        self.ub = []
        self.parent = None
        self.child = []
        # asf specific
        self.dir = np.zeros(3)
        self.len = 0
        # bvh specific
        self.offset = np.zeros(3)
        # inferred info
        self.pos = np.zeros(3)
        self.end = np.zeros(3)


class Skeleton:
    def __init__(self):
        self.bones = []
        self.name2bone = {}
        self.mass_scale = 1.0
        self.len_scale = 1.0
        self.dof_name = ["x", "y", "z"]
        self.root = None

    # -- ASF ------------------------------------------------------------------
    # Section splitting + per-block field dicts.
    @staticmethod
    def _asf_sections(fname):
        """Split an ASF file into {':keyword' -> [lines]} sections."""
        sections, cur = {}, None
        with open(fname) as f:
            for ln in f:
                s = ln.strip()
                if not s or s.startswith("#"):
                    continue
                if s.startswith(":"):
                    parts = s.split(None, 1)
                    cur = parts[0][1:]
                    sections[cur] = []
                    if len(parts) > 1:
                        sections[cur].append(parts[1])
                elif cur is not None:
                    sections[cur].append(s)
        return sections

    @staticmethod
    def _asf_blocks(lines):
        """begin/end delimited blocks -> list of tokenized lines each."""
        blk = None
        for line in lines:
            w = line.split()
            if w[0] == "begin":
                blk = []
            elif w[0] == "end":
                yield blk
                blk = None
            elif blk is not None:
                blk.append(w)

    def load_from_asf(self, fname, swap_axes=False):
        sections = self._asf_sections(fname)

        for line in sections.get("units", []):
            w = line.split()
            if w[0] == "mass":
                self.mass_scale = float(w[1])
            elif w[0] == "length":
                self.len_scale = 1 / float(w[1]) * 0.0254

        self.root = Bone()
        self.root.id = 0
        self.root.name = "root"
        self.name2bone["root"] = self.root
        self.bones.append(self.root)

        dof_ind = {"rx": 0, "ry": 1, "rz": 2}
        for blk in self._asf_blocks(sections.get("bonedata", [])):
            bone = Bone()
            fields, limits = {}, []
            for w in blk:
                if w[0] == "limits":
                    limits.append(w[1:])
                elif w[0].startswith("(") and limits:
                    limits.append(w)  # continuation limit rows
                else:
                    fields[w[0]] = w[1:]
            bone.id = len(self.bones)
            bone.name = fields["name"][0]
            bone.dir = np.array([float(x) for x in fields["direction"][:3]])
            bone.len = float(fields["length"][0]) * self.len_scale
            if "axis" in fields:
                a = [math.radians(float(x)) for x in fields["axis"][:3]]
                bone.orient = _euler_matrix_sxyz(*a)
            # the skeleton's dof order is the reverse of the file's
            bone.dof_index = [dof_ind[d] for d in reversed(fields.get("dof", []))
                              if d in dof_ind]
            for pair in limits:  # "( -20.0 20.0 )"-style ranges, file order
                bone.lb.append(float(pair[0].lstrip("(")))
                bone.ub.append(float(pair[1].rstrip(")")))
            if swap_axes:  # y-up ASF -> z-up
                bone.dir[1], bone.dir[2] = -bone.dir[2], bone.dir[1]
                orient = bone.orient.copy()
                bone.orient[1, :], bone.orient[2, :] = \
                    -orient[2, :], orient[1, :]
            self.bones.append(bone)
            self.name2bone[bone.name] = bone

        for line in sections.get("hierarchy", []):
            w = line.split()
            if w[0] in ("begin", "end"):
                continue
            parent = self.name2bone[w[0]]
            for child_name in w[1:]:
                child = self.name2bone[child_name]
                parent.child.append(child)
                child.parent = parent
        self.forward_asf(self.root)

    def forward_asf(self, bone):
        if bone.parent:
            bone.pos = bone.parent.end
        bone.end = bone.pos + bone.dir * bone.len
        for c in bone.child:
            self.forward_asf(c)

    # -- BVH -----------------------------------------------------------------
    def load_from_bvh(self, fname, exclude_bones=None, spec_channels=None):
        exclude_bones = exclude_bones or set()
        spec_channels = spec_channels or {}
        with open(fname) as f:
            mocap = Bvh(f.read())
        joint_names = [x for x in mocap.get_joints_names()
                       if all(t not in x for t in exclude_bones)]
        dof_ind = {"x": 0, "y": 1, "z": 2}
        self.len_scale = 0.0254
        self.root = Bone()
        self.root.id = 0
        self.root.name = joint_names[0]
        self.root.channels = mocap.joint_channels(self.root.name)
        self.name2bone[self.root.name] = self.root
        self.bones.append(self.root)
        for i, joint in enumerate(joint_names[1:]):
            bone = Bone()
            bone.id = i + 1
            bone.name = joint
            bone.channels = spec_channels.get(joint,
                                              mocap.joint_channels(joint))
            bone.dof_index = [dof_ind[x[0].lower()] for x in bone.channels]
            bone.offset = np.array(mocap.joint_offset(joint)) * self.len_scale
            bone.lb = [-180.0] * 3
            bone.ub = [180.0] * 3
            self.bones.append(bone)
            self.name2bone[joint] = bone
        for bone in self.bones[1:]:
            parent = mocap.joint_parent(bone.name)
            if parent is not None and parent.name in self.name2bone:
                bone_p = self.name2bone[parent.name]
                bone_p.child.append(bone)
                bone.parent = bone_p
        self.forward_bvh(self.root)
        for bone in self.bones:
            real_children = [c for c in bone.child if isinstance(c, Bone)]
            if not real_children:
                j = mocap.get_joint(bone.name)
                end_off = j.children[-1]["OFFSET"] \
                    if isinstance(j.children[-1], dict) else [0, 0, 0]
                bone.end = bone.pos + np.array(
                    [float(x) for x in end_off]) * self.len_scale
            else:
                bone.end = sum(c.pos for c in real_children) / len(real_children)
            bone.child = real_children

    def forward_bvh(self, bone):
        if bone.parent:
            bone.pos = bone.parent.pos + bone.offset
        else:
            bone.pos = bone.offset
        for c in bone.child:
            if isinstance(c, Bone):
                self.forward_bvh(c)

    # -- MJCF emission (local coordinates) ------------------------------------
    def write_xml(self, fname, template_fname=None, offset=np.zeros(3)):
        """Emit the humanoid MJCF, optionally filling a template's worldbody/
        actuator sections (cli/create_humanoid.py's --template-id)."""
        if template_fname is not None:
            tree_in = ET.parse(template_fname)
            root = tree_in.getroot()
            comp = root.find("compiler")
            if comp is not None and "coordinate" in comp.attrib:
                # we emit local coordinates (MuJoCo >= 2.3.4 dropped global)
                del comp.attrib["coordinate"]
            worldbody = root.find("worldbody")
            if worldbody is None:
                worldbody = ET.SubElement(root, "worldbody")
            actuators = root.find("actuator")
            if actuators is None:
                actuators = ET.SubElement(root, "actuator")
        else:
            root = ET.Element("mujoco", {"model": "humanoid"})
            ET.SubElement(root, "compiler",
                          {"angle": "degree", "inertiafromgeom": "true"})
            default = ET.SubElement(root, "default")
            ET.SubElement(default, "joint", {"damping": "0.0",
                                             "armature": "0.01",
                                             "stiffness": "0.0",
                                             "limited": "true"})
            ET.SubElement(default, "geom", {"conaffinity": "7", "condim": "1",
                                            "contype": "7", "margin": "0.001",
                                            "rgba": "0.8 0.6 .4 1"})
            ET.SubElement(root, "option", {"timestep": "0.00222222222"})
            worldbody = ET.SubElement(root, "worldbody")
            ET.SubElement(worldbody, "geom", {
                "name": "floor", "type": "plane", "condim": "3",
                "friction": "1. .1 .1", "pos": "0 0 0", "size": "100 100 .2"})
            actuators = ET.SubElement(root, "actuator")
        self._write_bodynode(self.root, worldbody, offset)
        for body in worldbody.iter("body"):
            for joint in body.findall("joint"):
                if joint.get("type") == "free":
                    continue
                name = joint.get("name")
                ET.SubElement(actuators, "motor",
                              {"name": name, "joint": name, "gear": "1"})
        tree = ET.ElementTree(root)
        ET.indent(tree)
        tree.write(fname)
        return fname

    def _write_bodynode(self, bone, parent_node, parent_pos):
        fmt3 = lambda v: "{:.4f} {:.4f} {:.4f}".format(*v)
        node = ET.SubElement(parent_node, "body", {
            "name": bone.name,
            "pos": fmt3(bone.pos - parent_pos),       # local coordinates
            "user": fmt3(bone.end)})
        if bone.parent is None:
            ET.SubElement(node, "joint", {
                "name": bone.name, "pos": "0 0 0", "limited": "false",
                "type": "free", "armature": "0", "damping": "0",
                "stiffness": "0"})
        else:
            for i, ind in enumerate(bone.dof_index):
                axis = bone.orient[:, ind]
                attr = {"name": f"{bone.name}_{self.dof_name[ind]}",
                        "type": "hinge", "pos": "0 0 0",
                        "axis": fmt3(axis)}
                if i < len(bone.lb):
                    attr["range"] = "{:.4f} {:.4f}".format(bone.lb[i],
                                                           bone.ub[i])
                else:
                    attr["range"] = "-180.0 180.0"
                ET.SubElement(node, "joint", attr)
        if bone.parent is None:
            ET.SubElement(node, "geom", {"size": "0.03", "type": "sphere",
                                         "pos": "0 0 0"})
        else:
            e1 = bone.pos.copy()
            e2 = bone.end.copy()
            v = e2 - e1
            if np.linalg.norm(v) > 1e-6:
                v = v / np.linalg.norm(v)
            else:
                v = np.array([0.0, 0.0, 0.2])
            e1 = e1 + v * 0.02 - bone.pos
            e2 = e2 - v * 0.02 - bone.pos
            ET.SubElement(node, "geom", {
                "size": "0.03", "type": "capsule",
                "fromto": "{:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.4f}".format(
                    *np.concatenate([e1, e2]))})
        for c in bone.child:
            self._write_bodynode(c, node, bone.pos)
