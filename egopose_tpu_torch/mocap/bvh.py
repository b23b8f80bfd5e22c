"""Minimal BVH (Biovision Hierarchy) parser (counterpart of
egopose_tpu/mocap/bvh.py, numpy only).

Stands in for the third-party ``bvh`` package of the original EgoPose code.
Supports the subset the EgoPose pipeline uses: joint hierarchy, per-joint
channels/offsets, End Sites, frames.
"""
from __future__ import annotations

import numpy as np


class BvhJoint:
    def __init__(self, name, parent=None):
        self.name = name
        self.parent = parent
        self.children = []
        self.offset = (0.0, 0.0, 0.0)
        self.channels = []
        self.channel_offset = 0   # index into a frame row
        self.end_site = None      # (x, y, z) or None


class Bvh:
    def __init__(self, text: str):
        self.joints = []          # in declaration order
        self.name2joint = {}
        self.frames = None        # (nframes, total_channels)
        self.frame_time = None
        self._parse(text)

    # -- API mirroring the third-party package ------------------------------
    @property
    def nframes(self) -> int:
        return 0 if self.frames is None else self.frames.shape[0]

    def get_joints_names(self):
        return [j.name for j in self.joints]

    def joint_channels(self, name):
        return self.name2joint[name].channels

    def joint_offset(self, name):
        return self.name2joint[name].offset

    def joint_parent(self, name):
        return self.name2joint[name].parent

    def get_joint(self, name):
        return self.name2joint[name]

    def frame_joint_channels(self, frame_idx, name, channels):
        j = self.name2joint[name]
        row = self.frames[frame_idx]
        out = []
        for ch in channels:
            k = j.channels.index(ch)
            out.append(float(row[j.channel_offset + k]))
        return out

    # -- parsing -------------------------------------------------------------
    def _parse(self, text):
        tokens = text.split()
        i = 0
        stack = []
        channel_count = 0
        cur = None

        def expect(tok):
            nonlocal i
            assert tokens[i].upper() == tok, f"expected {tok}, got {tokens[i]}"
            i += 1

        expect("HIERARCHY")
        while i < len(tokens):
            t = tokens[i].upper()
            if t in ("ROOT", "JOINT"):
                name = tokens[i + 1]
                parent = stack[-1] if stack else None
                j = BvhJoint(name, parent)
                if parent is not None:
                    parent.children.append(j)
                self.joints.append(j)
                self.name2joint[name] = j
                cur = j
                i += 2
            elif t == "{":
                stack.append(cur)
                i += 1
            elif t == "}":
                cur = stack.pop()
                cur = stack[-1] if stack else None
                i += 1
            elif t == "OFFSET":
                off = (float(tokens[i + 1]), float(tokens[i + 2]),
                       float(tokens[i + 3]))
                if cur is not None and cur.end_site == "pending":
                    cur.end_site = off
                    # mirror the third-party API: children[-1]['OFFSET']
                    cur.children.append({"OFFSET": [str(x) for x in off]})
                elif stack:
                    stack[-1].offset = off
                i += 4
            elif t == "CHANNELS":
                n = int(tokens[i + 1])
                stack[-1].channels = tokens[i + 2:i + 2 + n]
                stack[-1].channel_offset = channel_count
                channel_count += n
                i += 2 + n
            elif t == "END":  # End Site
                cur = stack[-1]
                cur.end_site = "pending"
                i += 2  # skip "End Site"
            elif t == "MOTION":
                i += 1
                expect("FRAMES:")
                nframes = int(tokens[i]); i += 1
                expect("FRAME")
                expect("TIME:")
                self.frame_time = float(tokens[i]); i += 1
                vals = np.array([float(x) for x in
                                 tokens[i:i + nframes * channel_count]])
                self.frames = vals.reshape(nframes, channel_count)
                break
            else:
                i += 1
