"""State-regression dataset (counterpart of egopose_tpu/data/dataset.py).

Serves (optical_flow, norm_traj, orig_traj) chunks of numpy arrays on the
host: ``iter`` walks the takes in order with ``overlap`` frames shared
between consecutive chunks, ``sample`` draws random chunks.  Flow is read
from a packed per-take ``<take>.npy`` (one (T, H, W, 2) array, made by
``pack_optical_flow``) through the native loader, or from one ``.npy`` per
frame.  ``synthetic`` generates a world from ``np.random.RandomState(seed)``
with the same draws as the JAX package, so both packages serve the same
arrays for a seed; ``EGOPOSE_SYN_RES`` / ``EGOPOSE_SYN_TAKES`` /
``EGOPOSE_SYN_LEN`` override its flow resolution, take count and length.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch
import yaml

from ..ops import math_utils as M


def _de_heading_np(q):
    return M.de_heading(torch.as_tensor(q, dtype=torch.float64)).numpy()


def _qvel_fd_np(a, b, dt, transform):
    return M.get_qvel_fd(torch.as_tensor(a, dtype=torch.float64),
                         torch.as_tensor(b, dtype=torch.float64), dt,
                         transform).numpy()


class Dataset:
    def __init__(self, meta_id, mode, fr_num, iter_method="iter",
                 shuffle=False, overlap=0, num_sample=20000,
                 base_folder="datasets", synthetic=False, seed=0):
        self.meta_id = meta_id
        self.mode = mode
        self.fr_num = fr_num
        self.iter_method = iter_method
        self.shuffle = shuffle
        self.overlap = overlap
        self.num_sample = num_sample
        self.base_folder = base_folder
        self.of_folder = os.path.join(base_folder, "fpv_of")
        self.traj_folder = os.path.join(base_folder, "traj")
        self.synthetic = synthetic
        self._rng = np.random.RandomState(seed)

        if synthetic:
            self._init_synthetic()
        else:
            with open(f"{base_folder}/meta/{meta_id}.yml") as f:
                self.meta = yaml.safe_load(f)
            self.no_traj = self.meta.get("no_traj", False)
            self.msync = self.meta["video_mocap_sync"]
            self.dt = 1 / self.meta["capture"]["fps"]
            self.takes = self.meta["train"] + self.meta["test"] \
                if mode == "all" else self.meta[mode]
        self.len = int(np.sum([self.msync[x][2] - self.msync[x][1]
                               for x in self.takes]))

        if self.no_traj:
            self.trajs = self.orig_trajs = self.norm_trajs = None
            self.traj_dim = None
        else:
            self.trajs, self.orig_trajs = [], []
            for take in self.takes:
                orig = self._load_traj(take).copy()
                # remove the noisy hand pose (statereg_dataset.py:45-46)
                orig[:, 32:35] = 0.0
                orig[:, 42:45] = 0.0
                self.trajs.append(np.hstack([self.get_traj_pos(orig),
                                             self.get_traj_vel(orig)]))
                self.orig_trajs.append(orig)
            if mode == "train" or synthetic:
                all_traj = np.vstack(self.trajs)
                self.mean = all_traj.mean(axis=0)
                self.std = all_traj.std(axis=0)
                self.norm_trajs = self.normalize_traj()
            else:
                self.mean = self.std = self.norm_trajs = None
            self.traj_dim = self.trajs[0].shape[1]

        self._packed_reader = None
        self.sample_count = None
        self.take_indices = None
        self.cur_ind = self.cur_tid = self.cur_fr = None
        self.fr_lb = self.fr_ub = self.im_offset = None

    # -- synthetic data -----------------------------------------------------
    def _init_synthetic(self, n_takes=2, t_len=240, nq=59, res=(32, 32)):
        r = int(os.environ.get("EGOPOSE_SYN_RES", "0"))
        if r:
            res = (r, r)
        n_takes = int(os.environ.get("EGOPOSE_SYN_TAKES", n_takes))
        t_len = int(os.environ.get("EGOPOSE_SYN_LEN", t_len))
        self.meta = None
        self.no_traj = False
        self.dt = 1 / 30.0
        self.takes = [f"synthetic_{i:02d}" for i in range(n_takes)]
        self.msync = {t: (0, 0, t_len) for t in self.takes}
        self._syn_trajs, self._syn_of = {}, {}
        for t in self.takes:
            tt = np.arange(t_len) / 30.0
            traj = np.zeros((t_len, nq))
            traj[:, 2] = 0.9
            traj[:, 3] = 1.0
            freqs = self._rng.uniform(0.2, 0.8, nq - 7)
            phases = self._rng.uniform(0, 2 * np.pi, nq - 7)
            traj[:, 7:] = 0.4 * np.sin(2 * np.pi * freqs * tt[:, None]
                                       + phases)
            self._syn_trajs[t] = traj
            # synthetic "optical flow": a linear function of the pose plus
            # noise.  With the resolution overridden the draws come from
            # SFC64 seeded by the take's name (the JAX package's fast path,
            # ~10x quicker at 224x224); the default 32x32 world from the
            # RandomState, exactly as the JAX package draws them
            if r:
                fast = np.random.Generator(
                    np.random.SFC64(zlib.crc32(t.encode())))
                w = fast.standard_normal(
                    (nq, res[0] * res[1] * 2), dtype=np.float32) / nq
                noise = 0.05 * fast.standard_normal(
                    (t_len, res[0], res[1], 2), dtype=np.float32)
            else:
                w = self._rng.randn(
                    nq, res[0] * res[1] * 2).astype(np.float32) / nq
                noise = 0.05 * self._rng.randn(
                    t_len, res[0], res[1], 2).astype(np.float32)
            of = (traj @ w).reshape(t_len, res[0], res[1], 2).astype(
                np.float32)
            of += noise
            self._syn_of[t] = of

    # -- loading ------------------------------------------------------------
    def _load_traj(self, take):
        if self.synthetic:
            return self._syn_trajs[take]
        return np.load(f"{self.traj_folder}/{take}_traj.p", allow_pickle=True)

    def load_of(self, take_ind, start, end):
        take = self.takes[take_ind]
        if self.synthetic:
            return self._syn_of[take][start:end]
        packed = f"{self.of_folder}/{take}.npy"
        if os.path.exists(packed):
            if self._packed_reader is None:
                from .fastload import PackedFlowReader
                avail = {t: f"{self.of_folder}/{t}.npy" for t in self.takes
                         if os.path.exists(f"{self.of_folder}/{t}.npy")}
                self._packed_reader = PackedFlowReader(avail)
            return self._packed_reader.read_batch(
                [(take, start, end - start)])[0]
        return np.stack([np.load(f"{self.of_folder}/{take}/{i:05d}.npy")
                         for i in range(start, end)])

    # -- trajectory channels (statereg_dataset.py:111-124) ------------------
    def get_traj_pos(self, orig_traj):
        traj_pos = orig_traj[:, 2:].copy()
        traj_pos[:, 1:5] = _de_heading_np(traj_pos[:, 1:5])
        return traj_pos

    def get_traj_vel(self, orig_traj):
        vel = _qvel_fd_np(orig_traj[:-1], orig_traj[1:], self.dt, "heading")
        return np.vstack([vel, vel[-1:]])

    def set_mean_std(self, mean, std):
        self.mean, self.std = mean, std
        if not self.no_traj:
            self.norm_trajs = self.normalize_traj()

    def normalize_traj(self):
        return [(t - self.mean[None]) / (self.std[None] + 1e-8)
                for t in self.trajs]

    # -- iteration (statereg_dataset.py:70-109,138-149) ---------------------
    def __iter__(self):
        if self.iter_method == "sample":
            self.sample_count = 0
        else:
            self.cur_ind = -1
            self.take_indices = np.arange(len(self.takes))
            if self.shuffle:
                self._rng.shuffle(self.take_indices)
            self._next_take()
        return self

    def _next_take(self):
        self.cur_ind += 1
        if self.cur_ind < len(self.take_indices):
            self.cur_tid = self.take_indices[self.cur_ind]
            self.im_offset, self.fr_lb, self.fr_ub = \
                self.msync[self.takes[self.cur_tid]]
            self.cur_fr = self.fr_lb

    def _trajs(self, take_ind, fr_start, fr_end):
        if self.no_traj:
            return None, None
        return (self.norm_trajs[take_ind][fr_start:fr_end],
                self.orig_trajs[take_ind][fr_start:fr_end])

    def __next__(self):
        if self.iter_method == "sample":
            if self.sample_count >= self.num_sample:
                raise StopIteration
            self.sample_count += self.fr_num - self.overlap
            return self.sample()
        if self.cur_ind >= len(self.takes):
            raise StopIteration
        fr_start = self.cur_fr
        # the take's last chunk runs to its end when fewer than 30 frames
        # would be left over (statereg_dataset.py:98)
        fr_end = self.cur_fr + self.fr_num \
            if self.cur_fr + self.fr_num + 30 < self.fr_ub else self.fr_ub
        of = self.load_of(self.cur_tid, fr_start + self.im_offset,
                          fr_end + self.im_offset)
        norm_traj, orig_traj = self._trajs(self.cur_tid, fr_start, fr_end)
        self.cur_fr = fr_end - self.overlap
        if fr_end == self.fr_ub:
            self._next_take()
        return of, norm_traj, orig_traj

    def sample(self):
        take_ind = self._rng.randint(len(self.takes))
        im_offset, fr_lb, fr_ub = self.msync[self.takes[take_ind]]
        fr_start = self._rng.randint(fr_lb, fr_ub - self.fr_num)
        fr_end = fr_start + self.fr_num
        of = self.load_of(take_ind, fr_start + im_offset, fr_end + im_offset)
        return (of,) + self._trajs(take_ind, fr_start, fr_end)


def pack_optical_flow(base_folder, take):
    """Per-frame .npy optical flow of a take -> one packed
    ``fpv_of/<take>.npy`` (the layout the native loader reads)."""
    folder = os.path.join(base_folder, "fpv_of", take)
    files = sorted(f for f in os.listdir(folder) if f.endswith(".npy"))
    out = np.stack([np.load(os.path.join(folder, f)) for f in files])
    np.save(os.path.join(base_folder, "fpv_of", f"{take}.npy"), out)
    return out.shape
