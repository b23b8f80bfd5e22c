"""MuJoCo C oracle physics for the cross-engine check (counterpart of
egopose_tpu/envs/mujoco_oracle.py).

The reference simulates its env on MuJoCo with a stable-PD torque computed
per substep.  This module runs exactly that control loop on the installed
MuJoCo 3 C library, so a policy can be rolled out closed-loop under the
reference's physics (``ego_mimic_eval --engine mujoco``) and its eval
metrics compared one to one with the port's engine (sim-to-sim fidelity).

Host code by design: this is the golden oracle, not a production path.  The
batch is a Python loop over lanes (takes); the oracle's arithmetic is
float64, as in the reference.  In the closed loop the (qpos, qvel) handed
back between control steps pass through the eval's EnvState in the eval
dtype -- float32 by default -- so the oracle trajectory is float32-quantised
at control-step boundaries; ``--f64`` gives full float64 oracle parity.
"""
from __future__ import annotations

import numpy as np


def _f64(x):
    """A float64 numpy copy of a tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


class MuJoCoOracle:
    """Batched stable-PD control stepping on MuJoCo C.

    One persistent MjData per lane (take) keeps MuJoCo's internal warm
    start state exactly as the reference's per-env simulation does.
    """

    def __init__(self, spec, n_lanes: int, jkp, jkd, torque_lim,
                 frame_skip: int = 15):
        import mujoco
        from ..physics.spec import export_mjcf
        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(export_mjcf(spec))
        self.data = [mujoco.MjData(self.model) for _ in range(n_lanes)]
        self.frame_skip = frame_skip
        nv = self.model.nv
        self.jkp, self.jkd, self.tl = _f64(jkp), _f64(jkd), _f64(torque_lim)
        self.kp = np.zeros(nv)
        self.kd = np.zeros(nv)
        self.kp[6:] = self.jkp
        self.kd[6:] = self.jkd
        self._mfull = np.zeros((nv, nv))

    def _stable_pd_torque(self, d, ctrl):
        """Stable-PD torque: tau = -kp e - kd (edot + qacc dt), qacc from
        (M + dt diag(kd)) qacc = -C - kp e - kd edot."""
        from scipy.linalg import cho_factor, cho_solve
        mj, m = self._mujoco, self.model
        mj.mj_forward(m, d)
        mj.mj_fullM(m, d, self._mfull)
        e = np.concatenate([np.zeros(6), d.qpos[7:] - ctrl])
        ed = d.qvel.copy()
        qacc = cho_solve(
            cho_factor(self._mfull + np.diag(self.kd) * m.opt.timestep),
            -d.qfrc_bias - self.kp * e - self.kd * ed)
        tq = -self.jkp * e[6:] - self.jkd * (ed + qacc * m.opt.timestep)[6:]
        return np.clip(tq, -self.tl, self.tl)

    def control_step(self, qpos, qvel, ctrl):
        """One 30 Hz control step for every lane: frame_skip substeps of
        stable-PD torque + mj_step.  Inputs (B, nq) / (B, nv) / (B, nu),
        tensors on any device or arrays; returns numpy float64 (B, nq),
        (B, nv)."""
        qpos, qvel, ctrl = _f64(qpos), _f64(qvel), _f64(ctrl)
        mj = self._mujoco
        out_q = np.empty_like(qpos)
        out_v = np.empty_like(qvel)
        for i, d in enumerate(self.data):
            d.qpos[:] = qpos[i]
            d.qvel[:] = qvel[i]
            for _ in range(self.frame_skip):
                d.ctrl[:] = self._stable_pd_torque(d, ctrl[i])
                mj.mj_step(self.model, d)
            out_q[i] = d.qpos
            out_v[i] = d.qvel
        return out_q, out_v
