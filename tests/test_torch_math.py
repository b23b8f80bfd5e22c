"""Quaternion and kinematic math of egopose_tpu_torch against the JAX
package on random float64 batches, to 1e-12."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.ops import math_utils as JM
from egopose_tpu.ops import quat as JQ
from egopose_tpu_torch.ops import math_utils as TM
from egopose_tpu_torch.ops import quat as TQ

TOL = 1e-12


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(64, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.randn(64, 4)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = rng.randn(64, 3)
    qpos0 = np.concatenate([rng.randn(64, 3), q, rng.randn(64, 5)], 1)
    qpos1 = qpos0 + 0.03 * rng.randn(64, 12)
    qpos1[:, 3:7] /= np.linalg.norm(qpos1[:, 3:7], axis=1, keepdims=True)
    bq0 = np.concatenate([q, q2], 1)
    bq1 = np.concatenate([qpos1[:, 3:7], q], 1)
    e = rng.uniform(-np.pi, np.pi, (64, 3))
    return dict(q=q, q2=q2, v=v, qpos0=qpos0, qpos1=qpos1, bq0=bq0, bq1=bq1,
                e=e, small=1e-3 * v)


CASES = {
    "quat_mul": (lambda Q, M, x: Q.quat_mul(x["q"], x["q2"])),
    "quat_inv": (lambda Q, M, x: Q.quat_inv(x["q"])),
    "quat_rotate": (lambda Q, M, x: Q.quat_rotate(x["q"], x["v"])),
    "quat_rotate_inv": (lambda Q, M, x: Q.quat_rotate_inv(x["q"], x["v"])),
    "quat_to_mat": (lambda Q, M, x: Q.quat_to_mat(x["q"])),
    "rotvec_from_quat": (lambda Q, M, x: Q.rotvec_from_quat(x["q"])),
    "quat_from_expmap": (lambda Q, M, x: Q.quat_from_expmap(x["v"])),
    "quat_from_euler": (lambda Q, M, x: Q.quat_from_euler(
        x["e"][:, 0], x["e"][:, 1], x["e"][:, 2])),
    "euler_from_quat_zyx": (lambda Q, M, x: Q.euler_from_quat_zyx(x["q"])),
    "quat_integrate": (lambda Q, M, x: Q.quat_integrate(x["q"], x["v"],
                                                        1 / 450.0)),
    "quat_integrate_small": (lambda Q, M, x: Q.quat_integrate(
        x["q"], x["small"] * 1e-9, 1 / 450.0)),
    "get_heading_q": (lambda Q, M, x: M.get_heading_q(x["q"])),
    "get_heading": (lambda Q, M, x: M.get_heading(x["q"])),
    "de_heading": (lambda Q, M, x: M.de_heading(x["q"])),
    "transform_vec_root": (lambda Q, M, x: M.transform_vec(x["v"], x["q"],
                                                           "root")),
    "transform_vec_heading": (lambda Q, M, x: M.transform_vec(
        x["v"], x["q"], "heading")),
    "get_qvel_fd": (lambda Q, M, x: M.get_qvel_fd(x["qpos0"], x["qpos1"],
                                                  1 / 30.0)),
    "get_qvel_fd_heading": (lambda Q, M, x: M.get_qvel_fd(
        x["qpos0"], x["qpos1"], 1 / 30.0, "heading")),
    "get_angvel_fd": (lambda Q, M, x: M.get_angvel_fd(x["bq0"], x["bq1"],
                                                      1 / 30.0)),
    "multi_quat_norm_diff": (lambda Q, M, x: M.multi_quat_norm(
        M.multi_quat_diff(x["bq1"], x["bq0"]))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax(name):
    x = _inputs(sum(map(ord, name)))
    got = CASES[name](TQ, TM, {k: torch.tensor(v) for k, v in x.items()})
    want = CASES[name](JQ, JM, {k: jnp.asarray(v) for k, v in x.items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
