"""Operations and bytes the cells' work needs, counted from shapes: the
control-step kernel K1 (a frozen copy of the count that was reviewed with
the kernel), the nets' matrix products and LSTM cells, and the whole step
or iteration they add up to.  Peaks of one NVIDIA H100 SXM (data sheet,
700 W): 67 TFLOP/s float32 outside the tensor cores (the program keeps
TF32 off), 3.35 TB/s of HBM3."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_FRAMES = 15        # physics substeps of one 30 Hz control step
PREP_REFRESH = 3     # the configuration's prep cadence (ContactParams)
MAX_CONTACTS = 6     # floor points kept per substep (ContactParams)
MAX_PAIRS = 6        # body-pair rows kept per substep (ContactParams)


@lru_cache(maxsize=1)
def model_counts() -> dict:
    """Sizes of the humanoid that K1's count reads: dofs, bodies, contact
    points and pairs, the nonzeros of the tree-structured mass matrix
    below its diagonal, and the bytes of the model tables the kernel
    reads once a launch."""
    from .reference.plain.physics.model import build_model
    from .reference.plain.physics.spec import parse_mjcf
    from .reference.world import XML
    m = build_model(parse_mjcf(XML), dtype=torch.float64, device="cpu")
    anc = m.anc_mask.numpy() > 0.5
    nd = m.ndof
    nnz = sum(1 for d in range(nd) for j in range(d)
              if anc[d, j] or anc[j, d])
    floats = sum(int(np.prod(t.shape)) for t in (
        m.body_pos, m.body_ipos, m.body_mass, m.body_inertia, m.dof_axis,
        m.dof_anchor, m.dof_armature, m.dof_damping, m.dof_stiffness,
        m.jnt_range, m.actuator_gear, m.cpoint_local, m.cpoint_radius,
        m.cpoint_mu))
    ints = 4 * m.nbody + 6 * nd + 2 * nnz
    return dict(nd=nd, nb=m.nbody, nq=m.nq, nu=m.nu, ncpoint=m.ncpoint,
                npair=m.npair, nbpair=m.nbpair, nnz=nnz,
                table_bytes=8 * floats + 4 * ints)


def k1_prep_ops(c: dict, rows: int) -> float:
    """One environment's prep, shared by both branches of K1: FK,
    inertias, the CRBA entries and diagonal, RNEA, the narrowphase and the
    Jacobian rows of ``rows`` active contact rows."""
    nd, nb, nnz = c["nd"], c["nb"], c["nnz"]
    return (150 * (nd - 6) + 190 * nb + 12 * nnz + 60 * nd + 200 * nb
            + 60 * nd + 30 * c["ncpoint"] + 120 * c["npair"]
            + 400 * c["nbpair"] + 12 * rows * nd)


def k1_work(bsz: int, itemsize: int, floor_rows: float,
            pair_rows: float) -> tuple:
    """(bytes, operations) of one K1 launch over ``bsz`` environments:
    state, controls and gains in, state out, the model tables once; the
    prep once per group of PREP_REFRESH substeps; only the contact rows
    active in the inputs (``floor_rows`` normal rows of floor points and
    ``pair_rows`` pair rows, each a mean per environment)."""
    c = model_counts()
    nd, nq, nu, nnz = c["nd"], c["nq"], c["nu"], c["nnz"]
    nbytes = bsz * (nq + nd + 4 * nu) * itemsize \
        + bsz * (nq + nd) * itemsize + c["table_bytes"]
    rows = 3 * floor_rows + pair_rows
    groups = -(-N_FRAMES // PREP_REFRESH)
    prep = (k1_prep_ops(c, rows) + 2 * (2 * nnz * 10)
            + 2 * rows * nnz + rows * rows * nd)
    sub = (20 * nd + 3 * 4 * nnz + 4 * rows * nd + 10 * 2 * rows * rows
           + 20 * nd)
    return nbytes, bsz * (groups * prep + N_FRAMES * sub)


def k1_bound_s(bsz: int, floor_rows: float, pair_rows: float) -> float:
    """The least time a K1 launch could take on one H100 in float32."""
    nbytes, ops = k1_work(bsz, 4, floor_rows, pair_rows)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def active_rows(states: torch.Tensor) -> tuple:
    """Mean active floor normal rows and pair rows per environment at the
    given states (qpos rows), from the reference's contact geometry."""
    from .reference.plain.physics import engine
    from .reference.plain.physics.model import build_model
    from .reference.plain.physics.spec import parse_mjcf
    from .reference.world import XML
    m = build_model(parse_mjcf(XML), dtype=torch.float64, device="cpu")
    q = states.detach().to("cpu", torch.float64)
    params = engine.DEFAULT_CONTACT
    jf, _, _ = engine.contact_blocks(m, engine.fk(m, q), params)
    k = min(params.max_contacts, m.ncpoint)
    act = torch.any(jf != 0, dim=2).to(torch.float64)
    return (float(act[:, 2 * k:3 * k].sum(1).mean()),
            float(act[:, 3 * k:].sum(1).mean()))


def mlp_flops(dims) -> float:
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def lstm_step_flops(n_in: int, hid: int) -> float:
    """One LSTM cell step: the two products and the gates."""
    return 2.0 * 4 * hid * (n_in + hid) + 12.0 * hid


def net_dims(config: dict) -> dict:
    """Input widths of the policy and value MLPs and their context nets."""
    y = config["yaml"]
    c = model_counts()
    obs = (c["nq"] - 2) + c["nd"]          # obs_vel full, no heading/phase
    vh = int(y["policy_v_hdim"])
    if config["kind"] == "egoforecast":
        sh = int(y["policy_s_hdim"])
        n_in = vh + sh
    else:
        sh, n_in = 0, obs + vh
    hs = [int(h) for h in y["policy_hsize"]]
    return dict(obs=obs, v_hdim=vh, s_hdim=sh, n_in=n_in, hidden=hs,
                nu=c["nu"], margin=int(y["fr_margin"]), feat=64)


def eval_step_flops(config: dict, takes: int, floor_rows, pair_rows) -> float:
    """One eval step over ``takes`` takes: policy and value MLPs and K1
    (the contexts are encoded once, in set-up)."""
    d = net_dims(config)
    mlps = mlp_flops([d["n_in"], *d["hidden"], d["nu"]]) \
        + mlp_flops([d["n_in"], *d["hidden"], 1])
    return takes * mlps + k1_work(takes, 4, floor_rows, pair_rows)[1]


def train_iter_flops(config: dict, lanes: int, steps: int, epochs: int,
                     floor_rows, pair_rows) -> float:
    """One iteration of ``steps`` control steps over ``lanes`` lanes: the
    sample (the policy's context encode, its MLP and K1 each step; the
    forecast's state LSTM step), then the update (contexts, MLPs and state
    LSTMs of both nets over the batch: a forward pass for the fixed
    log-probabilities and values, then per epoch a forward and backward
    pass of each, counted as three forward passes)."""
    d = net_dims(config)
    n = lanes * steps
    pol = mlp_flops([d["n_in"], *d["hidden"], d["nu"]])
    val = mlp_flops([d["n_in"], *d["hidden"], 1])
    m = d["margin"]
    if config["kind"] == "egoforecast":
        ctx = lanes * m * lstm_step_flops(d["feat"], d["v_hdim"]) \
            + n * lstm_step_flops(d["obs"], d["s_hdim"])
        step_ctx = n * lstm_step_flops(d["obs"], d["s_hdim"])
        enc = lanes * m * lstm_step_flops(d["feat"], d["v_hdim"])
    else:
        half = d["v_hdim"] // 2
        ctx = 2 * lanes * (steps + 2 * m) * lstm_step_flops(d["feat"], half)
        step_ctx, enc = 0.0, ctx
    sample = enc + step_ctx + n * pol \
        + steps * k1_work(lanes, 4, floor_rows, pair_rows)[1]
    fwd = 2 * ctx + n * (pol + val)
    return sample + fwd + epochs * 3 * fwd
