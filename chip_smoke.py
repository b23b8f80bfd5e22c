"""Chip smoke test of the PyTorch/CUDA port (egopose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (``t``: seconds since the script started);
any failure exits non-zero:

  device       card name (torch) and name + power limit (nvidia-smi)
  build        nvcc builds of every kernel source in csrc/ (K1 substep.cu,
               both branches, K2 spd_solve.cu, K3 + K4 fused_contact.cu, K5
               fk.cu) and the stage-clock builds of K1 and of K3 + K4, one
               nvcc per library, started together
  k1_vs_plain  the kernel against the plain split path on the card, one
               control step (15 substeps) at R=3 (B=1024, B=4) and R=2
               (remainder group), on contact-rich states drawn from a numpy
               seed: f64 max-abs <= 1e-9, f32 RMS qpos <= 1e-6 and qvel
               <= 1e-4 with finite outputs
  k1_time      kernel and plain version timed with CUDA events (median of
               >= 20 launches after warm-up, each bracketed alone: ms) at
               B=1024 and B=4, f32, and the kernel's 50 launches back to
               back between two events (ms_b2b, per launch: without the
               wrapper's host time, where the card stays ahead of the
               host), the kernel's own device time per launch from
               torch.profiler (device_ms: no host time at all), with the
               bound of the same work on this card, and the kernel's
               registers, shared bytes, blocks per SM and waves at B=1024
  k1_dense_vs_plain
               K1's dense branch (ContactParams.sparse_ldl=False, given
               prep_refresh=3, which it must ignore) against the split path
               at R=1 on contact-rich states, B=1024, 4 and 64, with
               k1_vs_plain's bars
  k1_dense_time
               the same timings of the dense branch and its plain version,
               bound from k1_dense_work, resources
  k1_stages    the stage-clock build of K1 (EGOPOSE_STAGE_CLOCKS: thread 0
               of each block sums clock64() cycles per stage) at B=4 and
               B=1024, f32, each branch: the median over environments of
               each stage's cycles in one control step (the dense
               branch's own stages: factor, gram, torque, z0, residual,
               sweep, velocity, integrate; substep.STAGES)
  eval         the port's main path: ego_mimic_eval --cfg subject_03
               --synthetic --iter 3000 in f32 on the card (4 takes x 380
               steps), then eval_pose's compute_stats; asserts one kernel
               launch per step, num_reset <= 3, every take's average
               reward >= 0.80, pose_dist <= 0.50, all finite; times the
               steady-state steps WINDOW
  eval_profile the same eval again under torch.profiler, its takes cut
               to the profiled steps' end (150 frames, 130 steps),
               recording only the first PROFILE_STEPS (20) steps of
               WINDOW: device time by kernel, kernels launched per step,
               device busy share of their wall time
  render_eval  ego_mimic_eval --render --profile-dir on the card, the 4
               takes cut to 60 frames (40 steps): one K1 launch a step in
               the launch counts and in the trace, no other kernel, the
               replay npz equal to the results pickle's traj_pred and
               traj_orig; the trace's kernels and device ms a step
  engine_mujoco
               ego_mimic_eval --engine mujoco (the MuJoCo C oracle on the
               host) on the same short world, only where ``import mujoco``
               succeeds: no kernel launches, finite, the _mj pickle
               written; elsewhere one line says that it did not run and
               why (mujoco not installed)
  k2_vs_plain  the SPD-solve kernel against torch.cholesky_solve on the
               torque path's systems (M + dt diag(damping), rhs [qfrc | J^T])
               at contact-rich states, B=1024 and B=4, r=25 and r=1: f64
               max-abs <= 1e-9 max|X|; f32 error against the f64 solution of
               the same inputs at most 4x the plain f32 version's; finite
  k2_time      kernel, plain version and torch.linalg.solve (the library
               yardstick) timed with CUDA events at B=1024 and B=4, r=25,
               f32 (the kernel also back to back), with the bound of the
               same work on this card and the kernel's resources as in
               k1_time
  train        the training main path: ego_mimic --cfg subject_03
               --synthetic --batch-lanes 1024 --max-iter 1 in f32 (shipped
               widths; one 200-step segment of 204,800 env steps per
               iteration; save_model_interval 1 in a scratch copy of the
               config; one iteration, cut from 2 to keep the script's time
               as the phases below grew): K1 launches == control steps, K2
               launches == 0, K6 launches inside the update (its context
               nets' passes) > 0, finite losses and rewards, per-step reward
               components in (0, 1], iter_0001.p written and loaded back
               into AgentEgo with equal weights; T_sample, T_update,
               env-steps/s
  train_torque the same CLI with action_type: torque in a scratch copy of
               the config, --episode-len 20 --min-batch 20480 --max-iter 1
               (one segment):
               K2 launches == 15 x control steps, K1 launches == 0, finite
  train_profile
               ego_mimic at the shipped widths, 1024 lanes, 2 iterations of
               one 20-step segment (--episode-len 20, --min-batch 20480),
               the second under --profile-dir: the trace's K1 launches in
               the ``sample`` range == the control steps sampled, none in
               ``update``; the kernels and device ms of each range (the
               PPO update's split), profiled and unprofiled T_sample and
               T_update
  train_trpo   ego_mimic with policy_objective: trpo in a scratch copy of
               the config, shipped widths, 1024 lanes, 2 iterations of one
               20-step segment (--episode-len 20, --min-batch 20480): K1
               launches == control steps, K2 == 0, every metric finite, and
               at least one iteration whose line search accepted a step
               with surrogate_after < policy_loss and 0 < kl <= 1.5 max_kl,
               K6 launches inside each update (its context nets under
               torch.func's grad, vjp and jvp) > 0; T_update beside PPO's
               (train's 200-step and train_profile's 20-step iterations)
  train_a2c    the same with policy_objective: a2c: the launch checks,
               finite metrics, the policy and its context net moved from
               their seeded initial weights
  train_vgail  the same with a discriminator: block (VGAIL_BLOCK), 3
               iterations: the launch checks, finite discrim_loss, and
               whether it fell (with why, where it did not)
  resume_native
               ego_mimic --ckpt-format orbax (1 iteration, save interval
               1) writes models/iter_0001.orbax holding only the native
               file; a fresh AgentEgo loads it with every net, the filter
               and both optimizers' mu, nu, counts and lr torch.equal to the
               writer's; one update of each on one newly sampled batch
               leaves their nets and optimizers torch.equal; then
               ego_forecast --ckpt-format orbax writes iter_0002.orbax and
               --iter 2 resumes a third iteration with the value
               optimizer's step count carried on; K1 launches == control
               steps
  f64_ckpt_f32_eval
               iter_3000.p cast to float64 (filter included, the layout of
               a float64 JAX session's checkpoint) evaluated without --f64,
               takes cut to 60 frames: the filter loads as float32, one K1
               launch a step and no other kernel, the trajectories within
               1e-5 of the float32 checkpoint's own eval
  k3_vs_plain  the fused contact-solve kernel (K3) against its plain
               version on the torque path's systems at contact-rich states
               (B=1024, B=4; c=24 rows, 10 iterations): f64 max-abs <= 1e-9
               max|v|; f32 error against the f64 result of the same inputs
               at most 4x the plain f32 version's; finite
  k4_vs_plain  the same for the fused stable-PD substep kernel (K4) on the
               position path's PD and dynamics systems
  k5_vs_plain  the FK kernel (K5) against engine.fk on random and
               contact-rich qpos (B=1024, B=4): every output within 1e-10
               (f64) and 1e-5 (f32); finite
  k3_time, k4_time, k5_time
               kernel and plain version timed with CUDA events at B=1024
               and B=4, f32 (the kernel also back to back), with the bound
               of the same work on this card (K2-K4 count the lower
               triangle of A / M as read, all that a Cholesky factor reads);
               also their resources as in k1_time (and systems per block)
  lstm         K6, the LSTM's time loop (csrc/lstm.cu through
               models/rnn.py), against the plain loop of cells at the
               cells' shapes: (B 4, T 150, H 64 both ways) statereg,
               (B 1024, T 70, H 64 both ways) the ego-mimic update's
               context nets, (B 1024, T 90, H 128 one way) the forecast's
               state net: the output, every gradient (x, W_ih, W_hh,
               b_ih, b_hh) and the torch.func.jvp tangent in f64 within
               1e-12 (derivatives relative to their largest entry) and in
               f32 within 1e-5 (output) and 1e-4 (derivatives); then, f32,
               each kernel's device time a launch (torch.profiler), the
               pass through K6, the plain loop and torch.nn.LSTM (cuDNN's
               RNN, the library's time of the same function, timed here
               alone) with CUDA events (no-grad forward, and forward with
               backward), each kernel's bound (its hh products at 67
               TFLOP/s, its reads and writes at 3.35 TB/s: K6_WORDS) and
               resources
  data_pipeline
               create_humanoid, then convert_clip on the card, on two
               seeded BVH takes (4 s at 120 Hz) in a scratch directory:
               the model parses, the (121, nq) trajectories are finite with
               unit root quaternions and within 1e-12 of convert_clip
               --device cpu
  gen_expert   gen_expert on the card (float64) over 8 seeded takes of
               3,600 frames (two minutes at 30 Hz each, nq 59: a size
               chosen for this run, not the dataset's): one K5 launch a
               take and no other kernel, every field of every take within
               1e-9 of gen_expert --device cpu, the file loaded by the
               non-synthetic build_world on the card; frames/s, K5's ms,
               device ms and bound at B=3,600 in float64
  k34_stages   the stage-clock build of K3 and K4 (EGOPOSE_STAGE_CLOCKS:
               lane 0 of each warp stamps clock64() after each stage) at
               B=4 and B=1024, f32: the median over warps of each stage's
               cycles in one launch, K4's PD and dynamics warps apart
  pd_fused_step
               one control step of engine.pd_control_step with
               ContactParams(substep_resident=False, pd_fused=True) on the
               card (15 K4 launches, 0 K1) against pd_control_step_split at
               R=1 on the card: f64 max-abs qpos <= 1e-9, qvel <= 1e-8; f32
               RMS qpos <= 1e-6, qvel <= 1e-4
  fused_solver_step
               one torque-mode control step (torque_control_step, 15
               step_raw substeps) with fused_solver=True on the card (15 K3
               launches, 0 K2) against the same step on a CPU copy of the
               inputs in f64: f64 the same bars; f32 error at most 4x that
               of the same f32 step on the CPU
  split_step   engine.pd_control_step with substep_resident and pd_fused
               off on the card: the split path at R=3 (30 K2 launches: the
               PD and the dynamics solve of each substep) and with
               fused_solver (R=1: 15 K2, 15 K3, 15 K5), each against the
               same step on a CPU copy of the inputs, with
               fused_solver_step's bars
  rollout_pd_fused
               the slice's path at full width: build_world(subject_03,
               synthetic), ContactParams(substep_resident=False,
               pd_fused=True), AgentEgo.sample over 1024 lanes for one
               segment cut to 20 control steps, then one PPO update: K4
               launches == 15 x control steps, K1 == 0, finite rewards and
               losses, reward components in (0, 1]; T_sample, env-steps/s
  rollout_torque_fused
               the same in torque mode with fused_solver=True: K3 launches
               == 15 x control steps, K2 == 0
  rollout_dense
               the same in position mode with sparse_ldl=False: one launch
               of K1's dense branch per control step, no other kernel
  forecast_train
               ego_forecast --cfg subject_03_syn --synthetic at the shipped
               widths (1024 lanes, episodes of 90 steps, min batch 50000:
               one segment of 92,160 env steps per iteration, 10 epochs),
               2 iterations (depth cut from 3000), in a scratch directory
               with the committed mimic iter_3000.p: the warm start copied
               the mimic leaves (a run with --max-iter 0), K1 launches ==
               control steps and no other physics kernel, K6 launches
               inside the update > 0, finite losses and
               rewards, rewards in [0, 1] (decayed over the episode) and
               their components in (0, 1], iter_0002.p reloads equal;
               T_sample, T_update, env-steps/s
  forecast_eval
               ego_forecast_eval on that checkpoint, every window of the 4
               takes one lane (40 windows of 90 steps), initialised from
               the eval phase's estimation results (ego_mimic_eval runs
               first when eval does not), then with --gt-init: 90 K1
               launches a run, no other kernel, finite; each run's first
               control step (K1 over all windows) against the plain split
               path on the CPU in f64 from the same state and action,
               within K1's f32 RMS bar; the em-init run's horizon-30 pose
               dist within 5% of the port's CPU f64 run of the same windows
               (where either misses and the CPU f32 counterpart misses too,
               against that: decided_by); wall time, frames/s, num_fail,
               and K1's device time on the first step's inputs with its
               share of a control step
  forecast_stats
               eval_forecast --mode stats on both pickles: horizon-30 and
               horizon-90 pose, velocity and acceleration metrics, finite
  vis_headless eval_pose --mode vis on the card's ego_mimic_eval results
               and eval_forecast --mode vis on forecast_eval's --gt-init
               results, in the forecast workdir: the file written (the
               .npz fallback where mujoco is missing) and the cause the
               fallback logged; its arrays equal to the pickle's first
               take (first window)
  statereg_train
               state_reg --mode train --synthetic at the shipped
               config/statereg/subject_03.yml widths (ResNet-18, bi-LSTM
               v_hdim 128, cnn_fdim 128, MLP 300/200, chunks of 120 + 30
               frames, 4 chunks a step) on the 224x224 synthetic flow, 4
               takes x 240 frames (2 steps an epoch), 4 epochs (depth cut
               from 100), in a scratch directory: finite losses, a loss
               that falls, the checkpoint written, the temporal net through
               K6 (two launches a step, its forward and backward, at the
               least); frames/s per epoch, ms
               a step, peak device memory, and one step split by section,
               each in its own torch.profiler session (host batch
               assembly, host->device copy, CNN forward, temporal net
               forward, its backward, CNN backward, Adam); every statereg
               phase runs it first
  statereg_test
               state_reg --mode test on that checkpoint (every take, the
               per-take trajectory assembly): 4 takes, finite; the first
               take's predictions on the card (f32) against the port's
               CPU f64 run of the same checkpoint within 1e-4 relative RMS
               (STATEREG_TOL)
  statereg_stats
               eval_pose --algo state_reg on statereg_test's results
               pickle: finite pose, velocity and acceleration metrics for
               the 4 takes
  gen_cnn_feature
               gen_cnn_feature over the 4 takes in batches of 256 frames:
               frames/s, (240, 128) features a take, the first batch
               against the CPU f64 CNN within 1e-4 relative RMS
  statereg_eval
               the same statereg config at cnn_fdim 64 (the synthetic
               ego-mimic world's feature width) trained 4 epochs and saved
               with save_inf, then ego_mimic_eval --cfg subject_03
               --synthetic --iter 3000 re-anchored on it (state_net_cfg /
               state_net_iter): one K1 launch a step and no other kernel,
               the state net's predictions on the card against its CPU f64
               run on the same features within 1e-4 relative RMS, the
               first control step against the plain f64 step on its
               inputs within K1's f32 bar; frames/s, num_reset and
               pose_dist printed, not gated
  wild_setup   the in-the-wild world written into the statereg workdir
               (host only): the synthetic mimic world's 4 takes x 400
               frames of 64 CNN features as
               datasets/features/cnn_feat_wild_syn.p, and each take's
               expert projected by the port's Pose2DContext (CPU, f64)
               into OpenPose keypoint files under datasets/tpv/poses/
  wild_eval    state_reg --mode test --test-feat wild_syn on
               statereg_eval's state net, then ego_mimic_eval_wild --cfg
               subject_03 --iter 3000 --test-feat wild_syn in f32 on the
               card re-anchored on it (4 takes x 380 steps): one K1 launch
               a step and no other kernel, finite, the first control step
               within K1's f32 bar of the plain f64 step on its inputs;
               frames/s, resets per take and the steady-state ms a step
               over WINDOW printed
  wild_stats   eval_pose_wild on both wild results (ego-mimic and
               statereg) on the card: one K5 launch per take and
               algorithm, no other kernel, finite metrics, the card's f32
               projection of every frame within WILD_TOL (1e-4) of the CPU
               f64 projection in the metric's units; both 2D pose
               distances and accels, K5's time at B=380
  wild_forecast_eval
               ego_forecast_eval_wild --cfg subject_03_syn --test-feat
               wild_syn --egomimic-iter 3000 on forecast_train's checkpoint
               (the warm start from iter_3000.p without it), the 40 windows
               of the 4 takes one batch: 90 K1 launches, no other kernel,
               the first step within K1's f32 bar, finite, the lane rule's
               window count; frames/s
  wild_forecast_stats
               eval_forecast_wild --horizons 30 90 on the card: one K5
               launch per take with windows, no other kernel, finite;
               both horizons, K5's time at B=1200
  statereg_variants
               one training step each of cnn_type mobile and of v_net tcn
               (non-causal and causal) at the same widths on
               statereg_train's first batch: finite losses
  dp_train     the parallel runtime's main path: ego_mimic --dp-devices 1
               on the card (a process group of one, NCCL) against the
               no-flag run at train's widths, 1024 lanes, one 20-step
               segment and one update: rewards and update metrics within
               rtol 1e-6, K1 launches == control steps in each run
  dp_two_ranks two ranks sharing the card (make_mesh(2, device_ids=[0, 0]),
               gloo staged through host memory) against one process: (a)
               float64, the JAX dry run's world, 64 lanes x 4 steps,
               rewards rtol 1e-8 / atol 1e-10, update metrics rtol 1e-6 /
               atol 1e-8; (b) float32, train's world and widths (10
               optimizer epochs), 2 x 512 lanes, one 20-step segment and
               one update: finite,
               the first control step within K1's f32 RMS bar of the
               one-process step, 20 K1 launches in each rank (the ranks'
               counts come back to the script and add to K1's row);
               T_sample / T_update beside the one-process run's, with the
               card's name and power limit (a check of the code path and
               the collectives, not a speed-up)
  sp_encode    vsnet_encode_sp on 2 ranks sharing the card, a TCN context
               net at the JAX defaults (size [64, 128], kernel 3) from a
               seed over the synthetic eval world's 4 full takes, against
               the unsharded pass: f32 max-abs <= 1e-5; then ego_mimic_eval
               --sp-devices 1 against the no-flag eval of a TCN agent
               built from a seed, takes cut to 60 frames: the same results
               pickle, one K1 launch a step in each
  dryrun       python -m egopose_tpu_torch.parallel.dryrun 2 --device cuda
               (its ranks share the card): the audit summaries and the ok
               line
  kernels      every kernel of the port with its TPU counterpart (K1's
               two branches on two rows), launches on the main paths (eval
               + render_eval + train + train_torque + train_profile + the
               three one-step phases + the
               three rollouts + forecast_train + forecast_eval +
               statereg_eval + wild_eval + wild_forecast_eval + dp_train +
               dp_two_ranks + sp_encode + dryrun for K1, wild_stats +
               wild_forecast_stats + gen_expert + the synthetic worlds'
               expert replays (those of the ranks too) for K5), error
               against the plain version and times

Every world is built through cli/ego_mimic.py's build_world, which the
script wraps (count_world_builds): a synthetic world built on the card
must launch K5 once a take (its experts' replay) and nothing else, and
every launch count is zeroed after the build, so each phase's counts read
only its own path.

With ``--only a,b`` only the phases named run (the device and build
phases always do, statereg_test before statereg_stats, statereg_train
before any statereg or wild phase,
statereg_eval before any wild phase, and each wild phase's inputs'
phases before it).  ``--ab DIR`` instead times every kernel of the
checkout in DIR (a parent commit, unpacked with git archive) and of this
tree in turns, parent, tree, tree, parent (phase ``ab``: ``ms``,
``ms_b2b`` and ``device_ms`` of each phase at each B), each run a
subprocess of ``--only
k1_time,k1_dense_time,k2_time,k3_time,k4_time,k5_time`` (or of the
phases of an ``--only`` given beside ``--ab``); the parent's phases
must print ``device_ms`` (649cfae and later do).

The last two lines are the card's name and power limit and then
{"ok": true, "device": {...}}.  Without CUDA it exits non-zero and prints no
result.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_F64_FLOPS = 34e12        # float64 outside the tensor cores (data sheet)
N_FRAMES = 15                 # substeps per 30 Hz control step
ROLLOUT_STEPS = 20            # control steps of the fused rollouts' segment
ROLLOUT_LANES = 1024          # lanes of the fused rollouts


T0 = time.time()              # every line's "t": seconds since the start


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw, t=time.time() - T0)),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def load_world(dtype, device):
    import torch
    import yaml
    from egopose_tpu_torch.physics import model as pmodel
    from egopose_tpu_torch.physics.spec import parse_mjcf
    spec = parse_mjcf(os.path.join(REPO, "assets", "mujoco_models",
                                   "humanoid_1205_v1.xml"))
    m = pmodel.build_model(spec, dtype=dtype, device=device)
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    jp = list(zip(*cfg["joint_params"]))
    mult = cfg["jkp_multiplier"]
    gains = [torch.tensor(np.array(jp[i], float) * s, dtype=dtype,
                          device=device)
             for i, s in ((1, mult), (2, mult), (5, 1.0))]
    return spec, m, gains


def contact_states(spec, m, bsz, seed, dtype, device):
    """Standing and crouched poses with random tilt, velocities and
    flailing arms, lowered so the lowest floor candidate of each lane
    penetrates by 3-10 mm: floor rows active, pair rows active where limbs
    cross, and depths continuous (no top-K ties)."""
    import torch
    from egopose_tpu_torch.physics import engine
    from egopose_tpu_torch.ops import quat as Q
    rng = np.random.RandomState(seed)
    names = spec.jnt_names
    q = np.zeros((bsz, spec.nq))
    tilt = rng.normal(0.0, 0.03, (bsz, 3))
    q[:, 3:7] = np.c_[np.ones(bsz), 0.5 * tilt]
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.15, 0.15, (bsz, spec.nq - 7))
    crouch = np.arange(bsz) % 2 == 1
    for side in ("Right", "Left"):
        q[crouch, 7 + names.index(side + "UpLeg_x")] -= rng.uniform(
            0.6, 1.0, crouch.sum())
        q[crouch, 7 + names.index(side + "Leg_x")] += rng.uniform(
            0.9, 1.5, crouch.sum())
        for ax in "xyz":
            q[:, 7 + names.index(f"{side}Arm_{ax}")] += rng.uniform(
                -1.2, 1.2, bsz)
        q[:, 7 + names.index(side + "ForeArm_z")] += rng.uniform(
            -1.5, 1.5, bsz)
    qt = torch.tensor(q, dtype=torch.float64, device=device)
    m64 = m if m.dtype == torch.float64 else None
    if m64 is None:
        from egopose_tpu_torch.physics import model as pmodel
        m64 = pmodel.build_model(spec, dtype=torch.float64, device=device)
    kin = engine.fk(m64, qt)
    pts = kin.xpos[:, m64.cpoint_body] + Q.quat_rotate(
        kin.xquat[:, m64.cpoint_body], m64.cpoint_local)
    lowest = torch.amin(pts[..., 2] - m64.cpoint_radius, 1).cpu().numpy()
    q[:, 2] -= lowest + rng.uniform(0.003, 0.010, bsz)
    v = np.zeros((bsz, spec.ndof))
    v[:, :3] = rng.normal(0, 0.2, (bsz, 3))
    v[:, 3:6] = rng.normal(0, 0.3, (bsz, 3))
    v[:, 6:] = rng.normal(0, 0.8, (bsz, spec.ndof - 6))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (bsz, spec.nu))
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return t(q), t(v), t(ctrl)


def active_rows(m, qpos, params):
    """Mean active floor and pair contact rows per lane at the state."""
    import torch
    from egopose_tpu_torch.physics import engine
    jf, _, _ = engine.contact_blocks(m, engine.fk(m, qpos), params)
    k = min(params.max_contacts, m.ncpoint)
    act = torch.any(jf != 0, dim=2).to(torch.float64)
    return (float(act[:, 2 * k:3 * k].sum(1).mean()),
            float(act[:, 3 * k:].sum(1).mean()))


def run_pair(m, gains, q, v, ctrl, params):
    """(kernel, plain) outputs of one control step on the same inputs."""
    from egopose_tpu_torch.physics import engine, substep
    jkp, jkd, tl = gains
    bsz = q.shape[0]
    lane = lambda x: x.expand(bsz, -1).contiguous()
    out_k = substep.pd_control_step_cuda(m, q, v, ctrl, lane(jkp), lane(jkd),
                                         lane(tl), N_FRAMES, params)
    out_p = engine.pd_control_step_split(m, q, v, ctrl, jkp, jkd, tl,
                                         N_FRAMES, params)
    return out_k, out_p


def k1_bars(dtype, got, want):
    """(ok, record) of K1's (qpos, qvel) ``got`` against its plain
    version's ``want``: finite, and f64 max-abs qpos and qvel <= 1e-9, f32
    RMS qpos <= 1e-6 and qvel <= 1e-4."""
    import torch
    (qk, vk), (qp, vp) = got, want
    finite = bool(torch.isfinite(qk).all() and torch.isfinite(vk).all())
    dq, dv = (qk - qp).double(), (vk - vp).double()
    rec = dict(finite=finite, max_abs_qpos=float(dq.abs().max()),
               max_abs_qvel=float(dv.abs().max()),
               rms_qpos=float(dq.pow(2).mean().sqrt()),
               rms_qvel=float(dv.pow(2).mean().sqrt()))
    if dtype == torch.float64:
        ok = rec["max_abs_qpos"] <= 1e-9 and rec["max_abs_qvel"] <= 1e-9
    else:
        ok = rec["rms_qpos"] <= 1e-6 and rec["rms_qvel"] <= 1e-4
    return finite and ok, rec


def phase_k1_vs_plain(device):
    import torch
    from egopose_tpu_torch.physics import engine
    worst = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, gains = load_world(dtype, device)
        for bsz, r, seed in ((1024, 3, 0), (4, 3, 1), (64, 2, 2)):
            params = engine.DEFAULT_CONTACT._replace(prep_refresh=r)
            q, v, ctrl = contact_states(spec, m, bsz, seed, dtype, device)
            floor_rows, pair_rows = active_rows(m, q, params)
            (qk, vk), (qp, vp) = run_pair(m, gains, q, v, ctrl, params)
            torch.cuda.synchronize()
            ok, bars = k1_bars(dtype, (qk, vk), (qp, vp))
            rec = dict(dtype=str(dtype).split(".")[1], B=bsz, R=r,
                       active_floor_normals=floor_rows,
                       active_pair_rows=pair_rows, **bars)
            emit("k1_vs_plain", ok=ok, **rec)
            if not ok:
                raise AssertionError(f"kernel disagrees with plain: {rec}")
            key = rec["dtype"]
            worst[key] = max(worst.get(key, 0.0), rec["max_abs_qpos"],
                             rec["max_abs_qvel"])
    return worst


def k1_work(m, dims_nnz, table_bytes, bsz, itemsize, n_frames, r, floor_rows,
            pair_rows):
    """(bytes, flops) the control step must move / do for ``bsz`` lanes:
    state, controls and gains in, state out, model tables read once;
    operations from the model's tree tables, the prep once per group of R
    substeps, and only the contact rows active in the inputs."""
    nd, nb, nq, nu = m.ndof, m.nbody, m.nq, m.nu
    nbytes = bsz * (nq + nd + 4 * nu) * itemsize \
        + bsz * (nq + nd) * itemsize + table_bytes
    c = 3 * floor_rows + pair_rows            # active contact rows
    groups = -(-n_frames // r)
    prep = (k1_prep_ops(m, dims_nnz, c)
            + 2 * (2 * dims_nnz * 10)                  # two tree factors
            + 2 * c * dims_nnz + c * c * nd)           # Y, Delassus
    sub = (20 * nd + 3 * 4 * dims_nnz                  # rhs, three solves
           + 4 * c * nd + 10 * 2 * c * c + 20 * nd)    # sweep, v, integrate
    return nbytes, bsz * (groups * prep + n_frames * sub)


def k1_prep_ops(m, dims_nnz, c):
    """Operations of one environment's prep that both branches of K1 run:
    FK, inertias, the CRBA entries and diagonal, RNEA, the narrowphase and
    the Jacobian rows of ``c`` active contact rows."""
    nd, nb = m.ndof, m.nbody
    return (150 * (nd - 6) + 190 * nb                 # FK, inertias
            + 12 * dims_nnz + 60 * nd                  # CRBA rows, diag
            + 200 * nb + 60 * nd                       # RNEA
            + 30 * m.ncpoint + 120 * m.npair + 400 * m.nbpair
            + 12 * c * nd)                             # Jacobian rows


def k1_dense_work(m, dims_nnz, n_sup, table_bytes, bsz, itemsize, n_frames,
                  iters, floor_rows, pair_rows):
    """(bytes, flops) of the dense branch's control step for ``bsz``
    lanes: bytes as k1_work's; per substep the least dense algebra known
    to compute it, the forward-only solve: the prep, 2 n^3/3 for the two
    factors, 2 n^2 for the PD column's two substitutions, n^2 c for
    Y = L^-1 J^T, c (c + 1) n for the lower triangle of D = Y^T Y, n^2
    for z0 = L^-1 dt qfrc, 2 c |sup| for J v over the ``n_sup``
    contact-loaded dofs and 2 c n for Y^T z0 (the residual), c^2 for D's
    row sums, iters (2 c^2 + 4 c) for the sweep, 2 n c for Y lam, n^2 for
    the back substitution and 40 n for the rhs, torque and integration;
    c the active contact rows."""
    nbytes, _ = k1_work(m, dims_nnz, table_bytes, bsz, itemsize, n_frames,
                        1, floor_rows, pair_rows)
    n = m.ndof
    c = 3 * floor_rows + pair_rows
    sub = (k1_prep_ops(m, dims_nnz, c) + 2 * n ** 3 / 3 + 2 * n * n
           + n * n * c + c * (c + 1) * n + n * n + 2 * c * n_sup
           + 2 * c * n + c * c + iters * (2 * c * c + 4 * c) + 2 * n * c
           + n * n + 40 * n)
    return nbytes, bsz * n_frames * sub


def time_ms(fn, n=25, warm=5):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_b2b(fn, n=50, warm=5):
    """ms per call of ``n`` calls back to back between two CUDA events:
    the host's time of a call hides behind the card's, so this reads the
    kernel where time_ms also reads the wrapper's host time at small B."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# The name each kernel has in a torch.profiler trace (a substring of it).
KERNEL_KEYS = dict(k1="substep_kernel", k1_dense="substep_dense_kernel",
                   k2="spd_solve_kernel", k3="fused_contact_kernel",
                   k4="pd_fused_kernel", k5="fk_kernel",
                   k6_fwd="lstm_fwd_kernel", k6_bwd="lstm_bwd_kernel",
                   k6_jvp="lstm_jvp_kernel")


def device_ms(fn, key, n=20, tries=3):
    """The kernel's own time per launch on the card: torch.profiler's
    device time of the kernels whose name holds ``key`` over ``n`` calls
    of ``fn``, divided by the launches traced.  Unlike time_b2b it holds no
    host time even where one call's host time exceeds the kernel's.  The
    trace of a short session can miss launches (of K5 at B=4, all of them
    once in six sessions), so a session that traced none is run again,
    up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dtime = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and key in e.key]
        launched = sum(e.count for e in ev)
        if launched:
            return sum(dtime(e) for e in ev) / launched / 1e3
    raise AssertionError(f"{key}: no launch traced in {tries} sessions")


def resources(occ, bsz, per_block=1):
    """An occupancy record plus the waves ``bsz`` blocks of work take on
    this card (``per_block``: systems per block)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-bsz // per_block)
    return dict(occ, sms=sms,
                waves=blocks / (occ["blocks_per_sm"] * sms))


def phase_k1_time(device):
    import torch
    from egopose_tpu_torch.physics import engine, substep
    spec, m, gains = load_world(torch.float32, device)
    jkp, jkd, tl = gains
    params = engine.DEFAULT_CONTACT
    dims, itab, ftab = substep.build_tables(m, params)
    table_bytes = itab.size * 4 + ftab.size * 4
    out = {}
    for bsz in (1024, 4):
        q, v, ctrl = contact_states(spec, m, bsz, 10 + bsz,
                                    torch.float32, device)
        lane = lambda x: x.expand(bsz, -1).contiguous()
        gk = (lane(jkp), lane(jkd), lane(tl))
        kern = lambda: substep.pd_control_step_cuda(m, q, v, ctrl, *gk,
                                                    N_FRAMES, params)
        plain = lambda: engine.pd_control_step_split(
            m, q, v, ctrl, jkp, jkd, tl, N_FRAMES, params)
        floor_rows, pair_rows = active_rows(m, q, params)
        nbytes, flops = k1_work(m, dims["nnz"], table_bytes, bsz, 4, N_FRAMES,
                                params.prep_refresh, floor_rows, pair_rows)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        rec = dict(B=bsz, dtype="float32", R=params.prep_refresh,
                   ms=time_ms(kern), ms_b2b=time_b2b(kern),
                   device_ms=device_ms(kern, KERNEL_KEYS["k1"]),
                   plain_ms=time_ms(plain, n=20, warm=2),
                   bytes=nbytes, flops=flops,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   library_ms=None)
        rec["env_steps_per_s"] = bsz / rec["ms"] * 1e3
        rec.update(resources(substep.occupancy(m, torch.float32), bsz))
        emit("k1_time", **rec)
        out[bsz] = rec
    return out


DENSE = dict(sparse_ldl=False)   # K1's dense branch


def phase_k1_dense_vs_plain(device):
    """K1's dense branch (sparse_ldl=False) against the split path at R=1,
    its plain version, one control step at B=1024, 4 and 64 on
    contact-rich states.  The kernel is given prep_refresh=3 and must
    refresh every substep all the same, as the TPU kernel's dense branch
    does.  K1's bars: f64 max-abs <= 1e-9, f32 RMS qpos <= 1e-6, qvel
    <= 1e-4, finite.

    In f32 the kernel is held against the plain version's f32 run; where
    that run is itself beyond the f32 bars from the plain version's f64
    run on the same inputs (its rounding crossed a discontinuity of the
    model: a pair contact held at the activation margin switches on in
    one run and not in the other, ~0.4 of qvel at once), the kernel is
    held to the same bars against the f64 run instead.  Both comparisons
    are reported, and which one decided."""
    import torch
    from egopose_tpu_torch.physics import engine, substep
    dense = engine.DEFAULT_CONTACT._replace(prep_refresh=3, **DENSE)
    plain = engine.DEFAULT_CONTACT._replace(prep_refresh=1)
    m64 = load_world(torch.float64, device)[1]
    worst = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, (jkp, jkd, tl) = load_world(dtype, device)
        for bsz, seed in ((1024, 90), (4, 91), (64, 92)):
            q, v, ctrl = contact_states(spec, m, bsz, seed, dtype, device)
            lane = lambda x: x.expand(bsz, -1).contiguous()
            qk, vk = substep.pd_control_step_cuda(
                m, q, v, ctrl, lane(jkp), lane(jkd), lane(tl), N_FRAMES,
                dense)
            qp, vp = engine.pd_control_step_split(
                m, q, v, ctrl, jkp, jkd, tl, N_FRAMES, plain)
            torch.cuda.synchronize()
            ok, bars = k1_bars(dtype, (qk, vk), (qp, vp))
            floor_rows, pair_rows = active_rows(m, q, plain)
            rec = dict(dtype=str(dtype).split(".")[1], B=bsz,
                       kernel_prep_refresh=dense.prep_refresh, plain_R=1,
                       active_floor_normals=floor_rows,
                       active_pair_rows=pair_rows, **bars)
            if dtype == torch.float32:
                ref = engine.pd_control_step_split(
                    m64, *[x.double() for x in (q, v, ctrl, jkp, jkd, tl)],
                    N_FRAMES, plain)
                plain_ok, rec["plain_f32_vs_f64"] = k1_bars(dtype, (qp, vp),
                                                            ref)
                k64_ok, rec["kernel_vs_f64"] = k1_bars(dtype, (qk, vk), ref)
                rec["decided_by"] = "plain_f32"
                if not ok and not plain_ok:
                    ok, rec["decided_by"] = k64_ok, "plain_f64"
                    rec["plain_parting"] = parting(
                        m, m64, (jkp, jkd, tl), (q, v, ctrl), vp, ref[1],
                        plain)
            emit("k1_dense_vs_plain", ok=ok, **rec)
            if not ok:
                raise AssertionError(f"K1 dense disagrees with plain: {rec}")
            key = rec["dtype"]
            held = rec["kernel_vs_f64"] \
                if rec.get("decided_by") == "plain_f64" else rec
            worst[key] = max(worst.get(key, 0.0), held["max_abs_qpos"],
                             held["max_abs_qvel"])
    return worst


def parting(m32, m64, gains, state, v32, v64, params):
    """Where the plain version's f32 run leaves its f64 run: the lane of
    the largest qvel gap, the first substep after which the gap exceeds
    1e-2, and at the f64 state that enters it the contact candidate whose
    depth is nearest the activation margin (depth > -margin activates a
    row), with that distance in metres."""
    import torch
    from egopose_tpu_torch.physics import engine
    lane = int((v32.double() - v64).abs().amax(1).argmax())
    s32 = [x[lane:lane + 1] for x in state]
    s64 = [x.double() for x in s32]
    g64 = [g.double() for g in gains]
    for sub in range(1, N_FRAMES + 1):
        kin = engine.fk(m64, s64[0])
        pts = kin.xpos[:, m64.cpoint_body] + engine.Q.quat_rotate(
            kin.xquat[:, m64.cpoint_body], m64.cpoint_local)
        phi = {"floor": m64.cpoint_radius - pts[..., 2],
               "pair": engine.pair_candidates(m64, kin)[0]}
        near = {k: float((x + params.margin).abs().min())
                for k, x in phi.items()}
        s32[:2] = engine.pd_control_step_split(m32, *s32, *gains, 1, params)
        s64[:2] = engine.pd_control_step_split(m64, *s64, *g64, 1, params)
        if float((s32[1].double() - s64[1]).abs().max()) > 1e-2:
            kind = min(near, key=near.get)
            return dict(lane=lane, substep=sub, nearest_margin=kind,
                        distance_m=near[kind])
    return dict(lane=lane, substep=None)


def phase_k1_dense_time(device):
    """K1's dense branch and its plain version (the split path at R=1)
    timed at B=1024 and B=4, f32, with the bound of the dense work
    (k1_dense_work) and the branch's resources."""
    import torch
    from egopose_tpu_torch.physics import engine, substep
    spec, m, gains = load_world(torch.float32, device)
    jkp, jkd, tl = gains
    params = engine.DEFAULT_CONTACT._replace(**DENSE)
    plain_params = engine.DEFAULT_CONTACT._replace(prep_refresh=1)
    dims, itab, ftab = substep.build_tables(m, params)
    table_bytes = itab.size * 4 + ftab.size * 4
    n_sup = sum(b - a for a, b in substep.support_segments(m))
    out = {}
    for bsz in (1024, 4):
        q, v, ctrl = contact_states(spec, m, bsz, 10 + bsz,
                                    torch.float32, device)
        lane = lambda x: x.expand(bsz, -1).contiguous()
        gk = (lane(jkp), lane(jkd), lane(tl))
        kern = lambda: substep.pd_control_step_cuda(m, q, v, ctrl, *gk,
                                                    N_FRAMES, params)
        plain = lambda: engine.pd_control_step_split(
            m, q, v, ctrl, jkp, jkd, tl, N_FRAMES, plain_params)
        floor_rows, pair_rows = active_rows(m, q, params)
        # the plain step takes ~1 s on the card's host: five calls
        rec = dict(B=bsz, dtype="float32", ms=time_ms(kern),
                   ms_b2b=time_b2b(kern),
                   device_ms=device_ms(kern, KERNEL_KEYS["k1_dense"]),
                   plain_ms=time_ms(plain, n=5, warm=1), library_ms=None,
                   **bound(*k1_dense_work(
                       m, dims["nnz"], n_sup, table_bytes, bsz, 4, N_FRAMES,
                       params.iters, floor_rows, pair_rows)))
        rec.update(resources(substep.occupancy(m, torch.float32,
                                               params=params), bsz))
        emit("k1_dense_time", **rec)
        out[bsz] = rec
    return out


def phase_k1_stages(device):
    """K1's stage-clock build at B=4 and B=1024 (f32, contact-rich states),
    the sparse branch at R=3 and the dense branch: the median over
    environments of each stage's cycles in one control step, after two
    warm-up launches.  The SM clock (nvidia-smi) converts cycles to
    microseconds."""
    import torch
    from egopose_tpu_torch.physics import engine
    spec, m, gains = load_world(torch.float32, device)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = {}
    for branch, params in (
            ("sparse", engine.DEFAULT_CONTACT),
            ("dense", engine.DEFAULT_CONTACT._replace(**DENSE))):
        out[branch] = stages_of(m, spec, gains, params, clock, branch, device)
    return out


def stages_of(m, spec, gains, params, clock, branch, device):
    """One branch's k1_stages records at B=4 and B=1024."""
    import torch
    from egopose_tpu_torch.physics import substep
    jkp, jkd, tl = gains
    out = {}
    for bsz in (4, 1024):
        q, v, ctrl = contact_states(spec, m, bsz, 10 + bsz, torch.float32,
                                    device)
        lane = lambda x: x.expand(bsz, -1).contiguous()
        clocks = torch.zeros(bsz, len(substep.STAGES), dtype=torch.int64,
                             device=device)
        for _ in range(3):
            substep.pd_control_step_cuda(m, q, v, ctrl, lane(jkp), lane(jkd),
                                         lane(tl), N_FRAMES, params,
                                         clocks=clocks)
        torch.cuda.synchronize()
        med = clocks.double().median(0).values.cpu().numpy()
        total = float(med.sum())
        rec = dict(branch=branch, B=bsz,
                   R=1 if branch == "dense" else params.prep_refresh,
                   dtype="float32",
                   sm_clock_mhz_now_max=clock, total_cycles=total,
                   cycles={n: float(c) for n, c in zip(substep.STAGES, med)},
                   share={n: float(c) / total
                          for n, c in zip(substep.STAGES, med)})
        emit("k1_stages", **rec)
        out[bsz] = rec
    return out


@contextlib.contextmanager
def eval_workdir(env=None):
    """A scratch working directory for the eval CLI, which reads config/
    and results/<...>/models relative to it and writes results/ and logs
    there; ``env`` variables are set for the duration."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.symlink(os.path.join(REPO, "config"), os.path.join(tmp, "config"))
        models = os.path.join(tmp, "results", "egomimic", "subject_03")
        os.makedirs(models)
        os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                                "models"), os.path.join(models, "models"))
        os.environ.update(env or {})
        os.chdir(tmp)
        try:
            yield
        finally:
            os.chdir(cwd)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


EVAL_ARGS = ["--cfg", "subject_03", "--synthetic", "--iter", "3000"]
# Steady-state steps [lo, hi) of the 380-step eval that are timed (phase
# eval): past the first steps' warm-up and between the expert syncs at
# t % 100 == 0.  Phase eval_profile profiles the first PROFILE_STEPS of
# them: the profiler's processing of all 50 steps' ~200k kernel records
# took ~100 s of the script.
WINDOW = (110, 160)
PROFILE_STEPS = 20


def window_hook(marks, after=None, window=WINDOW):
    """An eval step hook: at the window's edges (after steps lo-1 and
    hi-1) it waits for the card and stamps the host clock into ``marks``;
    then it calls ``after`` (the profiler's step)."""
    import torch
    lo, hi = window

    def hook(t):
        if t in (lo - 1, hi - 1):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        if after is not None:
            after()
    return hook


def phase_eval(device):
    import torch
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.cli.eval_pose import compute_stats
    from egopose_tpu_torch.physics import linalg, substep
    marks = []
    with eval_workdir():
        reset_counts()
        t0 = time.time()
        results, meta = ego_mimic_eval.main(
            EVAL_ARGS + ["--device", str(device)],
            step_hook=window_hook(marks))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, k2_launches = substep.launches, linalg.launches
        stats = compute_stats(results)
    steps = meta["steps"]
    rewards = meta["avg_reward"]
    finite = bool(all(np.isfinite(np.asarray(a)).all()
                      for key in ("traj_pred", "vel_pred")
                      for a in results[key].values())
                  and np.isfinite(stats["pose_dist"]))
    rec = dict(frames_per_sec=meta["frames_per_sec"], wall_s=wall,
               window=list(WINDOW),
               window_step_ms=(marks[1] - marks[0]) * 1e3
               / (WINDOW[1] - WINDOW[0]),
               steps=steps, launches=launches, k2_launches=k2_launches,
               num_reset=meta["num_reset"],
               avg_reward=rewards, pose_dist=stats["pose_dist"],
               vel_dist=stats["vel_dist"], accel=stats["accel"],
               finite=finite)
    ok = bool(launches == steps and k2_launches == 0
              and meta["num_reset"] <= 3
              and min(rewards.values()) >= 0.80
              and stats["pose_dist"] <= 0.50 and finite)
    emit("eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"eval out of bounds: {rec}")
    return dict(rec, em_results=(results, meta))


def phase_eval_profile(device, step_ms=None):
    """torch.profiler over the first PROFILE_STEPS steps of the
    steady-state window of the eval (4 takes; only those steps recorded,
    no setup): device time by kernel, CUDA kernels launched per step, and
    the device's busy share of the profiled steps' wall time, profiled
    and (from phase eval's ``window_step_ms`` over WINDOW) unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from egopose_tpu_torch.cli import ego_mimic_eval
    lo = WINDOW[0]
    hi = lo + PROFILE_STEPS
    saved, marks = [], []
    # takes cut to hi + 2 * fr_margin frames, so the eval stops at the
    # window's end (PR 9: the steps after it were run and not recorded)
    with eval_workdir({"EGOPOSE_SYNTHETIC_LEN": str(hi + 20)}):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=lo - 5, warmup=5,
                                       active=hi - lo, repeat=1),
                     on_trace_ready=lambda p: saved.append(
                         p.key_averages())) as prof:
            ego_mimic_eval.main(EVAL_ARGS + ["--device", str(device)],
                                step_hook=window_hook(marks, prof.step,
                                                      (lo, hi)))
    # device activity only: kernels and copies, not the profiler's own
    # per-step range (reported on the device too)
    dev = [e for e in saved[0]
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    dtime = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    n = hi - lo
    dev_ms = sum(dtime(e) for e in dev) / 1e3 / n
    wall_ms = (marks[1] - marks[0]) * 1e3 / n
    top = sorted(dev, key=dtime, reverse=True)[:6]
    emit("eval_profile", window=[lo, hi],
         device_ms_per_step=dev_ms, profiled_step_ms=wall_ms,
         device_busy_share_profiled=dev_ms / wall_ms,
         unprofiled_step_ms=step_ms,
         device_busy_share=dev_ms / step_ms if step_ms else None,
         kernels_per_step=sum(e.count for e in dev) / n,
         control_step_kernels=sum(e.count for e in dev
                                  if "substep_kernel" in e.key),
         top=[dict(name=e.key[:60], ms_per_step=dtime(e) / 1e3 / n,
                   per_step=e.count / n) for e in top])


# ---------------------------------------------------------------------------
# K2: the batched SPD solve of the torque-mode substep
# ---------------------------------------------------------------------------

def k2_systems(m, q, v, params):
    """The torque path's systems at the states (engine.step_raw): A = M +
    dt diag(damping) (B,nd,nd), rhs = [qfrc | J^T] (B,nd,1+c)."""
    import torch
    from egopose_tpu_torch.physics import engine
    kin = engine.fk(m, q)
    qfrc, a = engine.smooth_dynamics(
        m, q, v, torch.zeros_like(v), params, engine.crba(m, kin),
        engine.bias_force(m, kin, v))
    jf, _, _ = engine.contact_blocks(m, kin, params)
    rhs = torch.cat([qfrc[..., None], jf.transpose(1, 2)], 2)
    return a.contiguous(), rhs.contiguous()


def tri(n):
    """Values of an n x n matrix's lower triangle: all of A (M) that a
    Cholesky factor reads."""
    return n * (n + 1) // 2


def k2_work(bsz, n, r, itemsize):
    """(bytes, flops) of B solves: A's lower triangle and B read once, X
    written once; n^3/3 for the factor and 2 n^2 r for the two
    substitutions."""
    return (bsz * (tri(n) + 2 * n * r) * itemsize,
            bsz * (n ** 3 / 3 + 2 * n * n * r))


def phase_k2_vs_plain(device):
    import torch
    from egopose_tpu_torch.physics import engine, linalg
    params = engine.DEFAULT_CONTACT
    worst = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, _ = load_world(dtype, device)
        for bsz, r, seed in ((1024, 25, 20), (4, 25, 21), (1024, 1, 22),
                             (4, 1, 23)):
            q, v, _ = contact_states(spec, m, bsz, seed, dtype, device)
            a, rhs = k2_systems(m, q, v, params)
            rhs = rhs[..., :r].contiguous()
            xk = linalg.spd_solve_cuda(a, rhs)
            xp = linalg.spd_solve_plain(a, rhs)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(xk).all() and torch.isfinite(xp).all())
            scale = float(xp.abs().max())
            rec = dict(dtype=str(dtype).split(".")[1], B=bsz, n=a.shape[1],
                       r=r, finite=finite, max_abs_x=scale,
                       max_abs_err=float((xk - xp).abs().max()))
            if dtype == torch.float64:
                ok = finite and rec["max_abs_err"] <= 1e-9 * scale
            else:
                ref = linalg.spd_solve_plain(a.double(), rhs.double())
                rec["kernel_err_vs_f64"] = float((xk.double() - ref).abs().max())
                rec["plain_err_vs_f64"] = float((xp.double() - ref).abs().max())
                ok = finite and rec["kernel_err_vs_f64"] \
                    <= 4 * rec["plain_err_vs_f64"]
            emit("k2_vs_plain", ok=ok, **rec)
            if not ok:
                raise AssertionError(f"K2 disagrees with plain: {rec}")
            key = rec["dtype"]
            worst[key] = max(worst.get(key, 0.0), rec["max_abs_err"])
    return worst


def phase_k2_time(device):
    import torch
    from egopose_tpu_torch.physics import engine, linalg
    spec, m, _ = load_world(torch.float32, device)
    out = {}
    for bsz in (1024, 4):
        q, v, _ = contact_states(spec, m, bsz, 30 + bsz, torch.float32,
                                 device)
        a, rhs = k2_systems(m, q, v, engine.DEFAULT_CONTACT)
        n, r = a.shape[1], rhs.shape[2]
        nbytes, flops = k2_work(bsz, n, r, 4)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        rec = dict(B=bsz, n=n, r=r, dtype="float32",
                   ms=time_ms(lambda: linalg.spd_solve_cuda(a, rhs)),
                   ms_b2b=time_b2b(lambda: linalg.spd_solve_cuda(a, rhs)),
                   device_ms=device_ms(lambda: linalg.spd_solve_cuda(a, rhs),
                                       KERNEL_KEYS["k2"]),
                   plain_ms=time_ms(lambda: linalg.spd_solve_plain(a, rhs)),
                   library_ms=time_ms(lambda: torch.linalg.solve(a, rhs)),
                   bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations")
        occ = linalg.spd_solve_occupancy(n, r, torch.float32)
        rec.update(resources(occ, bsz, occ["systems_per_block"]))
        emit("k2_time", **rec)
        out[bsz] = rec
    return out


# ---------------------------------------------------------------------------
# K3, K4: the fused contact solve and the fused stable-PD substep; K5: FK
# ---------------------------------------------------------------------------

def k3_systems(m, q, v, params):
    """The torque path's fused-solve inputs at the states (engine.step_raw
    with fused_solver): (a, qfrc, qvel, jf, target, mu)."""
    import torch
    from egopose_tpu_torch.physics import engine
    kin = engine.fk(m, q)
    qfrc, a = engine.smooth_dynamics(
        m, q, v, torch.zeros_like(v), params, engine.crba(m, kin),
        engine.bias_force(m, kin, v))
    jf, target, mu = engine.contact_blocks(m, kin, params)
    return tuple(x.contiguous() for x in (a, qfrc, v, jf, target, mu))


def k4_systems(m, gains, q, v, ctrl, params):
    """The position path's fused PD-substep inputs at the states
    (engine._pd_fused_control_step): the 13 tensors of linalg.pd_fused."""
    from egopose_tpu_torch.physics import engine
    jkp_f, jkd_f, tlim_f, gear_f, kdd = engine.pd_fused_gains(
        m, q.shape[0], *gains)
    mm, rhspd, e, qfb, jf, target, mu = engine.pd_fused_terms(
        m, q, v, ctrl, jkp_f, jkd_f, engine.fk(m, q), params)
    return tuple(x.contiguous() for x in (
        mm, kdd, rhspd, e, jkp_f, jkd_f, tlim_f, gear_f, qfb, v, jf, target,
        mu))


def k3_work(bsz, n, c, k, iters, itemsize):
    """(bytes, flops) of B fused contact solves: a's lower triangle, qfrc,
    qvel, jf, target, mu read once, v_new written once; the forward-only
    solve the kernel does, the least dense algebra known to compute it:
    n^3/3 for the factor, n^2 (1 + c) for the forward substitution of
    [dt qfrc, J^T], c (c + 1) n for the lower triangle of the Delassus
    matrix Z^T Z, 4 c n for the residual J v + Z^T z0, c^2 for the row
    sums, iters (2 c^2 + 4 c) for the sweep, 2 n c + n for z0 + Z lam and
    n^2 + n for the back substitution and v_new."""
    return (bsz * (tri(n) + 3 * n + c * n + c + k) * itemsize,
            bsz * (n ** 3 / 3 + n * n * (1 + c) + c * (c + 1) * n
                   + 4 * c * n + c * c + iters * (2 * c * c + 4 * c)
                   + 2 * n * c + n + n * n + n))


def k4_work(bsz, n, c, k, iters, itemsize):
    """(bytes, flops) of B fused stable-PD substeps: M's lower triangle,
    kdd, the eight vectors, jf, target, mu read once, v_new written once;
    K3's work plus
    a second factor (n^3/3), the PD column's two substitutions (2 n^2),
    the two diagonal additions (4 n) and the torque, clamp and force
    (10 n)."""
    _, flops = k3_work(bsz, n, c, k, iters, itemsize)
    return (bsz * (tri(n) + 11 * n + c * n + c + k) * itemsize,
            flops + bsz * (n ** 3 / 3 + 2 * n * n + 14 * n))


def k5_work(m, bsz, itemsize):
    """(bytes, flops) of B FKs: qpos read once, xpos, xquat, com and s
    written once; per hinge 139 operations (three quaternion rotations of
    30, a product of 28, a cross product, the half-angle sine and cosine),
    per body 66 (the body offset and com rotations), the root 131."""
    nb, nd = m.nbody, m.ndof
    return (bsz * (m.nq + 10 * nb + 6 * nd) * itemsize,
            bsz * (139 * (nd - 6) + 66 * nb + 131))


def bound(nbytes, flops, flops_per_s=H100_F32_FLOPS):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def phase_fused_vs_plain(device, which):
    """K3 (``which`` = "k3") or K4 ("k4") against its plain version."""
    import torch
    from egopose_tpu_torch.physics import engine, linalg
    cuda, plain = {"k3": (linalg.fused_contact_cuda,
                          linalg.fused_contact_plain),
                   "k4": (linalg.pd_fused_cuda, linalg.pd_fused_plain)}[which]
    params = engine.DEFAULT_CONTACT
    worst = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, gains = load_world(dtype, device)
        extra = (m.timestep, params.iters, params.relax)
        for bsz, seed in ((1024, 40), (4, 41)):
            q, v, ctrl = contact_states(spec, m, bsz, seed, dtype, device)
            args = k3_systems(m, q, v, params) if which == "k3" \
                else k4_systems(m, gains, q, v, ctrl, params)
            vk = cuda(*args, *extra)
            vp = plain(*args, *extra)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(vk).all() and torch.isfinite(vp).all())
            scale = float(vp.abs().max())
            c, k = args[-3].shape[1], args[-1].shape[1]
            rec = dict(dtype=str(dtype).split(".")[1], B=bsz, c=c, k=k,
                       iters=params.iters, finite=finite, max_abs_v=scale,
                       max_abs_err=float((vk - vp).abs().max()))
            if dtype == torch.float64:
                ok = finite and rec["max_abs_err"] <= 1e-9 * scale
            else:
                ref = plain(*[x.double() for x in args], *extra)
                rec["kernel_err_vs_f64"] = float((vk.double() - ref).abs().max())
                rec["plain_err_vs_f64"] = float((vp.double() - ref).abs().max())
                ok = finite and rec["kernel_err_vs_f64"] \
                    <= 4 * rec["plain_err_vs_f64"]
            emit(which + "_vs_plain", ok=ok, **rec)
            if not ok:
                raise AssertionError(f"{which} disagrees with plain: {rec}")
            key = rec["dtype"]
            worst[key] = max(worst.get(key, 0.0), rec["max_abs_err"])
    return worst


def phase_fused_time(device, which):
    import torch
    from egopose_tpu_torch.physics import engine, linalg
    cuda, plain, work, occupancy = {
        "k3": (linalg.fused_contact_cuda, linalg.fused_contact_plain,
               k3_work, linalg.fused_contact_occupancy),
        "k4": (linalg.pd_fused_cuda, linalg.pd_fused_plain, k4_work,
               linalg.pd_fused_occupancy)}[which]
    params = engine.DEFAULT_CONTACT
    spec, m, gains = load_world(torch.float32, device)
    extra = (m.timestep, params.iters, params.relax)
    out = {}
    for bsz in (1024, 4):
        q, v, ctrl = contact_states(spec, m, bsz, 50 + bsz, torch.float32,
                                    device)
        args = k3_systems(m, q, v, params) if which == "k3" \
            else k4_systems(m, gains, q, v, ctrl, params)
        n, c, k = args[0].shape[1], args[-3].shape[1], args[-1].shape[1]
        rec = dict(B=bsz, n=n, c=c, k=k, iters=params.iters, dtype="float32",
                   ms=time_ms(lambda: cuda(*args, *extra)),
                   ms_b2b=time_b2b(lambda: cuda(*args, *extra)),
                   device_ms=device_ms(lambda: cuda(*args, *extra),
                                       KERNEL_KEYS[which]),
                   plain_ms=time_ms(lambda: plain(*args, *extra)),
                   library_ms=None,
                   **bound(*work(bsz, n, c, k, params.iters, 4)))
        occ = occupancy(n, c, k, torch.float32)
        rec.update(resources(occ, bsz, occ["systems_per_block"]))
        emit(which + "_time", **rec)
        out[bsz] = rec
    return out


def phase_k34_stages(device):
    """K3's and K4's stage-clock build at B=4 and B=1024 (f32, the k3_time /
    k4_time systems): the median over warps of each stage's cycles in one
    launch, after two warm-up launches; K4's PD warp and dynamics warp
    apart."""
    import torch
    from egopose_tpu_torch.physics import engine, linalg
    params = engine.DEFAULT_CONTACT
    spec, m, gains = load_world(torch.float32, device)
    extra = (m.timestep, params.iters, params.relax)
    out = {}
    for bsz in (4, 1024):
        q, v, ctrl = contact_states(spec, m, bsz, 50 + bsz, torch.float32,
                                    device)
        for which, warps in (("k3", {"warp": slice(None)}),
                             ("k4", {"pd_warp": slice(0, None, 2),
                                     "dynamics_warp": slice(1, None, 2)})):
            if which == "k3":
                args, run = k3_systems(m, q, v, params), \
                    linalg.fused_contact_cuda
            else:
                args, run = k4_systems(m, gains, q, v, ctrl, params), \
                    linalg.pd_fused_cuda
            clocks = torch.zeros(bsz * (1 if which == "k3" else 2),
                                 len(linalg.FUSED_STAGES), dtype=torch.int64,
                                 device=device)
            for _ in range(3):
                run(*args, *extra, clocks=clocks)
            torch.cuda.synchronize()
            cyc = linalg.fused_stage_cycles(clocks.cpu())
            rec = dict(kernel=which, B=bsz, dtype="float32")
            for who, rows in warps.items():
                c = cyc[rows]
                rec[who] = {
                    name: float(c[:, i][c[:, i] > 0].median())
                    for i, name in enumerate(linalg.FUSED_STAGES)
                    if bool((c[:, i] > 0).any())}
                rec[who + "_total"] = sum(rec[who].values())
            emit("k34_stages", **rec)
            out[(which, bsz)] = rec
    return out


def fk_states(spec, m, bsz, seed, dtype, device):
    """Half random qpos (any root, unnormalised root quaternion, hinges in
    +-1.5 rad), half contact_states."""
    import torch
    rng = np.random.RandomState(seed)
    h = bsz // 2
    q = np.zeros((h, spec.nq))
    q[:, :3] = rng.randn(h, 3)
    q[:, 3:7] = rng.randn(h, 4)
    q[:, 7:] = rng.uniform(-1.5, 1.5, (h, spec.nq - 7))
    qc, _, _ = contact_states(spec, m, bsz - h, seed, dtype, device)
    return torch.cat([torch.tensor(q, dtype=dtype, device=device), qc])


def phase_k5_vs_plain(device):
    import torch
    from egopose_tpu_torch.physics import engine, fk
    worst = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        spec, m, _ = load_world(dtype, device)
        for bsz, seed in ((1024, 60), (4, 61)):
            q = fk_states(spec, m, bsz, seed, dtype, device)
            got = fk.fk_cuda(m, q)
            want = engine.fk(m, q)
            torch.cuda.synchronize()
            errs = {name: float((g - w).abs().max())
                    for name, g, w in zip(want._fields, got, want)}
            finite = bool(all(torch.isfinite(g).all() for g in got))
            rec = dict(dtype=str(dtype).split(".")[1], B=bsz, tol=tol,
                       finite=finite, max_abs_err=errs)
            ok = finite and max(errs.values()) <= tol
            emit("k5_vs_plain", ok=ok, **rec)
            if not ok:
                raise AssertionError(f"K5 disagrees with engine.fk: {rec}")
            key = rec["dtype"]
            worst[key] = max(worst.get(key, 0.0), *errs.values())
    return worst


def phase_k5_time(device):
    import torch
    from egopose_tpu_torch.physics import engine, fk
    spec, m, _ = load_world(torch.float32, device)
    out = {}
    for bsz in (1024, 4):
        q, _, _ = contact_states(spec, m, bsz, 70 + bsz, torch.float32,
                                 device)
        rec = dict(B=bsz, dtype="float32",
                   ms=time_ms(lambda: fk.fk_cuda(m, q)),
                   ms_b2b=time_b2b(lambda: fk.fk_cuda(m, q)),
                   device_ms=device_ms(lambda: fk.fk_cuda(m, q),
                                       KERNEL_KEYS["k5"]),
                   plain_ms=time_ms(lambda: engine.fk(m, q)),
                   library_ms=None, **bound(*k5_work(m, bsz, 4)))
        occ = fk.occupancy(m, torch.float32)
        rec.update(resources(occ, bsz, occ["systems_per_block"]))
        emit("k5_time", **rec)
        out[bsz] = rec
    return out


# ---------------------------------------------------------------------------
# K6: the LSTM's time loop
# ---------------------------------------------------------------------------

# (name, B, T, input width, H, both ways): the cells' LSTM passes
LSTM_SHAPES = (("statereg", 4, 150, 128, 64, True),
               ("egomimic_update", 1024, 70, 64, 64, True),
               ("egoforecast_update", 1024, 90, 64, 128, False))


# words a batch row and step of one direction, in units of H, that each
# kernel of K6 reads and writes: the no-grad forward reads xg and writes h;
# under autograd it also writes the gates and c; the backward reads dy, the
# gates and c and writes dg; the tangent reads tg, the gates and c and
# writes dh
K6_WORDS = dict(fwd=5, fwd_keep=10, bwd=10, jvp=10)


def k6_work(bsz, t_len, hid, ndir, itemsize, kind):
    """(bytes, flops) of one launch of a kernel of K6 (``kind`` a key of
    K6_WORDS): W_hh read once and each row's words, and the hh products,
    2 B 4H H a step and direction (the gate arithmetic not counted)."""
    rows = t_len * bsz * ndir
    return (ndir * 4 * hid * hid + rows * K6_WORDS[kind] * hid) * itemsize, \
        2 * rows * 4 * hid * hid


def k6_pass(net, x, r):
    """(output, gradients of x and every parameter) of sum(net(x) * r)."""
    net.zero_grad()
    x = x.detach().requires_grad_(True)
    out = net(x)
    (out * r).sum().backward()
    return out.detach(), [x.grad] + [p.grad.clone() for p in net.parameters()]


def k6_tangent(net, x, tangents):
    """(output, tangent) of net(x) under torch.func.jvp along ``tangents``
    (of the parameters and x)."""
    from torch.func import functional_call, jvp
    params = {k: v.detach() for k, v in net.named_parameters()}
    return jvp(lambda p, v: functional_call(net, p, (v,)), (params, x),
               tangents)


def phase_lstm(device):
    import torch
    from egopose_tpu_torch.models.rnn import RNN
    from egopose_tpu_torch.ops import lstm

    class Loop(torch.nn.Module):
        """The plain loop of cells over the net's own cells."""
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            out = self.net.loop(self.net.rnn_f, x, False)
            if self.net.bi_dir:
                out = torch.cat([out, self.net.loop(self.net.rnn_b, x, True)],
                                -1)
            return out

    def cudnn_lstm(net, d_in, hid, bi):
        """torch.nn.LSTM (cuDNN's RNN) holding the net's weights: the
        library's time of the same function, measured here alone."""
        lib = torch.nn.LSTM(d_in, hid, bidirectional=bi).to(device)
        with torch.no_grad():
            for sfx, cell in (("", net.rnn_f),) + (
                    (("_reverse", net.rnn_b),) if bi else ()):
                getattr(lib, "weight_ih_l0" + sfx).copy_(cell.ih.weight)
                getattr(lib, "weight_hh_l0" + sfx).copy_(cell.hh.weight)
                getattr(lib, "bias_ih_l0" + sfx).copy_(cell.ih.bias)
                getattr(lib, "bias_hh_l0" + sfx).copy_(cell.hh.bias)
        return lambda v: lib(v)[0]

    def worst(a, b):
        return max(float((u - v).abs().max()) / max(float(v.abs().max()),
                                                    1e-300)
                   for u, v in zip(a, b))

    out = {}
    for name, bsz, t_len, d_in, hid, bi in LSTM_SHAPES:
        ndir = 2 if bi else 1
        errs = {}
        for dtype, out_tol, grad_tol in ((torch.float64, 1e-12, 1e-12),
                                         (torch.float32, 1e-5, 1e-4)):
            torch.manual_seed(bsz + t_len)
            net = RNN(d_in, ndir * hid, bi_dir=bi).to(device=device,
                                                      dtype=dtype)
            x = torch.randn(t_len, bsz, d_in, device=device, dtype=dtype)
            r = torch.randn(t_len, bsz, ndir * hid, device=device,
                            dtype=dtype)
            tangents = ({k: torch.randn_like(v)
                         for k, v in net.named_parameters()},
                        torch.randn_like(x))
            before = lstm.launches
            y, g = k6_pass(net, x, r)
            yt, dt = k6_tangent(net, x, tangents)
            launched = lstm.launches - before
            y0, g0 = k6_pass(Loop(net), x, r)
            yt0, dt0 = k6_tangent(Loop(net), x,
                                  ({"net." + k: v for k, v in
                                    tangents[0].items()}, tangents[1]))
            torch.cuda.synchronize()
            e_y = max(float((y - y0).abs().max()),
                      float((yt - yt0).abs().max()))
            e_g, e_t = worst(g, g0), worst([dt], [dt0])
            ok = bool(torch.isfinite(y).all() and e_y <= out_tol
                      and max(e_g, e_t) <= grad_tol and launched == 4)
            key = str(dtype).split(".")[1]
            errs[key] = dict(out=e_y, grad=e_g, tangent=e_t,
                             out_tol=out_tol, grad_tol=grad_tol,
                             launches=launched, ok=ok)
            if not ok:
                emit("lstm", ok=False, shape=name, errors=errs)
                raise AssertionError(f"K6 disagrees with the loop: {name} "
                                     f"{errs}")
        # times, float32 (the last net)
        loop, lib = Loop(net), cudnn_lstm(net, d_in, hid, bi)
        with torch.no_grad():
            lib_gap = float((lib(x) - net(x)).abs().max())

        def fwd(m):
            with torch.no_grad():
                m(x)

        def both(m):
            net.zero_grad()
            (m(x) * r).sum().backward()

        def tangent():
            k6_tangent(net, x, tangents)

        rec = dict(shape=name, B=bsz, T=t_len, D=d_in, H=hid, ndir=ndir,
                   dtype="float32", errors=errs,
                   fwd_device_ms=device_ms(lambda: fwd(net),
                                           KERNEL_KEYS["k6_fwd"]),
                   bwd_device_ms=device_ms(lambda: both(net),
                                           KERNEL_KEYS["k6_bwd"]),
                   jvp_device_ms=device_ms(tangent, KERNEL_KEYS["k6_jvp"]),
                   fwd_ms=time_ms(lambda: fwd(net)),
                   pass_ms=time_ms(lambda: both(net)),
                   plain_fwd_ms=time_ms(lambda: fwd(loop), n=5, warm=2),
                   plain_pass_ms=time_ms(lambda: both(loop), n=5, warm=2),
                   library_ms=dict(fwd=time_ms(lambda: fwd(lib)),
                                   pass_ms=time_ms(lambda: both(lib)),
                                   max_gap_to_k6=lib_gap))
        for which, kind, work in (("fwd", "fwd", "fwd"),
                                  ("bwd", "bwd", "bwd"),
                                  ("jvp", "jvp", "jvp")):
            b = bound(*k6_work(bsz, t_len, hid, ndir, 4, work))
            occ = lstm.occupancy(bsz, hid, ndir, torch.float32, kind)
            rec[which] = dict(b, **resources(occ, -(-bsz // occ[
                "rows_per_block"]) * ndir))
        rec["rows_per_thread"] = rec["fwd"]["rows_per_thread"]
        emit("lstm", ok=True, **rec)
        out[name] = rec
    return out


# ---------------------------------------------------------------------------
# data processing: create_humanoid, convert_clip and gen_expert
# ---------------------------------------------------------------------------

# The BVH hierarchy of tests/test_torch_mocap.py's seeded take: a root with
# translation, Spine and Head, LeftLeg and its LeftToe (which convert_clip's
# EXCLUDE_BONES drops), offsets in inches.
BVH_HIERARCHY = """HIERARCHY
ROOT Hips
{
  OFFSET 0.0 0.0 0.0
  CHANNELS 6 Xposition Yposition Zposition Xrotation Yrotation Zrotation
  JOINT Spine
  {
    OFFSET 0.0 2.0 4.0
    CHANNELS 3 Xrotation Yrotation Zrotation
    JOINT Head
    {
      OFFSET 0.0 1.0 6.0
      CHANNELS 3 Xrotation Yrotation Zrotation
      End Site
      {
        OFFSET 0.0 0.0 3.0
      }
    }
  }
  JOINT LeftLeg
  {
    OFFSET 1.0 0.0 -4.0
    CHANNELS 3 Xrotation Yrotation Zrotation
    JOINT LeftToe
    {
      OFFSET 0.0 1.0 -8.0
      CHANNELS 3 Xrotation Yrotation Zrotation
      End Site
      {
        OFFSET 0.0 1.0 0.0
      }
    }
  }
}
"""


def seeded_bvh(n_frames, seed):
    """BVH_HIERARCHY with ``n_frames`` of seeded motion at 120 Hz: a moving
    root turning about all three axes, the joints within +-80 degrees."""
    rng = np.random.RandomState(seed)
    t = np.arange(n_frames)[:, None] / 120.0
    frames = np.hstack([
        np.hstack([t * 10, np.sin(t) * 5, 36 + np.cos(3 * t)]),
        rng.uniform(-90, 90, 3) + 40 * np.sin(2 * t + rng.uniform(0, 6, 3)),
        rng.uniform(-60, 60, (1, 12)) + 20 * np.sin(
            t * rng.uniform(1, 4, 12) + rng.uniform(0, 6, 12))])
    rows = "\n".join(" ".join("%.6f" % v for v in r) for r in frames)
    return (f"{BVH_HIERARCHY}MOTION\nFrames: {n_frames}\n"
            f"Frame Time: 0.008333\n{rows}\n")


def phase_data_pipeline(device):
    """create_humanoid, then convert_clip on the card, in a scratch
    directory, on two seeded takes of BVH_HIERARCHY (4 s at 120 Hz each):
    the generated model parses, the trajectories are finite (T, nq) with
    unit root quaternions and within 1e-12 of convert_clip --device cpu."""
    import io
    from egopose_tpu_torch.cli import convert_clip, create_humanoid
    from egopose_tpu_torch.physics.spec import parse_mjcf
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("datasets/traj")
            for i, take in enumerate(("take_01", "take_02")):
                with open(f"datasets/traj/0000_{take}.bvh", "w") as f:
                    f.write(seeded_bvh(481, i))
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                xml = create_humanoid.main(["--mocap-id", "0000",
                                            "--out-id", "humanoid_0000"])
                t_xml = time.time() - t0
                t0 = time.time()
                card = convert_clip.main(["--model-id", "humanoid_0000",
                                          "--mocap-id", "0000",
                                          "--device", str(device)])
                t_card = time.time() - t0
                cpu = convert_clip.main(["--model-id", "humanoid_0000",
                                         "--mocap-id", "0000",
                                         "--device", "cpu"])
            spec = parse_mjcf(xml)
        finally:
            os.chdir(cwd)
    trajs = list(card.values())
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in card)
    unit = max(float(np.abs(np.linalg.norm(q[:, 3:7], axis=1) - 1).max())
               for q in trajs)
    finite = bool(all(np.isfinite(q).all() for q in trajs))
    rec = dict(takes=len(trajs), shape=list(trajs[0].shape), nq=spec.nq,
               nbody=spec.nbody, finite=finite, max_abs_err_vs_cpu=err,
               root_quat_norm_err=unit, create_humanoid_s=t_xml,
               convert_clip_s=t_card)
    ok = bool(finite and len(trajs) == 2 and err <= 1e-12 and unit <= 1e-12
              and all(q.shape == (121, spec.nq) for q in trajs))
    emit("data_pipeline", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"data_pipeline out of bounds: {rec}")
    return rec


# Takes of phase gen_expert: 8 x 3,600 frames (two minutes at 30 Hz each),
# at the full width of humanoid_1205_v1 (nq 59): a size chosen for this
# run, not the EgoPose dataset's.
GEN_EXPERT_TAKES, GEN_EXPERT_LEN = 8, 3600
GEN_EXPERT_TOL = 1e-9         # max-abs of every field, card against CPU f64


def expert_workdir_files(spec):
    """Write into the working directory the seeded takes of phase
    gen_expert (datasets/traj/<take>_traj.p: a root walking and turning,
    hinges moving within their ranges, as envs.synthetic_experts draws
    them), their meta (6 train, 2 test, video_mocap_sync [0, 2, T-4]),
    64-wide CNN features and an ego-mimic config that reads both files."""
    import pickle
    import yaml
    rng = np.random.RandomState(11)
    n_t = GEN_EXPERT_LEN
    t = np.arange(n_t) / 30.0
    takes = ["syn_%02d" % i for i in range(GEN_EXPERT_TAKES)]
    for d in ("datasets/traj", "datasets/meta", "datasets/features",
              "config/egomimic"):
        os.makedirs(d)
    lo = np.clip(spec.jnt_range[:, 0], -0.6, 0.0)
    hi = np.clip(spec.jnt_range[:, 1], 0.0, 0.6)
    for take in takes:
        heading = 0.8 * np.sin(2 * np.pi * 0.01 * t + rng.uniform(0, 6))
        q = np.zeros((n_t, spec.nq))
        q[:, 0] = np.cumsum(np.cos(heading)) / 30.0
        q[:, 1] = np.cumsum(np.sin(heading)) / 30.0
        q[:, 2] = 0.92 + 0.02 * np.sin(2 * np.pi * t)
        q[:, 3], q[:, 6] = np.cos(heading / 2), np.sin(heading / 2)
        amp = 0.25 * (hi - lo) * rng.uniform(0.2, 1.0, spec.nq - 7)
        q[:, 7:] = 0.5 * (lo + hi) + amp * np.sin(
            2 * np.pi * rng.uniform(0.2, 0.7, spec.nq - 7) * t[:, None]
            + rng.uniform(0, 2 * np.pi, spec.nq - 7))
        with open(f"datasets/traj/{take}_traj.p", "wb") as f:
            pickle.dump(q, f)
    meta = {"train": takes[:6], "test": takes[6:], "capture": {"fps": 30},
            "video_mocap_sync": {k: [0, 2, n_t - 4] for k in takes}}
    with open("datasets/meta/gen_expert_syn.yml", "w") as f:
        yaml.safe_dump(meta, f)
    with open("datasets/features/cnn_feat_gen_expert_syn.p", "wb") as f:
        pickle.dump(({k: rng.randn(n_t - 6, 64).astype(np.float32)
                      for k in takes}, None), f)
    em = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                          "subject_03.yml")))
    em.update(meta_id="gen_expert_syn", expert_feat="card",
              cnn_feat="gen_expert_syn")
    em.pop("state_net_cfg", None)
    with open("config/egomimic/gen_expert_syn.yml", "w") as f:
        yaml.safe_dump(em, f)
    return takes


def phase_gen_expert(device):
    """gen_expert --meta-id gen_expert_syn on the card (float64) over
    GEN_EXPERT_TAKES seeded takes of GEN_EXPERT_LEN frames, in a scratch
    directory: one K5 launch a take and no other kernel; every field of
    every take within GEN_EXPERT_TOL of gen_expert --device cpu; the
    written file loads through the non-synthetic build_world on the card.
    frames/s (every frame replayed, over the CLI's wall time), and K5's
    time and bound at B=GEN_EXPERT_LEN in float64."""
    import io
    import torch
    from egopose_tpu_torch.cli import gen_expert
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.physics import fk
    from egopose_tpu_torch.physics.model import build_model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    spec = parse_mjcf(os.path.join(REPO, "assets", "mujoco_models",
                                   "humanoid_1205_v1.xml"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            takes = expert_workdir_files(spec)
            argv = ["--meta-id", "gen_expert_syn", "--model-xml",
                    "humanoid_1205_v1"]
            with contextlib.redirect_stdout(io.StringIO()):
                reset_counts()
                t0 = time.time()
                card = gen_expert.main(argv + ["--out-id", "card",
                                               "--device", str(device)])
                torch.cuda.synchronize()
                wall = time.time() - t0
                counts = read_counts()
                t0 = time.time()
                cpu = gen_expert.main(argv + ["--out-id", "cpu", "--device",
                                              "cpu"])
                cpu_s = time.time() - t0
            world = build_world(EgoMimicConfig("gen_expert_syn"),
                                torch.float32, device)
        finally:
            os.chdir(cwd)
    errs = {key: max(float(np.abs(np.asarray(card[t][key])
                                  - np.asarray(cpu[t][key])).max())
                     for t in takes)
            for key in cpu[takes[0]] if key != "len"}
    same = list(card) == list(cpu) == takes and all(
        card[t]["len"] == cpu[t]["len"] == GEN_EXPERT_LEN - 6
        and sorted(card[t]) == sorted(cpu[t]) for t in takes)
    expert = world[4]
    loaded = tuple(expert.qpos.shape) == (6, GEN_EXPERT_LEN - 6, spec.nq) \
        and bool(torch.isfinite(expert.obs).all())
    m = build_model(spec, dtype=torch.float64, device=device)
    q = torch.as_tensor(card[takes[0]]["qpos"], device=device)
    # the file's cut take plus its last 6 frames again: B = GEN_EXPERT_LEN,
    # the batch of one take's replay
    q = torch.cat([q, q[-6:]])
    k5 = dict(B=int(q.shape[0]), dtype="float64",
              ms=time_ms(lambda: fk.fk_cuda(m, q)),
              device_ms=device_ms(lambda: fk.fk_cuda(m, q),
                                  KERNEL_KEYS["k5"]),
              **bound(*k5_work(m, q.shape[0], 8), H100_F64_FLOPS))
    others = {k: v for k, v in counts.items() if k != "k5"}
    frames = GEN_EXPERT_TAKES * GEN_EXPERT_LEN
    rec = dict(takes=GEN_EXPERT_TAKES, frames_per_take=GEN_EXPERT_LEN,
               k5_launches=counts["k5"], other_launches=others,
               wall_s=wall, frames_per_sec=frames / wall, cpu_f64_s=cpu_s,
               cpu_frames_per_sec=frames / cpu_s, max_abs_err=errs,
               tol=GEN_EXPERT_TOL, same_takes_and_fields=same,
               build_world_loads=loaded, k5=k5)
    ok = bool(counts["k5"] == GEN_EXPERT_TAKES and not any(others.values())
              and max(errs.values()) <= GEN_EXPERT_TOL and same and loaded)
    emit("gen_expert", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"gen_expert out of bounds: {rec}")
    return rec


# K5 launches of each synthetic world built on the card (one a take: its
# experts' replay), recorded by count_world_builds
WORLD_K5 = []


def count_world_builds():
    """Wrap cli/ego_mimic.py's build_world, through which every CLI and
    phase builds its world: a synthetic world built on the card must have
    launched K5 once a take (its experts' replay, envs/expert.py), any
    other world no kernel; those launches go to WORLD_K5 and every count
    is zeroed after the build, so a phase's counts, zeroed before it
    starts, read only its own path past its world."""
    from egopose_tpu_torch.cli import ego_mimic
    build = ego_mimic.build_world

    def counted(cfg, dtype, device, *args, **kw):
        before = read_counts()
        out = build(cfg, dtype, device, *args, **kw)
        after = read_counts()
        n = {k: after[k] - before[k] for k in after}
        synthetic = kw.get("synthetic", args[0] if args else False)
        on_card = str(device).startswith("cuda")
        want = int(out[4].qpos.shape[0]) if synthetic and on_card else 0
        if n["k5"] != want or any(v for k, v in n.items() if k != "k5"):
            raise AssertionError(
                f"build_world launched {n}, expected {want} K5 launches")
        WORLD_K5.append(n["k5"])
        if on_card:
            reset_counts()
        return out

    ego_mimic.build_world = counted


def reset_counts():
    """Zero the launch count of every kernel."""
    from egopose_tpu_torch.physics import fk, linalg, substep
    substep.reset_launches()
    linalg.reset_launches()
    fk.reset_launches()


def read_counts():
    from egopose_tpu_torch.physics import fk, linalg, substep
    return dict(k1=substep.launches, k1_dense=substep.dense_launches,
                k2=linalg.launches,
                k3=linalg.fused_contact_launches,
                k4=linalg.pd_fused_launches, k5=fk.launches)


def step_bars(dtype, dq, dv):
    """f64: max-abs qpos <= 1e-9, qvel <= 1e-8; f32: RMS qpos <= 1e-6,
    qvel <= 1e-4 (K1's bar)."""
    import torch
    rec = dict(max_abs_qpos=float(dq.abs().max()),
               max_abs_qvel=float(dv.abs().max()),
               rms_qpos=float(dq.pow(2).mean().sqrt()),
               rms_qvel=float(dv.pow(2).mean().sqrt()))
    if dtype == torch.float64:
        ok = rec["max_abs_qpos"] <= 1e-9 and rec["max_abs_qvel"] <= 1e-8
    else:
        ok = rec["rms_qpos"] <= 1e-6 and rec["rms_qvel"] <= 1e-4
    return ok, rec


def add_counts(total, counts):
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n
    return total


def hold_against_cpu(dtype, out, step, args):
    """(ok, record) of a card step's (qpos, qvel) ``out`` against
    ``step(m, *args)`` on a CPU copy of the inputs in f64.  f64: the step
    bars.  f32: the card's error against that f64 step is at most 4x the
    error of the same f32 step on the CPU (K2's rule)."""
    import torch
    cpu = lambda dt: [x.cpu().to(dt) for x in args]
    q64, v64 = step(load_world(torch.float64, "cpu")[1], *cpu(torch.float64))
    dq, dv = out[0].cpu().double() - q64, out[1].cpu().double() - v64
    ok, rec = step_bars(dtype, dq, dv)
    if dtype == torch.float32:
        qc, vc = step(load_world(dtype, "cpu")[1], *cpu(dtype))
        rec.update(cpu_f32_max_abs_qpos=float((qc.double() - q64).abs()
                                              .max()),
                   cpu_f32_max_abs_qvel=float((vc.double() - v64).abs()
                                              .max()))
        ok = rec["max_abs_qpos"] <= 4 * rec["cpu_f32_max_abs_qpos"] \
            and rec["max_abs_qvel"] <= 4 * rec["cpu_f32_max_abs_qvel"]
    return ok, rec


def phase_pd_fused_step(device):
    """engine.pd_control_step with pd_fused (K4) on the card against the
    split path at R=1 on the card, one control step at B=64.  Returns the
    launch counts of the K4 runs."""
    import torch
    from egopose_tpu_torch.physics import engine
    fused = engine.DEFAULT_CONTACT._replace(substep_resident=False,
                                            pd_fused=True)
    split = engine.DEFAULT_CONTACT._replace(substep_resident=False,
                                            prep_refresh=1)
    total = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, gains = load_world(dtype, device)
        q, v, ctrl = contact_states(spec, m, 64, 80, dtype, device)
        reset_counts()
        qk, vk = engine.pd_control_step(m, q, v, ctrl, *gains, N_FRAMES,
                                        fused)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(total, counts)
        qp, vp = engine.pd_control_step_split(m, q, v, ctrl, *gains,
                                              N_FRAMES, split)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(qk).all() and torch.isfinite(vk).all())
        ok, rec = step_bars(dtype, (qk - qp).double(), (vk - vp).double())
        ok = ok and finite and counts["k4"] == N_FRAMES and counts["k1"] == 0
        emit("pd_fused_step", ok=ok, dtype=str(dtype).split(".")[1], B=64,
             finite=finite, launches=counts, **rec)
        if not ok:
            raise AssertionError(f"pd_fused step out of bounds: {rec} "
                                 f"{counts}")
    return total


def phase_fused_solver_step(device):
    """torque_control_step with fused_solver (K3) on the card against the
    same step on a CPU copy of the inputs (hold_against_cpu), one control
    step at B=64.  The f32 bar is K2's rule, not K1's RMS bar: held torques
    of up to 1.5x the limits make the step amplify rounding, so two f32
    runs on two devices already differ by ~1e-3 in qvel.  Returns the
    launch counts."""
    import torch
    from egopose_tpu_torch.physics import engine
    params = engine.DEFAULT_CONTACT._replace(fused_solver=True)
    step = lambda mc, *a: engine.torque_control_step(mc, *a, N_FRAMES, params)
    total = {}
    for dtype in (torch.float64, torch.float32):
        spec, m, gains = load_world(dtype, device)
        q, v, _ = contact_states(spec, m, 64, 81, dtype, device)
        tl = gains[2]
        tau = torch.tensor(np.random.RandomState(82).uniform(
            -1.5, 1.5, (64, spec.nu)), dtype=dtype, device=device) * tl
        reset_counts()
        qk, vk = engine.torque_control_step(m, q, v, tau, tl, N_FRAMES,
                                            params)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(total, counts)
        finite = bool(torch.isfinite(qk).all() and torch.isfinite(vk).all())
        ok, rec = hold_against_cpu(dtype, (qk, vk), step, (q, v, tau, tl))
        ok = ok and finite and counts["k3"] == N_FRAMES and counts["k2"] == 0
        emit("fused_solver_step", ok=ok, dtype=str(dtype).split(".")[1], B=64,
             finite=finite, launches=counts, **rec)
        if not ok:
            raise AssertionError(f"fused_solver step out of bounds: {rec} "
                                 f"{counts}")
    return total


def phase_split_step(device):
    """engine.pd_control_step on the card with substep_resident and pd_fused
    off: the split path with its SPD solves through K2, at R=3 and with
    fused_solver (R=1, each substep's dynamics solve and sweep through K3
    and its FK through K5); one control step at B=64 against the same step
    on a CPU copy of the inputs (hold_against_cpu).  Returns the launch
    counts."""
    import torch
    from egopose_tpu_torch.physics import engine
    base = engine.DEFAULT_CONTACT._replace(substep_resident=False)
    variants = (
        ("split", base, dict(k2=2 * N_FRAMES)),
        ("fused_solver", base._replace(fused_solver=True),
         dict(k2=N_FRAMES, k3=N_FRAMES, k5=N_FRAMES)))
    total = {}
    for name, params, want in variants:
        step = lambda mc, *a, p=params: engine.pd_control_step(
            mc, *a, N_FRAMES, p)
        for dtype in (torch.float64, torch.float32):
            spec, m, gains = load_world(dtype, device)
            q, v, ctrl = contact_states(spec, m, 64, 83, dtype, device)
            reset_counts()
            qk, vk = step(m, q, v, ctrl, *gains)
            torch.cuda.synchronize()
            counts = read_counts()
            add_counts(total, counts)
            finite = bool(torch.isfinite(qk).all()
                          and torch.isfinite(vk).all())
            ok, rec = hold_against_cpu(dtype, (qk, vk), step,
                                       (q, v, ctrl, *gains))
            ok = ok and finite and all(counts[key] == want.get(key, 0)
                                       for key in counts)
            r = 1 if params.fused_solver else params.prep_refresh
            emit("split_step", ok=ok, variant=name, R=r,
                 dtype=str(dtype).split(".")[1], B=64, finite=finite,
                 launches=counts, want_launches=want, **rec)
            if not ok:
                raise AssertionError(f"split step ({name}) out of bounds: "
                                     f"{rec} {counts}")
    return total


# ---------------------------------------------------------------------------
# training: the ego_mimic CLI in position and in torque mode
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def train_workdir(**overrides):
    """A scratch working directory for the training CLI, with a copy of
    config/egomimic/subject_03.yml whose keys ``overrides`` replaces."""
    import yaml
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                               "subject_03.yml")))
        cfg.update(overrides)
        os.makedirs(os.path.join(tmp, "config", "egomimic"))
        with open(os.path.join(tmp, "config", "egomimic", "subject_03.yml"),
                  "w") as f:
            yaml.safe_dump(cfg, f)
        os.chdir(tmp)
        try:
            yield cfg
        finally:
            os.chdir(cwd)


def run_train(device, args):
    """ego_mimic.main on the card with both launch counts zeroed just
    before; returns (agent, per-iteration records, K1 and K2 launches,
    wall seconds)."""
    import torch
    from egopose_tpu_torch.cli import ego_mimic
    from egopose_tpu_torch.physics import linalg, substep
    iters = []
    hook = lambda i, log, metrics, t_update: iters.append(dict(
        iter=i, T_sample=log.sample_time, T_update=t_update,
        env_steps=log.num_steps,
        env_steps_per_s=log.num_steps / log.sample_time,
        R_avg=log.avg_c_reward, R_min=log.min_c_reward,
        R_max=log.max_c_reward, R_info=[float(x) for x in log.avg_c_info],
        eps_len_avg=log.avg_episode_len, **metrics))
    reset_counts()
    t0 = time.time()
    agent = ego_mimic.main(["--cfg", "subject_03", "--synthetic",
                            "--device", str(device)] + args, iter_hook=hook)
    torch.cuda.synchronize()
    return agent, iters, substep.launches, linalg.launches, time.time() - t0


@contextlib.contextmanager
def k6_in_update():
    """K6's launches inside each AgentEgo.update_params call (the forecast
    agent's too), appended to the list it yields."""
    from egopose_tpu_torch.ops import lstm
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    update, counts = AgentEgo.update_params, []

    def counted(self, batch):
        before = lstm.launches
        out = update(self, batch)
        counts.append(lstm.launches - before)
        return out
    AgentEgo.update_params = counted
    try:
        yield counts
    finally:
        AgentEgo.update_params = update


def train_finite(iters):
    keys = ("T_sample", "T_update", "R_avg", "R_min", "R_max",
            "policy_loss", "value_loss")
    return bool(all(np.isfinite([it[k] for k in keys]).all()
                    and np.isfinite(it["R_info"]).all() for it in iters))


def phase_train(device):
    """Position-mode PPO at the shipped widths: every control step is one
    K1 launch over the 1024 lanes."""
    import torch
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    lanes, n_iter = 1024, 1
    with train_workdir(save_model_interval=1) as cfg, \
            k6_in_update() as k6:
        agent, iters, k1, k2, wall = run_train(
            device, ["--batch-lanes", str(lanes), "--max-iter", str(n_iter)])
        n_seg = -(-cfg["min_batch_size"] // (lanes * cfg["env_episode_len"]))
        steps = n_iter * n_seg * cfg["env_episode_len"]
        path = os.path.join("results", "egomimic", "subject_03", "models",
                            "iter_0001.p")
        saved = os.path.exists(path)
        same = False
        if saved:
            back = AgentEgo(agent.model, agent.spec, agent.p, agent.tables,
                            agent.expert, agent.cnn_feat.cpu().numpy(),
                            agent.cfg, batch_lanes=lanes, seed=99,
                            dtype=agent.dtype, device=device)
            back.load(path)
            same = all(torch.equal(x, y) for n1, n2 in zip(agent.nets,
                                                           back.nets)
                       for x, y in zip(n1.state_dict().values(),
                                       n2.state_dict().values())) \
                and all(torch.equal(x, y) for x, y in zip(agent.zstat,
                                                          back.zstat))
    # rewards: the per-step imitation reward and its components lie in
    # (0, 1]; from iteration 2 on an episode's last step also carries the
    # end-of-episode bonus (avg reward * gamma / (1 - gamma)), so R_avg and
    # R_max are bounded by 1 only in the first iteration
    rewards_ok = all(0 < it["R_min"] and all(0 < x <= 1 for x in it["R_info"])
                     for it in iters) \
        and iters[0]["R_avg"] <= 1 and iters[0]["R_max"] <= 1
    rec = dict(lanes=lanes, iters=iters, control_steps=steps, k1_launches=k1,
               k2_launches=k2, k6_update_launches=k6, wall_s=wall,
               checkpoint_written=saved, checkpoint_reloads_equal=same)
    ok = bool(k1 == steps and k2 == 0 and k6 and min(k6) > 0
              and train_finite(iters) and rewards_ok and saved and same)
    emit("train", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train out of bounds: {rec}")
    return rec


def phase_train_torque(device):
    """Torque-mode PPO (action_type: torque): every control step is 15
    substeps of step_raw, each one K2 launch over the 1024 lanes; the
    episode cut to 20 steps and the iteration to one segment of them
    (--min-batch 20480; PR 9 cut it from the shipped min batch's 3
    segments to make room for the statereg phases)."""
    lanes, ep_len = 1024, 20
    with train_workdir(action_type="torque"):
        _, iters, k1, k2, wall = run_train(
            device, ["--batch-lanes", str(lanes), "--episode-len",
                     str(ep_len), "--min-batch", str(lanes * ep_len),
                     "--max-iter", "1"])
    steps = ep_len
    rec = dict(lanes=lanes, episode_len=ep_len, iters=iters,
               control_steps=steps, k1_launches=k1, k2_launches=k2,
               wall_s=wall)
    ok = bool(k2 == N_FRAMES * steps and k1 == 0 and train_finite(iters))
    emit("train_torque", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train_torque out of bounds: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the slice's path: rollouts with the fused solver options at full width
# ---------------------------------------------------------------------------

def run_rollout(device, contact, **overrides):
    """AgentEgo.sample on the synthetic subject_03 world (1024 lanes, f32)
    with the ContactParams fields ``contact`` replaced, one segment cut to
    ROLLOUT_STEPS control steps, with every launch count zeroed just before
    it; then one PPO update.  Returns (record, launch counts, ok)."""
    import dataclasses
    import torch
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    lanes = ROLLOUT_LANES
    cfg = EgoMimicConfig("subject_03", config_root=os.path.join(REPO,
                                                                "config"))
    cfg.env_episode_len = ROLLOUT_STEPS
    for key, val in overrides.items():
        setattr(cfg, key, val)
    spec, model, tables, p, expert, cnn_feat = build_world(
        cfg, torch.float32, device, synthetic=True)
    p = dataclasses.replace(p, contact=p.contact._replace(**contact))
    agent = AgentEgo(model, spec, p, tables, expert, cnn_feat, cfg,
                     batch_lanes=lanes, seed=cfg.seed, dtype=torch.float32,
                     device=device)
    cfg.update_adaptive_params(0)
    agent.set_noise_rate(cfg.adp_noise_rate)
    if cfg.fix_std:
        agent.fill_log_std(cfg.adp_log_std)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    reset_counts()
    batch, log = agent.sample(generator, lanes * ROLLOUT_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    t0 = time.time()
    metrics = agent.update_params(batch)
    t_update = time.time() - t0
    info = [float(x) for x in log.avg_c_info]
    finite = bool(np.isfinite([log.avg_c_reward, log.min_c_reward,
                               log.max_c_reward, metrics["policy_loss"],
                               metrics["value_loss"]]).all()
                  and np.isfinite(info).all())
    rec = dict(lanes=lanes, control_steps=ROLLOUT_STEPS,
               env_steps=log.num_steps, T_sample=log.sample_time,
               env_steps_per_s=log.num_steps / log.sample_time,
               T_update=t_update, R_avg=log.avg_c_reward,
               R_min=log.min_c_reward, R_max=log.max_c_reward, R_info=info,
               policy_loss=metrics["policy_loss"],
               value_loss=metrics["value_loss"], launches=counts,
               finite=finite)
    rewards_ok = 0 < log.min_c_reward and log.max_c_reward <= 1 \
        and all(0 < x <= 1 for x in info)
    return rec, counts, finite and rewards_ok


def phase_rollout_pd_fused(device):
    """Position mode with pd_fused: every control step is 15 K4 launches
    (each substep's FK through K5)."""
    rec, n, ok = run_rollout(device, dict(substep_resident=False,
                                          pd_fused=True))
    ok = bool(ok and n["k4"] == N_FRAMES * ROLLOUT_STEPS and n["k1"] == 0
              and n["k1_dense"] == 0 and n["k2"] == 0 and n["k3"] == 0)
    emit("rollout_pd_fused", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"rollout_pd_fused out of bounds: {rec}")
    return rec


def phase_rollout_torque_fused(device):
    """Torque mode with fused_solver: every control step is 15 K3 launches
    (each substep's FK through K5)."""
    rec, n, ok = run_rollout(device, dict(substep_resident=False,
                                          fused_solver=True),
                             action_type="torque")
    ok = bool(ok and n["k3"] == N_FRAMES * ROLLOUT_STEPS and n["k2"] == 0
              and n["k1"] == 0 and n["k1_dense"] == 0 and n["k4"] == 0)
    emit("rollout_torque_fused", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"rollout_torque_fused out of bounds: {rec}")
    return rec


def phase_rollout_dense(device):
    """Position mode through K1's dense branch, the JAX package's own way
    to reach it (the env params' contact with sparse_ldl=False; no config
    key sets it): every control step is one launch of the dense branch,
    no other kernel runs."""
    rec, n, ok = run_rollout(device, DENSE)
    ok = bool(ok and n["k1_dense"] == ROLLOUT_STEPS and n["k1"] == 0
              and n["k2"] == 0 and n["k3"] == 0 and n["k4"] == 0
              and n["k5"] == 0)
    emit("rollout_dense", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"rollout_dense out of bounds: {rec}")
    return rec


# ---------------------------------------------------------------------------
# ego-forecast: training, the sliding-window eval and its horizon metrics
# ---------------------------------------------------------------------------

FORECAST = "subject_03_syn"
FORECAST_ITERS = 2


@contextlib.contextmanager
def forecast_workdir():
    """A scratch working directory for the forecast CLIs: a copy of
    config/egoforecast/subject_03_syn.yml that saves a checkpoint every
    FORECAST_ITERS iterations, config/egomimic and the committed mimic
    models (the warm start's iter_3000.p) linked in."""
    import yaml
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = yaml.safe_load(open(os.path.join(
            REPO, "config", "egoforecast", FORECAST + ".yml")))
        cfg["save_model_interval"] = FORECAST_ITERS
        os.makedirs(os.path.join(tmp, "config", "egoforecast"))
        with open(os.path.join(tmp, "config", "egoforecast",
                               FORECAST + ".yml"), "w") as f:
            yaml.safe_dump(cfg, f)
        os.symlink(os.path.join(REPO, "config", "egomimic"),
                   os.path.join(tmp, "config", "egomimic"))
        mimic = os.path.join(tmp, "results", "egomimic", "subject_03")
        os.makedirs(mimic)
        os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                                "models"), os.path.join(mimic, "models"))
        os.chdir(tmp)
        try:
            yield cfg
        finally:
            os.chdir(cwd)


def phase_forecast_train(device, cfg):
    """ego_forecast --cfg subject_03_syn --synthetic at the shipped widths
    (1024 lanes, episodes of 90 steps, min batch 50000: one segment of
    92,160 env steps per iteration, 10 PPO epochs) for FORECAST_ITERS
    iterations, warm-started from the committed ego-mimic iter_3000.p:
    every control step is one K1 launch over the 1024 lanes."""
    import torch
    from egopose_tpu_torch.cli import ego_forecast
    from egopose_tpu_torch.convert import load_checkpoint_pickle, \
        params_to_jax
    from egopose_tpu_torch.physics import substep
    from egopose_tpu_torch.rl.agent_forecast import AgentForecast
    lanes = 1024
    args = ["--cfg", FORECAST, "--synthetic", "--device", str(device),
            "--batch-lanes", str(lanes)]
    # the warm start alone (no iteration): the copied leaves are the
    # mimic checkpoint's
    warm = ego_forecast.main(args + ["--max-iter", "0"])
    mimic = load_checkpoint_pickle(os.path.join(
        "results", "egomimic", "subject_03", "models", "iter_3000.p"))
    pol, _, val, _ = params_to_jax(*[n.state_dict() for n in warm.nets])
    warm_ok = True
    for mine, theirs in ((pol, mimic["policy_dict"]),
                         (val, mimic["value_dict"])):
        for key in ("Dense_0", "Dense_1"):
            a, b = mine["params"]["net"][key], theirs["params"]["net"][key]
            warm_ok &= bool(np.array_equal(a["bias"], b["bias"]))
            warm_ok &= (key == "Dense_0") != bool(
                a["kernel"].shape == b["kernel"].shape
                and np.array_equal(a["kernel"], b["kernel"]))
    warm_ok &= bool(np.array_equal(
        pol["params"]["action_mean"]["kernel"],
        mimic["policy_dict"]["params"]["action_mean"]["kernel"]))
    del warm

    iters = []
    hook = lambda i, log, metrics, t_update: iters.append(dict(
        iter=i, T_sample=log.sample_time, T_update=t_update,
        env_steps=log.num_steps,
        env_steps_per_s=log.num_steps / log.sample_time,
        R_avg=log.avg_c_reward, R_min=log.min_c_reward,
        R_max=log.max_c_reward, R_info=[float(x) for x in log.avg_c_info],
        eps_len_avg=log.avg_episode_len, **metrics))
    reset_counts()
    t0 = time.time()
    with k6_in_update() as k6:
        agent = ego_forecast.main(args + ["--max-iter", str(FORECAST_ITERS)],
                                  iter_hook=hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    n_seg = -(-cfg["min_batch_size"] // (lanes * cfg["env_episode_len"]))
    steps = FORECAST_ITERS * n_seg * cfg["env_episode_len"]
    path = os.path.join("results", "egoforecast", FORECAST, "models",
                        "iter_%04d.p" % FORECAST_ITERS)
    saved = os.path.exists(path)
    same = False
    if saved:
        back = AgentForecast(agent.model, agent.spec, agent.p, agent.tables,
                             agent.expert, agent.cnn_feat.cpu().numpy(),
                             agent.cfg, batch_lanes=lanes, seed=99,
                             dtype=agent.dtype, device=device)
        back.load(path)
        same = all(torch.equal(x, y) for n1, n2 in zip(agent.nets,
                                                       back.nets)
                   for x, y in zip(n1.state_dict().values(),
                                   n2.state_dict().values())) \
            and all(torch.equal(x, y) for x, y in zip(agent.zstat,
                                                      back.zstat))
    # the config decays the reward over the episode (reward_weights.decay)
    # and gives no end bonus, so rewards lie in [0, 1]; the components in
    # (0, 1]
    rewards_ok = all(0 <= it["R_min"] and it["R_max"] <= 1
                     and 0 < it["R_avg"]
                     and all(0 < x <= 1 for x in it["R_info"])
                     for it in iters)
    others = {k: v for k, v in counts.items() if k != "k1"}
    rec = dict(lanes=lanes, episode_len=cfg["env_episode_len"],
               iters=iters, control_steps=steps, k1_launches=counts["k1"],
               other_launches=others, k6_update_launches=k6, wall_s=wall,
               warm_start_verified=warm_ok, checkpoint_written=saved,
               checkpoint_reloads_equal=same)
    ok = bool(counts["k1"] == steps and not any(others.values())
              and k6 and min(k6) > 0
              and train_finite(iters) and rewards_ok and warm_ok and saved
              and same)
    emit("forecast_train", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"forecast_train out of bounds: {rec}")
    return rec


def first_step_hook(out):
    """A forecast eval step hook that keeps the first control step's
    inputs (qpos, qvel, action) and output (qpos, qvel)."""
    def hook(t, st, action, new_st):
        if t == 0:
            out.extend([st.qpos, st.qvel, action, new_st.qpos, new_st.qvel])
    return hook


def run_forecast_eval(device, extra=(), f64=False):
    """ego_forecast_eval on the FORECAST_ITERS checkpoint, the launch
    counts zeroed just before; returns (results, meta, first step, launch
    counts)."""
    import torch
    from egopose_tpu_torch.cli import ego_forecast_eval
    first = []
    reset_counts()
    results, meta = ego_forecast_eval.main(
        ["--cfg", FORECAST, "--synthetic", "--iter", str(FORECAST_ITERS),
         "--device", str(device)] + (["--f64"] if f64 else []) + list(extra),
        step_hook=first_step_hook(first))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return results, meta, first, read_counts()


def step_inputs(first, cfg, dtype, device):
    """(model, qpos, qvel, ctrl, jkp, jkd, torque_lim) of an eval's first
    control step (``first``: its qpos, qvel and action, then the step's
    output) in ``dtype`` on ``device``, with the gains of ``cfg``."""
    import torch
    q, v, action = [x.to(device=device, dtype=dtype) for x in first[:3]]
    lane = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=dtype).expand(q.shape[0], -1).contiguous()
    ctrl = lane(cfg.a_ref) + action * lane(cfg.a_scale)
    return (load_world(dtype, device)[1], q, v, ctrl, lane(cfg.jkp),
            lane(cfg.jkd), lane(cfg.torque_lim))


def forecast_step_inputs(first, dtype, device):
    """step_inputs with the forecast config's gains."""
    from egopose_tpu_torch.utils.config import EgoForecastConfig
    return step_inputs(first, EgoForecastConfig(FORECAST), dtype, device)


def first_step_vs_plain(first, inputs=forecast_step_inputs):
    """(ok, record) of the card's first control step of an eval (K1 over
    every lane) against the plain split path on the CPU from the same
    qpos, qvel and action, in f64 (K1's f32 RMS bar: qpos <= 1e-6, qvel
    <= 1e-4); ``inputs(first, dtype, device)`` builds the step's inputs.
    Where it misses and the plain f32 step misses too against the f64
    one, the card is held to the bar against the plain f32 step
    (decided_by)."""
    import torch
    from egopose_tpu_torch.physics import engine
    qk, vk = [x.cpu() for x in first[3:]]

    def plain(dtype):
        return engine.pd_control_step_split(
            *inputs(first, dtype, "cpu"), N_FRAMES, engine.DEFAULT_CONTACT)
    ref = plain(torch.float64)
    ok, rec = k1_bars(torch.float32, (qk, vk), ref)
    rec["decided_by"] = "plain_f64"
    if not ok:
        p32 = plain(torch.float32)
        p32_ok, rec["plain_f32_vs_f64"] = k1_bars(torch.float32, p32, ref)
        if not p32_ok:
            ok, rec["vs_plain_f32"] = k1_bars(torch.float32, (qk, vk), p32)
            rec["decided_by"] = "plain_f32"
    return ok, rec


def horizon_pose_dist(results, margin, horizon=30):
    """eval_forecast's pose dist at ``horizon`` (hands zeroed as its
    stats mode does), on a copy of ``results``."""
    from egopose_tpu_torch.cli.eval_forecast import compute_metrics
    from egopose_tpu_torch.utils.tools import remove_noisy_hands
    res = {k: {t: a.copy() for t, a in v.items()} for k, v in results.items()}
    remove_noisy_hands(res)
    return compute_metrics(res, "forecast", horizon, margin,
                           verbose=False)[0]


def horizon_band(results, ref, margin):
    """(ok, record): horizon-30 pose dist of ``results`` within 5% of
    ``ref``'s, the cross-engine band of tests/test_cross_engine.py."""
    got, want = horizon_pose_dist(results, margin), \
        horizon_pose_dist(ref, margin)
    rel = abs(got - want) / want
    return rel <= 0.05, dict(horizon30_pose_dist=got, ref=want, rel=rel)


def phase_forecast_eval(device, cfg, em_results=None):
    """ego_forecast_eval on forecast_train's checkpoint, every window of
    the 4 synthetic takes one lane of one batch (one K1 launch per control
    step over all windows), initialised from the eval phase's estimation
    results (ego_mimic_eval runs here when that phase did not), then with
    --gt-init.  The card's f32 em-init run is held against the port's own
    CPU f64 run of the same windows and checkpoint: its first control step
    (first_step_vs_plain) and its horizon-30 pose dist within 5%; where
    the card misses that band and the CPU f32 run misses it too against
    the f64 run, the card is held to the band against the CPU f32 run,
    and the record says which decided."""
    import pickle
    import torch
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.physics import engine, substep
    em_path = os.path.join("results", "egomimic", "subject_03", "results",
                           "iter_3000_test.p")
    if em_results is None:
        ego_mimic_eval.main(EVAL_ARGS + ["--device", str(device)])
    else:
        os.makedirs(os.path.dirname(em_path), exist_ok=True)
        with open(em_path, "wb") as f:
            pickle.dump(em_results, f)
    steps, margin = cfg["env_episode_len"], cfg["fr_margin"]
    res_path = os.path.join("results", "egoforecast", FORECAST, "results",
                            "iter_%04d_test.p" % FORECAST_ITERS)
    cpu = torch.device("cpu")
    t0 = time.time()
    ref = run_forecast_eval(cpu, f64=True)[0]
    cpu_s = time.time() - t0
    runs, ok = {}, True
    for mode, extra in (("em_init", ()), ("gt_init", ("--gt-init",))):
        results, meta, first, counts = run_forecast_eval(device, extra)
        finite = bool(all(np.isfinite(a).all()
                          for a in results["traj_pred"].values()))
        others = {k: v for k, v in counts.items() if k != "k1"}
        step_ok, step_rec = first_step_vs_plain(first)
        rec = dict(windows=meta["n_windows"], control_steps=steps,
                   k1_launches=counts["k1"], other_launches=others,
                   wall_s=meta["wall_s"],
                   frames_per_sec=meta["frames_per_sec"],
                   num_fail=meta["num_fail"], finite=finite,
                   first_step=step_rec)
        good = counts["k1"] == steps and not any(others.values()) \
            and finite and step_ok
        if mode == "em_init":
            # K1 alone on this step's inputs: its share of a control step
            k1 = device_ms(lambda: substep.pd_control_step_cuda(
                *forecast_step_inputs(first, torch.float32, device),
                N_FRAMES, engine.DEFAULT_CONTACT), KERNEL_KEYS["k1"])
            rec.update(k1_device_ms=k1, step_ms=meta["wall_s"] * 1e3 / steps)
            rec["k1_share"] = k1 / rec["step_ms"]
            band_ok, rec["vs_cpu_f64"] = horizon_band(results, ref, margin)
            rec.update(cpu_f64_s=cpu_s, decided_by="cpu_f64")
            if not band_ok:
                f32 = run_forecast_eval(cpu)[0]
                with open(res_path, "wb") as f:     # the card's, for stats
                    pickle.dump((results, meta), f)
                f32_ok, rec["cpu_f32_vs_f64"] = horizon_band(f32, ref,
                                                             margin)
                if not f32_ok:
                    band_ok, rec["vs_cpu_f32"] = horizon_band(results, f32,
                                                              margin)
                    rec["decided_by"] = "cpu_f32"
            good = good and band_ok
        runs[mode] = rec
        ok = ok and good
        emit("forecast_eval", mode=mode, ok=bool(good), **rec)
    if not ok:
        raise AssertionError(f"forecast_eval out of bounds: {runs}")
    return runs


def phase_forecast_stats():
    """eval_forecast --mode stats on both pickles of forecast_eval:
    horizon-30 and horizon-90 pose, velocity and acceleration metrics,
    all finite."""
    import io
    from egopose_tpu_torch.cli import eval_forecast
    out, ok = {}, True
    for mode, extra in (("em_init", []), ("gt_init", ["--suffix", "_gt"])):
        with contextlib.redirect_stdout(io.StringIO()):
            stats = eval_forecast.main(
                ["--egoforecast-cfg", FORECAST, "--egoforecast-iter",
                 str(FORECAST_ITERS)] + extra)
        rec = {h: dict(zip(("pose_dist", "vel_dist", "accel"), v))
               for h, v in stats.items()}
        finite = bool(np.isfinite([list(v) for v in stats.values()]).all())
        ok = ok and finite
        out[mode] = rec
        emit("forecast_stats", mode=mode, ok=finite, **rec)
    if not ok:
        raise AssertionError(f"forecast_stats not finite: {out}")
    return out


# ---------------------------------------------------------------------------
# The eval and training options: --profile-dir, --render, the vis modes and
# --engine mujoco
# ---------------------------------------------------------------------------

PROFILE_STEPS_TRAIN = 20      # control steps of train_profile's segments
RENDER_LEN = 60               # frames a take in render_eval (40 steps)


def trace_split(path, names=("sample", "update")):
    """The device kernels of a torch.profiler Chrome trace by the
    record_function range (of ``names``) their launch lies in: a kernel's
    launch is the runtime call of the same correlation id, else (no such
    call recorded) the kernel's own start inside the range's device-side
    copy.  Per range: kernels, their device ms and the K1 launches
    (substep_kernel); ``all`` counts every kernel of the trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    host = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] in names}
    dev = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "gpu_user_annotation" and e["name"] in names}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {n: dict(kernels=0, device_ms=0.0, k1=0)
           for n in ("all",) + tuple(names)}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        if ts is None:
            where = [n for n, (a, b) in dev.items() if a <= e["ts"] <= b]
        else:
            where = [n for n, (a, b) in host.items() if a <= ts <= b]
        for n in ["all"] + where:
            out[n]["kernels"] += 1
            out[n]["device_ms"] += e["dur"] / 1e3
            out[n]["k1"] += KERNEL_KEYS["k1"] in e["name"]
    out["ranges_found"] = sorted(set(host) | set(dev))
    return out


def phase_train_profile(device):
    """ego_mimic at the shipped subject_03 widths, 1024 lanes, 2 iterations
    of one PROFILE_STEPS_TRAIN-step segment (--episode-len and --min-batch
    cut), the second under --profile-dir: the trace's K1 launches inside
    ``sample`` equal the control steps sampled; device ms and kernel
    counts of ``sample`` and of ``update`` (the PPO update's split)."""
    lanes, ep, n_iter = 1024, PROFILE_STEPS_TRAIN, 2
    with train_workdir():
        agent, iters, k1, k2, wall = run_train(
            device, ["--batch-lanes", str(lanes), "--episode-len", str(ep),
                     "--min-batch", str(lanes * ep), "--max-iter",
                     str(n_iter), "--profile-dir", "prof"])
        t0 = time.time()
        split = trace_split(os.path.join("prof", "trace.json"))
        parse_s = time.time() - t0
        trace_mb = os.path.getsize(os.path.join("prof", "trace.json")) / 1e6
    prof_iter = iters[1]
    rec = dict(lanes=lanes, control_steps_sampled=ep, k1_launches=k1,
               k2_launches=k2, wall_s=wall, trace_mb=trace_mb,
               trace_parse_s=parse_s,
               T_sample_profiled=prof_iter["T_sample"],
               T_update_profiled=prof_iter["T_update"],
               T_sample_unprofiled=iters[0]["T_sample"],
               T_update_unprofiled=iters[0]["T_update"], split=split)
    ok = bool(split["sample"]["k1"] == ep and k1 == n_iter * ep
              and k2 == 0 and split["update"]["k1"] == 0
              and train_finite(iters))
    emit("train_profile", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train_profile out of bounds: {rec}")
    return rec


def phase_render_eval(device):
    """ego_mimic_eval --render --profile-dir on the card, its 4 takes cut
    to RENDER_LEN frames: one K1 launch a step (in the counts and in the
    trace), no other kernel, the replay npz equal to the results pickle's
    traj_pred and traj_orig."""
    import pickle
    from egopose_tpu_torch.cli import ego_mimic_eval
    with eval_workdir({"EGOPOSE_SYNTHETIC_LEN": str(RENDER_LEN)}):
        reset_counts()
        results, meta = ego_mimic_eval.main(
            EVAL_ARGS + ["--device", str(device), "--render",
                         "--profile-dir", "prof"])
        counts = read_counts()
        res_dir = os.path.join("results", "egomimic", "subject_03",
                               "results")
        with open(os.path.join(res_dir, "iter_3000_test.p"), "rb") as f:
            saved, _ = pickle.load(f)
        replay = dict(np.load(os.path.join(res_dir,
                                           "iter_3000_test_replay.npz")))
        split = trace_split(os.path.join("prof", "trace.json"), names=())
    steps = meta["steps"]
    same = sorted(replay) == sorted(
        [f"pred__{t}" for t in saved["traj_pred"]]
        + [f"orig__{t}" for t in saved["traj_orig"]]) and all(
        np.array_equal(replay[f"{k}__{t}"], saved[f"traj_{k}"][t])
        for k in ("pred", "orig") for t in saved["traj_pred"])
    others = {k: v for k, v in counts.items() if k != "k1"}
    rec = dict(steps=steps, k1_launches=counts["k1"], other_launches=others,
               trace_k1=split["all"]["k1"],
               trace_kernels_per_step=split["all"]["kernels"] / steps,
               trace_device_ms_per_step=split["all"]["device_ms"] / steps,
               frames_per_sec_profiled=meta["frames_per_sec"],
               replay_equals_pickle=same, num_reset=meta["num_reset"])
    ok = bool(counts["k1"] == steps and not any(others.values())
              and split["all"]["k1"] == steps and same)
    emit("render_eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"render_eval out of bounds: {rec}")
    return rec


def vis_run(main, argv):
    """``main(argv)`` with its output captured: (return value, the cause
    the headless fallback logged)."""
    import io
    import re
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        written = main(argv)
    cause = re.search(r"no display \((.*)\) -- writing", out.getvalue())
    return written, cause.group(1) if cause else None


def phase_vis_headless():
    """In the forecast workdir, after forecast_eval: eval_pose --mode vis
    on the card's ego_mimic_eval results and eval_forecast --mode vis on
    forecast_eval's --gt-init results.  Each falls back (no mujoco on the
    card's machine) to an .npz of the trajectories it would render, which
    must equal the pickle's: the first take's traj_pred and traj_orig
    (eval_pose), their first windows after remove_noisy_hands, which
    eval_forecast applies to what it reads (eval_forecast)."""
    import pickle
    from egopose_tpu_torch.cli import eval_forecast, eval_pose
    from egopose_tpu_torch.utils.tools import remove_noisy_hands
    runs, ok = {}, True
    for name, main, argv, pkl, win in (
            ("eval_pose", eval_pose.main,
             ["--egomimic-cfg", "subject_03", "--egomimic-iter", "3000",
              "--mode", "vis"],
             os.path.join("results", "egomimic", "subject_03", "results",
                          "iter_3000_test.p"), False),
            ("eval_forecast", eval_forecast.main,
             ["--egoforecast-cfg", FORECAST, "--egoforecast-iter",
              str(FORECAST_ITERS), "--suffix", "_gt", "--mode", "vis"],
             os.path.join("results", "egoforecast", FORECAST, "results",
                          "iter_%04d_test_gt.p" % FORECAST_ITERS), True)):
        t0 = time.time()
        written, cause = vis_run(main, argv)
        secs = time.time() - t0
        with open(pkl, "rb") as f:
            res, _ = pickle.load(f)
        if win:
            remove_noisy_hands(res)
        take = list(res["traj_pred"])[0]
        want = [res["traj_pred"][take], res["traj_orig"][take]]
        if win:
            want = [w[0] for w in want]
        got = dict(np.load(written)) if written.endswith(".npz") else {}
        same = sorted(got) == ["traj_0", "traj_1"] and all(
            np.array_equal(got[f"traj_{i}"], w) for i, w in enumerate(want))
        good = bool(written.endswith(".npz") and same)
        runs[name] = dict(written=written, fallback_cause=cause,
                          arrays_equal_pickle=same, seconds=secs)
        ok = ok and good
        emit("vis_headless", cli=name, ok=good, **runs[name])
    if not ok:
        raise AssertionError(f"vis_headless out of bounds: {runs}")
    return runs


def phase_engine_mujoco(device):
    """ego_mimic_eval --engine mujoco (the MuJoCo C oracle on the host)
    on render_eval's short world, where ``import mujoco`` succeeds: no
    kernel launches, finite, the _mj pickle written.  Where it does not,
    one line says so and why."""
    try:
        import mujoco  # noqa: F401
    except ImportError as e:
        emit("engine_mujoco", ran=False,
             reason=f"mujoco does not import on this machine: {e}")
        return None
    from egopose_tpu_torch.cli import ego_mimic_eval
    with eval_workdir({"EGOPOSE_SYNTHETIC_LEN": str(RENDER_LEN)}):
        reset_counts()
        results, meta = ego_mimic_eval.main(
            EVAL_ARGS + ["--device", str(device), "--engine", "mujoco"])
        counts = read_counts()
        written = os.path.exists(os.path.join(
            "results", "egomimic", "subject_03", "results",
            "iter_3000_test_mj.p"))
    finite = bool(all(np.isfinite(a).all()
                      for a in results["traj_pred"].values()))
    rec = dict(ran=True, steps=meta["steps"], launches=counts,
               num_reset=meta["num_reset"],
               frames_per_sec=meta["frames_per_sec"], finite=finite,
               pickle_written=written)
    ok = bool(not any(counts.values()) and finite and written)
    emit("engine_mujoco", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"engine_mujoco out of bounds: {rec}")
    return rec


# ---------------------------------------------------------------------------
# The other objectives (TRPO, a2c), VGAIL, the native checkpoint and a
# float64 checkpoint in a float32 eval
# ---------------------------------------------------------------------------

OBJ_STEPS = 20                # control steps of these phases' segments
OBJ_LANES = 1024
VGAIL_BLOCK = {"hidden_dims": [128, 128], "lr": 1e-3, "num_update": 10,
               "reward_weight": 1.0}


def objective_args(n_iter):
    """ego_mimic / ego_forecast flags for ``n_iter`` iterations of one
    OBJ_STEPS-step segment over OBJ_LANES lanes (the shipped widths; the
    episode and the batch cut as in train_profile)."""
    return ["--batch-lanes", str(OBJ_LANES), "--episode-len",
            str(OBJ_STEPS), "--min-batch", str(OBJ_LANES * OBJ_STEPS),
            "--max-iter", str(n_iter)]


def nets_moved(agent, nets):
    """Whether ``nets`` (names on AgentEgo) differ from the same agent's
    fresh weights (its config's seed), the schedule-set log-std aside."""
    import torch
    fresh = type(agent)(agent.model, agent.spec, agent.p, agent.tables,
                        agent.expert, agent.cnn_feat.cpu().numpy(),
                        agent.cfg, batch_lanes=agent.batch_lanes,
                        seed=agent.cfg.seed, dtype=agent.dtype,
                        device=agent.device)
    return any(not torch.equal(a, b) for name in nets
               for (key, a), b in zip(
                   getattr(agent, name).state_dict().items(),
                   getattr(fresh, name).state_dict().values())
               if key != "action_log_std")


def run_objective(device, n_iter, **overrides):
    """ego_mimic at the shipped widths on a scratch config with
    ``overrides``, OBJ_LANES lanes, ``n_iter`` iterations of one
    OBJ_STEPS-step segment: K1 launches == control steps, K2 == 0, every
    metric finite.  Returns (agent, record, ok)."""
    with train_workdir(**overrides):
        agent, iters, k1, k2, wall = run_train(device,
                                               objective_args(n_iter))
    steps = n_iter * OBJ_STEPS
    finite = bool(all(np.isfinite([v for k, v in it.items()
                                   if isinstance(v, (int, float))]).all()
                      and np.isfinite(it["R_info"]).all() for it in iters))
    rec = dict(lanes=OBJ_LANES, control_steps=steps, k1_launches=k1,
               k2_launches=k2, wall_s=wall, iters=iters, finite=finite)
    return agent, rec, bool(k1 == steps and k2 == 0 and finite)


def ppo_updates(tr, tp):
    """PPO's update times from phases train (200-step segments) and
    train_profile (its unprofiled first iteration, OBJ_STEPS-step)."""
    return dict(
        ppo_T_update_train_200=[it["T_update"] for it in tr["iters"]]
        if tr else None,
        ppo_T_update_train_profile_20=tp["T_update_unprofiled"]
        if tp else None)


def phase_train_trpo(device, tr=None, tp=None):
    """policy_objective: trpo: the natural-gradient step on every
    iteration's batch; at least one iteration's line search accepted a
    step that lowered the surrogate within 1.5 max_kl (the JAX package's
    bar, tests/test_trpo_vgail.py); K6 launches inside each update (the
    context nets' passes under torch.func's grad, vjp and jvp) > 0."""
    with k6_in_update() as k6:
        agent, rec, ok = run_objective(device, 2,
                                       policy_objective="trpo")
    max_kl = float(agent.cfg.max_kl)
    accepted = [it for it in rec["iters"] if it["ls_success"]
                and it["surrogate_after"] < it["policy_loss"]
                and 0 < it["kl"] <= 1.5 * max_kl]
    rec.update(max_kl=max_kl, accepted_iters=len(accepted),
               T_update=[it["T_update"] for it in rec["iters"]],
               k6_update_launches=k6, **ppo_updates(tr, tp))
    ok = bool(ok and accepted and agent.objective == "trpo" and k6
              and min(k6) > 0)
    emit("train_trpo", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train_trpo out of bounds: {rec}")
    return rec


def phase_train_a2c(device, tr=None, tp=None):
    """policy_objective: a2c: the vanilla policy gradient in PPO's epoch
    loop; the policy and its context net moved."""
    agent, rec, ok = run_objective(device, 2,
                                   policy_objective="a2c")
    moved = nets_moved(agent, ("policy_net", "policy_vs_net"))
    rec.update(policy_moved=moved,
               T_update=[it["T_update"] for it in rec["iters"]],
               **ppo_updates(tr, tp))
    ok = bool(ok and moved and agent.objective == "a2c")
    emit("train_a2c", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train_a2c out of bounds: {rec}")
    return rec


def phase_train_vgail(device):
    """A discriminator: block (VGAIL_BLOCK): -log D(s) rewards, PPO, then
    the discriminator's BCE steps, 3 iterations; discrim_loss finite, and
    whether it fell (printed with the losses when it did not)."""
    agent, rec, ok = run_objective(device, 3,
                                   discriminator=dict(VGAIL_BLOCK))
    losses = [it["discrim_loss"] for it in rec["iters"]]
    fell = bool(losses[-1] < losses[0])
    rec.update(discriminator=VGAIL_BLOCK, discrim_loss=losses,
               discrim_loss_fell=fell,
               T_update=[it["T_update"] for it in rec["iters"]])
    if not fell:
        rec["why_not"] = (
            "the generator's states moved with the policy between the "
            "iterations: each iteration's loss is on a new batch")
    ok = bool(ok and type(agent).__name__ == "AgentVGAIL"
              and np.isfinite(losses).all())
    emit("train_vgail", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"train_vgail out of bounds: {rec}")
    return rec


def same_state(a, b, with_filter=True):
    """Whether two agents hold equal nets, filters (unless not
    ``with_filter``) and optimizer states (mu, nu, count, skip counts,
    lr), compared with torch.equal."""
    import torch
    tensors = lambda ag: [t for net in ag.nets
                          for t in net.state_dict().values()] \
        + (list(ag.zstat) if with_filter else [])
    if not all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b))):
        return False
    for name in ("opt_policy", "opt_value"):
        sa = getattr(a.train_state, name).state_dict()
        sb = getattr(b.train_state, name).state_dict()
        if sa["lr"] != sb["lr"] or not all(
                torch.equal(x, y) for k in ("mu", "nu")
                for x, y in zip(sa[k], sb[k])) or not all(
                torch.equal(sa[k], sb[k])
                for k in ("count", "notfinite_count", "total_notfinite")):
            return False
    return True


def phase_resume_native(device):
    """ego_mimic --ckpt-format orbax writes models/iter_0001.orbax; a fresh
    agent loads it equal to the writer (nets, filter, both optimizers); one
    update of each on the same newly sampled batch leaves their nets and
    optimizers equal.  Then ego_forecast --ckpt-format orbax writes iter_0002.orbax and a
    third iteration resumes from it with the value optimizer's step count
    carried on."""
    import torch
    from egopose_tpu_torch.cli import ego_forecast
    from egopose_tpu_torch.rl.agent_ego import NATIVE_FILE, AgentEgo
    with train_workdir(save_model_interval=1):
        writer, iters, k1, k2, _ = run_train(
            device, objective_args(1) + ["--ckpt-format", "orbax"])
        path = os.path.join("results", "egomimic", "subject_03", "models",
                            "iter_0001.orbax")
        files = sorted(os.listdir(path))
        reader = AgentEgo(writer.model, writer.spec, writer.p, writer.tables,
                          writer.expert, writer.cnn_feat.cpu().numpy(),
                          writer.cfg, batch_lanes=OBJ_LANES, seed=99,
                          dtype=writer.dtype, device=device)
        reader.load_native(path)
        loaded_equal = same_state(reader, writer)
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        reset_counts()
        batch, _ = writer.sample(gen, OBJ_LANES * OBJ_STEPS)
        k1 += read_counts()["k1"]
        # (sampling moved the writer's filter; an update does not read it)
        m_w, m_r = writer.update_params(batch), reader.update_params(batch)
        updated_equal = same_state(reader, writer, with_filter=False) \
            and m_w == m_r
    with forecast_workdir():
        args = ["--cfg", FORECAST, "--synthetic", "--device", str(device),
                "--ckpt-format", "orbax"]
        reset_counts()
        ego_forecast.main(args + objective_args(FORECAST_ITERS))
        f_k1 = read_counts()["k1"]
        reset_counts()
        f_path = os.path.join("results", "egoforecast", FORECAST, "models",
                              "iter_%04d.orbax" % FORECAST_ITERS)
        saved = torch.load(os.path.join(f_path, NATIVE_FILE),
                           map_location="cpu", weights_only=True)
        resumed = ego_forecast.main(
            args + objective_args(FORECAST_ITERS + 1)
            + ["--iter", str(FORECAST_ITERS)])
        f_k1 += read_counts()["k1"]
        epochs = int(resumed.cfg.num_optim_epoch)
        count_v = int(resumed.train_state.opt_value.count)
        count_p = int(resumed.train_state.opt_policy.count)
    rec = dict(mimic_files=files, loaded_equal=loaded_equal,
               updated_equal=updated_equal,
               forecast_saved_counts=dict(
                   value=int(saved["opt_value"]["count"]),
                   policy=int(saved["opt_policy"]["count"])),
               forecast_resumed_counts=dict(value=count_v, policy=count_p),
               k1_launches=k1 + f_k1, k2_launches=k2,
               control_steps=2 * OBJ_STEPS
               + (FORECAST_ITERS + 1) * OBJ_STEPS)
    ok = bool(files == [NATIVE_FILE] and loaded_equal and updated_equal
              and rec["forecast_saved_counts"]["value"]
              == FORECAST_ITERS * epochs
              and count_v == (FORECAST_ITERS + 1) * epochs
              and count_p >= rec["forecast_saved_counts"]["policy"]
              and rec["k1_launches"] == rec["control_steps"] and k2 == 0)
    emit("resume_native", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"resume_native out of bounds: {rec}")
    return rec


F64_LEN = 60                  # frames a take in f64_ckpt_f32_eval (40 steps)


def phase_f64_ckpt_f32_eval(device):
    """The committed iter_3000.p with every array cast to float64 (the
    layout the JAX package writes from a float64 session, filter float64)
    evaluated in float32 through K1, takes cut to F64_LEN frames: the
    filter loads as float32, one K1 launch a step, and the trajectories
    within 1e-5 of those of the float32 checkpoint itself (the cast is
    exact both ways, so equal unless the card reorders a sum)."""
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.convert import (load_checkpoint_pickle,
                                           save_checkpoint_pickle)
    from egopose_tpu_torch.ops import running_norm
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    src = os.path.join(REPO, "results", "egomimic", "subject_03", "models",
                       "iter_3000.p")
    cp = load_checkpoint_pickle(src)
    f64 = lambda t: {k: f64(v) for k, v in t.items()} \
        if isinstance(t, dict) else np.asarray(t, np.float64)
    cp64 = {k: f64(v) for k, v in cp.items() if k != "running_state"}
    cp64["running_state"] = running_norm.RunningStat(
        *[np.asarray(x, np.float64) for x in cp["running_state"]])
    seen = []
    load = AgentEgo.load_checkpoint

    def watched(agent, c):
        load(agent, c)
        seen.append(sorted({str(x.dtype) for x in agent.zstat}))
    runs = {}
    AgentEgo.load_checkpoint = watched
    try:
        for name in ("f32", "f64"):
            with eval_workdir({"EGOPOSE_SYNTHETIC_LEN": str(F64_LEN)}):
                if name == "f64":
                    models = os.path.join("results", "egomimic",
                                          "subject_03", "models")
                    os.unlink(models)
                    os.makedirs(models)
                    save_checkpoint_pickle(
                        os.path.join(models, "iter_3000.p"), cp64)
                reset_counts()
                results, meta = ego_mimic_eval.main(
                    EVAL_ARGS + ["--device", str(device)])
                runs[name] = (results, meta, read_counts())
    finally:
        AgentEgo.load_checkpoint = load
    (r32, m32, c32), (r64, m64, c64) = runs["f32"], runs["f64"]
    same = all(np.array_equal(r64["traj_pred"][t], r32["traj_pred"][t])
               for t in r32["traj_pred"])
    gap = max(float(np.abs(r64["traj_pred"][t] - r32["traj_pred"][t]).max())
              for t in r32["traj_pred"])
    finite = bool(all(np.isfinite(a).all() for a in r64["traj_pred"].values()))
    others = {k: v for k, v in c64.items() if k != "k1"}
    rec = dict(steps=m64["steps"], k1_launches=c64["k1"] + c32["k1"],
               f64_run_k1=c64["k1"], other_launches=others,
               filter_dtypes=dict(f32=seen[0], f64=seen[1]),
               traj_equal=same, traj_max_abs_gap=gap, finite=finite,
               num_reset=dict(f32=m32["num_reset"], f64=m64["num_reset"]))
    ok = bool(seen[1] == ["torch.float32"] and c64["k1"] == m64["steps"]
              and c32["k1"] == m32["steps"] and not any(others.values())
              and finite and gap <= 1e-5)
    emit("f64_ckpt_f32_eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"f64_ckpt_f32_eval out of bounds: {rec}")
    return rec


# ---------------------------------------------------------------------------
# State regression: the shipped config/statereg/subject_03.yml widths
# ---------------------------------------------------------------------------

# -- the parallel runtime (parallel/) ---------------------------------------

DP_STEPS = 20                 # control steps of dp_train's and dp_two_ranks'
DP_LANES = 1024               # segment, and their lanes (all ranks together)
DP_F64 = dict(lanes=64, steps=4)
SP_TOL = 1e-5                 # f32 max-abs, the JAX dry run's bar


def shared_card(device, n):
    """Ranks sharing the card (gloo, staged through host memory) on CUDA,
    gloo CPU ranks otherwise."""
    return [0] * n if device.type == "cuda" else None


def close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def phase_dp_train(device):
    """ego_mimic --dp-devices 1 (a process group of one: NCCL on the card)
    against the no-flag run at train's widths, DP_LANES lanes, one
    DP_STEPS-step segment and one update: rewards and update metrics
    equal to float32 rounding (rtol 1e-6), K1 launches == control steps in
    each run."""
    args = ["--batch-lanes", str(DP_LANES), "--episode-len", str(DP_STEPS),
            "--min-batch", str(DP_LANES * DP_STEPS), "--max-iter", "1"]
    runs = {}
    for name, extra in (("one_process", []), ("dp_1", ["--dp-devices", "1"])):
        with train_workdir(save_model_interval=0):
            _agent, iters, k1, k2, wall = run_train(device, args + extra)
        runs[name] = dict(iters=iters, k1_launches=k1, k2_launches=k2,
                          wall_s=wall)
    a, b = runs["one_process"]["iters"][0], runs["dp_1"]["iters"][0]
    keys = ("R_avg", "R_min", "R_max", "R_info", "policy_loss", "value_loss",
            "n_valid", "n_exp")
    equal = {k: close(b[k], a[k], 1e-6) for k in keys}
    ok = bool(all(equal.values()) and train_finite([a, b])
              and all(r["k1_launches"] == DP_STEPS and r["k2_launches"] == 0
                      for r in runs.values()))
    rec = dict(lanes=DP_LANES, control_steps=DP_STEPS, equal=equal,
               T_sample=[r["iters"][0]["T_sample"] for r in runs.values()],
               T_update=[r["iters"][0]["T_update"] for r in runs.values()],
               k1_launches=sum(r["k1_launches"] for r in runs.values()),
               runs={k: dict(v, iters=v["iters"][0]) for k, v in
                     runs.items()})
    emit("dp_train", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"dp_train out of bounds: {rec}")
    return rec


def phase_dp_two_ranks(device, smi):
    """Two ranks sharing the card (make_mesh(2, device_ids=[0, 0]), gloo)
    against one process on it.  (a) float64, the JAX dry run's world,
    DP_F64 lanes x steps: rewards rtol 1e-8 / atol 1e-10, update metrics
    rtol 1e-6 / atol 1e-8.  (b) float32, the training CLI's world at
    train's widths (subject_03 unchanged: 4 synthetic takes x 400 frames,
    64 features a frame, 10 optimizer epochs), 2 x DP_LANES / 2 lanes,
    one DP_STEPS-step segment and one update: finite, the first control step's qpos / qvel within K1's f32
    RMS bar of the one-process step's lanes, DP_STEPS K1 launches in each
    rank.  Two ranks on one card test the code path and the collectives,
    not a speed-up; T_sample and T_update are printed beside the
    one-process run's."""
    import torch
    from egopose_tpu_torch.parallel import dryrun
    from egopose_tpu_torch.parallel import mesh as meshlib
    ids = shared_card(device, 2)
    rec, ok, k1, k5 = {}, True, 0, 0
    for name, dtype, lanes, steps, full in (
            ("float64", "float64", DP_F64["lanes"], DP_F64["steps"], False),
            ("float32", "float32", DP_LANES, DP_STEPS, True)):
        one = dryrun.train_step(1, 1, dtype, lanes, steps, device=str(device),
                                first_step=True, full=full)
        ranks = meshlib.launch(2, dryrun.train_step, 2, 1, dtype, lanes,
                               steps, False, False, None, 1, 7, str(device),
                               ids, True, None, full, device=str(device),
                               device_ids=ids)
        k1 += one["k1"] + sum(r["k1"] for r in ranks)
        # the ranks' worlds and the dry-run world; the training CLI's world
        # of the one-process run is built through the wrapped build_world
        # (count_world_builds), its K5 launches in WORLD_K5
        k5 += (0 if full else one["k5"]) + sum(r["k5"] for r in ranks)
        half = lanes // 2
        lane = lambda r: slice(r["data_rank"] * half,
                               (r["data_rank"] + 1) * half)
        r = dict(lanes=lanes, control_steps=steps,
                 world="train" if full else "dry run",
                 k1_launches_per_rank=[x["k1"] for x in ranks],
                 T_sample_one_process=one["T_sample"],
                 T_update_one_process=one["T_update"],
                 T_sample_ranks=[x["T_sample"] for x in ranks],
                 T_update_ranks=[x["T_update"] for x in ranks])
        finite = all(np.isfinite(x["rewards"].numpy()).all()
                     and np.isfinite(list(x["metrics"].values())).all()
                     for x in ranks)
        if name == "float64":
            rewards_ok = all(close(x["rewards"], one["rewards"][:, lane(x)],
                                   1e-8, 1e-10) for x in ranks)
            metrics_ok = all(close(x["metrics"][k], v, 1e-6, 1e-8)
                             for x in ranks for k, v in
                             one["metrics"].items())
            r.update(rewards_ok=rewards_ok, metrics_ok=metrics_ok,
                     max_abs_reward=max(float((x["rewards"] - one["rewards"]
                                               [:, lane(x)]).abs().max())
                                        for x in ranks))
            ok &= rewards_ok and metrics_ok
        else:
            bars = [step_bars(torch.float32,
                              x["first_qpos"] - one["first_qpos"][lane(x)],
                              x["first_qvel"] - one["first_qvel"][lane(x)])
                    for x in ranks]
            r.update(first_step=[b[1] for b in bars],
                     first_step_ok=all(b[0] for b in bars))
            ok &= r["first_step_ok"]
        r["finite"] = finite
        ok &= finite and all(x["k1"] == steps for x in ranks) \
            and one["k1"] == steps
        rec[name] = r
    rec.update(k1_launches=k1, k5_launches=k5, nvidia_smi=smi)
    emit("dp_two_ranks", ok=bool(ok), **rec)
    if not ok:
        raise AssertionError(f"dp_two_ranks out of bounds: {rec}")
    return rec


def phase_sp_encode(device):
    """vsnet_encode_sp on 2 ranks sharing the card against the unsharded
    pass: a TCN context net at the JAX defaults (size [64, 128], kernel
    3, fr_margin 10) built from a seed, over the synthetic eval world's
    four full takes, f32 max-abs <= SP_TOL.  Then ego_mimic_eval
    --sp-devices 1 against the no-flag eval of a TCN agent built from a
    seed, the takes cut to RENDER_LEN frames: the same results pickle."""
    import pickle
    import torch
    from egopose_tpu_torch.cli import ego_mimic, ego_mimic_eval
    from egopose_tpu_torch.models.video_state_net import VideoStateNet
    from egopose_tpu_torch.parallel import dryrun
    from egopose_tpu_torch.parallel import mesh as meshlib
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    tcn = {"size": [64, 128], "kernel_size": 3}
    overrides = {f"{who}_v_{key}": value for who in ("policy", "value")
                 for key, value in (("net", "tcn"), ("net_param", tcn))}
    with train_workdir(**overrides):
        cfg = EgoMimicConfig("subject_03")
        feats = ego_mimic.build_world(cfg, torch.float32, device,
                                      synthetic=True)[-1]
        kw = dict(cnn_feat_dim=feats.shape[-1], v_hdim=128,
                  v_margin=cfg.fr_margin, v_net_type="tcn", causal=False,
                  v_net_param=tcn)
        torch.manual_seed(0)
        state = VideoStateNet(**kw).state_dict()
        ids = shared_card(device, 2)
        ref = dryrun.sp_apply("vsnet", 1, kw, state, feats, torch.float32,
                              device=str(device))["out"]
        outs = meshlib.launch(2, dryrun.sp_apply, "vsnet", 2, kw, state,
                              feats, torch.float32, False, None, str(device),
                              ids, device=str(device), device_ids=ids)
        errs = [float((o["out"] - ref.cpu()).abs().max()) for o in outs]
        results, launches = {}, {}
        saved = os.environ.get("EGOPOSE_SYNTHETIC_LEN")
        os.environ["EGOPOSE_SYNTHETIC_LEN"] = str(RENDER_LEN)
        for name, extra in (("sp_1", ["--sp-devices", "1"]),
                            ("one_process", [])):
            reset_counts()
            ego_mimic_eval.main(["--cfg", "subject_03", "--synthetic",
                                 "--device", str(device)] + extra)
            launches[name] = read_counts()["k1"]
            with open(os.path.join("results", "egomimic", "subject_03",
                                   "results", "iter_0000_test.p"), "rb") as f:
                results[name] = pickle.load(f)[0]
        if saved is None:
            os.environ.pop("EGOPOSE_SYNTHETIC_LEN")
        else:
            os.environ["EGOPOSE_SYNTHETIC_LEN"] = saved
    a, b = results["sp_1"], results["one_process"]
    same = a.keys() == b.keys() and all(
        np.array_equal(a[k][t], b[k][t]) for k in a for t in a[k])
    steps = max(x.shape[0] for x in b["traj_pred"].values())
    rec = dict(frames=list(feats.shape), halo=[6, 6], max_abs_err=errs,
               eval_same_results=bool(same), eval_k1_launches=launches,
               eval_steps=steps)
    ok = bool(max(errs) <= SP_TOL and same
              and all(n == steps for n in launches.values()))
    emit("sp_encode", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"sp_encode out of bounds: {rec}")
    return dict(rec, k1_launches=sum(launches.values()))


def phase_dryrun(device):
    """python -m egopose_tpu_torch.parallel.dryrun 2 --device cuda, its
    ranks sharing the card: its audit summary and its ok line."""
    import io
    from egopose_tpu_torch.parallel import dryrun
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outs = dryrun.main(["2", "--device", str(device.type)])
    text = buf.getvalue()
    ok = "dryrun_multichip(2): ok" in text \
        and "collective audit [update]" in text
    rec = dict(output=text.splitlines(),
               k1_launches=sum(o["k1"] for o in outs),
               k5_launches=sum(o["k5"] for o in outs))
    emit("dryrun", ok=bool(ok), **rec)
    if not ok:
        raise AssertionError(f"dryrun failed: {text}")
    return rec


STATEREG = "subject_03"
# The re-anchoring state net of phase statereg_eval: the same config with
# cnn_fdim 64, the width of the synthetic ego-mimic world's CNN features,
# which the committed iter_3000.p's context nets read (the state net runs
# over the same features as the policy).
STATEREG_EVAL = "subject_03_eval"
STATEREG_EPOCHS = 4           # depth cut from the shipped 100
STATEREG_SYN = {"EGOPOSE_SYN_RES": "224", "EGOPOSE_SYN_TAKES": "4",
                "EGOPOSE_SYN_LEN": "240"}
# Relative RMS bar of the card's float32 state-regression outputs against
# the port's CPU float64 run of the same checkpoint and inputs: TF32 is
# off, so each float32 convolution or matmul rounds at ~6e-8 per term,
# ~sqrt(4608) * 6e-8 ~ 4e-6 relative for a 3x3x512 convolution, compounded
# over ResNet-18's 20 weighted layers and the LSTM (~2e-5); the bar is 5x
# that.
STATEREG_TOL = 1e-4


@contextlib.contextmanager
def statereg_workdir():
    """A scratch working directory for the statereg CLIs and the
    re-anchored eval: config/statereg/subject_03.yml as shipped (a
    checkpoint after STATEREG_EPOCHS epochs), its cnn_fdim-64 copy
    STATEREG_EVAL, config/egomimic/subject_03.yml re-anchored on that
    net's iter_%04d_inf.p, the committed mimic models; the synthetic flow
    at 224x224, 4 takes x 240 frames (STATEREG_SYN)."""
    import yaml
    saved = {k: os.environ.get(k) for k in STATEREG_SYN}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        sr = yaml.safe_load(open(os.path.join(REPO, "config", "statereg",
                                              STATEREG + ".yml")))
        sr["save_model_interval"] = STATEREG_EPOCHS
        os.makedirs(os.path.join(tmp, "config", "statereg"))
        os.makedirs(os.path.join(tmp, "config", "egomimic"))
        for name, cfg in ((STATEREG, sr),
                          (STATEREG_EVAL, dict(sr, cnn_fdim=64))):
            with open(os.path.join(tmp, "config", "statereg",
                                   name + ".yml"), "w") as f:
                yaml.safe_dump(cfg, f)
        em = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                              "subject_03.yml")))
        em.update(state_net_cfg=STATEREG_EVAL,
                  state_net_iter=STATEREG_EPOCHS)
        with open(os.path.join(tmp, "config", "egomimic", "subject_03.yml"),
                  "w") as f:
            yaml.safe_dump(em, f)
        os.symlink(os.path.join(REPO, "config", "egoforecast"),
                   os.path.join(tmp, "config", "egoforecast"))
        models = os.path.join(tmp, "results", "egomimic", "subject_03")
        os.makedirs(models)
        os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                                "models"), os.path.join(models, "models"))
        os.environ.update(STATEREG_SYN)
        os.chdir(tmp)
        try:
            yield sr
        finally:
            os.chdir(cwd)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


class SectionProfiler:
    """Runs each section of a step in a torch.profiler session of its own:
    ``mark(name)`` waits for the card, closes the running session as
    section ``name`` (its device time: kernels and copies; its host wall
    time; its kernel count) and opens the next."""

    def __init__(self):
        self.out = {}
        self._open()

    def _open(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def _close(self):
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        dtime = lambda e: getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0))
        dev = [e for e in self.prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return dict(device_ms=sum(dtime(e) for e in dev) / 1e3,
                    wall_ms=wall * 1e3, kernels=sum(e.count for e in dev))

    def mark(self, name):
        self.out[name] = self._close()
        self._open()

    def close(self):
        self._close()
        return self.out


def statereg_step_split(net, dataset, cfg, device):
    """One training step of the trained net on the epoch's first batch,
    each section in its own profiler session (SectionProfiler): the host's
    batch assembly, the host->device copy, the CNN's forward, the temporal
    net's (the LSTM's unroll, with the MLP head and the loss) forward and
    backward, the CNN's backward and the Adam update."""
    import torch
    from egopose_tpu_torch.cli.state_reg import (host_batches, to_device,
                                                 train_step)
    opt = torch.optim.Adam(net.parameters(), lr=cfg["lr"])
    batches = host_batches(dataset, 4, cfg["fr_margin"], dataset.traj_dim,
                           np.float32, np.float32, pin=True)
    torch.cuda.synchronize()
    split = SectionProfiler()
    batch = next(batches)
    split.mark("host_batch_assembly")
    of, gt, mask, frames = to_device(batch, device)
    split.mark("host_to_device_copy")
    loss = train_step(net, opt, of, gt, mask, cfg["fr_margin"],
                      torch.float32, marks=split.mark)
    out = split.close()
    total = sum(r["wall_ms"] for r in out.values())
    # the CNN's forward operations a frame (torch's flop counter: 2 per
    # multiply-add of every convolution and matmul), and the rate the
    # section's device time gives them
    from torch.utils.flop_counter import FlopCounterMode
    net.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net.cnn_feature(torch.zeros((1,) + frame_shape(dataset),
                                    device=device))
    flops = counter.get_total_flops()
    fwd = out["cnn_forward"]
    fwd["flops"] = flops * of.shape[0] * of.shape[1]
    fwd["tflop_per_s"] = fwd["flops"] / fwd["device_ms"] / 1e9 \
        if fwd["device_ms"] else None
    return dict(sections=out, step_wall_ms=total, cnn_flops_per_frame=flops,
                step_device_ms=sum(r["device_ms"] for r in out.values()),
                frames=int(of.shape[0] * of.shape[1]),
                loss=float(loss))


def phase_statereg_train(device, cfg):
    """state_reg --mode train --synthetic at the shipped widths (ResNet-18,
    bi-LSTM v_hdim 128, cnn_fdim 128, MLP 300/200, chunks of 120 frames
    with 10 frames of margin, 4 chunks a step) on the 224x224 synthetic
    flow, 4 takes x 240 frames (8 chunks, 2 steps an epoch), for
    STATEREG_EPOCHS epochs: finite losses, a loss that falls, the
    checkpoint written; frames/s per epoch, ms a step, peak device memory,
    and the profiler's split of one step."""
    import torch
    from egopose_tpu_torch.cli import state_reg
    from egopose_tpu_torch.ops import lstm
    epochs = []
    hook = lambda e, dt, n, loss, steps: epochs.append(dict(
        epoch=e, seconds=dt, frames=n, frames_per_s=n / dt, loss=loss,
        steps=steps))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    k6 = lstm.launches
    net, dataset = state_reg.main(
        ["--cfg", STATEREG, "--mode", "train", "--synthetic", "--max-epoch",
         str(STATEREG_EPOCHS), "--device", str(device)], epoch_hook=hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k6 = lstm.launches - k6
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_epoch = epochs[-1]["steps"]
    # ms a step past the first epoch (cuDNN's first calls, the allocator)
    step_ms = [e["seconds"] * 1e3 / per_epoch for e in epochs[1:]]
    split = statereg_step_split(net, dataset, cfg, device)
    losses = [e["loss"] for e in epochs]
    saved = os.path.exists(os.path.join(
        "results", "statereg", STATEREG, "models",
        "iter_%04d.p" % STATEREG_EPOCHS))
    steps = sum(e["steps"] for e in epochs)
    rec = dict(epochs=epochs, steps_per_epoch=per_epoch, step_ms=step_ms,
               peak_memory_gib=peak, wall_s=wall, step_split=split,
               checkpoint_written=saved, k6_launches=k6)
    ok = bool(np.isfinite(losses).all() and losses[-1] < losses[0]
              and per_epoch == 2 and saved and np.isfinite(split["loss"])
              and k6 >= 2 * steps)
    emit("statereg_train", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"statereg_train out of bounds: {rec}")
    return net, dataset


def frame_shape(dataset):
    """(H, W, 3): the CNN's frames of a statereg dataset's flow."""
    return dataset.load_of(0, 0, 1).shape[1:3] + (3,)


def rel_rms(got, want):
    import torch
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt())


def take_predictions(device, dtype):
    """The statereg checkpoint's normalised predictions over the first
    synthetic take (its two chunks, each padded to fr_num + 30 frames, as
    test mode runs them), on ``device`` in ``dtype``.  The first take's
    flow, trajectory and normalisation do not depend on the take count,
    so one take is generated."""
    import torch
    from egopose_tpu_torch.cli.state_reg import (load_state_net, make_net,
                                                 pad_flow_channels,
                                                 prepare_of)
    from egopose_tpu_torch.data.dataset import Dataset
    from egopose_tpu_torch.utils.config import StateRegConfig
    cfg = StateRegConfig(STATEREG)
    saved = os.environ["EGOPOSE_SYN_TAKES"]
    os.environ["EGOPOSE_SYN_TAKES"] = "1"
    try:
        ds = Dataset(cfg.meta_id, "test", cfg.fr_num, "iter", False,
                     2 * cfg.fr_margin, synthetic=True, seed=cfg.seed)
    finally:
        os.environ["EGOPOSE_SYN_TAKES"] = saved
    sd, meta = load_state_net(cfg, os.path.join(
        cfg.model_dir, "iter_%04d.p" % STATEREG_EPOCHS), no_cnn=False)
    ds.set_mean_std(meta["mean"], meta["std"])
    net = make_net(cfg, ds.traj_dim, False, frame_shape(ds), cfg.seed).to(
        device=device, dtype=dtype)
    net.load_state_dict(sd)
    net.eval()
    m, preds = cfg.fr_margin, []
    with torch.no_grad():
        for of_np, traj_np, _ in ds:
            num = traj_np.shape[0] - 2 * m
            of, _ = prepare_of(of_np, cfg.fr_num + 30, np.float32,
                               pad_channels=False)
            x = pad_flow_channels(torch.from_numpy(of).to(device).to(dtype))
            preds.append(net(x)[m:m + num, 0].cpu())
    return torch.cat(preds)


def phase_statereg_test(device):
    """state_reg --mode test on the checkpoint statereg_train wrote (every
    take through the net on the card, per-take trajectory assembly), and
    the card's float32 predictions for the first take against the port's
    CPU float64 run of the same checkpoint, within STATEREG_TOL relative
    RMS."""
    import pickle
    import torch
    from egopose_tpu_torch.cli import state_reg
    t0 = time.time()
    results = state_reg.main(["--cfg", STATEREG, "--mode", "test", "--iter",
                              str(STATEREG_EPOCHS), "--synthetic",
                              "--device", str(device)])
    wall = time.time() - t0
    with open(os.path.join("results", "statereg", STATEREG, "results",
                           "iter_%04d_test.p" % STATEREG_EPOCHS), "rb") as f:
        _, meta = pickle.load(f)
    card = take_predictions(device, torch.float32)
    t0 = time.time()
    cpu = take_predictions(torch.device("cpu"), torch.float64)
    cpu_s = time.time() - t0
    err = rel_rms(card, cpu)
    finite = bool(all(np.isfinite(a).all()
                      for a in results["traj_pred"].values()))
    rec = dict(takes_assembled=len(results["traj_pred"]),
               frames=meta["num_sample"], loss=meta["epoch_loss"],
               wall_s=wall, take0_frames=int(card.shape[0]),
               take0_rel_rms_vs_cpu_f64=err, tol=STATEREG_TOL,
               cpu_f64_s=cpu_s, finite=finite)
    ok = bool(finite and len(results["traj_pred"]) == 4
              and np.isfinite(meta["epoch_loss"]) and err <= STATEREG_TOL)
    emit("statereg_test", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"statereg_test out of bounds: {rec}")
    return rec


def phase_statereg_stats():
    """eval_pose --algo state_reg on the results pickle statereg_test
    wrote (host numpy): finite pose, velocity and acceleration metrics for
    each of the 4 takes."""
    import io
    from egopose_tpu_torch.cli import eval_pose
    with contextlib.redirect_stdout(io.StringIO()):
        stats = eval_pose.main(["--algo", "state_reg", "--statereg-cfg",
                                STATEREG, "--statereg-iter",
                                str(STATEREG_EPOCHS), "--data", "test"])
    keys = ("pose_dist", "vel_dist", "accel")
    finite = bool(np.isfinite([stats[k] for k in keys]).all()
                  and all(np.isfinite([v[k] for k in keys]).all()
                          for v in stats["per_take"].values()))
    rec = dict(takes=len(stats["per_take"]), finite=finite,
               **{k: stats[k] for k in keys})
    ok = finite and len(stats["per_take"]) == 4
    emit("statereg_stats", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"statereg_stats out of bounds: {rec}")
    return rec

def feature_batch_split(sd, cfg, state_dim, device, batch=256):
    """gen_cnn_feature's work on one batch of the first take, each section
    in its own profiler session (SectionProfiler), after a warm-up batch:
    the host's read and padding to ``batch`` frames, the copy to the card,
    the CNN's forward and the features' copy back."""
    import torch
    from egopose_tpu_torch.cli.state_reg import make_net, pad_flow_channels
    from egopose_tpu_torch.data.dataset import Dataset
    saved = os.environ["EGOPOSE_SYN_TAKES"]
    os.environ["EGOPOSE_SYN_TAKES"] = "1"
    try:
        ds = Dataset("synthetic", "all", 0, "iter", False, 0, synthetic=True)
    finally:
        os.environ["EGOPOSE_SYN_TAKES"] = saved
    net = make_net(cfg, state_dim, False, frame_shape(ds), cfg.seed).to(
        device)
    net.load_state_dict(sd)
    net.eval()
    marks = None
    with torch.no_grad():
        for _ in range(2):                  # warm-up, then the timed one
            split = SectionProfiler()
            of = ds.load_of(0, 0, ds.msync[ds.takes[0]][2])
            of = np.concatenate([of, np.repeat(of[-1:], batch - len(of), 0)])
            split.mark("host_read_and_pad")
            frames = torch.from_numpy(of).to(device)
            split.mark("host_to_device_copy")
            feats = net.cnn_feature(pad_flow_channels(frames))
            split.mark("cnn_forward")
            feats.cpu()
            split.mark("device_to_host_copy")
            marks = split.close()
    return marks


def phase_gen_cnn_feature(device):
    """gen_cnn_feature over the 4 synthetic takes at 224x224 in batches of
    256 frames on the card; the first batch's features against the port's
    CPU float64 CNN on the same frames, within STATEREG_TOL relative
    RMS."""
    import pickle
    import torch
    from egopose_tpu_torch.cli import gen_cnn_feature
    from egopose_tpu_torch.cli.state_reg import load_state_net, make_net
    from egopose_tpu_torch.utils.config import StateRegConfig
    stamps, first = [], []

    def hook(take, start, frames, feats):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), frames.shape[0]))
        if not first:
            first.extend([frames.cpu(), feats.cpu()])
    gen_cnn_feature.main(["--meta-id", "synthetic", "--out-id", "smoke",
                          "--statereg-cfg", STATEREG, "--statereg-iter",
                          str(STATEREG_EPOCHS), "--batch", "256",
                          "--synthetic", "--device", str(device)],
                         batch_hook=hook)
    with open(os.path.join("datasets", "features", "cnn_feat_smoke.p"),
              "rb") as f:
        feats, mean = pickle.load(f)
    cfg = StateRegConfig(STATEREG)
    sd, _ = load_state_net(cfg, os.path.join(
        cfg.model_dir, "iter_%04d.p" % STATEREG_EPOCHS), no_cnn=False)
    net = make_net(cfg, mean.size, False, tuple(first[0].shape[1:]),
                   cfg.seed).double()
    net.load_state_dict(sd)
    net.eval()
    t0 = time.time()
    with torch.no_grad():
        ref = net.cnn_feature(first[0].double())
    cpu_s = time.time() - t0
    err = rel_rms(first[1], ref)
    split = feature_batch_split(sd, cfg, mean.size, device)
    # frames/s over every batch after the first (its time holds cuDNN's
    # first calls)
    frames = sum(n for _, n in stamps[1:])
    fps = frames / (stamps[-1][0] - stamps[0][0])
    shapes = {t: list(a.shape) for t, a in feats.items()}
    finite = bool(all(np.isfinite(a).all() for a in feats.values()))
    rec = dict(takes=shapes, batches=len(stamps), frames_per_s=fps,
               batch_split=split,
               batch0_rel_rms_vs_cpu_f64=err, tol=STATEREG_TOL,
               cpu_f64_s=cpu_s, finite=finite)
    ok = bool(finite and len(feats) == 4 and err <= STATEREG_TOL
              and all(s == [240, cfg.cnn_fdim] for s in shapes.values()))
    emit("gen_cnn_feature", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"gen_cnn_feature out of bounds: {rec}")
    return rec


def phase_statereg_eval(device):
    """The state net STATEREG_EVAL (the shipped widths at cnn_fdim 64)
    trained STATEREG_EPOCHS epochs on the 224x224 synthetic flow and saved
    with save_inf, then ego_mimic_eval --cfg subject_03 --synthetic --iter
    3000 on the card (4 takes x 380 steps, one K1 launch a step)
    re-anchored on it: its initial states and every fail-safe reset come
    from the state net's predictions.  Holds the state net's predictions
    on the card against the port's CPU float64 run of the same net on the
    same features (STATEREG_TOL relative RMS) and the first control step
    against the plain f64 step on its own inputs (K1's f32 bar).
    pose_dist and num_reset are printed, not gated: the state net is
    STATEREG_EPOCHS epochs old and learned another synthetic world."""
    import torch
    from egopose_tpu_torch.cli import ego_mimic_eval, state_reg
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.cli.eval_pose import compute_stats
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    t0 = time.time()
    state_reg.main(["--cfg", STATEREG_EVAL, "--mode", "train", "--synthetic",
                    "--max-epoch", str(STATEREG_EPOCHS), "--device",
                    str(device)])
    state_reg.main(["--cfg", STATEREG_EVAL, "--mode", "save_inf", "--iter",
                    str(STATEREG_EPOCHS), "--synthetic", "--device",
                    str(device)])
    train_s = time.time() - t0
    first = []
    reset_counts()
    t0 = time.time()
    results, meta = ego_mimic_eval.main(
        EVAL_ARGS + ["--device", str(device)],
        phys_hook=first_step_hook(first))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    stats = compute_stats(results)
    cfg = EgoMimicConfig("subject_03")
    feats = build_world(cfg, torch.float32, "cpu", synthetic=True)[-1]
    card = ego_mimic_eval.state_net_pred(cfg, feats, device, torch.float32)
    ref = ego_mimic_eval.state_net_pred(cfg, feats, torch.device("cpu"),
                                        torch.float64)
    err = rel_rms(card.cpu(), ref)
    step_ok, step_rec = first_step_vs_plain(
        first, lambda f, dt, dev: step_inputs(f, cfg, dt, dev))
    others = {k: v for k, v in counts.items() if k != "k1"}
    finite = bool(all(np.isfinite(np.asarray(a)).all()
                      for key in ("traj_pred", "vel_pred")
                      for a in results[key].values()))
    rec = dict(state_net=STATEREG_EVAL, state_net_train_s=train_s,
               frames_per_sec=meta["frames_per_sec"], wall_s=wall,
               steps=meta["steps"], k1_launches=counts["k1"],
               other_launches=others, num_reset=meta["num_reset"],
               pose_dist=stats["pose_dist"], vel_dist=stats["vel_dist"],
               accel=stats["accel"], avg_reward=meta["avg_reward"],
               state_net_rel_rms_vs_cpu_f64=err, tol=STATEREG_TOL,
               first_step=step_rec, finite=finite)
    ok = bool(counts["k1"] == meta["steps"] and not any(others.values())
              and err <= STATEREG_TOL and step_ok and finite)
    emit("statereg_eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"statereg_eval out of bounds: {rec}")
    return rec


def phase_statereg_variants(device, dataset, cfg):
    """One training step each of cnn_type mobile (with the bi-LSTM) and of
    v_net tcn (v_net_param's default [64, 128], non-causal and causal, with
    ResNet-18) at the shipped widths, on the first batch of statereg_train's
    dataset: finite losses; ms and peak memory of each step."""
    import torch
    from egopose_tpu_torch.cli.state_reg import (host_batches, make_net,
                                                 to_device, train_step)
    from egopose_tpu_torch.utils.config import StateRegConfig
    batch = to_device(next(host_batches(
        dataset, 4, cfg["fr_margin"], dataset.traj_dim, np.float32,
        np.float32, pin=True)), device)
    out, ok = {}, True
    for name, over in (("mobile_lstm", dict(cnn_type="mobile")),
                       ("resnet_tcn", dict(v_net="tcn")),
                       ("resnet_tcn_causal", dict(v_net="tcn",
                                                  causal=True))):
        vcfg = StateRegConfig(STATEREG, cfg_dict=dict(cfg, **over))
        net = make_net(vcfg, dataset.traj_dim, False, frame_shape(dataset),
                       vcfg.seed).to(device)
        opt = torch.optim.Adam(net.parameters(), lr=vcfg.lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(train_step(net, opt, *batch[:3], vcfg.fr_margin,
                                torch.float32))
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(loss=loss, first_step_ms=ms,
                         peak_memory_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30)
        ok = ok and bool(np.isfinite(loss))
        del net, opt
    emit("statereg_variants", ok=ok, **out)
    if not ok:
        raise AssertionError(f"statereg_variants not finite: {out}")
    return out


# ---------------------------------------------------------------------------
# In-the-wild evaluation: the synthetic world standing in for wild video
# ---------------------------------------------------------------------------

WILD_FEAT = "wild_syn"
# Max-abs bar of the card's float32 2D projection (K5) against the CPU
# float64 one, in the metric's units (the ground truth's shoulder-to-hip
# height is 0.5): float32 FK rounds at ~1e-7 m over ~1 m of body, ~1e-6
# of that height; the bar is 100x that.
WILD_TOL = 1e-4


def phase_wild_setup():
    """The wild world, written into the working directory from the
    synthetic mimic world (host only, float64): its 4 takes x 400 frames
    of 64 CNN features as datasets/features/cnn_feat_wild_syn.p =
    (features, None), keyed wild_00 ... wild_03, and every frame of each
    take's expert projected by the port's Pose2DContext into the
    OpenPose-25 layout (x 100 + 300, tests/test_wild_eval.py's scale) as
    datasets/tpv/poses/<take>/%05d_keypoints.json."""
    import pickle
    import torch
    from egopose_tpu_torch.cli.eval_pose_wild import keypoint_file
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    from egopose_tpu_torch.utils.pose2d import JOINTS_MAP, Pose2DContext
    t0 = time.time()
    cfg = EgoMimicConfig("subject_03")
    spec, model, _, _, expert, feats = build_world(cfg, torch.float64, "cpu",
                                                   synthetic=True)
    takes = ["wild_%02d" % i for i in range(feats.shape[0])]
    os.makedirs(os.path.join(cfg.data_dir, "features"), exist_ok=True)
    with open(os.path.join(cfg.data_dir, "features",
                           f"cnn_feat_{WILD_FEAT}.p"), "wb") as f:
        pickle.dump((dict(zip(takes, feats)), None), f)
    ctx = Pose2DContext(model, spec)
    n_files = 0
    for i, take in enumerate(takes):
        os.makedirs(os.path.dirname(keypoint_file(cfg.data_dir, take, 0)))
        p2 = ctx.project_traj(expert.qpos[i].numpy()) * 100.0 + 300.0
        for fr in range(p2.shape[0]):
            kp = np.zeros(25 * 3)
            for op_idx, body in JOINTS_MAP:
                kp[3 * op_idx:3 * op_idx + 3] = [*p2[fr, ctx.body2id[body]],
                                                 1.0]
            with open(keypoint_file(cfg.data_dir, take, fr), "w") as f:
                json.dump({"people": [{"pose_keypoints_2d": kp.tolist()}]},
                          f)
            n_files += 1
    rec = dict(takes=len(takes), frames=int(feats.shape[1]),
               feature_dim=int(feats.shape[2]), keypoint_files=n_files,
               seconds=time.time() - t0)
    emit("wild_setup", ok=True, **rec)
    return rec


def phase_wild_eval(device):
    """state_reg --mode test --test-feat wild_syn on the STATEREG_EVAL net
    (the statereg wild results), then ego_mimic_eval_wild --cfg subject_03
    --iter 3000 --test-feat wild_syn on the card, re-anchored on that net:
    4 takes x 380 steps, one K1 launch a step and no other kernel, all
    outputs finite, the first control step within K1's f32 bar of the
    plain f64 step on its own inputs.  frames/s, the wall time, the resets
    per take and the steady-state ms a step over WINDOW are printed, not
    gated."""
    import torch
    from egopose_tpu_torch.cli import ego_mimic_eval_wild, state_reg
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    t0 = time.time()
    sr = state_reg.main(["--cfg", STATEREG_EVAL, "--mode", "test",
                         "--test-feat", WILD_FEAT, "--iter",
                         str(STATEREG_EPOCHS), "--synthetic", "--device",
                         str(device)])
    sr_s = time.time() - t0
    first, marks = [], []
    reset_counts()
    t0 = time.time()
    results, meta = ego_mimic_eval_wild.main(
        ["--cfg", "subject_03", "--iter", "3000", "--test-feat", WILD_FEAT,
         "--device", str(device)],
        step_hook=window_hook(marks), phys_hook=first_step_hook(first))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    cfg = EgoMimicConfig("subject_03")
    step_ok, step_rec = first_step_vs_plain(
        first, lambda f, dt, dev: step_inputs(f, cfg, dt, dev))
    others = {k: v for k, v in counts.items() if k != "k1"}
    finite = bool(all(np.isfinite(a).all()
                      for res in (results, sr) for key in res
                      for a in res[key].values()))
    rec = dict(takes=len(results["traj_pred"]), steps=meta["steps"],
               k1_launches=counts["k1"], other_launches=others,
               frames_per_sec=meta["frames_per_sec"], wall_s=wall,
               window=list(WINDOW),
               window_step_ms=(marks[1] - marks[0]) * 1e3
               / (WINDOW[1] - WINDOW[0]),
               num_reset=meta["num_reset_per_take"],
               statereg_test_s=sr_s, first_step=step_rec, finite=finite)
    ok = bool(counts["k1"] == meta["steps"] and not any(others.values())
              and step_ok and finite)
    emit("wild_eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"wild_eval out of bounds: {rec}")
    return dict(rec, results=results)


def wild_projection_err(card, cpu, traj_pred, data_dir, margin):
    """Max over every frame of every take, and over its keypoints, of the
    distance between the card's aligned projection (``card``, a
    Pose2DContext on the card) and the CPU's (``cpu``), in the metric's
    units, against the keypoints eval_pose_wild reads for that frame."""
    from egopose_tpu_torch.cli.eval_pose_wild import keypoint_file
    worst = 0.0
    for take, traj in traj_pred.items():
        pk, pc = card.project_traj(traj), cpu.project_traj(traj)
        for fr in range(traj.shape[0]):
            gt = cpu.load_gt_pose(keypoint_file(data_dir, take,
                                                fr + margin))
            d = cpu.align_qpos(None, gt, p=pk[fr]) \
                - cpu.align_qpos(None, gt, p=pc[fr])
            worst = max(worst, float(np.linalg.norm(d, axis=1).max()
                                     * cpu.dist_scale(gt)))
    return worst


def k5_at(m, traj, device):
    """K5's ms (events), device ms and bound on a trajectory's frames."""
    import torch
    from egopose_tpu_torch.physics import fk
    q = torch.as_tensor(traj).to(device=device, dtype=torch.float32)
    return dict(B=int(q.shape[0]), ms=time_ms(lambda: fk.fk_cuda(m, q)),
                device_ms=device_ms(lambda: fk.fk_cuda(m, q),
                                    KERNEL_KEYS["k5"]),
                **bound(*k5_work(m, q.shape[0], 4)))


def phase_wild_stats(device, em_results):
    """eval_pose_wild --egomimic-cfg subject_03 --egomimic-iter 3000
    --statereg-cfg STATEREG_EVAL --data wild_syn on the card: one K5
    launch per take and algorithm (the whole take's 2D projection), no
    other kernel; both metrics finite; the card's float32 projection of
    every frame of both results within WILD_TOL of the CPU float64
    projection in the metric's units.  Both algorithms' pose dist and
    accels are printed, and K5's time on one take's frames."""
    import io
    import pickle
    import torch
    from egopose_tpu_torch.cli import eval_pose_wild
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        out = eval_pose_wild.main(
            ["--egomimic-cfg", "subject_03", "--egomimic-iter", "3000",
             "--statereg-cfg", STATEREG_EVAL, "--statereg-iter",
             str(STATEREG_EPOCHS), "--data", WILD_FEAT, "--device",
             str(device)])
    torch.cuda.synchronize()
    counts = read_counts()
    cfg = EgoMimicConfig("subject_03")
    with open(os.path.join("results", "statereg", STATEREG_EVAL, "results",
                           "iter_%04d_%s.p" % (STATEREG_EPOCHS, WILD_FEAT)),
              "rb") as f:
        sr_results = pickle.load(f)[0]
    card = eval_pose_wild.pose_context(cfg.mujoco_model, device)
    cpu = eval_pose_wild.pose_context(cfg.mujoco_model, "cpu", torch.float64)
    err = max(wild_projection_err(card, cpu, res["traj_pred"], cfg.data_dir,
                                  cfg.fr_margin)
              for res in (em_results, sr_results))
    n_takes = len(em_results["traj_pred"])
    others = {k: v for k, v in counts.items() if k != "k5"}
    finite = bool(np.isfinite([out["ego_mimic"], out["state_reg"]]).all())
    rec = dict(takes=n_takes, k5_launches=counts["k5"],
               other_launches=others,
               ego_mimic=dict(zip(("pose_dist", "accels"), out["ego_mimic"])),
               state_reg=dict(zip(("pose_dist", "accels"), out["state_reg"])),
               projection_max_abs_err=err, tol=WILD_TOL,
               k5=k5_at(card.model, next(iter(
                   em_results["traj_pred"].values())), device),
               finite=finite)
    ok = bool(counts["k5"] == 2 * n_takes and not any(others.values())
              and err <= WILD_TOL and finite)
    emit("wild_stats", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"wild_stats out of bounds: {rec}")
    return rec


def wild_forecast_checkpoint(device, forecast_ckpt):
    """results/egoforecast/FORECAST/models/iter_FORECAST_ITERS.p: the
    bytes forecast_train wrote (``forecast_ckpt``), or without them the
    warm start from the mimic iter_3000.p saved as a forecast checkpoint.
    Returns which."""
    from egopose_tpu_torch.cli import ego_forecast
    path = os.path.join("results", "egoforecast", FORECAST, "models",
                        "iter_%04d.p" % FORECAST_ITERS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if forecast_ckpt is not None:
        with open(path, "wb") as f:
            f.write(forecast_ckpt)
        return "forecast_train"
    ego_forecast.main(["--cfg", FORECAST, "--synthetic", "--device",
                       str(device), "--batch-lanes", "4", "--max-iter",
                       "0"]).save(path)
    return "warm_start"


def phase_wild_forecast_eval(device, forecast_ckpt=None):
    """ego_forecast_eval_wild --cfg subject_03_syn --test-feat wild_syn
    --egomimic-iter 3000 on the card, on forecast_train's checkpoint (the
    warm start without it): every window of the 4 wild takes one lane of
    one batch, 90 K1 launches and no other kernel, the first control step
    within K1's f32 bar of the plain f64 step on its own inputs, finite
    outputs, the window count the lane rule's; frames/s printed."""
    import pickle
    import torch
    from egopose_tpu_torch.cli import ego_forecast_eval_wild as efw
    from egopose_tpu_torch.utils.config import (EgoForecastConfig,
                                                EgoMimicConfig)
    source = wild_forecast_checkpoint(device, forecast_ckpt)
    first = []
    reset_counts()
    results, meta = efw.main(
        ["--cfg", FORECAST, "--iter", str(FORECAST_ITERS), "--test-feat",
         WILD_FEAT, "--egomimic-iter", "3000", "--device", str(device)],
        step_hook=first_step_hook(first))
    torch.cuda.synchronize()
    counts = read_counts()
    cfg = EgoForecastConfig(FORECAST)
    em_cfg = EgoMimicConfig(cfg.ego_mimic_cfg)
    with open(os.path.join(em_cfg.result_dir,
                           "iter_3000_%s.p" % WILD_FEAT), "rb") as f:
        em_traj = pickle.load(f)[0]["traj_pred"]
    from egopose_tpu_torch.cli.ego_mimic_eval_wild import load_wild_features
    feats = load_wild_features(cfg, WILD_FEAT)
    want = len(efw.wild_window_lanes(list(feats), feats, em_traj,
                                     cfg.fr_margin, em_cfg.fr_margin,
                                     cfg.env_episode_len)[0])
    step_ok, step_rec = first_step_vs_plain(first)
    others = {k: v for k, v in counts.items() if k != "k1"}
    finite = bool(all(np.isfinite(a).all()
                      for a in results["traj_pred"].values()))
    steps = cfg.env_episode_len
    rec = dict(checkpoint=source, windows=meta["n_windows"],
               lane_rule_windows=want, control_steps=steps,
               k1_launches=counts["k1"], other_launches=others,
               wall_s=meta["wall_s"], frames_per_sec=meta["frames_per_sec"],
               first_step=step_rec, finite=finite)
    ok = bool(counts["k1"] == steps and not any(others.values())
              and step_ok and finite and meta["n_windows"] == want)
    emit("wild_forecast_eval", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"wild_forecast_eval out of bounds: {rec}")
    return dict(rec, results=results)


def phase_wild_forecast_stats(device, fc_results):
    """eval_forecast_wild --horizons 30 90 on the card: one K5 launch per
    take with windows (all its windows' frames at once) and no other
    kernel, finite metrics; both horizons printed, and K5's time on one
    take's windows."""
    import io
    import torch
    from egopose_tpu_torch.cli import eval_forecast_wild
    from egopose_tpu_torch.cli.eval_pose_wild import pose_context
    from egopose_tpu_torch.utils.config import EgoForecastConfig
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        out = eval_forecast_wild.main(
            ["--egoforecast-cfg", FORECAST, "--egoforecast-iter",
             str(FORECAST_ITERS), "--data", WILD_FEAT, "--horizons", "30",
             "90", "--device", str(device)])
    torch.cuda.synchronize()
    counts = read_counts()
    with_windows = [w for w in fc_results["traj_pred"].values()
                    if w.shape[0]]
    others = {k: v for k, v in counts.items() if k != "k5"}
    finite = bool(np.isfinite(list(out.values())).all())
    ctx = pose_context(EgoForecastConfig(FORECAST).mujoco_model, device)
    rec = dict(takes_with_windows=len(with_windows),
               k5_launches=counts["k5"], other_launches=others,
               horizons={h: dict(zip(("pose_dist", "accels"), v))
                         for h, v in out.items()},
               k5=k5_at(ctx.model, with_windows[0].reshape(
                   -1, with_windows[0].shape[-1]), device),
               finite=finite)
    ok = bool(counts["k5"] == len(with_windows) and not any(others.values())
              and finite)
    emit("wild_forecast_stats", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"wild_forecast_stats out of bounds: {rec}")
    return rec


AB_PHASES = "k1_time,k1_dense_time,k2_time,k3_time,k4_time,k5_time"


def run_ab(parent_dir, phases=AB_PHASES):
    """Every kernel's times of a parent checkout (``parent_dir``, holding
    its own chip_smoke.py) and of this tree in turns, parent, tree, tree,
    parent: each a subprocess running ``--only`` ``phases`` (AB_PHASES
    unless ``--only`` is given beside ``--ab``), which builds its own
    kernels.  Records each phase's ``ms``, ``ms_b2b`` and ``device_ms`` at
    each B, keyed by the whole phase name (the parent's phases must print
    ``device_ms``: 649cfae and later do).  Prints one ``ab`` line per run
    and one summary line; returns 0 when every run passed."""
    runs = []
    for who in ("parent", "tree", "tree", "parent"):
        root = parent_dir if who == "parent" else REPO
        out = subprocess.run(
            [sys.executable, os.path.join(root, "chip_smoke.py"), "--only",
             phases], cwd=root, capture_output=True, text=True,
            timeout=900)
        recs = [json.loads(x) for x in out.stdout.splitlines()
                if x.startswith('{"phase": "k')]
        times = {f"{r['phase']}_B{r['B']}_{f}": r[f] for r in recs
                 for f in ("ms", "ms_b2b", "device_ms") if f in r}
        runs.append(dict(who=who, rc=out.returncode, **times))
        emit("ab", **runs[-1])
    keys = sorted({k for r in runs for k in r
                   if k.endswith(("_ms", "_ms_b2b"))})
    summary = {k: dict(parent=[r.get(k) for r in runs
                               if r["who"] == "parent"],
                       tree=[r.get(k) for r in runs if r["who"] == "tree"])
               for k in keys}
    emit("ab_summary", parent_dir=os.path.relpath(parent_dir, REPO),
         order=[r["who"] for r in runs], **summary)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


def main():
    if "--ab" in sys.argv:
        root = os.path.abspath(sys.argv[sys.argv.index("--ab") + 1])
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            return 2
        return run_ab(root, *(sys.argv[sys.argv.index("--only") + 1:][:1]
                              if "--only" in sys.argv else ()))
    only = sys.argv[sys.argv.index("--only") + 1].split(",") \
        if "--only" in sys.argv else None
    want = lambda p: only is None or p in only
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import egopose_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from egopose_tpu_torch.physics import nvcc
    device = torch.device("cuda", 0)
    count_world_builds()
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    from egopose_tpu_torch.physics import substep
    t0 = time.time()
    from egopose_tpu_torch.physics import linalg
    libs = nvcc.build_all(nvcc.SOURCES + (
        ("substep.cu", (substep.CLOCKS_DEFINE,)),
        ("fused_contact.cu", (linalg.CLOCKS_DEFINE,))), verbose=True)
    emit("build", seconds=time.time() - t0,
         libraries=[os.path.relpath(lib, REPO) for lib in libs])
    errs = phase_k1_vs_plain(device) if want("k1_vs_plain") else {}
    times = phase_k1_time(device) if want("k1_time") else {}
    errs1d = phase_k1_dense_vs_plain(device) \
        if want("k1_dense_vs_plain") else {}
    times1d = phase_k1_dense_time(device) if want("k1_dense_time") else {}
    if want("k1_stages"):
        phase_k1_stages(device)
    ev = phase_eval(device) if want("eval") else None
    if want("eval_profile"):
        phase_eval_profile(device, ev["window_step_ms"] if ev else None)
    rv = phase_render_eval(device) if want("render_eval") else None
    if want("engine_mujoco"):
        phase_engine_mujoco(device)
    errs2 = phase_k2_vs_plain(device) if want("k2_vs_plain") else {}
    times2 = phase_k2_time(device) if want("k2_time") else {}
    errs3 = phase_fused_vs_plain(device, "k3") if want("k3_vs_plain") else {}
    errs4 = phase_fused_vs_plain(device, "k4") if want("k4_vs_plain") else {}
    errs5 = phase_k5_vs_plain(device) if want("k5_vs_plain") else {}
    times3 = phase_fused_time(device, "k3") if want("k3_time") else {}
    times4 = phase_fused_time(device, "k4") if want("k4_time") else {}
    times5 = phase_k5_time(device) if want("k5_time") else {}
    lstm_rec = phase_lstm(device) if want("lstm") else {}
    if want("data_pipeline"):
        phase_data_pipeline(device)
    ge = phase_gen_expert(device) if want("gen_expert") else None
    if want("k34_stages"):
        phase_k34_stages(device)
    steps = {}
    if want("pd_fused_step"):
        add_counts(steps, phase_pd_fused_step(device))
    if want("fused_solver_step"):
        add_counts(steps, phase_fused_solver_step(device))
    if want("split_step"):
        add_counts(steps, phase_split_step(device))
    tr = phase_train(device) if want("train") else None
    tq = phase_train_torque(device) if want("train_torque") else None
    tp = phase_train_profile(device) if want("train_profile") else None
    objectives = [
        phase_train_trpo(device, tr, tp) if want("train_trpo") else None,
        phase_train_a2c(device, tr, tp) if want("train_a2c") else None,
        phase_train_vgail(device) if want("train_vgail") else None,
        phase_resume_native(device) if want("resume_native") else None,
        phase_f64_ckpt_f32_eval(device)
        if want("f64_ckpt_f32_eval") else None]
    dpt = phase_dp_train(device) if want("dp_train") else None
    dp2 = phase_dp_two_ranks(device, smi) if want("dp_two_ranks") else None
    spe = phase_sp_encode(device) if want("sp_encode") else None
    dry = phase_dryrun(device) if want("dryrun") else None
    rp = phase_rollout_pd_fused(device) if want("rollout_pd_fused") else None
    rt = phase_rollout_torque_fused(device) \
        if want("rollout_torque_fused") else None
    rd = phase_rollout_dense(device) if want("rollout_dense") else None
    ft = fe = forecast_ckpt = None
    if any(want(p) for p in ("forecast_train", "forecast_eval",
                             "forecast_stats", "vis_headless")):
        with forecast_workdir() as fcfg:
            ft = phase_forecast_train(device, fcfg) \
                if want("forecast_train") else None
            if ft is not None:      # carried to phase wild_forecast_eval
                with open(os.path.join(
                        "results", "egoforecast", FORECAST, "models",
                        "iter_%04d.p" % FORECAST_ITERS), "rb") as f:
                    forecast_ckpt = f.read()
            # vis_headless reads forecast_eval's results
            fe = phase_forecast_eval(
                device, fcfg, ev["em_results"] if ev else None) \
                if want("forecast_eval") or want("vis_headless") else None
            if want("forecast_stats"):
                phase_forecast_stats()
            if want("vis_headless"):
                phase_vis_headless()
    se = we = ws = wfe = wfs = None
    statereg = ("statereg_train", "statereg_test", "statereg_stats",
                "gen_cnn_feature", "statereg_eval", "statereg_variants")
    # each wild phase reads what the phase it names wrote, so asking for
    # one runs those first
    wild_reads = dict(wild_eval="wild_setup", wild_stats="wild_eval",
                      wild_forecast_eval="wild_eval",
                      wild_forecast_stats="wild_forecast_eval")
    wild = ("wild_setup", *wild_reads)

    def need(p):
        return want(p) or any(need(q) for q, r in wild_reads.items()
                              if r == p)
    if any(want(p) for p in statereg + wild):
        # every statereg phase reads statereg_train's checkpoint or data,
        # so it runs first whenever one of them is asked for; the wild
        # phases read statereg_eval's state net
        with statereg_workdir() as scfg:
            net, dataset = phase_statereg_train(device, scfg)
            del net
            if want("statereg_test") or want("statereg_stats"):
                phase_statereg_test(device)
            if want("statereg_stats"):
                phase_statereg_stats()
            if want("gen_cnn_feature"):
                phase_gen_cnn_feature(device)
            if want("statereg_eval") or any(want(p) for p in wild):
                se = phase_statereg_eval(device)
            if need("wild_setup"):
                phase_wild_setup()
            if need("wild_eval"):
                we = phase_wild_eval(device)
            if need("wild_stats"):
                ws = phase_wild_stats(device, we["results"])
            if need("wild_forecast_eval"):
                wfe = phase_wild_forecast_eval(device, forecast_ckpt)
            if need("wild_forecast_stats"):
                wfs = phase_wild_forecast_stats(device, wfe["results"])
            if want("statereg_variants"):
                phase_statereg_variants(device, dataset, scfg)
    if only is None:
        t4, t2 = times[4], times2[1024]
        fused = lambda key: rp["launches"][key] + rt["launches"][key] \
            + rd["launches"][key] + steps[key]

        def row(name, source, replaces, launches, err, t):
            return dict(name=name, route="cuda",
                        source="egopose_tpu_torch/csrc/" + source,
                        replaces="egopose_tpu/physics/" + replaces,
                        launches=launches, max_abs_err=err, ms=t["ms"],
                        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                        bound_by=t["bound_by"], library_ms=t["library_ms"])
        print(json.dumps({"kernels": [
            row("substep_control_step", "substep.cu", "substep_pallas.py:694",
                ev["launches"] + tr["k1_launches"] + tq["k1_launches"]
                + tp["k1_launches"] + rv["k1_launches"]
                + sum(r["k1_launches"] for r in objectives)
                + fused("k1") + ft["k1_launches"]
                + sum(r["k1_launches"] for r in fe.values())
                + se["k1_launches"] + we["k1_launches"]
                + wfe["k1_launches"] + dpt["k1_launches"]
                + dp2["k1_launches"] + spe["k1_launches"]
                + dry["k1_launches"],
                errs["float32"], t4),
            row("substep_control_step_dense", "substep.cu",
                "substep_pallas.py:784", fused("k1_dense"), errs1d["float32"],
                times1d[1024]),
            row("batched_spd_solve", "spd_solve.cu", "linalg_pallas.py:163",
                ev["k2_launches"] + tr["k2_launches"] + tq["k2_launches"]
                + fused("k2"), errs2["float32"], t2),
            row("fused_contact_solve", "fused_contact.cu",
                "linalg_pallas.py:360", fused("k3"), errs3["float32"],
                times3[1024]),
            row("pd_fused_substep", "fused_contact.cu",
                "linalg_pallas.py:495", fused("k4"), errs4["float32"],
                times4[1024]),
            row("fk_batched", "fk.cu", "fk_pallas.py:67",
                fused("k5") + ws["k5_launches"] + wfs["k5_launches"]
                + ge["k5_launches"] + sum(WORLD_K5) + dp2["k5_launches"]
                + dry["k5_launches"],
                errs5["float32"], times5[1024]),
            dict(name="lstm_recurrence", route="cuda",
                 source="egopose_tpu_torch/csrc/lstm.cu",
                 replaces="none: egopose_tpu/models/rnn.py's lax.scan",
                 launches_in_updates=sum(tr["k6_update_launches"])
                 + sum(ft["k6_update_launches"]),
                 **{k: lstm_rec["egomimic_update"][k]
                    for k in ("errors", "fwd_device_ms", "bwd_device_ms",
                              "jvp_device_ms", "pass_ms", "plain_pass_ms",
                              "library_ms", "fwd", "bwd", "jvp")})]}),
              flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
