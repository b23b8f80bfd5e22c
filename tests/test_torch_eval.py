"""The port's inference slice against the JAX package's: ego_mimic_eval on
the committed iter_0800.p checkpoint, both on the CPU in float64, at a
reduced synthetic size (2 takes x 40 frames), then eval_pose's
compute_stats.  traj_pred agrees to 1e-6 over the run (the two packages
differ by rounding only; the largest seed is XLA's float32 sqrt of the
checkpoint's float32 observation statistics, one ulp from IEEE), num_reset
is equal, the stats agree to 1e-6, and the results pickle has the same
layout.  Outputs go to a temporary directory."""
import os
import pickle

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--cfg", "subject_03", "--synthetic", "--iter", "800", "--f64"]
RESULT = os.path.join("results", "egomimic", "subject_03", "results",
                      "iter_0800_test.p")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores, and the port's small
    CPU tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_in(workdir, fn, length=40):
    """Run ``fn`` with cwd = workdir (config/ and the committed models
    linked in) and the reduced synthetic size (2 takes x ``length``
    frames), restoring both after."""
    os.makedirs(os.path.join(workdir, "results", "egomimic", "subject_03"))
    os.symlink(os.path.join(REPO, "config"), os.path.join(workdir, "config"))
    os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                            "models"),
               os.path.join(workdir, "results", "egomimic", "subject_03",
                            "models"))
    env = {"EGOPOSE_SYNTHETIC_TAKES": "2",
           "EGOPOSE_SYNTHETIC_LEN": str(length)}
    saved = {k: os.environ.get(k) for k in env}
    cwd = os.getcwd()
    os.environ.update(env)
    os.chdir(workdir)
    try:
        out = fn()
        with open(RESULT, "rb") as f:
            return out, pickle.load(f)
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from egopose_tpu.cli import ego_mimic_eval as jeval
    from egopose_tpu_torch.cli import ego_mimic_eval as teval
    jax_run = _run_in(str(tmp_path_factory.mktemp("jax")),
                      lambda: jeval.main(ARGS))
    torch_run = _run_in(str(tmp_path_factory.mktemp("torch")),
                        lambda: teval.main(ARGS + ["--device", "cpu"]))
    return jax_run, torch_run


def test_eval_trajectories_match_jax(runs):
    ((res_j, meta_j), _), ((res_t, meta_t), _) = runs
    assert sorted(res_t["traj_pred"]) == sorted(res_j["traj_pred"])
    assert len(res_t["traj_pred"]) == 2
    for take in res_j["traj_pred"]:
        assert res_t["traj_pred"][take].shape == (20, 59)
        np.testing.assert_allclose(res_t["traj_pred"][take],
                                   res_j["traj_pred"][take], rtol=0,
                                   atol=1e-6, err_msg=take)
        np.testing.assert_array_equal(res_t["traj_orig"][take],
                                      res_j["traj_orig"][take])
    assert meta_t["num_reset"] == meta_j["num_reset"]


def test_eval_stats_match_jax(runs):
    from egopose_tpu.cli.eval_pose import compute_stats as jstats
    from egopose_tpu_torch.cli.eval_pose import compute_stats as tstats
    (_, (saved_j, _)), (_, (saved_t, _)) = runs
    sj, st = jstats(saved_j), tstats(saved_t)
    for key in ("pose_dist", "vel_dist", "accel"):
        assert abs(st[key] - sj[key]) <= 1e-6 * max(1.0, abs(sj[key])), key
    # the same function of the same results, to rounding
    same = tstats(saved_j)
    for key in ("pose_dist", "vel_dist", "accel"):
        assert abs(same[key] - sj[key]) <= 1e-9, key


def test_results_pickle_layout(runs):
    (_, (saved_j, meta_j)), (_, (saved_t, meta_t)) = runs
    assert set(saved_t) == set(saved_j)
    assert set(meta_j) <= set(meta_t)
    assert meta_t["device"] == "cpu" and meta_t["steps"] == 20


def test_eval_flags_change_behaviour(tmp_path):
    """The port's ego_mimic_eval flags (float32, CPU, 2 takes x 26 frames):
    --sync adds the expert re-expressed in the sim frame, --causal and
    --show-noise change the rollout and --causal / --fail-safe tag the
    results file, --expert-ind slices one take, --render with --sync
    writes the viewer's replay of the prediction and the synced expert;
    --sp-devices (not ported) raises."""
    from egopose_tpu_torch.cli import ego_mimic_eval as teval
    base = ["--cfg", "subject_03", "--synthetic", "--iter", "800",
            "--device", "cpu"]
    runs = {}

    def go():
        # --sync only adds a result: its rollout is the plain one
        for name, extra in (("plain", ["--sync", "--render"]),
                            ("causal", ["--causal"]),
                            ("naivefs", ["--fail-safe", "naivefs"]),
                            ("one", ["--expert-ind", "1"]),
                            ("noise", ["--show-noise"])):
            runs[name] = teval.main(base + extra)
        with pytest.raises(NotImplementedError):
            teval.main(base + ["--sp-devices", "2"])
        tags = sorted(os.listdir(os.path.dirname(RESULT)))
        assert tags == ["iter_0800_test.p", "iter_0800_test_causal.p",
                        "iter_0800_test_naivefs.p",
                        "iter_0800_test_replay.npz"], tags
        runs["replay"] = dict(np.load(RESULT.replace(".p", "_replay.npz")))

    _run_in(str(tmp_path), go, length=26)
    plain = runs["plain"][0]
    take = sorted(plain["traj_pred"])[0]
    assert "traj_orig_synced" not in runs["causal"][0]
    synced = plain["traj_orig_synced"]
    for t in synced:
        assert synced[t].shape == plain["traj_orig"][t].shape
        np.testing.assert_array_equal(runs["replay"][f"pred__{t}"],
                                      plain["traj_pred"][t])
        np.testing.assert_array_equal(runs["replay"][f"orig__{t}"],
                                      synced[t])
        np.testing.assert_allclose(synced[t][:, 7:],
                                   plain["traj_orig"][t][:, 7:], atol=1e-6)
    for name in ("causal", "noise"):
        assert np.abs(runs[name][0]["traj_pred"][take]
                      - plain["traj_pred"][take]).max() > 1e-6, name
    one = runs["one"][0]
    assert list(one["traj_pred"]) == ["take_1"]
    np.testing.assert_array_equal(one["traj_orig"]["take_1"],
                                  plain["traj_orig"]["take_1"])
    assert runs["naivefs"][1]["num_reset"] >= 0
