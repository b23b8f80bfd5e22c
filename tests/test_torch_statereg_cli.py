"""The port's state-regression CLIs against the JAX package's, end to end
on the CPU in float32 at a tiny size (the default 32x32 synthetic flow, 2
takes x 60 frames, ResNet-18 with a bi-LSTM of width 16, chunks of 24
frames, 2 chunks a step), each package in its own temporary directory:

- state_reg train: both packages train 2 epochs from the same --iter 1
  checkpoint (written by the port, so the JAX CLI loads the port's
  checkpoint); their per-epoch losses agree within 1e-3 relative (float32
  rounding, amplified by Adam's normalised steps);
- test mode: the JAX CLI on the port's checkpoint and the port on the JAX
  CLI's give the predictions each package gives on its own (5e-5 relative
  to the largest; the same float32 net in two libraries);
- save_inf: the port writes, from the JAX CLI's checkpoint, the JAX CLI's
  inference checkpoint exactly;
- gen_cnn_feature: the port's pickle against the JAX CLI's (same takes,
  shapes and mean; features within 1e-5 relative);
- the port's own options: --data-on-device gives the streamed run's
  losses, --transfer-dtype f16 runs, --profile-dir writes a trace,
  --dp-devices refuses chunks that do not split over the ranks, and
  without CUDA the CLIs raise;
- ego_mimic_eval re-anchored on a state net (a state_net_cfg whose
  iter_%04d_inf.p exists) against the JAX eval, float64, 2 takes x 40
  frames, with the naive fail-safe resetting to its predictions at every
  step: trajectories within 1e-6, equal resets."""
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = dict(fr_num=24, fr_margin=3, v_hdim=16, cnn_fdim=12, mlp_dim=[24],
          save_model_interval=1, seed=5)
TRAIN = ["--cfg", "tiny", "--mode", "train", "--synthetic",
         "--batch-chunks", "2"]
CPU = ["--device", "cpu"]
MODELS = os.path.join("results", "statereg", "tiny", "models")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workdir(root):
    os.makedirs(root / "config" / "statereg")
    cfg = yaml.safe_load(open(f"{REPO}/config/statereg/subject_03.yml"))
    cfg.update(SR)
    with open(root / "config" / "statereg" / "tiny.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    return root


def _epoch_losses(root):
    log = open(root / "results" / "statereg" / "tiny" / "log" /
               "log.txt").read()
    return {int(e): float(l) for e, l in
            re.findall(r"epoch\s+(\d+)\s+time .* loss (\S+)\s+frames/s", log)}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Two working directories, 'jax' and 'port', each trained 2 epochs
    from the port's 1-epoch checkpoint."""
    from egopose_tpu.cli import state_reg as jsr
    from egopose_tpu_torch.cli import state_reg as tsr
    mp = pytest.MonkeyPatch()
    mp.setenv("EGOPOSE_SYN_LEN", "60")
    jdir = _workdir(tmp_path_factory.mktemp("jax"))
    tdir = _workdir(tmp_path_factory.mktemp("port"))
    try:
        mp.chdir(tdir)
        tsr.main(TRAIN + CPU + ["--max-epoch", "1"])
        os.makedirs(jdir / MODELS)
        shutil.copy(tdir / MODELS / "iter_0001.p", jdir / MODELS)
        tsr.main(TRAIN + CPU + ["--iter", "1", "--max-epoch", "3"])
        mp.chdir(jdir)
        jsr.main(TRAIN + ["--iter", "1", "--max-epoch", "3"])
        yield jdir, tdir, mp
    finally:
        mp.undo()


def test_training_from_one_checkpoint_matches_jax(dirs):
    jdir, tdir, _ = dirs
    lj, lt = _epoch_losses(jdir), _epoch_losses(tdir)
    assert sorted(lj) == [1, 2] and sorted(lt) == [0, 1, 2]
    for epoch in (1, 2):
        assert abs(lt[epoch] - lj[epoch]) <= 1e-3 * abs(lj[epoch]), \
            (epoch, lt[epoch], lj[epoch])
    for d in (jdir, tdir):
        assert os.path.exists(d / MODELS / "iter_0003.p")


def _test_mode(main, root, mp, extra=()):
    mp.chdir(root)
    return main(["--cfg", "tiny", "--mode", "test", "--iter", "3",
                 "--synthetic", *extra])


def _assert_preds_close(a, b, tol):
    assert sorted(a["traj_pred"]) == sorted(b["traj_pred"])
    for take in a["traj_pred"]:
        x, y = a["traj_pred"][take], b["traj_pred"][take]
        assert x.shape == y.shape == (54, 59)
        assert np.abs(x - y).max() <= tol * np.abs(y).max(), take
        np.testing.assert_array_equal(a["traj_orig"][take],
                                      b["traj_orig"][take])


def test_test_mode_loads_each_others_checkpoints(dirs, tmp_path):
    from egopose_tpu.cli import state_reg as jsr
    from egopose_tpu_torch.cli import state_reg as tsr
    jdir, tdir, mp = dirs
    own_t = _test_mode(tsr.main, tdir, mp, CPU)
    jax_on_port = _test_mode(jsr.main, tdir, mp)      # reads the port's
    _assert_preds_close(jax_on_port, own_t, 5e-5)
    own_j = _test_mode(jsr.main, jdir, mp)
    port_on_jax = _test_mode(tsr.main, jdir, mp, CPU)  # reads the JAX one's
    _assert_preds_close(port_on_jax, own_j, 5e-5)
    with open(jdir / "results" / "statereg" / "tiny" / "results" /
              "iter_0003_test.p", "rb") as f:
        saved, meta = pickle.load(f)
    assert meta["algo"] == "state_reg" and meta["num_sample"] == 108
    assert set(saved) == {"traj_pred", "traj_orig"}


def test_save_inf_writes_the_jax_checkpoint(dirs):
    from egopose_tpu.cli import state_reg as jsr
    from egopose_tpu_torch.cli import state_reg as tsr
    import jax
    jdir, _, mp = dirs
    mp.chdir(jdir)
    args = ["--cfg", "tiny", "--mode", "save_inf", "--iter", "3",
            "--synthetic"]
    path = jdir / MODELS / "iter_0003_inf.p"
    jsr.main(args)
    with open(path, "rb") as f:
        want = pickle.load(f)
    tsr.main(args + CPU)
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert set(got[0]["state_net_dict"]) == {"params"}
    assert not any(k.startswith("cnn") for k in
                   got[0]["state_net_dict"]["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, got[0], want[0])
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got[1][key], want[1][key])
    assert got[1]["cfg_id"] == want[1]["cfg_id"] == "tiny"


def test_gen_cnn_feature_matches_jax(dirs):
    from egopose_tpu.cli import gen_cnn_feature as jgen
    from egopose_tpu_torch.cli import gen_cnn_feature as tgen
    jdir, _, mp = dirs
    mp.chdir(jdir)
    args = ["--meta-id", "x", "--statereg-cfg", "tiny", "--statereg-iter",
            "3", "--batch", "32", "--synthetic"]
    jgen.main(args + ["--out-id", "j"])
    tgen.main(args + ["--out-id", "t"] + CPU)
    load = lambda name: pickle.load(open(
        jdir / "datasets" / "features" / f"cnn_feat_{name}.p", "rb"))
    (fj, mean_j), (ft, mean_t) = load("j"), load("t")
    np.testing.assert_array_equal(mean_t, mean_j)
    assert sorted(ft) == sorted(fj) == ["synthetic_00", "synthetic_01"]
    for take in fj:
        assert ft[take].shape == fj[take].shape == (60, 12)
        assert ft[take].dtype == np.float32
        assert np.abs(ft[take] - fj[take]).max() \
            <= 1e-5 * np.abs(fj[take]).max(), take


def test_port_training_options(dirs, tmp_path):
    from egopose_tpu_torch.cli import state_reg as tsr
    _, _, mp = dirs
    runs = {}
    for name, extra in (("stream", []), ("resident", ["--data-on-device"]),
                        ("f16", ["--transfer-dtype", "f16",
                                 "--profile-dir", "prof"])):
        root = _workdir(tmp_path / name)
        mp.chdir(root)
        tsr.main(TRAIN + CPU + ["--max-epoch", "2"] + extra)
        runs[name] = _epoch_losses(root)
    assert runs["resident"] == runs["stream"]
    assert runs["f16"] != runs["stream"]
    assert abs(runs["f16"][1] - runs["stream"][1]) \
        <= 1e-2 * runs["stream"][1]
    assert os.path.exists(tmp_path / "f16" / "prof" / "trace.json")
    with pytest.raises(SystemExit, match="--batch-chunks 2 not divisible "
                       "by --dp-devices 3"):
        tsr.main(TRAIN + CPU + ["--dp-devices", "3"])


@pytest.mark.parametrize("cli", ["state_reg", "gen_cnn_feature"])
def test_cli_without_cuda_raises(dirs, monkeypatch, cli):
    import importlib
    mod = importlib.import_module(f"egopose_tpu_torch.cli.{cli}")
    jdir, _, mp = dirs
    mp.chdir(jdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = TRAIN if cli == "state_reg" else \
        ["--meta-id", "x", "--out-id", "z", "--statereg-cfg", "tiny",
         "--statereg-iter", "3", "--synthetic"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


# -- ego_mimic_eval re-anchored on a state net ------------------------------

EVAL = ["--cfg", "reanchor", "--synthetic", "--iter", "800", "--f64",
        "--fail-safe", "naivefs"]
RESULT = os.path.join("results", "egomimic", "reanchor", "results",
                      "iter_0800_test_naivefs.p")


def _eval_dir(root, inf_cp):
    """config/egomimic/reanchor.yml (subject_03 with state_net_cfg
    'sr_eval', iter 7), config/statereg/sr_eval.yml (a no-CNN width of the
    synthetic world's 64 features), the state net's iter_0007_inf.p and
    the committed mimic checkpoint."""
    os.makedirs(root / "config" / "egomimic")
    os.makedirs(root / "config" / "statereg")
    em = yaml.safe_load(open(f"{REPO}/config/egomimic/subject_03.yml"))
    em.update(state_net_cfg="sr_eval", state_net_iter=7)
    em.pop("meta_id", None)
    yaml.safe_dump(em, open(root / "config" / "egomimic" / "reanchor.yml",
                            "w"))
    sr = yaml.safe_load(open(f"{REPO}/config/statereg/subject_03.yml"))
    sr.update(v_hdim=8, cnn_fdim=64, mlp_dim=[16], fr_margin=10)
    yaml.safe_dump(sr, open(root / "config" / "statereg" / "sr_eval.yml",
                            "w"))
    models = root / "results" / "statereg" / "sr_eval" / "models"
    os.makedirs(models)
    with open(models / "iter_0007_inf.p", "wb") as f:
        pickle.dump(inf_cp, f)
    os.makedirs(root / "results" / "egomimic" / "reanchor")
    os.symlink(f"{REPO}/results/egomimic/subject_03/models",
               root / "results" / "egomimic" / "reanchor" / "models")
    return root


@pytest.fixture(scope="module")
def reanchored(tmp_path_factory):
    """Both evals on one state net: a no_cnn VideoRegNet with fresh
    weights, written by the port in the JAX layout, with a mean and std
    that put its predictions near one lying pose."""
    from egopose_tpu.cli import ego_mimic_eval as jeval
    from egopose_tpu_torch.cli import ego_mimic_eval as teval
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.cli.state_reg import make_net
    from egopose_tpu_torch.convert import video_reg_net_to_jax
    from egopose_tpu_torch.utils.config import EgoMimicConfig, StateRegConfig
    mp = pytest.MonkeyPatch()
    mp.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
    mp.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    try:
        mp.chdir(REPO)
        cfg = EgoMimicConfig("subject_03")
        _, _, _, _, expert, _ = build_world(cfg, torch.float64, "cpu",
                                            synthetic=True)
        kin = torch.cat([teval.kinematic_state_pred(expert, i)
                         for i in range(expert.qpos.shape[0])]).numpy()
        net = make_net(StateRegConfig("subject_03", cfg_dict=dict(
            v_hdim=8, cnn_fdim=64, mlp_dim=[16])), kin.shape[1], True,
            (224, 224, 3), seed=3)
        # the experts' mean pose laid on the floor (root 0.15 m high,
        # turned 90 degrees about x): the head starts below the naive
        # fail-safe's 0.3 m, so every step re-anchors to the prediction
        mean = kin.mean(0)
        mean[0], mean[1:5] = 0.15, [0.7071, 0.7071, 0.0, 0.0]
        inf_cp = ({"state_net_dict": video_reg_net_to_jax(net.state_dict())},
                  {"mean": mean, "std": np.full(kin.shape[1], 0.01),
                   "cfg_id": "sr_eval"})
        out = {}
        for name, main, extra in (("jax", jeval.main, []),
                                  ("port", teval.main, CPU)):
            root = _eval_dir(tmp_path_factory.mktemp(name), inf_cp)
            mp.chdir(root)
            out[name] = main(EVAL + extra)
        # the state net's own predictions (port, float64) on the world
        em = EgoMimicConfig("reanchor")
        feats = build_world(em, torch.float64, "cpu", synthetic=True)[-1]
        out["pred"] = teval.state_net_pred(em, feats, "cpu", torch.float64)
        yield out
    finally:
        mp.undo()


def test_reanchored_eval_matches_jax(reanchored):
    (res_j, meta_j), (res_t, meta_t) = reanchored["jax"], reanchored["port"]
    # every step but the last of each take re-anchors
    assert meta_t["num_reset"] == meta_j["num_reset"] == 2 * 19
    for i, take in enumerate(sorted(res_j["traj_pred"])):
        assert res_t["traj_pred"][take].shape == (20, 59)
        np.testing.assert_allclose(res_t["traj_pred"][take],
                                   res_j["traj_pred"][take], rtol=0,
                                   atol=1e-6, err_msg=take)
        # the run starts from the state net's prediction at frame
        # fr_margin: its joint angles are the prediction's
        np.testing.assert_allclose(res_t["traj_pred"][take][0, 7:],
                                   reanchored["pred"][i, 10, 5:57].numpy(),
                                   rtol=0, atol=1e-12)
