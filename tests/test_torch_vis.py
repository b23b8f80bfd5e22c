"""The vis modes of egopose_tpu_torch against the JAX package's, headless on
the CPU:

- TrajectoryViewer.update_pose of both packages, for each vis model of
  the family (1, 2 and N humanoid copies), after the same key sequences:
  data.qpos within 1e-12; each key of docs/keymap.md leaves both viewers
  in the same state;
- save_replay and render_qpos_video's npz (the fallback without a GL
  renderer): arrays equal to JAX's;
- Pose2DContext.draw_pose on the same canvas and pose: the same image;
- wild_fpv_tpv_video with no image folders (the keypoint panel on a blank
  canvas): the same frames as JAX's within 1 grey level;
- the headless view_or_render_windows and the eval_pose / eval_forecast
  vis modes, the viewer patched to raise as on a display-less host
  (tests/test_vis_modes.py), against the JAX package's files.

``pytest.importorskip`` guards the tests that draw (cv2) or read keycodes
(glfw).  The offscreen renderer is never constructed in this process by
the port (utils/render.py probes it in a child process), so the JAX
package's first attempt stays a catchable one.
"""
import glob
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "assets", "mujoco_models")
XML = os.path.join(MODELS, "humanoid_1205_v1.xml")
NQ = 59
VIS_MODELS = ["humanoid_1205_vis_single_v1", "humanoid_1205_vis_double_v1",
              "humanoid_1205_vis_ghost_v1", "humanoid_1205_vis_estimate_v1",
              "humanoid_1205_vis_forecast_v1", "humanoid_1205_vis_multi_v1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(t_len, seed):
    """(t_len, nq) qpos of a pose that walks and turns, joints swaying."""
    rng = np.random.RandomState(seed)
    q = np.zeros((t_len, NQ))
    fr = np.arange(t_len)
    q[:, 0] = 0.03 * fr
    q[:, 1] = 0.01 * fr + rng.randn()
    q[:, 2] = 0.9
    yaw = 0.05 * fr + rng.randn()
    q[:, 3], q[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    q[:, 4] = 0.05 * np.sin(0.1 * fr)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * np.sin(0.2 * fr[:, None] + np.arange(52)) \
        + 0.01 * rng.randn(t_len, 52)
    return q


def _results(t_len=40, n_takes=2, windows=None, seed=0):
    res = {}
    for i in range(n_takes):
        if windows is None:
            pred, orig = _walk(t_len, seed + 2 * i), _walk(t_len,
                                                           seed + 2 * i + 1)
        else:
            pred = np.stack([_walk(t_len, seed + 10 * i + w)
                             for w in range(windows)])
            orig = np.stack([_walk(t_len, seed + 10 * i + w + 5)
                             for w in range(windows)])
        res[f"take_{i}"] = {"pred": pred, "orig": orig}
    return res


def _viewers(model, algos):
    from egopose_tpu.envs.visual import TrajectoryViewer as JViewer
    from egopose_tpu_torch.envs.visual import TrajectoryViewer
    xml = os.path.join(MODELS, f"{model}.xml")
    return JViewer(xml, algos), TrajectoryViewer(xml, algos)


STATE = ("fr", "paused", "reverse", "speed", "stop", "take_ind", "traj_ind",
         "algo_ind", "show_gt", "mfr_int")


def _same(jv, tv):
    for key in STATE:
        assert getattr(tv, key) == getattr(jv, key), key
    assert tv.n_windows() == jv.n_windows()
    np.testing.assert_allclose(tv.data.qpos, jv.data.qpos, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("model", VIS_MODELS)
@pytest.mark.parametrize("fr", [0, 17, 39])
def test_update_pose_matches_jax(model, fr):
    """Puppeting at frame ``fr``, prediction and ground truth, every vis
    model (multi: staggered, heading-aligned copies clipped at the end)."""
    algos = [("em", _results())]
    jv, tv = _viewers(model, algos)
    assert tv.n_copies == jv.n_copies
    for show_gt in (False, True):
        for v in (jv, tv):
            v.fr, v.show_gt = fr, show_gt
            v.update_pose()
        _same(jv, tv)
    assert np.abs(tv.data.qpos).max() > 0


KEYS = ["SPACE", "LEFT", "RIGHT", "W", "S", "D", "F", "R", "Z", "C", "Q",
        "E", "X", "V", "1", "2", "0", "MINUS", "EQUAL", "P"]


@pytest.mark.parametrize("key", KEYS)
def test_key_contract_matches_jax(key, tmp_path, monkeypatch):
    """From a paused viewer on frame 5 of the second window of a forecast
    result set (two sets, two takes): each key (and a key outside the map)
    twice, then the puppeted qpos, on both packages' viewers."""
    glfw = pytest.importorskip("glfw")
    monkeypatch.chdir(tmp_path)       # x / v write under out/ where they can
    for model in ("humanoid_1205_vis_double_v1",
                  "humanoid_1205_vis_forecast_v1"):
        res = _results(t_len=30, windows=3)
        jv, tv = _viewers(model, [("ef", res), ("sr", _results(
            t_len=30, windows=3, seed=9))])
        code = getattr(glfw, "KEY_" + key)
        for v in (jv, tv):
            v.key_callback(glfw.KEY_SPACE)
            v.key_callback(glfw.KEY_E)
            for _ in range(5):
                v.key_callback(glfw.KEY_RIGHT)
            v.key_callback(code)
            v.key_callback(code)
            v.update_pose()
        _same(jv, tv)


def test_save_replay_matches_jax(tmp_path):
    from egopose_tpu.utils.render import save_replay as jsave
    from egopose_tpu_torch.utils.render import save_replay
    pred = {t: r["pred"] for t, r in _results().items()}
    orig = {"take_0": _walk(40, 9)}
    a = np.load(save_replay(str(tmp_path / "t.npz"), pred, orig))
    b = np.load(jsave(str(tmp_path / "j.npz"), pred, orig))
    assert sorted(a.files) == sorted(b.files) == [
        "orig__take_0", "pred__take_0", "pred__take_1"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_render_qpos_video_fallback_matches_jax(tmp_path):
    """No GL renderer here: both write the trajectories as an npz next to
    the video path, and return its path."""
    from egopose_tpu.utils.render import render_qpos_video as jrender
    from egopose_tpu_torch.utils.render import render_qpos_video
    trajs = [_walk(12, 0), _walk(12, 1)]
    got = render_qpos_video(trajs, str(tmp_path / "t.mp4"))
    want = jrender(trajs, str(tmp_path / "j.mp4"))
    assert got == str(tmp_path / "t.npz") and want == str(tmp_path / "j.npz")
    a, b = np.load(got), np.load(want)
    assert sorted(a.files) == sorted(b.files) == ["traj_0", "traj_1"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_offscreen_failure_is_cached():
    """After one failed probe every later call raises at once, without
    constructing a renderer."""
    from egopose_tpu_torch.utils import render
    if render._OFFSCREEN_BROKEN is False:
        pytest.skip("this host has a GL renderer")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="offscreen renderer"):
            render.make_offscreen_renderer(None)
    assert render._OFFSCREEN_BROKEN


@pytest.fixture(scope="module")
def contexts():
    import jax
    import jax.numpy as jnp
    from egopose_tpu.physics import build_model, engine, parse_mjcf
    from egopose_tpu.utils import pose2d as jpose2d
    from egopose_tpu_torch.physics.model import build_model as tbuild
    from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
    from egopose_tpu_torch.utils.pose2d import Pose2DContext
    # the JAX context's per-frame FK, jitted: the same function, ~0.7 s a
    # frame eager on the CPU
    mp = pytest.MonkeyPatch()
    mp.setattr(jpose2d, "engine", type("E", (), {"fk": jax.jit(engine.fk)}))
    spec = parse_mjcf(XML)
    tspec = tparse(XML)
    yield (jpose2d.Pose2DContext(build_model(spec, dtype=jnp.float32), spec),
           Pose2DContext(tbuild(tspec, dtype=torch.float32), tspec))
    mp.undo()


@pytest.mark.parametrize("flip", [False, True])
def test_draw_pose_matches_jax(contexts, flip):
    pytest.importorskip("cv2")
    jctx, tctx = contexts
    rng = np.random.RandomState(4)
    pose = rng.uniform(20, 340, size=(tctx.nbody, 3))
    a = np.full((360, 360, 3), 32, np.uint8)
    b = a.copy()
    tctx.draw_pose(a, pose, flip=flip)
    jctx.draw_pose(b, pose, flip=flip)
    assert (a != 32).any()
    np.testing.assert_array_equal(a, b)


class _Log:
    def __init__(self):
        self.msgs = []

    def info(self, msg):
        self.msgs.append(msg)


def test_wild_fpv_tpv_video_matches_jax(contexts, tmp_path, monkeypatch):
    """The keypoint panel on the blank canvas (no image folders, no GL):
    the port's frames (one projection of the take) within 1 grey level of
    the JAX package's (one projection a frame), channels as cv2 draws
    them; a traj_ub and a flip from the meta."""
    pytest.importorskip("cv2")
    from egopose_tpu.utils import render as jrender
    from egopose_tpu.utils.vis_modes import wild_fpv_tpv_video as jvideo
    from egopose_tpu_torch.utils import render
    from egopose_tpu_torch.utils.vis_modes import wild_fpv_tpv_video
    jctx, tctx = contexts
    monkeypatch.chdir(tmp_path)
    frames = {}
    for name, mod in (("jax", jrender), ("torch", render)):
        monkeypatch.setattr(mod, "_write_video",
                            lambda f, path, fps, bgr=False, name=name:
                            frames.setdefault(name, (np.stack(f), bgr)))
    cfg = type("Cfg", (), {"fr_margin": 5,
                           "mujoco_model": "humanoid_1205_v1"})()
    meta = {"traj_ub": {"w1": 9}, "tpv_flip": {"w1": True}}
    traj = _walk(12, 3)
    log = _Log()
    wild_fpv_tpv_video(traj, "w1", tctx, cfg, meta, "t.mp4", log)
    jvideo(traj, "w1", jctx, cfg, meta, "j.mp4", _Log())
    (a, bgr_a), (b, bgr_b) = frames["torch"], frames["jax"]
    assert bgr_a and bgr_b and a.shape == b.shape == (9, 360, 360, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert (a != 32).any()
    assert any("keypoint panels only" in m for m in log.msgs)


def _no_display(monkeypatch):
    """Both packages' TrajectoryViewer raise, as on a display-less host."""
    import egopose_tpu.envs.visual as jvis
    import egopose_tpu_torch.envs.visual as tvis

    class _NoDisplay:
        def __init__(self, *a, **k):
            raise RuntimeError("forced headless (test)")

    monkeypatch.setattr(jvis, "TrajectoryViewer", _NoDisplay)
    monkeypatch.setattr(tvis, "TrajectoryViewer", _NoDisplay)


def _equal_npz(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_view_or_render_windows_matches_jax(tmp_path, monkeypatch):
    """The forecast-window vis headless: the replay npz of every window
    and the first window's trajectories, equal to JAX's, and the cause
    logged; zero windows log a line and write nothing."""
    from egopose_tpu.utils.vis_modes import view_or_render_windows as jview
    from egopose_tpu_torch.utils.vis_modes import view_or_render_windows
    _no_display(monkeypatch)
    monkeypatch.chdir(REPO)           # the vis model's asset resolution
    win = _results(t_len=9, windows=2)
    results = {"traj_pred": {t: r["pred"] for t, r in win.items()},
               "traj_orig": {"take_0": win["take_0"]["orig"]}}
    log = _Log()
    got = view_or_render_windows(results, str(tmp_path / "t.p"), log)
    want = jview(results, str(tmp_path / "j.p"), _Log())
    assert got == str(tmp_path / "t.npz") and want == str(tmp_path / "j.npz")
    _equal_npz(got, want)
    _equal_npz(tmp_path / "t_replay.npz", tmp_path / "j_replay.npz")
    replay = np.load(tmp_path / "t_replay.npz")
    np.testing.assert_array_equal(replay["orig__take_1"],
                                  win["take_1"]["pred"])
    assert any("forced headless (test)" in m for m in log.msgs)
    empty = {"traj_pred": {"t1": np.zeros((0, 5, NQ))}, "traj_orig": {}}
    assert view_or_render_windows(empty, str(tmp_path / "e.p"), log) is None
    assert not glob.glob(str(tmp_path / "e*"))


def _pickle(path, results):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((results, {"algo": "x"}), f)


def test_eval_pose_vis_matches_jax(tmp_path, monkeypatch):
    """eval_pose --mode vis headless, with a state-reg result set beside
    the ego-mimic one: the first take's trajectories, equal to JAX's."""
    from egopose_tpu.cli import eval_pose as jeval
    from egopose_tpu_torch.cli import eval_pose
    _no_display(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = _results(t_len=8)
    results = {"traj_pred": {t: r["pred"] for t, r in res.items()},
               "traj_orig": {t: r["orig"] for t, r in res.items()}}
    em = "results/egomimic/em/results/iter_0002_test.p"
    _pickle(em, results)
    _pickle("results/statereg/sr/results/iter_0001_test.p", results)
    argv = ["--egomimic-cfg", "em", "--egomimic-iter", "2", "--statereg-cfg",
            "sr", "--statereg-iter", "1", "--mode", "vis"]
    got = eval_pose.main(argv + ["--multi"])
    assert got == em.replace(".p", ".npz")
    os.rename(got, "port.npz")
    jeval.main(argv + ["--multi"])
    _equal_npz("port.npz", got)
    np.testing.assert_array_equal(np.load(got)["traj_1"],
                                  results["traj_orig"]["take_0"])


def test_eval_forecast_vis_matches_jax(tmp_path, monkeypatch):
    """eval_forecast --mode vis headless: the first window of the first
    take, after remove_noisy_hands, equal to JAX's."""
    from egopose_tpu.cli import eval_forecast as jeval
    from egopose_tpu_torch.cli import eval_forecast
    _no_display(monkeypatch)
    cfg = yaml.safe_load(open(f"{REPO}/config/egoforecast/subject_03.yml"))
    cfg.update(dict(fr_margin=3, env_episode_len=5))
    cfg.pop("meta_id", None)
    (tmp_path / "config/egoforecast").mkdir(parents=True)
    with open(tmp_path / "config/egoforecast/tiny_vis.yml", "w") as f:
        yaml.dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    win = _results(t_len=8, windows=2)
    path = "results/egoforecast/tiny_vis/results/iter_0000_test.p"
    _pickle(path, {"traj_pred": {t: r["pred"] for t, r in win.items()},
                   "traj_orig": {t: r["orig"] for t, r in win.items()}})
    argv = ["--egoforecast-cfg", "tiny_vis", "--mode", "vis"]
    got = eval_forecast.main(argv)
    assert got == path.replace(".p", ".npz")
    os.rename(got, "port.npz")
    want = jeval.main(argv)
    _equal_npz("port.npz", want)
