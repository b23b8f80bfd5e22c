"""The port's mocap parsers, MJCF exports and the create_humanoid /
convert_clip CLIs against the JAX package's, on the CPU in float64:

- Bvh, Skeleton.load_from_bvh / load_from_asf: the same joints, bones,
  offsets, channels, limits and hierarchy (tests/test_mocap.py's texts);
- load_bvh_file, interpolated_traj and load_amc_file within 1e-12;
- Skeleton.write_xml, export_mjcf, export_vis_mjcf for every VIS_VARIANTS
  entry, write_vis_family and HUMANOID_TEMPLATE: identical text;
- create_humanoid then convert_clip --device cpu, each package in its own
  working directory, on a seeded BVH of 121 frames at 120 Hz: the same
  XML file and trajectories within 1e-12, with unit root quaternions.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from test_mocap import AMC_TEXT, ASF_TEXT, BVH_TEXT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_bvh(n_frames=121, seed=0):
    """tests/test_mocap.py's hierarchy with a LeftLeg child (dropped by
    convert_clip's EXCLUDE_BONES: "Toe") and seeded motion: a moving root
    with all three rotations, the joints within +-60 degrees."""
    rng = np.random.RandomState(seed)
    head = BVH_TEXT.split("MOTION")[0].replace(
        """    End Site
    {
      OFFSET 0.0 0.0 -8.0
    }""", """    JOINT LeftToe
    {
      OFFSET 0.0 1.0 -8.0
      CHANNELS 3 Xrotation Yrotation Zrotation
      End Site
      {
        OFFSET 0.0 1.0 0.0
      }
    }""")
    t = np.arange(n_frames)[:, None] / 120.0
    frames = np.hstack([
        np.hstack([t * 10, np.sin(t) * 5, 36 + np.cos(3 * t)]),
        rng.uniform(-90, 90, 3) + 40 * np.sin(2 * t + rng.uniform(0, 6, 3)),
        rng.uniform(-60, 60, (1, 12)) + 20 * np.sin(
            t * rng.uniform(1, 4, 12) + rng.uniform(0, 6, 12))])
    rows = "\n".join(" ".join("%.6f" % v for v in r) for r in frames)
    return (f"{head}MOTION\nFrames: {n_frames}\nFrame Time: 0.008333\n"
            f"{rows}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mocap")
    out = {}
    for name, ext, text in (("bvh", "bvh", BVH_TEXT),
                            ("seeded", "bvh", seeded_bvh()),
                            ("amc", "amc", AMC_TEXT),
                            ("asf", "asf", ASF_TEXT)):
        out[name] = str(d / f"clip_{name}.{ext}")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def _joint_record(j):
    return (j.name, None if j.parent is None else j.parent.name, j.offset,
            list(j.channels), j.channel_offset, j.end_site,
            [c if isinstance(c, dict) else c.name for c in j.children])


@pytest.mark.parametrize("which", ["bvh", "seeded"])
def test_bvh_matches_jax(files, which):
    from egopose_tpu.mocap import Bvh as JBvh
    from egopose_tpu_torch.mocap import Bvh
    text = open(files[which]).read()
    a, b = Bvh(text), JBvh(text)
    assert a.get_joints_names() == b.get_joints_names()
    assert [_joint_record(j) for j in a.joints] \
        == [_joint_record(j) for j in b.joints]
    assert a.nframes == b.nframes and a.frame_time == b.frame_time
    np.testing.assert_array_equal(a.frames, b.frames)
    name = a.get_joints_names()[1]
    assert a.frame_joint_channels(1, name, a.joint_channels(name)) \
        == b.frame_joint_channels(1, name, b.joint_channels(name))


EXACT = ("id", "name", "channels", "dof_index", "parent", "child")
NUMERIC = ("len", "lb", "ub", "orient", "dir", "offset", "pos", "end")


def _assert_same_skeleton(a, b):
    assert (a.mass_scale, a.len_scale, a.root.name) \
        == (b.mass_scale, b.len_scale, b.root.name)
    assert len(a.bones) == len(b.bones)
    name = lambda x: None if x is None else x.name
    for x, y in zip(a.bones, b.bones):
        for key in EXACT:
            vx, vy = getattr(x, key), getattr(y, key)
            if key == "parent":
                vx, vy = name(vx), name(vy)
            elif key == "child":
                vx, vy = list(map(name, vx)), list(map(name, vy))
            elif key in ("channels", "dof_index"):
                vx, vy = list(vx), list(vy)
            assert vx == vy, (x.name, key)
        for key in NUMERIC:
            np.testing.assert_allclose(
                np.asarray(getattr(x, key), float),
                np.asarray(getattr(y, key), float), rtol=0, atol=TOL,
                err_msg=f"{x.name}.{key}")


def _skeletons(load, path, *args, **kw):
    from egopose_tpu.mocap import Skeleton as JSkeleton
    from egopose_tpu_torch.mocap import Skeleton
    out = []
    for cls in (Skeleton, JSkeleton):
        sk = cls()
        getattr(sk, load)(path, *args, **kw)
        out.append(sk)
    return out


@pytest.mark.parametrize("which,spec_args", [
    ("bvh", False), ("seeded", False), ("seeded", True)])
def test_skeleton_from_bvh_matches_jax(files, which, spec_args):
    from egopose_tpu_torch.cli.convert_clip import (EXCLUDE_BONES,
                                                    SPEC_CHANNELS)
    args = (EXCLUDE_BONES, SPEC_CHANNELS) if spec_args else ()
    a, b = _skeletons("load_from_bvh", files[which], *args)
    _assert_same_skeleton(a, b)
    if spec_args:
        assert "LeftToe" not in a.name2bone
        assert a.name2bone["LeftLeg"].channels == ["Xrotation"]


@pytest.mark.parametrize("swap_axes", [False, True])
def test_skeleton_from_asf_matches_jax(files, swap_axes):
    a, b = _skeletons("load_from_asf", files["asf"], swap_axes=swap_axes)
    _assert_same_skeleton(a, b)
    assert [x.name for x in a.bones] == ["root", "lowerback", "upperback"]


def test_pose_loaders_match_jax(files):
    from egopose_tpu import mocap as J
    from egopose_tpu_torch import mocap as P
    a, b = _skeletons("load_from_bvh", files["seeded"])
    pa, addr_a = P.load_bvh_file(files["seeded"], a)
    pb, addr_b = J.load_bvh_file(files["seeded"], b)
    assert addr_a == addr_b and pa.shape == (121, 6 + 12)
    np.testing.assert_allclose(pa, pb, rtol=0, atol=TOL)
    for sample_t, fr in ((1 / 30, 120), (1 / 240, 120), (0.03, 100)):
        ta = P.interpolated_traj(pa, sample_t, mocap_fr=fr)
        tb = J.interpolated_traj(pb, sample_t, mocap_fr=fr)
        assert ta.shape == tb.shape
        np.testing.assert_allclose(ta, tb, rtol=0, atol=TOL)
    np.testing.assert_allclose(P.lin_interp(pa[0], pa[1], 0.25),
                               J.pose.lin_interp(pb[0], pb[1], 0.25),
                               rtol=0, atol=TOL)
    for scale in (0.5, 0.0254):
        qa, aa = P.load_amc_file(files["amc"], scale)
        qb, ab = J.load_amc_file(files["amc"], scale)
        assert aa == ab
        np.testing.assert_allclose(qa, qb, rtol=0, atol=TOL)


@pytest.mark.parametrize("template", [False, True])
def test_write_xml_matches_jax(files, tmp_path, template):
    tpl = os.path.join(REPO, "assets", "mujoco_models", "template",
                       "humanoid_template.xml") if template else None
    texts = []
    for i, sk in enumerate(_skeletons("load_from_bvh", files["seeded"])):
        out = str(tmp_path / f"{i}.xml")
        sk.write_xml(out, template_fname=tpl)
        texts.append(open(out).read())
    assert texts[0] == texts[1]
    assert 'coordinate=' not in texts[0]
    from egopose_tpu_torch.physics.spec import parse_mjcf
    assert parse_mjcf(str(tmp_path / "0.xml")).nbody == 5


@pytest.fixture(scope="module")
def specs():
    from egopose_tpu.physics.spec import parse_mjcf as jparse
    from egopose_tpu_torch.physics.spec import parse_mjcf
    return parse_mjcf(XML), jparse(XML)


def test_export_mjcf_matches_jax(specs):
    from egopose_tpu.physics import spec as J
    from egopose_tpu_torch.physics import export_mjcf, parse_mjcf
    from egopose_tpu_torch.physics import spec as P
    for floor in (True, False):
        assert export_mjcf(specs[0], floor) == J.export_mjcf(specs[1], floor)
    assert P.HUMANOID_TEMPLATE == J.HUMANOID_TEMPLATE
    # the export parses back to the same model
    back = parse_mjcf(export_mjcf(specs[0]))
    assert back.nq == specs[0].nq and back.nbody == specs[0].nbody
    np.testing.assert_allclose(back.body_mass, specs[0].body_mass,
                               rtol=1e-12)


@pytest.mark.parametrize("variant", ["vis", "vis_double_v1", "vis_ghost_v1",
                                     "vis_estimate_v1", "vis_forecast_v1",
                                     "vis_multi_v1", "vis_single_v1"])
def test_export_vis_mjcf_matches_jax(specs, variant):
    from egopose_tpu.physics import spec as J
    from egopose_tpu_torch.physics import spec as P
    assert P.VIS_VARIANTS == J.VIS_VARIANTS
    assert P.export_vis_mjcf(specs[0], *P.VIS_VARIANTS[variant]) \
        == J.export_vis_mjcf(specs[1], *J.VIS_VARIANTS[variant])


def test_write_vis_family_matches_jax(specs, tmp_path):
    from egopose_tpu.physics import spec as J
    from egopose_tpu_torch.physics import spec as P
    pa = P.write_vis_family(specs[0], str(tmp_path / "port"))
    pb = J.write_vis_family(specs[1], str(tmp_path / "jax"))
    rel = lambda ps, d: [os.path.relpath(p, str(tmp_path / d)) for p in ps]
    assert rel(pa, "port") == rel(pb, "jax") and len(pa) == 8
    for a, b in zip(pa, pb):
        assert open(a).read() == open(b).read()


def _run_cli_chain(root, bvh, create_humanoid, convert_clip, extra):
    (root / "datasets/traj").mkdir(parents=True)
    for take in ("take_01", "take_02"):
        shutil.copy(bvh, root / f"datasets/traj/0000_{take}.bvh")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        create_humanoid.main(["--mocap-id", "0000", "--skt-id", "take_01",
                              "--out-id", "humanoid_0000_orig"])
        convert_clip.main(["--model-id", "humanoid_0000_orig", "--mocap-id",
                           "0000", "--mocap-fr", "120"] + extra)
    finally:
        os.chdir(cwd)
    xml = open(root / "assets/mujoco_models/humanoid_0000_orig.xml").read()
    trajs = {t: pickle.load(open(root / f"datasets/traj/0000_{t}_traj.p",
                                 "rb"))
             for t in ("take_01", "take_02")}
    return xml, trajs


def test_cli_chain_matches_jax(files, tmp_path):
    from egopose_tpu.cli import convert_clip as jcc
    from egopose_tpu.cli import create_humanoid as jch
    from egopose_tpu_torch.cli import convert_clip, create_humanoid
    xa, ta = _run_cli_chain(tmp_path / "port", files["seeded"],
                            create_humanoid, convert_clip,
                            ["--device", "cpu"])
    xb, tb = _run_cli_chain(tmp_path / "jax", files["seeded"], jch, jcc, [])
    assert xa == xb
    for take in ta:
        a, b = ta[take], tb[take]
        assert isinstance(a, np.ndarray) and a.dtype == np.float64
        # 121 frames at 120 Hz -> 31 at 30 Hz; nq 7 + Spine/Head 3 hinges
        # each + LeftLeg restricted to Xrotation by SPEC_CHANNELS
        assert a.shape == b.shape == (31, 14)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        np.testing.assert_allclose(np.linalg.norm(a[:, 3:7], axis=1), 1.0,
                                   atol=1e-12)
    # the root's rotations move: the quaternion is not a constant
    assert np.ptp(ta["take_01"][:, 3:7], axis=0).max() > 0.1


def test_convert_clip_without_cuda_raises(files, tmp_path, monkeypatch):
    from egopose_tpu_torch.cli import convert_clip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_clip.main(["--mocap-id", "0000"])
