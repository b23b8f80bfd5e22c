"""The port's gen_expert against the JAX package's, on the CPU in float64:
a meta of 2 takes x 80 frames (tests/test_data_pipeline.py's
trajectories, video_mocap_sync [0, 2, T-4]) through both CLIs, each in its
own working directory (one shared fixture: the JAX CLI's eager replay is
~20 s of it):

- every field of every take within 1e-9, ``len`` and the take keys equal,
  numpy arrays in the file;
- the port's non-synthetic build_world loads the JAX file and the JAX
  package's loads the port's file, into the same experts.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from test_data_pipeline import T, TAKES, _make_traj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
FEAT = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_inputs(root):
    for d in ("datasets/traj", "datasets/meta", "datasets/features",
              "config/egomimic"):
        os.makedirs(os.path.join(root, d))
    os.symlink(os.path.join(REPO, "assets"), os.path.join(root, "assets"))
    rng = np.random.RandomState(7)
    feats = {}
    for i, take in enumerate(TAKES):
        with open(os.path.join(root, f"datasets/traj/{take}_traj.p"),
                  "wb") as f:
            pickle.dump(_make_traj(i), f)
        feats[take] = rng.randn(T - 6, FEAT).astype(np.float32)
    meta = {"train": TAKES, "test": [TAKES[-1]], "capture": {"fps": 30},
            "video_mocap_sync": {t: [0, 2, T - 4] for t in TAKES}}
    with open(os.path.join(root, "datasets/meta/meta_tiny.yml"), "w") as f:
        yaml.dump(meta, f)
    with open(os.path.join(root, "datasets/features/cnn_feat_tiny.p"),
              "wb") as f:
        pickle.dump((feats, None), f)
    em = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                          "subject_03.yml")))
    em.update(meta_id="meta_tiny", expert_feat="tiny", cnn_feat="tiny")
    em.pop("state_net_cfg", None)
    with open(os.path.join(root, "config/egomimic/tiny_pipe.yml"), "w") as f:
        yaml.dump(em, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from egopose_tpu.cli import gen_expert as jge
    from egopose_tpu_torch.cli import gen_expert
    out = {}
    cwd = os.getcwd()
    for who, main, extra in (("jax", jge.main, []),
                             ("port", gen_expert.main, ["--device", "cpu"])):
        root = str(tmp_path_factory.mktemp(who))
        _write_inputs(root)
        os.chdir(root)
        try:
            main(["--meta-id", "meta_tiny", "--out-id", "tiny"] + extra)
        finally:
            os.chdir(cwd)
        with open(os.path.join(root, "datasets/features/expert_tiny.p"),
                  "rb") as f:
            out[who] = (root, pickle.load(f))
    return out


def test_expert_file_matches_jax(runs):
    port, jax_ = runs["port"][1], runs["jax"][1]
    assert list(port) == list(jax_) == TAKES
    for take in TAKES:
        a, b = port[take], jax_[take]
        assert sorted(a) == sorted(b)
        assert a["len"] == b["len"] == T - 6
        for key in b:
            if key == "len":
                continue
            assert isinstance(a[key], (np.ndarray, np.floating)), key
            assert np.shape(a[key]) == np.shape(b[key]), key
            assert np.asarray(a[key]).dtype == np.float64, key
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=TOL,
                                       err_msg=f"{take}.{key}")
        assert a["qpos"].shape == (T - 6, 59)


def test_build_world_loads_either_file(runs, monkeypatch):
    """The port's build_world on the JAX directory's file and the JAX
    package's on the port's give the same experts."""
    import jax.numpy as jnp
    from egopose_tpu.cli.ego_mimic import build_world as jbuild
    from egopose_tpu.utils.config import EgoMimicConfig as JConfig
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    monkeypatch.chdir(runs["jax"][0])
    world = build_world(EgoMimicConfig("tiny_pipe"), torch.float64, "cpu",
                        synthetic=False)
    monkeypatch.chdir(runs["port"][0])
    jworld = jbuild(JConfig("tiny_pipe", create_dirs=False), jnp.float64,
                    synthetic=False)
    expert, jexpert = world[4], jworld[4]
    assert expert.qpos.shape == (len(TAKES), T - 6, 59)
    for name in expert._fields:
        np.testing.assert_allclose(
            getattr(expert, name).numpy(), np.asarray(getattr(jexpert, name)),
            rtol=0, atol=TOL, err_msg=name)
    assert world[5].shape == np.asarray(jworld[5]).shape \
        == (len(TAKES), T - 6, FEAT)
