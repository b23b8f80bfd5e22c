"""egopose_tpu_torch scaffold: the MJCF spec and env config equal the JAX
package's field by field, the port imports nothing of JAX or of the JAX
package (statically and at run time, checkpoint loading included), and
entry points refuse to fall back to the CPU when CUDA is absent."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
PORT = os.path.join(REPO, "egopose_tpu_torch")
CKPT = os.path.join(REPO, "results", "egomimic", "subject_03", "models",
                    "iter_0800.p")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egopose_tpu")


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_model_spec_matches_jax():
    from egopose_tpu.physics.spec import parse_mjcf as jparse
    from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
    js, ts = jparse(XML), tparse(XML)
    for f in dataclasses.fields(js):
        _assert_same(getattr(js, f.name), getattr(ts, f.name), f.name)
    assert (ts.nq, ts.ndof, ts.nu, ts.nbody) == (59, 58, 52, 21)


def test_env_params_match_jax():
    import jax.numpy as jnp
    from egopose_tpu.utils import config as jcfg
    from egopose_tpu.physics.spec import parse_mjcf as jparse
    from egopose_tpu_torch.utils import config as tcfg
    from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoMimicConfig("subject_03", config_root=root)
    tc = tcfg.EgoMimicConfig("subject_03", config_root=root)
    for key, val in vars(jc).items():
        _assert_same(val, getattr(tc, key), key)
    jp = jcfg.make_env_params(jc, jparse(XML), obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tparse(XML), obs_dim=115,
                              dtype=torch.float64)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if f.name == "contact":
            for name in b._fields:
                assert getattr(a, name) == getattr(b, name), name
        elif f.name == "env_init_noise":
            assert float(a) == b
        elif isinstance(a, jnp.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), f.name)
        else:
            assert a == b, f.name


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_ast():
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = [(p, m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_and_checkpoint_load_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import egopose_tpu_torch as P\n"
        "for mod in pkgutil.walk_packages(P.__path__, 'egopose_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from egopose_tpu_torch.rl.agent_ego import AgentEgo\n"
        "from egopose_tpu_torch.convert import load_checkpoint_pickle\n"
        f"cp = load_checkpoint_pickle({CKPT!r})\n"
        "assert type(cp['running_state']).__module__ == "
        "'egopose_tpu_torch.ops.running_norm'\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_entry_point_without_cuda_raises(monkeypatch):
    import egopose_tpu_torch
    from egopose_tpu_torch.cli import ego_mimic_eval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egopose_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ego_mimic_eval.main(["--cfg", "subject_03", "--synthetic"])
    assert egopose_tpu_torch.resolve_device("cpu").type == "cpu"


def test_entry_point_cuda_device_has_an_index(monkeypatch):
    """A bare ``cuda`` (the CLIs' default) resolves to the current card's
    index, the device its tensors report, so the kernels' device checks
    pass; an index given stays."""
    import egopose_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert egopose_tpu_torch.resolve_device(None) == torch.device("cuda", 0)
    assert egopose_tpu_torch.resolve_device("cuda") == torch.device("cuda", 0)
    assert egopose_tpu_torch.resolve_device("cuda:1") \
        == torch.device("cuda", 1)
