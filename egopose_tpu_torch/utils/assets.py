"""Locate packaged MJCF model assets (counterpart of
egopose_tpu/utils/assets.py).

Resolution works from the repo root and from any other working directory,
and never reaches outside the repo."""
import os

# repo root = parent of the egopose_tpu_torch package directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_model_xml(name_or_path):
    """Resolve a humanoid model to an XML path: an explicit ``.xml`` path or
    a model id like "humanoid_1205_v1".  Searches the working directory
    first, then the repo's assets/mujoco_models/."""
    if name_or_path.endswith(".xml"):
        candidates = [name_or_path, os.path.join(REPO_ROOT, name_or_path)]
    else:
        rel = os.path.join("assets", "mujoco_models", name_or_path + ".xml")
        candidates = [rel, os.path.join(REPO_ROOT, rel)]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        "model XML %r not found (searched %s)"
        % (name_or_path, ", ".join(candidates)))
