"""Physics: the MJCF spec, the model, the engine and its CUDA kernels."""
from .spec import ModelSpec, parse_mjcf, export_mjcf  # noqa: F401
