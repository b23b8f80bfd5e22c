"""CUDA kernels launched per training step in the profiled
state-regression steps."""


def read(run):
    tag = (run.trace or {}).get("tags", {}).get("step")
    if not tag or not tag["units"]:
        return None
    return tag["kernels"] / tag["units"]
