"""CUDA kernels launched per control step in the profiled eval steps."""


def read(run):
    tag = (run.trace or {}).get("tags", {}).get("step")
    if not tag or not tag["units"]:
        return None
    return tag["kernels"] / tag["units"]
