"""CUDA kernels launched per control step in the profiled steps of the
rollout's sample."""


def read(run):
    tag = (run.trace or {}).get("tags", {}).get("sample")
    if not tag or not tag["units"]:
        return None
    return tag["kernels"] / tag["units"]
