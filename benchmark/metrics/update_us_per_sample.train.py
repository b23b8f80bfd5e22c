"""The PPO update's host-clock time (T_update: the update reads its
losses back) over the window's iterations, per sample updated."""


def read(run):
    if not run.iters:
        return None
    samples = sum(it["steps"] for it in run.iters)
    return sum(it["update_s"] for it in run.iters) / samples * 1e6
