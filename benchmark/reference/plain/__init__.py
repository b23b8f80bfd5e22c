"""Frozen copies of the plain-PyTorch modules of egopose_tpu_torch that the
benchmark's reference needs: the MJCF parser and model tables, forward
kinematics, the split-path physics (the plain version of the program's
control-step kernel K1), the humanoid env and its rewards, the synthetic
experts, the nets, the observation filter, GAE and the checkpoint loader.

Copied once and kept under the benchmark's folder, so the yardstick does
not move when the program does.  Every kernel dispatch is removed: each
function runs its plain version on every device.  Nothing here imports
egopose_tpu_torch, egopose_tpu or jax.
"""
