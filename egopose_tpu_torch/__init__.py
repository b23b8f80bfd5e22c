"""egopose_tpu_torch: the PyTorch/CUDA port of egopose_tpu.

Mirrors the JAX package's module layout (physics / envs / models / rl / cli)
so each counterpart is easy to find.  Plain tensor code is PyTorch; each of
the JAX package's Pallas kernels (the substep-resident control step, the
batched SPD solve, the fused contact solve, the fused stable-PD substep and
the lane-major FK) is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); without CUDA they raise instead of
quietly running on the CPU.
"""
import torch

# The stiff 58-dof mass-matrix algebra NaNs under reduced-precision
# contractions (the JAX engine pins Precision.HIGHEST for the same reason),
# so float32 matmuls and convolutions stay full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU")
    return dev
