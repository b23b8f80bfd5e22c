"""Build the port's CUDA kernels (``csrc/*.cu``) with nvcc at first use.

Each source compiles on its own into a shared library with a plain C
interface (loaded with ctypes by its wrapper module), named by a hash of the
flags, the source and every header under ``csrc/`` (``*.cuh``), so an edited
source or header never loads a stale library.  A target is a source name or
a ``(source, defines)`` pair: the same source built with preprocessor
defines (``-D``) is a library of its own, as the stage-clock build of
``substep.cu`` is.
Output goes to the git-ignored ``egopose_tpu_torch/_build/``.
``build_all`` starts one nvcc per source at once and waits for all.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("substep.cu", "spd_solve.cu", "fused_contact.cu", "fk.cu",
           "lstm.cu")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels under csrc/")


def _split(target):
    """A target -> (source, defines)."""
    return (target, ()) if isinstance(target, str) else \
        (target[0], tuple(target[1]))


def library_path(target) -> str:
    source, defines = _split(target)
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    stem = "_".join([os.path.splitext(source)[0]]
                    + [d.lower() for d in defines])
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_all(sources=SOURCES, verbose: bool = False) -> list:
    """Compile every target whose library is missing, all nvcc processes
    at once; returns the libraries' paths in the order of ``sources``.
    With ``verbose`` prints ptxas's register / shared-memory report."""
    outs = [library_path(s) for s in sources]
    procs = []
    for target, out in zip(sources, outs):
        if os.path.exists(out):
            continue
        src, defines = _split(target)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines],
               "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{stdout}{stderr}")
            continue
        if verbose:
            print(stderr.strip())
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def build(target, verbose: bool = False) -> str:
    return build_all((target,), verbose)[0]
