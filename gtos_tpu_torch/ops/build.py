"""Builds the port's CUDA source (`ops/csrc/*.cu`) at first use.

The source has a plain C interface and is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library, loaded with ctypes. The library name
carries a hash of the source, the headers beside it (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. Libraries go to
`gtos_tpu_torch/_build/` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(source: str, defines=()) -> Path:
    """Where the library of `source` (a file name in csrc/) is built, with
    the preprocessor macros `defines`."""
    text = (CSRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str, defines=()) -> str:
    """Compile `source` (with the macros `defines`) unless its library
    exists. Returns nvcc's output (ptxas's register and spill report), ""
    if nothing was compiled. Raises RuntimeError with that output if the
    compile fails."""
    out = library_path(source, defines)
    if out.exists():
        return ""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), *_flags(defines), "-o",
         str(tmp), str(CSRC_DIR / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load(source: str, defines=()) -> ctypes.CDLL:
    """The loaded library of `source` (with the macros `defines`, a
    tuple), built first if missing."""
    build(source, defines)
    return ctypes.CDLL(str(library_path(source, defines)))
