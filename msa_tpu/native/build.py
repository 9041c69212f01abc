"""Build the native libraries from the sources in this directory.

- ``libmsanative.so``: the host C++ kernel (g++, plain C ABI, ctypes).
- ``libnwcuda.so``: the CUDA fill and walk behind ``jax.ffi`` (nvcc,
  ``sm_90a``; needs the CUDA toolkit, so it builds only where a card is).

Both go to ``BUILD_DIR``, which git ignores; each builds at first use, or
ahead of time with ``python -m msa_tpu.native.build [--cuda]``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")


class BuildError(RuntimeError):
    """A compiler was found and failed; carries its output."""


def _stale(out: str, src: str) -> bool:
    return not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(
        src
    )


def _compile(cmd, out: str) -> None:
    """Run ``cmd`` writing ``out + '.tmp.<pid>'``, then move it into place.

    The rename is atomic, so processes that build at once never load a
    half-written library.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.run(
        [*cmd, "-o", tmp], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise BuildError(
            f"{cmd[0]} failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)


def host_compiler() -> str | None:
    return shutil.which("g++")


def build(force: bool = False) -> str:
    """Build the host library; returns its path."""
    src = os.path.join(HERE, "msanative.cpp")
    out = os.path.join(BUILD_DIR, "libmsanative.so")
    if force or _stale(out, src):
        cxx = host_compiler()
        if cxx is None:
            raise BuildError("no C++ compiler (g++) on PATH")
        _compile(
            [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", src],
            out,
        )
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_cuda(force: bool = False) -> str:
    """Build the CUDA FFI library for Hopper; returns its path."""
    src = os.path.join(HERE, "nw_cuda.cu")
    out = os.path.join(BUILD_DIR, "libnwcuda.so")
    if force or _stale(out, src):
        nvcc = nvcc_path()
        if not os.path.exists(nvcc):
            raise BuildError(f"nvcc not found (looked for {nvcc})")
        import jax.ffi

        _compile(
            [
                nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", jax.ffi.include_dir(), src,
            ],
            out,
        )
    return out


if __name__ == "__main__":
    print(build(force=True))
    if "--cuda" in sys.argv[1:]:
        print(build_cuda(force=True))
