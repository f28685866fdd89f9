"""Builds the CUDA sources in ``csrc/`` with ``nvcc`` at first use and loads
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<digest>/lib<name>.so`` at
the root of the checkout, where ``<digest>`` hashes the sources and the
flags, so an edited source builds anew and an unchanged one is loaded as
it is.  All missing libraries are compiled at once, one ``nvcc`` process
per source, started together.  The kernels take a plain C interface (no
PyTorch headers), which keeps a build to seconds.

A missing ``nvcc`` or a failed build raises: nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas -v only reports registers, shared memory and spills (kept in the
# build log beside each library); it does not change the code
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_nvcc_runs = [0]  # nvcc processes this process has started


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "kernels in repro_torch/kernels/csrc cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # .cu and any .cuh they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no library yet, all at once.
    Returns ``{name: path of lib<name>.so}``; the compiler's output is in
    ``lib<name>.log`` beside it."""
    out_dir = BUILD_ROOT / _digest()
    libs = {src.stem: (src, out_dir / f"lib{src.stem}.so")
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {n: t for n, t in libs.items() if not t[1].exists()}
    if todo:
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, (src, lib) in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _nvcc_runs[0] += 1
            procs.append((name, proc, tmp, lib))
        failed = []
        for name, proc, tmp, lib in procs:
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode == 0:
                os.replace(tmp, lib)  # atomic: a concurrent build is safe
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: t[1] for n, t in libs.items()}


def libraries_built() -> int:
    """Kernel libraries this process has loaded plus the ``nvcc`` runs it
    has started: a count that grows only when a kernel is built or loaded
    for the first time (the port's counterpart of a jit cache's size)."""
    return len(_loaded) + _nvcc_runs[0]


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return lib
