"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  ``load_library(name)``
compiles it once with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the repository root (or under
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the source and the flags,
and loads it with ``ctypes``.  Nothing here runs at import time: the CPU
tests import every module, and only a launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per source: decode_attention instantiates ~30 kernels (head widths x
# dtypes x head groups); compiling them on every core halves its build.
EXTRA_FLAGS = {"decode_attention": ("--split-compile=0",)}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas output of the build


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME); the port's CUDA kernels are "
        "built from csrc/ at first use")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags(name)).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists;
    returns the library path.  Safe to call from several processes: each
    compiles to its own temporary file and renames it into place."""
    return build_all([name])[name]


def build_all(names) -> dict[str, pathlib.Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no build of its
    exact source yet, one ``nvcc`` process per source, all started together;
    returns each library's path.  Raises if any build fails."""
    paths, procs = {}, {}
    for name in names:
        out = paths[name] = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            if name not in BUILD_LOGS and log.exists():
                BUILD_LOGS[name] = log.read_text()
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name} ({proc.returncode}):"
                          f"\n{' '.join(cmd)}\n{text}")
            continue
        paths[name].with_suffix(".log").write_text(text)
        os.replace(tmp, paths[name])
        BUILD_LOGS[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` as a ``ctypes.CDLL`` (built on first
    use, loaded once per process)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
