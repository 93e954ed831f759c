"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface, then loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``build/kernels/`` at the repository root, named by a
hash of their source and flags, so an edited source is rebuilt and an
unchanged one is reused.  ``build()`` starts one ``nvcc`` per source,
all at once, and waits for them together (``compile_all``, which
``ab_build`` also uses for sources of other trees).

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()``; ``check()`` turns a
nonzero code into an exception, because a refused launch never runs and
a later synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "check", "compile_all", "error_string",
           "library_path", "load", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("smm", "tiled_matmul", "grouped_gemm", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> Path:
    """The library of ``name``, keyed by its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_all(jobs: Dict[str, tuple], *,
                ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile ``{key: (source, library)}``, one ``nvcc`` process each,
    all started together, each library written whole or not at all.
    Returns ``{key: {"seconds", "cached", "log"}}``; raises with the
    compiler's output if any build fails."""
    procs = {}
    for key, (src, lib) in jobs.items():
        Path(lib).parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(lib).with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, time.perf_counter())
    out: Dict[str, dict] = {}
    failed = []
    for key, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        out[key] = {"seconds": time.perf_counter() - t0, "cached": False,
                    "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {key} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def build(names: Iterable[str] = SOURCES, *,
          ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every source in ``names`` that has no current library
    (``compile_all``).  Returns ``{name: {"seconds", "cached", "log"}}``."""
    out: Dict[str, dict] = {}
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
        else:
            jobs[name] = (CSRC / f"{name}.cu", lib)
    out.update(compile_all(jobs, ptxas_verbose=ptxas_verbose))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(code: int, what: str, describe=None) -> None:
    """Raise if a C entry point reported a CUDA error; ``describe(code)``
    gives the error's text."""
    if code != 0:
        text = f" ({describe(code)})" if describe is not None else ""
        raise RuntimeError(f"{what}: CUDA error {code}{text}")


def error_string(name: str):
    """``code -> text`` through library ``name``'s
    ``<name>_error_string`` (cudaGetErrorString)."""
    fn = getattr(load(name), f"{name}_error_string")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return lambda code: fn(code).decode(errors="replace")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
