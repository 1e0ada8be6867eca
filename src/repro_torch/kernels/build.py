"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, one ``nvcc`` per source in
parallel, into ``build/repro_torch/<hash>/`` beside the checkout's
``src/``; the directory name is a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# every pointer and the stream as c_void_p: a default int would cut a
# 64-bit pointer to 32 bits
SIGNATURES = {
    "repro_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F,
                               I, I, I, P],
    "repro_flash_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, I,
                              I, P],
    "repro_mq_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                  I, F, I, I, I, P],
    "repro_paged_decode_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                     I, F, I, I, I, P],
    "repro_mq_paged_decode_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                        I, I, I, F, I, I, I, P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> pathlib.Path:
    return BUILD_ROOT / _digest() / "librepro_kernels.so"


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; returns its
    path. The compiler's register/spill report lands in ``ptxas.log``
    beside it."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs)[-8000:])
        lib_tmp = pathlib.Path(tmp) / out.name
        subprocess.run([nvcc, "-shared", "-o", str(lib_tmp),
                        *[str(o) for _, o, _ in procs]],
                       check=True, capture_output=True, text=True)
        (out.parent / "ptxas.log").write_text("\n".join(logs))
        os.replace(lib_tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
