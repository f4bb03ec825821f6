"""Build, load and count the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, never at import, into ``build/repro_torch/``
at the root of the checkout, under a name keyed on a hash of the source
and the flags (and of the headers under ``csrc/``), so a changed source is
rebuilt and an unchanged one is reused.  ``build()`` starts one ``nvcc`` per missing library, all at once.

``launch_counts`` counts kernel launches by kernel name and
``launch_shapes`` by name and operand shape (each wrapper adds one where it
launches, nowhere else); ``plain_calls`` counts calls of the plain PyTorch
versions.  A run that must show it went through the kernels clears them
(:func:`clear_counts`), runs, and reads them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"gspn_pair": CSRC / "gspn_pair.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (restype, argtypes).
_SIGNATURES = {
    "gspn_pair": {
        # ndir, dtype, x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, then
        # the launch shape: planes, warps, k, splits, batch, nbuf, xpitch,
        # smem; stream
        "gspn_fwd_launch": (_I, [_I, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        # ndir, dtype, dy, wl, wc, wr, g, G, H, W, cpw, chunk, then the
        # launch shape: planes, warps, k, splits, batch, nbuf, bands,
        # direct, smem; stream
        "gspn_bwd_launch": (_I, [_I, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "gspn_error_string": (ctypes.c_char_p, [_I]),
    },
}

launch_counts: collections.Counter = collections.Counter()
# The same launches by (kernel name, G, H, W, dtype name).
launch_shapes: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()


def clear_counts() -> None:
    for c in (launch_counts, launch_shapes, plain_calls):
        c.clear()
# Compiler output (ptxas register and shared-memory report) per library
# built in this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH); "
                           "the CUDA kernels are built from source at "
                           "first use")
    return found


def library_path(name: str) -> pathlib.Path:
    text = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, pathlib.Path]:
    """Compile the named libraries (all by default) that are not built
    yet, in parallel.  Raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    targets = {n: library_path(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, target in todo.items():
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.gspn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
