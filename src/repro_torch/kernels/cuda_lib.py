"""Build, load and count the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, never at import, into ``build/repro_torch/``
at the root of the checkout, under a name keyed on a hash of the source
and the flags (and of the headers under ``csrc/``), so a changed source is
rebuilt and an unchanged one is reused.  A source compiles in
:data:`PARTS` parts side by side (``-DGSPN_PART=p``, each object
instantiating its own part's kernels), then links them.  ``build()``
starts every object's ``nvcc`` of every missing library at once.

``launch_counts`` counts kernel launches by kernel name and
``launch_shapes`` by name and operand shape (each wrapper adds one where it
launches, nowhere else); ``plain_calls`` counts calls of the plain PyTorch
versions.  A run that must show it went through the kernels clears them
(:func:`clear_counts`), runs, and reads them.  ``meta_launches`` lists
the launches that ``meta`` operands stand for (the shape-only path of
``kernels.spec``): one record each, with the kernel's name, its operand
shape and the bytes and operations the launch would cost
(``gspn_scan.launch_cost``); no kernel runs and no count above moves.

Safe for threads (the serving tier's replicas launch from worker threads):
a library is built and loaded once, under a lock, into a temporary file
named by process and thread; the counters change under a lock of their
own (:func:`count`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"gspn_pair": CSRC / "gspn_pair.cu"}
# Parts of a source compiled side by side: gspn_pair.cu's float and
# bfloat16 forward and adjoint, a quarter of its kernels each (one object
# of them all took 105-134 s on the H100's host).
PARTS = 4
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
# The same launches by (kernel name, G, H, W, dtype name), and by (kernel
# name, boundary label of the launch's spec).
launch_shapes: collections.Counter = collections.Counter()
launch_boundaries: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()
meta_launches: list = []


_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def count(counter: collections.Counter, key, n: int = 1) -> None:
    """Add ``n`` to ``counter[key]`` under the counters' lock."""
    with _COUNT_LOCK:
        counter[key] += n


def clear_counts() -> None:
    with _COUNT_LOCK:
        for c in (launch_counts, launch_shapes, launch_boundaries,
                  plain_calls, meta_launches):
            c.clear()


def record_meta(**record) -> None:
    """Append one launch that a ``meta`` operand stands for to
    :data:`meta_launches`."""
    with _COUNT_LOCK:
        meta_launches.append(record)


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
    key = " ".join(NVCC_FLAGS) + f" parts={PARTS}"
    digest = hashlib.sha256(text + key.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names=None) -> dict[str, pathlib.Path]:
    """Compile the named libraries (all by default) that are not built
    yet: every part's object at once, then each library's link.  Raises
    with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    targets = {n: library_path(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = {}
    for n, target in todo.items():
        objs[n] = []
        for p in range(PARTS):
            obj = target.with_name(f"{target.stem}.{p}.{tag}.o")
            objs[n].append((obj, _run([nvcc, *NVCC_FLAGS, f"-DGSPN_PART={p}",
                                       "-c", "-o", obj, SOURCES[n]])))
    failed = []
    for n, target in todo.items():
        logs, ok = [], True
        for obj, proc in objs[n]:
            out, _ = proc.communicate()
            logs.append(out)
            ok &= proc.returncode == 0
        if ok:
            tmp = target.with_name(f"{target.name}.{tag}.tmp")
            link = _run([nvcc, "-shared", "-o", tmp,
                         *(obj for obj, _ in objs[n])])
            out, _ = link.communicate()
            logs.append(out)
            ok = link.returncode == 0
            if ok:
                os.replace(tmp, target)
            else:
                tmp.unlink(missing_ok=True)
        for obj, _ in objs[n]:
            obj.unlink(missing_ok=True)
        build_logs[n] = "\n".join(logs)
        if not ok:
            failed.append(f"{n}: nvcc failed\n{build_logs[n]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; built and
    loaded once per process, whichever thread asks first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIB_LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.gspn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
