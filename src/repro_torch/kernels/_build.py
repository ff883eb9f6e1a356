"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout (a directory git ignores).  The hash covers the source,
every header of ``csrc/`` (``*.cuh``, which a source may include) and the
flags, so an edited source or header is built anew and a built one is
reused.
Nothing is compiled when the package is imported: the first launch of a
kernel, or :func:`build`, compiles it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
# nvcc's output per source from the last build in this process (ptxas -v
# lists each kernel's registers, shared memory and spills)
build_log: Dict[str, str] = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = CUDA_HOME / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{CUDA_HOME}); the CUDA kernels cannot be built")


def target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = ()) -> float:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, all started together.  Returns the seconds taken;
    raises with the compiler's output if any of them fails."""
    names = list(names) or sources()
    todo = [n for n in names if not target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for n in todo:
            tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[n] = log
            if proc.returncode:
                failed.append(f"--- {n}.cu (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, target(n))
    finally:
        for _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, argtypes: Sequence):
    """The C entry ``name`` of ``csrc/<name>.cu``, returning an ``int``
    error code; built and loaded on first use."""
    fn = _FNS.get(name)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(target(name)))
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes, err_str.restype = [ctypes.c_int], ctypes.c_char_p
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _LIBS[name], _FNS[name] = lib, fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if the kernel's C entry reported a CUDA error at launch."""
    if err:
        msg = getattr(_LIBS[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
