"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources under ``csrc/`` compile to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The library lands
in ``_build/`` inside the package, under a name keyed on a hash of the
sources and flags, so an edit to a source rebuilds it and an unchanged tree
reuses it.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildResult", "build", "load_library"]

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = (PKG_DIR / "csrc" / "lstm_kernels.cu",)
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/lstm_kernels.cu (pointers and the stream as void*)
_SIGNATURES = {
    "lstm_fusedin_bilstm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_scan": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_revmasked": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_revmasked_train_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_revmasked_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_fwd_streamin": (_P,) * 7 + (_I,) * 7 + (_P,),
    "lstm_train_fwd2": (_P,) * 10 + (_I,) * 5 + (_P,),
    "lstm_train_bwd2": (_P,) * 14 + (_I,) * 5 + (_P,),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str        # nvcc's output, including ptxas register/spill counts


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile the kernels unless a library for these sources exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"liblstm_kernels_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
