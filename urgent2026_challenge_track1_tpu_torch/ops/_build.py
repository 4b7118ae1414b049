"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources under ``csrc/`` compile to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): one nvcc per
source, all started together, then one link.  The library lands
in ``_build/`` inside the package, under a name keyed on a hash of the
sources, flags and defines, so an edit to a source rebuilds it and an
unchanged tree reuses it.  A missing ``nvcc`` or a failed build raises.
Defines make a measurement build (``K1P_PHASE_CLOCKS``: K1p's per-phase
cycle counters) beside the plain one.
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
SOURCES = tuple(PKG_DIR / "csrc" / name for name in (
    "lstm_kernels.cu", "lstm_persistent.cu", "lstm_persistent_bwd.cu"))
HEADERS = (PKG_DIR / "csrc" / "lstm_persistent_common.cuh",)  # hashed with the sources
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu (pointers and the stream as void*); each returns
# an int (a cudaError_t) unless _RESTYPES says otherwise
_SIGNATURES = {
    "lstm_fusedin_bilstm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_scan": (_P,) * 7 + (_I,) * 6 + (_P,),
    "lstm_revmasked": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_revmasked_train_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lstm_revmasked_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lstm_train_fwd_streamin": (_P,) * 7 + (_I,) * 7 + (_P,),
    "lstm_train_bwd2": (_P,) * 14 + (_I,) * 5 + (_P,),
    "lstm_fusedin_persistent": (_P,) * 6 + (_I,) * 13 + (_P,),
    "lstm_streamin_persistent": (_P,) * 8 + (_I,) * 12 + (_P,),
    "lstm_scan_persistent": (_P,) * 12 + (_I,) * 11 + (_P,),
    "lstm_persistent_smem": (_I,) * 7,
    "lstm_persistent_phase_cycles": (_P, _I),
    "lstm_bwd_persistent": (_P,) * 8 + (_I,) * 12 + (_P,),
    "lstm_bwd2_persistent": (_P,) * 14 + (_I,) * 11 + (_P,),
    "lstm_persistent_bwd_smem": (_I,) * 7,
    "lstm_bwd_dw": (_P,) * 5 + (_I,) * 6 + (_P,),
}
_RESTYPES = {"lstm_persistent_smem": ctypes.c_longlong,
             "lstm_persistent_bwd_smem": ctypes.c_longlong}


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


def _digest(flags) -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(defines: tuple[str, ...] = ()) -> BuildResult:
    """Compile the kernels (with ``-D`` each of ``defines``) unless a
    library for these sources and flags exists."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"liblstm_kernels_{_digest(flags)}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{os.getpid()}.o") for src in SOURCES]
    t0 = time.perf_counter()
    cmds = [[nvcc, *flags, "-c", "-o", str(o), str(src)] for src, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    if all(rc == 0 for _, _, rc in runs):
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    log = "".join(out for _, out, _ in runs)
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, out, rc in runs:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library built with ``defines``, every C signature declared."""
    lib = ctypes.CDLL(str(build(defines).path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib
