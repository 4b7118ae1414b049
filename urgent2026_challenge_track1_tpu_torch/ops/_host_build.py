"""Build the host (CPU) C++ libraries under ``csrc/`` with g++ at first use.

``flac_native.cpp`` (the FLAC decoder), ``dsp_native.cpp`` (the wind-noise
sidechain compressor) and ``codec_native.cpp`` (mp3/ogg/opus through the
system libavcodec, linked with ``-lavformat -lavcodec -lavutil
-lswresample``) are plain C ABIs bound with ctypes.  Each compiles with
``g++ -O3 -shared -fPIC``, the flags of the JAX package's ``build_native``,
and its link flags, into ``_build/`` under a name keyed on a hash of the
source and all the flags, so an edited source rebuilds and an unchanged one
is reused.  The library is
written to a pid-suffixed file and renamed into place, so processes that
build at the same time (the loader's spawned workers) never load half a
file.  A missing compiler or a failed build raises; the callers decide
what to do without the library.  Imports neither torch nor numpy, so the
data loader's workers can use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["GXX_FLAGS", "build_host_library"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def build_host_library(src_name: str, link_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<src_name>`` with ``link_flags`` after the source
    (unless a library of this source and these flags exists) and load it."""
    src = CSRC / src_name
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS + tuple(link_flags)).encode())
    lib = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src), *link_flags],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
