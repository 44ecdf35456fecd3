"""Build and load the port's CUDA kernels (``dptpu_torch/csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into an object file
(one ``nvcc`` per source, all started together; the ``*.cuh`` headers
they include are hashed with them), and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lives in ``dptpu_torch/_build/`` (git-ignored),
is built at first use and rebuilt whenever the sources or the flags
change (the file name carries their hash). A failed build raises with
nvcc's own error output; nothing falls back.

Nothing here runs at import time: the CPU-only test host imports every
module of the port and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# where the CUDA toolkit is looked for after $CUDA_HOME, before PATH
CUDA_ROOTS = ("/usr/local/cuda",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last nvcc build in this process took (0.0 while the library
# was found already built); chip_smoke.py reports it
last_build_seconds = 0.0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the dptpu_torch CUDA kernels are built on the "
            "machine with the card"
        )
    return found


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdptpu_torch_{source_hash()}.so"


def build() -> Path:
    """Compile every source into the library (a no-op when the library
    for these sources is already built). Raises with nvcc's stderr."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    errors = []
    for src, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (exit "
                          f"{proc.returncode}):\n{stdout}{stderr}")
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {link.returncode}):\n"
                f"{link.stdout}{link.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's ctypes
    signature declared (pointers and the stream as ``c_void_p``, so no
    64-bit value is cut to a C int)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dptpu_fused_stem_fwd
            fn.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, vec, vdtype
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # z, g, b
                ctypes.c_void_p,                                # y
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,                                # stream
            ]
            fn.restype = ctypes.c_int
            fn = lib.dptpu_fused_stem_fwd_attrs
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]                     # ..., out[5]
            fn.restype = ctypes.c_int
            fn = lib.dptpu_fused_stem_bwd_blocks
            fn.argtypes = [ctypes.c_int] * 4                    # B, H, W, C
            fn.restype = ctypes.c_int
            fn = lib.dptpu_fused_stem_bwd
            fn.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, vec, vdtype
                ctypes.c_void_p, ctypes.c_void_p,               # z, g
                ctypes.c_void_p, ctypes.c_void_p,               # gamma, beta
                ctypes.c_void_p,                                # dz
                ctypes.c_void_p, ctypes.c_void_p,               # partials, dgb
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,                                # stream
            ]
            fn.restype = ctypes.c_int
            fn = lib.dptpu_fused_stem_bwd_attrs
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]                     # ..., out[5]
            fn.restype = ctypes.c_int
            # the layout probes: (x, o, four dims, stream)
            for name in ("squeeze", "parity_rows", "parity_cols",
                         "interleave", "lead", "sub", "il0", "il1", "tap"):
                fn = getattr(lib, f"dptpu_probe_{name}")
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               *[ctypes.c_int] * 4, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            fn = lib.dptpu_probe_accum_chunks
            fn.argtypes = [ctypes.c_int] * 4                    # H, W, S, L
            fn.restype = ctypes.c_int
            fn = lib.dptpu_probe_accum
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,               # x, o
                ctypes.c_void_p, ctypes.c_void_p,               # partials, acc
                *[ctypes.c_int] * 4,                            # H, W, S, L
                ctypes.c_void_p,                                # stream
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
