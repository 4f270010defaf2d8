"""Build and load the package's hand-written CUDA kernels.

The sources under `grlir_torch/csrc/` are compiled at first use with `nvcc`
for `sm_90a` (Hopper) into one shared library with a plain C interface, and
loaded with ctypes.  The library lands in `build/grlir_torch/` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  There is no fallback: a
missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "grlir_torch"
SOURCES = ("window_half.cu", "stripe_half.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of each exported function (pointers as c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
SIGNATURES = {
    "grlir_window_half": [_P] * 7 + [_I] * 10 + [_P],
    "grlir_stripe_half": [_P] * 11 + [_I] * 12 + [_P],
}

_library = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the grlir_torch kernels are built from source")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libgrlir_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists.

    The compiler's report (`-Xptxas -v`: registers, shared memory, spills
    of every kernel) is kept beside the library in `build.log`."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.grlir_error_string.argtypes = [ctypes.c_int]
        lib.grlir_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(err: int, kernel: str, what: str) -> None:
    """Raise for a non-zero return of a launch function."""
    if err == -1:
        raise NotImplementedError(
            f"{kernel}: {what} needs more shared memory than one block has")
    if err != 0:
        msg = library().grlir_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
