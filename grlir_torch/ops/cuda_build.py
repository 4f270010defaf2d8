"""Build and load the package's hand-written CUDA kernels.

The sources under `grlir_torch/csrc/` are compiled at first use with `nvcc`
for `sm_90a` (Hopper), one `nvcc` process per source, all started together,
and linked into one shared library with a plain C interface, loaded with
ctypes.  The library lands in `build/grlir_torch/` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
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
SOURCES = ("window_half.cu", "stripe_half.cu", "window_half_large.cu",
           "stripe_half_large.cu", "flash_attention.cu", "cosine_attention.cu")
HEADERS = ("common.cuh", "large_attn.cuh", "mma_util.cuh", "stripe_attn_mma.cuh",
           "mma_attend.cuh")
# -split-compile=0: each nvcc optimizes its source's kernels on every core
# at once (cosine_attention.cu's four instances: 13.5 s -> 7.2 s on 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of each exported function (pointers as c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
_COSINE = [_P] * 4 + [_L] * 16 + [_P] * 4 + [_I] * 7 + [_P]
SIGNATURES = {
    "grlir_window_half": [_P] * 7 + [_I] * 9 + [_P],
    "grlir_window_half_mma": [_P] * 2 + [_L] * 2 + [_I] + [_P] * 5 + [_I] * 9 + [_P],
    "grlir_window_half_mma_qkv": [_P] * 2 + [_L] * 2 + [_I] + [_P] * 5 + [_I] * 9 + [_P] * 2,
    "grlir_stripe_half": [_P] * 11 + [_I] * 11 + [_P],
    "grlir_stripe_half_mma": [_P] * 12 + [_I] * 12 + [_P],
    "grlir_window_half_large": [_P] * 8 + [_I] * 9 + [_P],
    "grlir_window_half_large_mma": [_P] * 8 + [_I] * 10 + [_P],
    "grlir_stripe_a2w_large": [_P] * 11 + [_I] * 11 + [_P],
    "grlir_stripe_w2a_large": [_P] * 12 + [_I] * 11 + [_P],
    "grlir_stripe_a2w_large_mma": [_P] * 11 + [_I] * 12 + [_P],
    "grlir_stripe_w2a_large_mma": [_P] * 13 + [_I] * 12 + [_P],
    "grlir_flash_rect_attention": [_P] * 10 + [_I] * 7 + [_P],
    "grlir_mma_attend_rows": [_L] * 2 + [_I] * 2 + [_P],
    "grlir_window_attention_qkv": _COSINE,
    "grlir_cosine_attention_split": _COSINE,
    "grlir_cosine_attention_packed": _COSINE,
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

    Each source compiles to an object in its own nvcc process, all at once;
    the objects then link into the library.  The compiler's report
    (`-Xptxas -v`: registers, shared memory, spills of every kernel) is kept
    beside the library in `build.log`."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [" ".join(c) + "\n" + log for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            failed.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + log for c, log in zip(cmds, logs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
            f"{kernel}: {what} is beyond the kernel (head dim or shared "
            "memory of one block)")
    if err != 0:
        msg = library().grlir_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
