"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its
own with nvcc for sm_90a into `build/<name>-<hash>.so` inside this package
(a directory that .gitignore lists), at first CUDA use, cached by a hash
of the source and the flags. The library is loaded with ctypes: every
pointer and the stream are passed as `c_void_p`, ints as `c_int`. Each C
entry returns `cudaGetLastError()` after its launches; `check` raises when
that is not 0. A failed build raises: there is no fallback for a CUDA
tensor.

`LAUNCHES` counts, per kernel name, the wrapper calls that launched the
kernel (a plain int per name), so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("shortlist", "mcam_dist", "mcam_search")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: wrapper launches per kernel name; chip_smoke.py zeroes and reads these
LAUNCHES: dict[str, int] = {"shortlist": 0, "mcam_dist": 0,
                            "mcam_search": 0, "mcam_rescore": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile the given sources, one nvcc process each, all started
    together. Returns nvcc's output (register / shared-memory report) per
    source that was built now; sources already built are skipped. Each
    library is written under a temporary name and renamed when nvcc
    succeeds, so a failed build leaves nothing that looks cached."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        jobs[n] = tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {n: proc.communicate()[0] for n, (_, proc) in jobs.items()}
    for n, (tmp, proc) in jobs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu "
                               f"(exit {proc.returncode}):\n{logs[n]}")
        os.replace(tmp, _target(n))
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use.
    `signatures` maps each C entry the caller uses to its argument types
    (`c_void_p` for pointers and the stream); every entry returns an int
    error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry of `lib` reported a CUDA error (every csrc
    library exports `repro_error_string`, cudaGetErrorString)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
