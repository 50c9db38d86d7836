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
SOURCES = ("shortlist", "mcam_dist", "mcam_search", "mcam_episode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: wrapper launches per kernel name; chip_smoke.py zeroes and reads these
LAUNCHES: dict[str, int] = {"shortlist": 0, "shortlist_blocks": 0,
                            "mcam_dist": 0,
                            "mcam_search": 0, "mcam_rescore": 0,
                            "mcam_episode": 0}

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


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, keyed by a hash of the source, the
    headers of csrc/ (which a source may include) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile the given sources, one nvcc run each, all started together.
    Returns nvcc's output (the ptxas register / shared-memory / spill
    report) per source that was built now; sources already built are
    skipped. Each library is written under a temporary name and renamed
    when nvcc succeeds, so a failed build leaves nothing that looks
    cached."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{n}.cu (exit "
                          f"{proc.returncode}):\n{logs[n]}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def ptxas_report(log: str) -> list[str]:
    """The lines of an nvcc log that give each kernel's registers, shared
    memory and spills (ptxas -v)."""
    return [line.strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use.
    `signatures` maps each C entry the caller uses to its argument types
    (`c_void_p` for pointers and the stream); every entry returns an int
    error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
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
