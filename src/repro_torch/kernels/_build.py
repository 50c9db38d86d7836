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
through; `SELECT_PATHS` are the one-table shortlist's two selects,
counted beside its entry so that a run shows which one ran.

A wrapper given tensors off the card (`off_card`: the CPU, or the meta
device, where only shapes exist) runs its plain version (`plain_route`).
While
analysis/cost.py traces a call (`TRACE`), every wrapper call reports the
kernel the card launches for it, with the shapes its cost model
(`analysis.cost.kernel_cost`) takes: off the card in place of the plain
version's arithmetic, on the card beside the launch.
"""

from __future__ import annotations

import contextlib
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
                            "mcam_episode": 0,
                            "shortlist_wgmma": 0, "shortlist_mma": 0}

#: the one-table entry's selects: `wgmma` (k <= 64, rows of whole 16-byte
#: segments) and `mma` (mma.sync, the rest), each counted with the entry's
#: launch under its own name (no cost of its own: the entry's is counted)
SELECT_PATHS = ("shortlist_wgmma", "shortlist_mma")

_LIBS: dict[str, ctypes.CDLL] = {}

#: the running trace of analysis/cost.py, or None
TRACE: list = [None]


def count_launch(name: str, shapes=None) -> None:
    """One launch of kernel `name`; `shapes()` gives its cost model's
    arguments to a running trace. Without `shapes` (a select path of an
    entry already counted) the launch is counted but not traced."""
    LAUNCHES[name] += 1
    if TRACE[0] is not None and shapes is not None:
        TRACE[0].launched(name, shapes)


def profiler_range(name: str):
    """The profiler range `name` (`torch.profiler.record_function`) while
    analysis/cost.py traces a call or a profiler records, else no range:
    outside them a range would cost two dispatcher calls a call on the
    serving path and be seen by nothing."""
    import torch
    if TRACE[0] is None and not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def off_card(*tensors) -> bool:
    """Every tensor on the CPU, or every one on the meta device."""
    kinds = {t.device.type for t in tensors}
    return kinds == {"cpu"} or kinds == {"meta"}


def plain_route(name: str, shapes, plain):
    """`plain()`, a wrapper's route off the card; under a trace it counts
    as kernel `name` at `shapes()`, not as the plain arithmetic."""
    if TRACE[0] is None:
        return plain()
    return TRACE[0].off_card(name, shapes, plain)


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
