"""Dense AVSS LUT-distance product (port of `repro.kernels.mcam_dist`).

    out[b, n] = sum_c q[b, c] * s[n, c]          (B, K) x (N, K)^T -> (B, N)

With one-hot queries and the write-time LUT projection as `s`, this is the
exact ideal AVSS distance of every (query, support) pair. The CUDA kernel
is `csrc/mcam_dist.cu` (bf16: wgmma on the tensor cores, fed by TMA or,
for a depth TMA cannot describe, by plain loads; f32: SIMT FMA);
`lut_dist_matmul_plain` is its plain version. Both are exact for
integer-valued operands (f32 sums below 2**24).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"mcam_dist_launch": [_P, _P, _P, _I, _I, _I, _I, _P]}

_DTYPES = (torch.bfloat16, torch.float32)

# csrc/mcam_dist.cu routes: bf16 wgmma fed by TMA, bf16 wgmma fed by plain
# loads, f32 SIMT FMA
ROUTE_TMA, ROUTE_RAGGED, ROUTE_SIMT_F32 = 0, 1, 2


def dist_route(dtype: torch.dtype, k: int, *addresses: int) -> int:
    """The kernel route for operands of `dtype` with depth `k` at the given
    device addresses: TMA needs a 16-byte row stride (k % 8 == 0 in bf16)
    and 16-byte aligned bases; f32 never takes the tensor cores (TF32
    would round LUT entries above 2**11)."""
    if dtype == torch.float32:
        return ROUTE_SIMT_F32
    if k > 0 and k % 8 == 0 and all(a % 16 == 0 for a in addresses):
        return ROUTE_TMA
    return ROUTE_RAGGED


def lut_dist_matmul_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: accumulate one rank-1 update per depth column in
    float32 (no library product)."""
    qf = q.to(torch.float32)
    sf = s.to(torch.float32)
    out = torch.zeros(q.shape[0], s.shape[0], dtype=torch.float32,
                      device=q.device)
    for c in range(q.shape[1]):
        out.addcmul_(qf[:, c:c + 1], sf[:, c][None, :])
    return out


def lut_dist_matmul(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, K) x (N, K) -> (B, N) float32. Both operands bf16 or both f32.

    A CPU or meta tensor runs the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    if q.dim() != 2 or s.dim() != 2 or q.shape[1] != s.shape[1]:
        raise ValueError(f"lut_dist_matmul: shapes {tuple(q.shape)} and "
                         f"{tuple(s.shape)} do not contract")
    if q.dtype != s.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"lut_dist_matmul: dtypes {q.dtype}, {s.dtype}; "
                        f"expected both bf16 or both f32")

    def shapes():
        return dict(b=q.shape[0], n=s.shape[0], k=q.shape[1],
                    elem=q.element_size())
    if _build.off_card(q, s):
        return _build.plain_route("mcam_dist", shapes,
                                  lambda: lut_dist_matmul_plain(q, s))
    if q.device.type != "cuda":
        raise ValueError(f"lut_dist_matmul: unsupported device {q.device}")
    _build.require_cuda("lut_dist_matmul", q, s)
    B, K = q.shape
    N = s.shape[0]
    out = torch.empty(B, N, dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    if q.dtype == torch.float32 and (B + 63) // 64 > 65535:
        raise ValueError(f"lut_dist_matmul: B={B} exceeds the grid")
    route = dist_route(q.dtype, K, q.data_ptr(), s.data_ptr())
    lib = _build.load("mcam_dist", _SIGNATURES)
    err = lib.mcam_dist_launch(
        _build.ptr(q), _build.ptr(s), _build.ptr(out), ctypes.c_int(B),
        ctypes.c_int(N), ctypes.c_int(K), ctypes.c_int(route),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "mcam_dist_launch")
    _build.count_launch("mcam_dist", shapes)
    return out
