"""Feature-extraction controllers of the paper's few-shot experiments
(port of `repro.models.controller`).

Conv4 (Vinyals et al.) -- Omniglot, 48-d embeddings: four blocks of 3x3
convolution (SAME padding), GroupNorm, ReLU and a 2x2 max-pool.
ResNet12 (Oreshkin et al.) -- CUB, 480-d embeddings: four residual blocks
(three 3x3 convolutions with GroupNorm, ReLU between them, a 1x1
shortcut with GroupNorm, ReLU of the sum, a 2x2 max-pool), widths (64,
160, 320, 640).

Both end in global average pooling, a linear projection and a ReLU (MCAM
stores unsigned levels), and pool only while the feature map is at least
2x2 (a VALID pool, flooring odd sizes). GroupNorm is the reference's:
gcd(8, c) groups, population variance, rsqrt(var + 1e-5), no affine.
Images are NHWC at the interface, as in the JAX package; inside,
activations are NCHW and the convolution weights OIHW, PyTorch's layout.

Parameters are nested dicts applied by pure functions (`apply_conv4`,
`apply_resnet12`: what the trainer differentiates); `Conv4` and
`ResNet12` hold the same dicts as nn.Modules.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tree as tree_lib


def _group_norm(x: torch.Tensor, groups: int = 8,
                eps: float = 1e-5) -> torch.Tensor:
    """NCHW group norm as the reference's NHWC `_group_norm`."""
    n, c, h, w = x.shape
    g = math.gcd(groups, c)
    xg = x.reshape(n, g, c // g, h, w)
    mu = xg.mean((2, 3, 4), keepdim=True)
    var = xg.var((2, 3, 4), keepdim=True, correction=0)
    return ((xg - mu) * torch.rsqrt(var + eps)).reshape(n, c, h, w)


def _he_conv(rng: np.random.Generator, k: int, cin: int, cout: int) -> dict:
    """He-normal OIHW convolution weights and zero biases (numpy's draws)."""
    # host ints: the He fan-in, in numpy before the weights are tensors
    w = rng.standard_normal((cout, cin, k, k)) * math.sqrt(
        2.0 / (k * k * cin))  # lint: allow=tensor-number-div
    return {"w": w, "b": np.zeros(cout)}


def _conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution, NCHW."""
    return F.conv2d(x, p["w"], p["b"], padding="same")


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 VALID max-pool, while the map is at least 2x2."""
    if min(x.shape[2], x.shape[3]) >= 2:
        return F.max_pool2d(x, 2, 2)
    return x


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Global average pooling, the projection and the ReLU."""
    x = x.mean((2, 3))
    return torch.relu(x @ params["proj"]["w"] + params["proj"]["b"])


def init_conv4(seed: int = 0, in_ch: int = 1, width: int = 64,
               embed_dim: int = 48,
               device: torch.device | str | None = None) -> dict:
    """Random Conv4 parameters from `seed` (He-normal convolutions, zero
    biases, proj ~ N(0, 1/width)); the draws are numpy's, not jax.random's.
    """
    rng = np.random.default_rng(seed)
    params = {"blocks": []}
    cin = in_ch
    for _ in range(4):
        params["blocks"].append(_he_conv(rng, 3, cin, width))
        cin = width
    params["proj"] = {"w": rng.standard_normal((width, embed_dim))
                      / math.sqrt(width), "b": np.zeros(embed_dim)}
    return _tensors(params, device)


def _tensors(tree, device) -> dict:
    return tree_lib.tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        tree)


def _oihw(conv: dict) -> dict:
    """A JAX package convolution {"w" HWIO, "b"} -> OIHW."""
    return {"w": np.transpose(np.asarray(conv["w"]), (3, 2, 0, 1)),
            "b": conv["b"]}


def conv4_from_numpy(params: dict,
                     device: torch.device | str | None = None) -> dict:
    """Carry Conv4 parameters across from the JAX package (its
    `init_conv4` tree as numpy arrays): convolutions HWIO -> OIHW,
    everything else as it is."""
    out = {"blocks": [_oihw(b) for b in params["blocks"]],
           "proj": {"w": params["proj"]["w"], "b": params["proj"]["b"]}}
    return _tensors(out, device)


def apply_conv4(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> (B, embed_dim) non-negative embeddings."""
    x = images.permute(0, 3, 1, 2)
    for blk in params["blocks"]:
        x = _maxpool(torch.relu(_group_norm(_conv(blk, x))))
    return _head(params, x)


class Conv4(nn.Module):
    """Conv4 as an nn.Module over the parameter dict of `init_conv4`."""

    def __init__(self, params: dict):
        super().__init__()
        self.blocks = nn.ModuleList()
        for blk in params["blocks"]:
            m = nn.Module()
            m.w = nn.Parameter(blk["w"].detach().clone())
            m.b = nn.Parameter(blk["b"].detach().clone())
            self.blocks.append(m)
        self.proj_w = nn.Parameter(params["proj"]["w"].detach().clone())
        self.proj_b = nn.Parameter(params["proj"]["b"].detach().clone())

    def tree(self) -> dict:
        """The parameters as `apply_conv4`'s dict (the same tensors)."""
        return {"blocks": [{"w": m.w, "b": m.b} for m in self.blocks],
                "proj": {"w": self.proj_w, "b": self.proj_b}}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply_conv4(self.tree(), images)


# ---------------------------------------------------------------------------
# ResNet12
# ---------------------------------------------------------------------------

RES_CONVS = ("c1", "c2", "c3", "sc")


def init_resnet12(seed: int = 0, in_ch: int = 3,
                  widths: tuple[int, ...] = (64, 160, 320, 640),
                  embed_dim: int = 480,
                  device: torch.device | str | None = None) -> dict:
    """Random ResNet12 parameters from `seed`: per block He-normal 3x3
    convolutions c1, c2, c3 and a 1x1 shortcut sc, zero biases; proj ~
    N(0, 1/width). The draws are numpy's, not jax.random's."""
    rng = np.random.default_rng(seed)
    params = {"blocks": []}
    cin = in_ch
    for w in widths:
        params["blocks"].append({
            "c1": _he_conv(rng, 3, cin, w), "c2": _he_conv(rng, 3, w, w),
            "c3": _he_conv(rng, 3, w, w), "sc": _he_conv(rng, 1, cin, w)})
        cin = w
    params["proj"] = {"w": rng.standard_normal((cin, embed_dim))
                      / math.sqrt(cin), "b": np.zeros(embed_dim)}
    return _tensors(params, device)


def resnet12_from_numpy(params: dict,
                        device: torch.device | str | None = None) -> dict:
    """Carry ResNet12 parameters across from the JAX package (its
    `init_resnet12` tree as numpy arrays): convolutions HWIO -> OIHW,
    everything else as it is."""
    out = {"blocks": [{c: _oihw(b[c]) for c in RES_CONVS}
                      for b in params["blocks"]],
           "proj": {"w": params["proj"]["w"], "b": params["proj"]["b"]}}
    return _tensors(out, device)


def _res_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_group_norm(_conv(p["c1"], x)))
    h = torch.relu(_group_norm(_conv(p["c2"], h)))
    h = _group_norm(_conv(p["c3"], h))
    return _maxpool(torch.relu(h + _group_norm(_conv(p["sc"], x))))


def apply_resnet12(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> (B, embed_dim) non-negative embeddings."""
    x = images.permute(0, 3, 1, 2)
    for blk in params["blocks"]:
        x = _res_block(blk, x)
    return _head(params, x)


class ResNet12(nn.Module):
    """ResNet12 as an nn.Module over the parameter dict of
    `init_resnet12`."""

    def __init__(self, params: dict):
        super().__init__()
        self.blocks = nn.ModuleList()
        for blk in params["blocks"]:
            m = nn.Module()
            for c in RES_CONVS:
                conv = nn.Module()
                conv.w = nn.Parameter(blk[c]["w"].detach().clone())
                conv.b = nn.Parameter(blk[c]["b"].detach().clone())
                setattr(m, c, conv)
            self.blocks.append(m)
        self.proj_w = nn.Parameter(params["proj"]["w"].detach().clone())
        self.proj_b = nn.Parameter(params["proj"]["b"].detach().clone())

    def tree(self) -> dict:
        """The parameters as `apply_resnet12`'s dict (the same tensors)."""
        return {"blocks": [{c: {"w": getattr(m, c).w, "b": getattr(m, c).b}
                            for c in RES_CONVS} for m in self.blocks],
                "proj": {"w": self.proj_w, "b": self.proj_b}}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply_resnet12(self.tree(), images)


#: name -> (init, apply), as the reference's registry
CONTROLLERS = {
    "conv4": (init_conv4, apply_conv4),
    "resnet12": (init_resnet12, apply_resnet12),
}
