"""Feature-extraction controller of the paper's Omniglot experiment (port
of `repro.models.controller`, Conv4; ResNet12 waits, ROADMAP Queue A5).

Conv4 (Vinyals et al.): four blocks of 3x3 convolution (SAME padding),
GroupNorm, ReLU and a 2x2 max-pool, then global average pooling, a linear
projection and a ReLU (MCAM stores unsigned levels). GroupNorm is the
reference's: gcd(8, c) groups, population variance, rsqrt(var + 1e-5), no
affine. Images are NHWC at the interface, as in the JAX package; inside,
activations are NCHW and the convolution weights OIHW, PyTorch's layout.

Parameters are a nested dict, {"blocks": [{"w", "b"} x 4], "proj": {"w",
"b"}}, applied by the pure function `apply_conv4(params, images)` (what
the trainer differentiates); `Conv4` holds the same dict as an nn.Module.
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
        fan_in = 9 * cin
        w = rng.standard_normal((width, cin, 3, 3)) * math.sqrt(2.0 / fan_in)
        params["blocks"].append({"w": w, "b": np.zeros(width)})
        cin = width
    params["proj"] = {"w": rng.standard_normal((width, embed_dim))
                      / math.sqrt(width), "b": np.zeros(embed_dim)}
    return _tensors(params, device)


def _tensors(tree, device) -> dict:
    return tree_lib.tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        tree)


def conv4_from_numpy(params: dict,
                     device: torch.device | str | None = None) -> dict:
    """Carry Conv4 parameters across from the JAX package (its
    `init_conv4` tree as numpy arrays): convolutions HWIO -> OIHW,
    everything else as it is."""
    out = {"blocks": [{"w": np.transpose(np.asarray(b["w"]), (3, 2, 0, 1)),
                       "b": b["b"]} for b in params["blocks"]],
           "proj": {"w": params["proj"]["w"], "b": params["proj"]["b"]}}
    return _tensors(out, device)


def apply_conv4(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> (B, embed_dim) non-negative embeddings."""
    x = images.permute(0, 3, 1, 2)
    for blk in params["blocks"]:
        x = F.conv2d(x, blk["w"], blk["b"], padding="same")
        x = torch.relu(_group_norm(x))
        if min(x.shape[2], x.shape[3]) >= 2:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean((2, 3))                                     # GAP
    return torch.relu(x @ params["proj"]["w"] + params["proj"]["b"])


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
