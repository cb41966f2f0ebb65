"""R(2+1)D-34, the ig65m video backbone (reference wrapper
``R2Plus1D_34_IG65M_32frames``, ``model/model.py:626-661``).

Port of ``vtc_tpu/models/r2plus1d.py``: every 3x3x3 convolution factorized
into a (1, 3, 3) spatial conv -> BatchNorm -> ReLU -> (3, 1, 1) temporal
conv, with the intermediate width that keeps the 3-D conv's parameter count
(``_midplanes``, computed once per block from its input and output widths
and used by both of its convs); the stem, layers (3, 4, 6, 3) of widths
(64, 128, 256, 512), then spatial and temporal pooling (mean or max) to
``[b, 512]``.

The module is NCDHW (``[b, 3, t, h, w]``, the reference's layout) and
carries torchvision's ``r2plus1d_34`` names (``stem.{0,1,3,4}``,
``layerN.M.conv1.0.{0,1,3}``, ``layerN.M.conv1.1``, ``layerN.M.downsample``),
so a torchvision or ig65m state dict loads strictly through
``load_ig65m_state_dict`` (the layout ``vtc_tpu``'s ``import_ig65m_weights``
reads). The convolutions are ``nn.Conv3d``, cuDNN on the card: the JAX
package runs them through XLA, with no Pallas kernel. They compute in
``dtype``; BatchNorm (``layers.TorchBatchNorm``) in fp32.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .layers import TorchBatchNorm

LAYERS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def _midplanes(cin: int, cout: int) -> int:
    """torchvision's ``Conv2Plus1D`` width rule."""
    return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)


class Conv3d(nn.Conv3d):
    """A bias-free ``nn.Conv3d`` whose weight is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride, padding, bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _conv2plus1d(cin: int, cout: int, mid: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv3d(cin, mid, (1, 3, 3), (1, stride, stride), (0, 1, 1)),
        TorchBatchNorm(mid, dtype=dtype), nn.ReLU(),
        Conv3d(mid, cout, (3, 1, 1), (stride, 1, 1), (1, 0, 0)))


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock`` with ``Conv2Plus1D``: ``conv1`` =
    (Conv2Plus1D, BN, ReLU), ``conv2`` = (Conv2Plus1D, BN), a (1, 1, 1)
    ``downsample`` where the stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        mid = _midplanes(cin, cout)  # shared by conv1 AND conv2
        self.conv1 = nn.Sequential(_conv2plus1d(cin, cout, mid, stride, dtype),
                                   TorchBatchNorm(cout, dtype=dtype), nn.ReLU())
        self.conv2 = nn.Sequential(_conv2plus1d(cout, cout, mid, 1, dtype),
                                   TorchBatchNorm(cout, dtype=dtype))
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Conv3d(cin, cout, 1, stride),
                                            TorchBatchNorm(cout, dtype=dtype))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv2(self.conv1(x)) + identity)


class R2Plus1D_34_IG65M_32frames(nn.Module):
    """``[b, 3, t, h, w]`` -> ``[b, 512]`` fp32, spatial then temporal
    pooling (``"mean"`` or ``"max"``)."""

    def __init__(self, pool_spatial: str = "mean", pool_temporal: str = "mean",
                 dtype=torch.float32):
        super().__init__()
        self.pool_spatial, self.pool_temporal = pool_spatial, pool_temporal
        self.dtype = dtype
        self.stem = nn.Sequential(
            Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3)),
            TorchBatchNorm(45, dtype=dtype), nn.ReLU(),
            Conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0)),
            TorchBatchNorm(64, dtype=dtype), nn.ReLU())
        cin = 64
        for li, (n, w) in enumerate(zip(LAYERS, WIDTHS)):
            blocks = []
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(BasicBlock(cin, w, stride, dtype))
                cin = w
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x, generator=None, draws=None):
        # no random draws: ``generator``/``draws`` are the train step's call
        x = self.stem(x.to(self.dtype))
        for li in range(len(LAYERS)):
            x = getattr(self, f"layer{li + 1}")(x)
        x = x.float()  # [b, c, t, h, w]
        x = x.mean(dim=(3, 4)) if self.pool_spatial == "mean" else x.amax(dim=(3, 4))
        return x.mean(dim=2) if self.pool_temporal == "mean" else x.amax(dim=2)


def load_ig65m_state_dict(model: R2Plus1D_34_IG65M_32frames,
                          state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a torchvision/ig65m ``r2plus1d_34`` state dict strictly, less its
    classifier ``fc.*``, which the wrapper does not use (as
    ``import_ig65m_weights`` reads no ``fc``)."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if not k.startswith("fc.")}
    model.load_state_dict(sd, strict=True)
