"""GDT's ResNet-9 audio tower (``AudioBaseNetwork("resnet9")``, consumed by
the reference at ``model/model.py:408-438`` and
``scripts/get_audio_embeddings.py:30-39``).

Port of ``vtc_tpu/audio/resnet9.py``: a torchvision ResNet with one
``BasicBlock`` per stage (64, 128, 256, 512) over single-channel log
spectrograms ``[b, 1, 257, 199]`` (NCHW), average-pooled to ``[b, 512]``
(the classifier replaced by the identity). The module carries GDT's names
under ``base.*`` (``base.conv1``, ``base.bn1``, ``base.layerN.0.*``), so
``load_gdt_state_dict`` loads the ``audio_network.*`` keys of a GDT
checkpoint strictly, the layout ``vtc_tpu``'s ``import_gdt_audio_weights``
reads. The convolutions are ``nn.Conv2d`` (cuDNN on the card: the JAX
package runs them through XLA, with no Pallas kernel), in ``dtype``;
BatchNorm in fp32.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..models.layers import TorchBatchNorm


class Conv2d(nn.Conv2d):
    """A bias-free ``nn.Conv2d`` whose weight is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride, padding, bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1)
        self.bn1 = TorchBatchNorm(cout, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1)
        self.bn2 = TorchBatchNorm(cout, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Conv2d(cin, cout, 1, stride),
                                            TorchBatchNorm(cout, dtype=dtype))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + identity)


class _Base(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv1 = Conv2d(1, 64, 7, 2, 3)
        self.bn1 = TorchBatchNorm(64, dtype=dtype)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (cout, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            self.add_module(f"layer{i + 1}", nn.Sequential(BasicBlock(cin, cout, stride,
                                                                      dtype)))
            cin = cout

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.float().mean(dim=(2, 3))


class AudioResNet9(nn.Module):
    """``[b, 1, 257, 199]`` -> ``[b, 512]`` fp32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.base = _Base(dtype)

    def forward(self, x):
        return self.base(x.to(self.dtype))


def load_gdt_state_dict(model: AudioResNet9, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a GDT checkpoint's audio tower strictly: its
    ``audio_network.base.*`` keys (or bare ``base.*``), as
    ``import_gdt_audio_weights`` selects them."""
    sd = {}
    for k, v in state_dict.items():
        if "audio_network." in k:
            k = k.split("audio_network.", 1)[1]
        elif not k.startswith("base."):
            continue
        if k.startswith("base."):
            sd[k] = torch.as_tensor(v)
    model.load_state_dict(sd, strict=True)
