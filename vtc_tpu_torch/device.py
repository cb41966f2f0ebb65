"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

# what a refusal of a distributed mode names: the data, model, expert and
# pipe axes and ZeRO-3 (FSDP2) run (one process per card under torchrun), and
# so do the sharded gallery and encode; the sequence and multi-slice axes
# (item 9c) do not
DISTRIBUTION = "ROADMAP: Queue 1 item 9c, the other axes of distribution on torch.distributed"

# the card's figures (the H100 SXM data sheet), for bounds and MFU: the HBM3
# rate and the dense peaks, bf16 on the tensor cores and fp32 on the CUDA
# cores (TF32 stays off, below)
CARD = "H100"
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: raise when there is none, never drop to the
    CPU quietly; under a process group on the card it is this process's
    card, ``cuda:LOCAL_RANK``. An explicit device is taken as given.

    fp32 matmuls and convolutions are pinned to full fp32 on the card
    (PyTorch lets cuDNN use TF32 by default), so an fp32 run keeps the
    reference's numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        import torch.distributed as dist

        if dist.is_initialized():
            from .utils.util import local_rank

            return torch.device("cuda", local_rank())
        return torch.device("cuda")
    return torch.device(device)
