"""Transfer-evaluation CLI of the port, the twin of
``evaluation/retrieval_evaluation.py`` (the reference's
``evaluation/retrieval_evaluation.py:271-363``):

    python -m vtc_tpu_torch.evaluation.retrieval_evaluation -m clip_timesformer_finaltf \\
        -r model_best.pth -c MSRVTT_videos [-d cpu]

The same parser; ``-d`` names the torch device to run on (``cpu``,
``cuda``, ``cuda:1``), as the ``eval.py`` twin's does; without it, the
card. A name that is no torch device raises. ``main(argv, dataset)`` takes
an injected dataset as ``retrieval_eval.retrieval_evaluation`` does.
``--n_devices N`` under ``torchrun --nproc_per_node N`` splits the videos
over the processes (``retrieval_eval``); without a process group it runs
on one device with a warning where the machine has fewer cards, and raises
with the ``torchrun`` line where it has them.
"""

from __future__ import annotations

import argparse
import logging

from ..device import resolve_device
from ..models import create_model
from ..parallel.mesh import check_data_devices
from ..utils.util import init_distributed, launched
from ..training.checkpoints import graft_into, load_checkpoint
from .retrieval_eval import retrieval_evaluation

MODEL_TYPES = {
    "pretrained_clip": "PretrainedCLIP",
    "clip_timesformer": "PretrainedCLIP_TimeSformer",
    "pretrained_clip_finaltf": "PretrainedCLIP_finaltf",
    "clip_timesformer_finaltf": "PretrainedCLIP_TimeSformer_finaltf",
}


def load_model(checkpoint_path, model_type, branch_to_adapt="text",
               residual_activation="none", device=None):
    """``retrieval_evaluation.py:65-105``: the model of ``model_type`` (a
    key of ``MODEL_TYPES``) on ``device`` (default: the card), with the
    ``.pth`` at ``checkpoint_path`` grafted in strictly; ``init_from_avg``
    comes from the checkpoint's config. An Orbax directory raises."""
    init_from_avg = False
    restored = None
    if checkpoint_path is not None:
        restored = load_checkpoint(checkpoint_path)
        cfg = restored.get("config") or {}
        try:
            init_from_avg = cfg["arch"]["args"].get("init_from_avg", False)
        except (KeyError, TypeError, AttributeError):
            init_from_avg = False

    arch = MODEL_TYPES[model_type]
    kwargs = {"residual_activation": residual_activation}
    if "finaltf" in model_type:
        kwargs.update(branch_to_adapt_val=branch_to_adapt, init_from_avg=init_from_avg)
    model = create_model(arch, device=resolve_device(device), **kwargs)

    if restored is not None:
        graft_into(model, restored["state_dict"], strict=True)
    return model


def parser() -> argparse.ArgumentParser:
    args = argparse.ArgumentParser()
    args.add_argument("-c", "--dataset", default="MSRVTT_videos",
                      choices=["MSRVTT_videos", "MSVD_videos", "K700_videos", "Reddit_videos",
                               "livebot"], type=str)
    args.add_argument("-r", "--checkpoint", default=None, type=str)
    args.add_argument("-m", "--model_type", default=None, type=str)
    args.add_argument("-d", "--device", default=None, type=str)
    args.add_argument("-s", "--split", default="full-test", type=str)
    args.add_argument("--branch_to_adapt", default="text",
                      choices=["text", "image", "random", "skip"], type=str)
    args.add_argument("--residual_activation", default="none", type=str)
    args.add_argument("--out_csv", default=None, type=str)
    args.add_argument("--frame_stride", default=16, type=int)
    args.add_argument("--first_frame_only", action="store_true")
    args.add_argument("--first_chunk_only", action="store_true")
    args.add_argument("--n_devices", default=1, type=int,
                      help="the processes of a torchrun group to split the videos over")
    return args


def main(argv=None, dataset=None):
    """CLI entry (``argv`` and ``dataset`` injectable, as in the JAX
    package); returns the recall table. In a process that ``torchrun``
    started, join the process group first."""
    args = parser().parse_args(argv)
    if launched():
        init_distributed()
    device = resolve_device(args.device)
    check_data_devices(args.n_devices, device, logging.getLogger(__name__), "evaluating",
                       "vtc_tpu_torch.evaluation.retrieval_evaluation")
    model = load_model(args.checkpoint, args.model_type, branch_to_adapt=args.branch_to_adapt,
                       residual_activation=args.residual_activation, device=device)
    return retrieval_evaluation(
        model, args.dataset, args.split, out_csv=args.out_csv, frame_stride=args.frame_stride,
        first_frame_only=args.first_frame_only, first_chunk_only=args.first_chunk_only,
        dataset=dataset, device=device)


if __name__ == "__main__":
    logging.getLogger().setLevel("INFO")
    main()
