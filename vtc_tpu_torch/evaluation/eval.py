"""Test-split evaluation of the port, the twin of ``evaluation/eval.py``:

    python -m vtc_tpu_torch.evaluation.eval -c configs/pretrained_clip.jsonc \\
        -r saved/models/run/model_best.pth [-d cpu]

Bidirectional R@1/5/10 on the config's test split, the JSON results named
by the experiment combo, and the ``add_irrelevant_comms`` robustness
probe (``--num_irrelevant_comments``), on the card unless ``-d cpu``.
Checkpoints are the port's ``.pth`` (``training.checkpoints``); an Orbax
directory of the JAX package is refused by name, with the route to a
``.pth`` (``scripts/export_torch_checkpoint.py``, run where JAX is).

Under a process group (``torchrun --nproc_per_node N -m
vtc_tpu_torch.evaluation.eval ... --n_devices N``, or ``--multihost 1``)
each process encodes the strided disjoint subset ``rank::world`` of the test
split, the embedding blocks are merged by ``allgather_varlen`` and both
directions are ranked on every process (``evaluation/eval.py:80-101,
267-286``); R@K does not depend on the rows' order, since queries and
gallery permute together. Rank 0 alone writes the JSON file. With
``--n_model M`` (``torchrun --nproc_per_node N·M``) the group is
``create_mesh(N, M)``'s: the model is split over each model group
(``parallel.tensor``), whose ranks encode the same share, and the shares
merge over the data group. A config with ``fsdp`` (an fsdp run's) is
evaluated as ``vtc_tpu``'s evaluation does it: the whole model on every
data rank, from the run's single-card checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import data as module_data
from ..config import ConfigParser, CustomArgs
from ..data import DataLoader
from ..data.tokenizer import truncate_batch_tokens
from ..device import resolve_device
from ..models import create_model
from ..ops.retrieval import recall_at_k
from ..parallel.mesh import (
    check_axes,
    check_data_devices,
    create_mesh,
    data_group,
    model_rank,
    process_share,
)
from ..parallel.tensor import shard_model
from ..training.checkpoints import graft_into, load_checkpoint
from ..training.trainer import flatten_data
from ..utils.util import all_max, allgather_varlen, init_distributed, launched, world


def add_irrelevant_comms(comments: np.ndarray, num_irrelevant_comments: int,
                         seed: int = 0) -> np.ndarray:
    """Append comments drawn at random from *other* batch elements
    (``evaluation/eval.py:30``, whose fixed version this is: every row is
    populated, with the same ``default_rng(seed)`` draws)."""
    rng = np.random.default_rng(seed)
    bs, ncomms, ntoks = comments.shape
    if bs < 2:
        # a 1-element batch has no other element to draw from
        raise ValueError(
            "add_irrelevant_comms needs batches of >= 2 items to draw irrelevant comments "
            "from; use a batch size that avoids 1-element remainders (or drop_last)")
    total = ncomms + num_irrelevant_comments
    updated = np.zeros((bs, total, ntoks), dtype=comments.dtype)
    for i in range(bs):
        new_comms = []
        comm_indices = rng.integers(0, ncomms, size=num_irrelevant_comments)
        for comm_ind in comm_indices:
            batch_ind = int(rng.integers(0, bs))
            if batch_ind == i:
                batch_ind = (batch_ind + 1) % bs
            new_comms.append(comments[batch_ind, comm_ind])
        updated[i] = np.concatenate([comments[i], np.stack(new_comms)], axis=0)
    return updated


class _StridedSubset:
    """Every ``count``-th item from ``index``: a process's share of the
    test split (``evaluation/eval.py:_StridedSubset``). The shares cover
    the split once; their uneven tails merge through the varlen gather."""

    def __init__(self, dataset, index: int, count: int):
        self.dataset, self.index, self.count = dataset, int(index), int(count)

    def __len__(self):
        return len(range(self.index, len(self.dataset), self.count))

    def __getitem__(self, i):
        return self.dataset[self.index + i * self.count]


def main(config: ConfigParser, args, checkpoint_path, device=None,
         process_index=None, process_count=None) -> dict:
    """Run the test-split evaluation as ``evaluation/eval.py:main`` does, on
    ``device`` (default: the card); returns the six recalls, also written
    to the JSON file that ``evaluation/eval.py`` names. Under a process
    group each process encodes its strided share (``process_index``/
    ``process_count``, the group's by default)."""
    device = resolve_device(device)
    logger = config.get_logger("test")
    n_model = int(config.get("n_model", 1) or 1)
    check_axes(n_model)
    check_data_devices(config.get("n_devices", 1), device, logger, "evaluating",
                       "vtc_tpu_torch.evaluation.eval", n_model)
    if world() > 1:
        create_mesh(world() // n_model, n_model, device=device)
    pidx, pcount = process_share(process_index, process_count)

    dataset = config.init_obj("dataset", module_data, train=False, test=True, device=device)
    n_total = len(dataset)
    if pcount > 1:
        dataset = _StridedSubset(dataset, pidx, pcount)
        logger.info("multi-process eval: process %d/%d evaluates %d of the %d items",
                    pidx, pcount, len(dataset), n_total)

    arch_args = dict(config["arch"]["args"])
    branch_to_adapt = arch_args.get("branch_to_adapt_val", None)
    comment_fusion = arch_args.get("comment_fusion", None)
    num_comms = config["dataset"]["args"].get("num_comms", None)
    add_comments = config["dataset"]["args"]["add_comments"]
    num_irrelevant_comments = args.num_irrelevant_comments

    if branch_to_adapt is None:
        if add_comments != "always":
            exp_combo = "title_only"
        else:
            exp_combo = f"{comment_fusion}_{num_comms}_comms"
    else:
        exp_combo = f"adapted_{branch_to_adapt}_{num_comms}_comms"

    if checkpoint_path is not None:
        save_path = f"{Path(checkpoint_path).absolute().as_posix()}_res_{exp_combo}.json"
    else:
        save_path = f"zero_shot_res_{comment_fusion}.json"
    logging.info("Saving results to %s", save_path)

    data_loader = DataLoader(dataset, batch_size=config["batch_size"], num_workers=10,
                             shuffle=False)

    model = create_model(config["arch"]["type"], device=device, **arch_args)
    if checkpoint_path is not None:
        graft_into(model, load_checkpoint(checkpoint_path)["state_dict"], strict=True)
    shard_model(model)  # over the model axis, where the mesh has one
    logger.info("Model: %s", config["arch"]["type"])

    needs_comments = hasattr(model, "branch_to_adapt_val")
    if num_irrelevant_comments and needs_comments:
        # fail fast, before encoding, and on every process alike: a
        # 1-element tail batch would make add_irrelevant_comms raise mid-loop
        # on the process that drew it, leaving the others in the gather
        bs = int(config["batch_size"])
        sizes = [len(range(p, n_total, pcount)) for p in range(pcount)]
        if bs < 2 or any(n % bs == 1 for n in sizes):
            raise ValueError(
                f"--num_irrelevant_comments with batch_size={bs} yields a 1-element batch "
                f"(split sizes {sizes}); add_irrelevant_comms needs >= 2 items per batch "
                f"— use batch_size >= 2 without 1-element remainders")

    res_vis, res_text = [], []
    with torch.inference_mode():
        for items in data_loader:
            *batch, meta = items
            # the audio config's (comments, audio) nesting, as the trainer reads it
            batch = [np.asarray(d) for d in flatten_data(batch)]
            if num_irrelevant_comments and needs_comments:
                if num_irrelevant_comments > config["batch_size"]:
                    raise ValueError("Number of irrelevant comments needs to be smaller "
                                     "than batch size.")
                batch[2] = add_irrelevant_comms(batch[2], num_irrelevant_comments)
            # exact for the causal, EOT-pooled text tower: one shared bucket
            batch = truncate_batch_tokens(batch)
            feats_vis, feats_text = model(*[torch.as_tensor(d, device=device)
                                            for d in batch])[:2]
            res_vis.append(feats_vis.float().cpu().numpy())
            res_text.append(feats_text.float().cpu().numpy())
    if res_vis:
        res_vis = np.concatenate(res_vis)
        res_text = np.concatenate(res_text)
    elif pcount == 1:
        raise RuntimeError(f"eval produced no embeddings: the test split of {len(dataset)} "
                           f"items is empty or smaller than expected")
    if pcount > 1:
        # a process whose share is empty joins the gathers with empty blocks
        # of the width the others agree on; raising alone would leave them
        # waiting in the gather
        dim = all_max(res_vis.shape[1] if len(res_vis) else 0)
        if dim == 0:
            raise RuntimeError(f"eval produced no embeddings on ANY of {pcount} processes: "
                               f"the test split is empty (check the data root paths)")
        if not len(res_vis):
            res_vis = res_text = np.zeros((0, dim), np.float32)
        res_vis = allgather_varlen(np.asarray(res_vis, np.float32), data_group())
        res_text = allgather_varlen(np.asarray(res_text, np.float32), data_group())

    recall_title_from_im = recall_at_k(res_vis, res_text, [1, 5, 10], device=device)
    recall_im_from_title = recall_at_k(res_text, res_vis, [1, 5, 10], device=device)
    logging.info("Recall im from title: %s", recall_im_from_title)
    logging.info("Recall title from im: %s", recall_title_from_im)

    out = {
        "R1_title_from_im": recall_title_from_im[0][1],
        "R5_title_from_im": recall_title_from_im[1][1],
        "R10_title_from_im": recall_title_from_im[2][1],
        "R1_im_from_title": recall_im_from_title[0][1],
        "R5_im_from_title": recall_im_from_title[1][1],
        "R10_im_from_title": recall_im_from_title[2][1],
    }
    if pidx == 0 and model_rank() == 0:  # every process holds them; one writes
        with open(save_path, "w") as f:
            json.dump(out, f)
    return out


OPTIONS = [
    CustomArgs(["--multihost"], type=int, target="multihost"),
    CustomArgs(["--lr", "--learning_rate"], type=float, target="optimizer;args;lr"),
    CustomArgs(["--bs", "--batch_size"], type=int, target="batch_size"),
    CustomArgs(["--n_devices"], type=int, target="n_devices"),
    CustomArgs(["--n_model"], type=int, target="n_model"),
    CustomArgs(["--bv", "--branch_to_adapt_val"], type=str,
               target="arch;args;branch_to_adapt_val"),
    CustomArgs(["--nc", "--num_comms"], type=int, target="dataset;args;num_comms"),
    CustomArgs(["--am", "--comment_fusion"], type=str, target="arch;args;comment_fusion"),
    CustomArgs(["--ac", "--add_comments"], type=str, target="dataset;args;add_comments"),
]


def parser() -> argparse.ArgumentParser:
    args = argparse.ArgumentParser(description="vtc_tpu_torch evaluation")
    args.add_argument("-c", "--config", default="configs/pretrained_clip.jsonc", type=str)
    args.add_argument("-r", "--resume", default=None, type=str)
    # the device to run on ("cpu", "cuda", "cuda:1"); the JAX CLI's device
    # count is --n_devices
    args.add_argument("-d", "--device", dest="run_device", default=None, type=str)
    args.add_argument("--num_irrelevant_comments", default=0, type=int)
    return args


def cli(argv=None) -> dict:
    """Parse ``argv`` (default: the process's) as ``evaluation/eval.py``
    does, then ``main`` on the device ``-d`` names; in a process that
    ``torchrun`` started, or with ``--multihost``, join the process group
    first."""
    if launched():  # torchrun: the group exists before the run dir is picked
        init_distributed()
    args = parser()
    config = ConfigParser.from_args(args, OPTIONS, argv)
    if config.get("multihost"):
        init_distributed()
        config.finalize_run_dir()
    parsed = args.parse_args(argv)
    return main(config, parsed, config.resume, device=parsed.run_device)


if __name__ == "__main__":
    logging.getLogger().setLevel(logging.INFO)
    cli()
