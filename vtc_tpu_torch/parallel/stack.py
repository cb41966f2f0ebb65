"""The switch that routes the models' block stacks through the pipe or the
sequence axis, the port of ``vtc_tpu/parallel/stack.py``.

``train.py --pp S`` creates the pipe mesh and calls
``set_stack_parallel("pipe", mesh, n_micro)``; from then on every
``models.layers.Transformer`` (the text tower, the ViT tower, the CAM's
adapter) and the divided space-time stack of ``models.timesformer`` run
through ``pipeline.pipeline_blocks`` instead of their sequential loop, as
``vtc_tpu/models/layers.py:588-597`` and ``timesformer.py:179-191`` consult
it. ``train.py --sp S`` creates the sequence mesh and calls
``set_stack_parallel("seq", mesh)``: every ``Transformer`` then runs
``sequence.sp_transformer``, ring attention over its sequence shards. No
model definition or checkpoint changes.

A stack runs sequentially where ``vtc_tpu``'s does: one with MoE layers and
a non-3-D input under either mode, one whose layer count the stages do not
divide under ``"pipe"``, and the TimeSformer's divided space-time stack
under ``"seq"`` (its token layout alternates between temporal and spatial
groups, so the video tower runs data-parallel). The axes are layouts,
never a change of result, so such a stack gives the same numbers on every
rank. The joint TimeSformer has no hook in ``vtc_tpu`` and none here.
``n_micro`` is clamped per call to a divisor of the rank's batch
(``_pick_n_micro``). ``stack_counts()`` counts the stack forwards of this
process that ran pipelined, on the ring and sequentially under a mode.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

from .mesh import PIPE_AXIS, SEQ_AXIS

_CTX: Optional[tuple] = None  # None | ("pipe", mesh, n_micro) | ("seq", mesh, None)
_COUNTS: Counter = Counter()


def set_stack_parallel(mode: Optional[str] = None, mesh=None, n_micro: int = 4) -> None:
    """Select how the stacks run from now on: None (sequentially),
    ``"pipe"`` (GPipe over ``mesh``'s ``pipe`` axis, ``n_micro``
    microbatches asked for) or ``"seq"`` (ring attention over its ``seq``
    axis)."""
    global _CTX
    if mode is None:
        _CTX = None
        return
    if mode not in ("pipe", "seq"):
        raise ValueError(f"unknown stack-parallel mode {mode!r}")
    if mesh is None:
        raise ValueError("set_stack_parallel needs the mesh for the mode")
    axis = {"pipe": PIPE_AXIS, "seq": SEQ_AXIS}[mode]
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mode {mode!r} needs a {axis!r} mesh axis; got {mesh}")
    _CTX = (mode, mesh, int(n_micro) if mode == "pipe" else None)


def stack_parallel_mode() -> Optional[str]:
    return _CTX[0] if _CTX is not None else None


def stack_counts() -> Counter:
    """``{"pipelined": n, "ring": r, "sequential": m}``: the stack forwards
    since the last ``reset_stack_counts`` that ran on the pipe schedule, on
    the ring, and those that ran their sequential loop under a mode."""
    return Counter(_COUNTS)


def reset_stack_counts() -> None:
    _COUNTS.clear()


def _pick_n_micro(requested: int, local_batch: int) -> int:
    m = max(1, min(int(requested), local_batch))
    while local_batch % m:
        m -= 1
    return m


def _pipelined(stack, x, moe: bool, *args):
    """``stack``'s blocks on ``x`` through the pipeline, or None where it
    runs sequentially (the module docstring)."""
    from .pipeline import pipe_axis, pipeline_blocks

    _, mesh, n_micro = _CTX
    axis = pipe_axis(mesh)
    if moe or x.dim() != 3 or len(stack.resblocks) % axis.size:
        _COUNTS["sequential"] += 1
        return None
    _COUNTS["pipelined"] += 1
    stack.pipelined = True  # its block gradients are summed over the stages
    return pipeline_blocks(stack.resblocks, x, *args, axis=axis,
                           n_micro=_pick_n_micro(n_micro, x.shape[0]))


def _ring(stack, x, moe: bool, causal: bool):
    """``stack``'s blocks on ``x`` with ring attention over the sequence
    shards, or None where it runs sequentially (the module docstring)."""
    from .sequence import seq_axis, sp_transformer

    if moe or x.dim() != 3:
        _COUNTS["sequential"] += 1
        return None
    _COUNTS["ring"] += 1
    stack.ring = True  # its block gradients are summed over the seq group
    return sp_transformer(stack, x, causal, axis=seq_axis(_CTX[1]))


def transformer_stack_override(stack, x, causal: bool):
    """Called by ``models.layers.Transformer.forward``: the pipelined or
    ring-sharded stack's output, or None when the mode is off or the stack
    runs its sequential loop."""
    if _CTX is None:
        return None
    moe = any(hasattr(block, "mlp_moe") for block in stack.resblocks)
    if _CTX[0] == "seq":
        return _ring(stack, x, moe, causal)
    return _pipelined(stack, x, moe, causal)


def timesformer_stack_override(stack, x, nframes: int):
    """Called by ``models.timesformer.TimeSformerTransformer.forward``: the
    divided space-time stack pipelined, or None (as above; under ``"seq"``
    always: the video tower runs data-parallel)."""
    if _CTX is None:
        return None
    if _CTX[0] == "seq":
        _COUNTS["sequential"] += 1
        return None
    return _pipelined(stack, x, False, nframes)
