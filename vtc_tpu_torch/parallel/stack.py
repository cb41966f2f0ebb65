"""The switch that routes the models' block stacks through the pipe axis,
the port of ``vtc_tpu/parallel/stack.py``'s ``"pipe"`` mode.

``train.py --pp S`` creates the pipe mesh and calls
``set_stack_parallel("pipe", mesh, n_micro)``; from then on every
``models.layers.Transformer`` (the text tower, the ViT tower, the CAM's
adapter) and the divided space-time stack of ``models.timesformer`` run
through ``pipeline.pipeline_blocks`` instead of their sequential loop, as
``vtc_tpu/models/layers.py:588-597`` and ``timesformer.py:179-191`` consult
it. No model definition or checkpoint changes.

A stack runs sequentially where ``vtc_tpu``'s does: one with MoE layers,
one whose layer count the stages do not divide, and a non-3-D input. The
pipe axis is a layout, never a change of result, so such a stack gives the
same numbers on every stage. The joint TimeSformer has no hook in
``vtc_tpu`` and none here. ``n_micro`` is clamped per call to a divisor of
the rank's batch (``_pick_n_micro``). ``stack_counts()`` counts the stack
forwards of this process that ran pipelined and those that ran
sequentially under the mode. ``vtc_tpu``'s ``"seq"`` mode (ring attention,
``--sp``) is not ported.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

from ..device import DISTRIBUTION
from .mesh import PIPE_AXIS

_CTX: Optional[tuple] = None  # None | ("pipe", mesh, n_micro)
_COUNTS: Counter = Counter()


def set_stack_parallel(mode: Optional[str] = None, mesh=None, n_micro: int = 4) -> None:
    """Select how the stacks run from now on: None (sequentially) or
    ``"pipe"`` (GPipe over ``mesh``'s ``pipe`` axis, ``n_micro``
    microbatches asked for)."""
    global _CTX
    if mode is None:
        _CTX = None
        return
    if mode == "seq":
        raise NotImplementedError(f"stack-parallel mode 'seq' (ring attention, --sp) is not "
                                  f"ported ({DISTRIBUTION})")
    if mode != "pipe":
        raise ValueError(f"unknown stack-parallel mode {mode!r}")
    if mesh is None:
        raise ValueError("set_stack_parallel needs the mesh for the mode")
    if PIPE_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mode 'pipe' needs a 'pipe' mesh axis; got {mesh}")
    _CTX = ("pipe", mesh, int(n_micro))


def stack_parallel_mode() -> Optional[str]:
    return _CTX[0] if _CTX is not None else None


def stack_counts() -> Counter:
    """``{"pipelined": n, "sequential": m}``: the stack forwards since the
    last ``reset_stack_counts`` that ran on the schedule, and those that ran
    their sequential loop under the ``"pipe"`` mode."""
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


def transformer_stack_override(stack, x, causal: bool):
    """Called by ``models.layers.Transformer.forward``: the pipelined
    stack's output, or None when the mode is off or the stack runs its
    sequential loop."""
    if _CTX is None:
        return None
    moe = any(hasattr(block, "mlp_moe") for block in stack.resblocks)
    return _pipelined(stack, x, moe, causal)


def timesformer_stack_override(stack, x, nframes: int):
    """Called by ``models.timesformer.TimeSformerTransformer.forward``: the
    divided space-time stack pipelined, or None (as above)."""
    if _CTX is None:
        return None
    return _pipelined(stack, x, False, nframes)
