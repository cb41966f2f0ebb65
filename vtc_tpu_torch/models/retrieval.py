"""CLIP-backed retrieval models.

Port of ``vtc_tpu/models/retrieval.py``: ``PretrainedCLIP``,
``PretrainedCLIP_finaltf`` (CLIP + CAM), and the video models
``PretrainedCLIP_TimeSformer`` and ``PretrainedCLIP_TimeSformer_finaltf``
(the TimeSformer tower, without and with the CAM). Each keeps the reference's forward
contract ``forward(vis, title[, comments]) -> (feats_vis, feats_text, sim)``
with L2-normalized features and ``sim = exp(logit_scale) · v @ tᵀ``.

State-dict names are the reference's: the CLIP towers under ``model.*``
(``model.visual.*``, ``model.transformer.*``, ...), the CAM at the top level
(``final_transformer.*``, ``final_linear.weight``, ``mask_embedding``,
``mean_center_bn.*``), so ``load_state_dict(strict=True)`` takes a
reference checkpoint's keys.

In training (``module.train()``, ``vtc_tpu/models/retrieval.py:287-349``)
the CAM models adapt ``branch_to_adapt`` (not ``branch_to_adapt_val``), mask
comments at random when ``random_comment_masking`` is set, skip the adapter
at random when ``random_skip_adapter`` is set, and refuse the eval-only
shared-comment broadcast. The random draws come from the ``generator`` the
caller passes, or are handed in as ``draws`` (``{"comment_mask": [n, b, 1]
0/1, "adapter_skip": [b, 1] bool}``, the JAX rng streams' names). ``freeze``
is kept as the configs give it; ``create_model`` turns off the gradients of
the frozen parameters (``factory.frozen_predicate``).

Not yet ported (ROADMAP): the audio MLP (``init_audio_model``), the MoE
adapter (``moe_experts``) and the baselines ``MLP``/``JointEmbedding``/``CLIP``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .cam import ContextAdapter
from .clip_model import CLIP_VARIANTS, ClipModel, patch_input_dim
from .layers import l2_normalize
from .timesformer import TimeSformer


class _ClipRetrievalBase:
    """Visual shape dispatch, similarity and tower encodes shared by the
    CLIP-backed models (a mixin: the models are ``nn.Module``s)."""

    model: ClipModel

    @property
    def variant(self):
        return self.model.variant

    @property
    def feature_dim(self):
        return self.variant.embed_dim

    def _encode_vis(self, vis):
        """Features [b, d] pass through | images [b, 3, h, w] | video
        [b, t, 3, h, w] frame mean | patch input [b, n, p·p·3] or
        [b, t, n, p·p·3] (``data.preprocess.extract_patches``)."""
        shp = vis.shape
        pd = patch_input_dim(self.variant)
        if len(shp) == 2 and shp[1] == self.feature_dim:
            return vis.float()
        if len(shp) == 3 and shp[-1] == pd:  # image patches
            return self.model.encode_image(vis).float()
        if len(shp) == 4 and shp[-1] != pd:  # NCHW images
            return self.model.encode_image(vis).float()
        if len(shp) in (4, 5):  # video patches or NCHW frames
            b, t = shp[0], shp[1]
            feats = self.model.encode_image(vis.reshape((b * t,) + shp[2:]))
            return feats.reshape(b, t, -1).mean(dim=1).float()
        raise ValueError(f"Unsupported visual input shape {tuple(shp)}")

    def _sim(self, feats_vis, feats_text):
        return torch.exp(self.model.logit_scale) * (feats_vis @ feats_text.T)

    def _encode_comments(self, comments):
        """[b, ncomms, ntoks] -> [b, ncomms, d] through the text tower."""
        b, ncomms, ntoks = comments.shape
        feats = self.model.encode_text(comments.reshape(b * ncomms, ntoks))
        return feats.reshape(b, ncomms, self.feature_dim).float()

    def encode_image(self, vis):
        return self._encode_vis(vis)

    def encode_text(self, text):
        return self.model.encode_text(text)


class PretrainedCLIP(_ClipRetrievalBase, nn.Module):
    """CLIP dual encoder, with optional "averaging" comment fusion."""

    def __init__(self, model_type: str = "ViT-B/32", dtype=torch.float32,
                 comment_fusion: Optional[str] = None, freeze=False,
                 residual_activation: Optional[str] = None):
        super().__init__()
        if comment_fusion not in (None, "None", "averaging"):
            raise ValueError(f"unknown comment_fusion {comment_fusion!r}")
        self.comment_fusion = comment_fusion
        self.freeze = freeze
        self.residual_activation = residual_activation  # unused, as in vtc_tpu
        self.model = ClipModel(CLIP_VARIANTS[model_type], dtype)

    def forward(self, vis, title, comments=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        # no random draws: ``generator``/``draws`` are the train step's call
        feats_vis = self._encode_vis(vis)
        if comments is None or self.comment_fusion in (None, "None"):
            feats_text = self.model.encode_text(title).float()
        else:
            b, ncomms, ntoks = comments.shape
            if title.shape[-1] == ntoks:  # one text-tower pass for both
                feats = self.model.encode_text(
                    torch.cat([title, comments.reshape(b * ncomms, ntoks)])
                ).float()
                feats_title = feats[: title.shape[0]]
                feats_comm = feats[title.shape[0]:].reshape(b, ncomms, -1)
            else:
                feats_title = self.model.encode_text(title).float()
                feats_comm = self._encode_comments(comments)
            feats_text = torch.cat([feats_title[:, None], feats_comm], 1).mean(1)
        feats_text = l2_normalize(feats_text)
        feats_vis = l2_normalize(feats_vis)
        return feats_vis, feats_text, self._sim(feats_vis, feats_text)


class _CamRetrievalBase(_ClipRetrievalBase, ContextAdapter):
    """CAM plumbing of the ``*_finaltf`` models (reference
    ``model/model.py:207-266``); the model is its own ``ContextAdapter``."""

    def __init__(self, model_type: str = "ViT-B/32", dtype=torch.float32,
                 branch_to_adapt: str = "text", branch_to_adapt_val: str = "text",
                 residual_activation: Optional[str] = None,
                 n_layers: int = 2, n_heads: int = 8,
                 init_from_avg: bool = True, freeze=False,
                 random_comment_masking: bool = False,
                 random_skip_adapter: bool = True, moe_experts: int = 0,
                 moe_top_k: int = 1, clip_kwargs: Optional[dict] = None):
        if moe_experts:
            raise NotImplementedError(
                f"the MoE adapter (moe_experts={moe_experts}) is not ported yet "
                f"(ROADMAP: Queue 1, distribution on torch.distributed)"
            )
        variant = CLIP_VARIANTS[model_type]
        super().__init__(
            feature_dim=variant.embed_dim, n_layers=n_layers, n_heads=n_heads,
            init_from_avg=init_from_avg, residual_activation=residual_activation,
            random_skip_adapter=random_skip_adapter, dtype=dtype,
        )
        self.freeze = freeze
        self.random_comment_masking = random_comment_masking
        self.branch_to_adapt = branch_to_adapt  # the training branch
        self.branch_to_adapt_val = branch_to_adapt_val  # the eval branch
        self.model = ClipModel(variant, dtype, **(clip_kwargs or {}))

    @property
    def finaltf_frozen(self) -> bool:
        return isinstance(self.freeze, str) and "finaltf" in self.freeze

    def _encode_title_and_comments(self, title, comments):
        """One joint text-tower pass over [title; comments] when their token
        lengths match (the tower is per sequence, so the math is that of two
        passes). -> (feats_title [b, d], feats_comm [ncomms, b, d])."""
        b, ncomms, ntoks = comments.shape
        if title.shape[-1] == ntoks:
            feats = self.model.encode_text(
                torch.cat([title, comments.reshape(b * ncomms, ntoks)])
            ).float()
            feats_title = feats[: title.shape[0]]
            feats_comm = feats[title.shape[0]:].reshape(b, ncomms, self.feature_dim)
        else:
            feats_title = self.model.encode_text(title).float()
            feats_comm = self._encode_comments(comments)
        feats_comm = self.substitute_empty(feats_comm, comments)
        return feats_title, feats_comm.transpose(0, 1)

    def _encode_with_comments(self, feats_vis, feats_title, feats_comm,
                              branch_override: Optional[str] = None,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[dict] = None):
        draws = draws or {}
        if self.training:
            if self.random_comment_masking:
                feats_comm = self.random_mask_comments(
                    feats_comm, draws.get("comment_mask"), generator
                )
            branch = self.branch_to_adapt
        else:
            branch = branch_override if branch_override is not None else (
                self.branch_to_adapt_val
            )

        def bcast(fc, target_b):
            # a comment batch of 1 is shared by every row (transfer eval)
            if fc.shape[1] == 1 and target_b != 1:
                if self.training:
                    raise ValueError(
                        f"comment batch 1 vs feature batch {target_b} in "
                        f"training: the shared-comment broadcast is an "
                        f"eval-only optimization"
                    )
                return fc.expand(fc.shape[0], target_b, fc.shape[2])
            return fc

        def adapt(main, fc):
            return self.adapt(main, bcast(fc, main.shape[0]), self.finaltf_frozen,
                              draws.get("adapter_skip"), generator)

        if branch == "text":
            feats_text = adapt(feats_title, feats_comm)
        elif branch == "image":
            feats_vis = adapt(feats_vis, feats_comm)
            feats_text = feats_title
        elif branch == "skip":
            feats_text = feats_title
        else:
            raise ValueError(f"Unknown branch_to_adapt {branch!r}")
        return l2_normalize(feats_vis), l2_normalize(feats_text)


class PretrainedCLIP_finaltf(_CamRetrievalBase):
    """CLIP + CAM image/text retrieval, the flagship model (reference
    ``model/model.py:374-480``)."""

    def __init__(self, *args, init_audio_model: bool = False, **kwargs):
        if init_audio_model:
            raise NotImplementedError(
                "the audio MLP of PretrainedCLIP_finaltf is not ported yet "
                "(ROADMAP: rest of the model zoo, audio-MLP fusion)"
            )
        super().__init__(*args, **kwargs)

    def forward(self, vis, title, comments, audio_feats=None,
                branch_override: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        if audio_feats is not None:
            raise NotImplementedError(
                "audio features need the audio MLP, not ported yet (ROADMAP)"
            )
        feats_vis = self._encode_vis(vis)
        feats_title, feats_comm = self._encode_title_and_comments(title, comments)
        feats_vis, feats_text = self._encode_with_comments(
            feats_vis, feats_title, feats_comm, branch_override, generator, draws
        )
        return feats_vis, feats_text, self._sim(feats_vis, feats_text)


class _VideoTower:
    """The TimeSformer models' visual path: ``vis`` goes straight to the
    video tower (``[b, t, 3, h, w]`` or ``[b, t, n, p·p·3]`` patch frames)."""

    def _encode_vis(self, vis):
        return self.model.encode_image(vis).float()


def _video_kwargs(nframes: int) -> dict:
    return {"visual_module": TimeSformer, "visual_kwargs": {"nframes": nframes}}


class PretrainedCLIP_TimeSformer(_VideoTower, _ClipRetrievalBase, nn.Module):
    """CLIP with the TimeSformer video tower, no CAM (reference
    ``model/model.py:483-506``); comments, if given, are not used."""

    def __init__(self, model_type: str = "ViT-B/32", dtype=torch.float32,
                 nframes: int = 8, freeze=False,
                 residual_activation: Optional[str] = None):
        super().__init__()
        self.freeze = freeze
        self.residual_activation = residual_activation  # unused, as in vtc_tpu
        self.model = ClipModel(CLIP_VARIANTS[model_type], dtype, **_video_kwargs(nframes))

    def forward(self, vis, title, comments=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        # no random draws: ``generator``/``draws`` are the train step's call
        feats_vis = l2_normalize(self._encode_vis(vis))
        feats_text = l2_normalize(self.model.encode_text(title).float())
        return feats_vis, feats_text, self._sim(feats_vis, feats_text)


class PretrainedCLIP_TimeSformer_finaltf(_VideoTower, _CamRetrievalBase):
    """TimeSformer video tower + CAM (reference ``model/model.py:539-623``).
    ``visual_device``, the reference's manual two-card split, is accepted
    for the configs' sake and ignored: the model runs on one card."""

    def __init__(self, *args, nframes: int = 8, visual_device: Optional[str] = None,
                 **kwargs):
        super().__init__(*args, clip_kwargs=_video_kwargs(nframes), **kwargs)

    def forward(self, vis, title, comments, branch_override: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        feats_vis = self._encode_vis(vis)
        feats_title, feats_comm = self._encode_title_and_comments(title, comments)
        feats_vis, feats_text = self._encode_with_comments(
            feats_vis, feats_title, feats_comm, branch_override, generator, draws
        )
        return feats_vis, feats_text, self._sim(feats_vis, feats_text)
