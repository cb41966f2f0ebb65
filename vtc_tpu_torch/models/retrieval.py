"""CLIP-backed retrieval models, eval path.

Port of ``vtc_tpu/models/retrieval.py``: ``PretrainedCLIP`` and
``PretrainedCLIP_finaltf`` (CLIP + CAM). Each keeps the reference's forward
contract ``forward(vis, title[, comments]) -> (feats_vis, feats_text, sim)``
with L2-normalized features and ``sim = exp(logit_scale) · v @ tᵀ``.

State-dict names are the reference's: the CLIP towers under ``model.*``
(``model.visual.*``, ``model.transformer.*``, ...), the CAM at the top level
(``final_transformer.*``, ``final_linear.weight``, ``mask_embedding``,
``mean_center_bn.*``), so ``load_state_dict(strict=True)`` takes a
reference checkpoint's keys.

Not yet ported (ROADMAP): the training paths (``train=True``: random
adapter skip, random comment masking, BN stat updates), the audio MLP
(``init_audio_model``), the baselines ``MLP``/``JointEmbedding``/``CLIP`` and
the TimeSformer models.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .cam import ContextAdapter
from .clip_model import CLIP_VARIANTS, ClipModel, patch_input_dim
from .layers import l2_normalize


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
                 comment_fusion: Optional[str] = None):
        super().__init__()
        if comment_fusion not in (None, "None", "averaging"):
            raise ValueError(f"unknown comment_fusion {comment_fusion!r}")
        self.comment_fusion = comment_fusion
        self.model = ClipModel(CLIP_VARIANTS[model_type], dtype)

    def forward(self, vis, title, comments=None):
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
                 branch_to_adapt_val: str = "text",
                 residual_activation: Optional[str] = None,
                 n_layers: int = 2, n_heads: int = 8,
                 init_from_avg: bool = True):
        variant = CLIP_VARIANTS[model_type]
        super().__init__(
            feature_dim=variant.embed_dim, n_layers=n_layers, n_heads=n_heads,
            init_from_avg=init_from_avg, residual_activation=residual_activation,
            dtype=dtype,
        )
        self.branch_to_adapt_val = branch_to_adapt_val  # the eval branch
        self.model = ClipModel(variant, dtype)

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
                              branch_override: Optional[str] = None):
        branch = branch_override if branch_override is not None else (
            self.branch_to_adapt_val
        )

        def bcast(fc, target_b):
            # a comment batch of 1 is shared by every row (transfer eval)
            if fc.shape[1] == 1 and target_b != 1:
                return fc.expand(fc.shape[0], target_b, fc.shape[2])
            return fc

        if branch == "text":
            feats_text = self.adapt(
                feats_title, bcast(feats_comm, feats_title.shape[0])
            )
        elif branch == "image":
            feats_vis = self.adapt(feats_vis, bcast(feats_comm, feats_vis.shape[0]))
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
                branch_override: Optional[str] = None):
        if audio_feats is not None:
            raise NotImplementedError(
                "audio features need the audio MLP, not ported yet (ROADMAP)"
            )
        feats_vis = self._encode_vis(vis)
        feats_title, feats_comm = self._encode_title_and_comments(title, comments)
        feats_vis, feats_text = self._encode_with_comments(
            feats_vis, feats_title, feats_comm, branch_override
        )
        return feats_vis, feats_text, self._sim(feats_vis, feats_text)
