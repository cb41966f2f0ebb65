"""The retrieval models and the feature baselines.

Port of ``vtc_tpu/models/retrieval.py``: ``PretrainedCLIP``,
``PretrainedCLIP_finaltf`` (CLIP + CAM, with the audio MLP when
``init_audio_model``), the video models ``PretrainedCLIP_TimeSformer`` and
``PretrainedCLIP_TimeSformer_finaltf`` (the TimeSformer tower, without and
with the CAM), and the baselines ``MLP``, ``JointEmbedding`` and ``CLIP``
(reference ``model/model.py:80-130``). Each CLIP-backed model keeps the
reference's forward contract ``forward(vis, title[, comments]) ->
(feats_vis, feats_text, sim)`` with L2-normalized features and
``sim = exp(logit_scale) · v @ tᵀ``.

State-dict names are the reference's: the CLIP towers under ``model.*``
(``model.visual.*``, ``model.transformer.*``, ...), the CAM at the top level
(``final_transformer.*``, ``final_linear.weight``, ``mask_embedding``,
``mean_center_bn.*``), the audio MLP under ``audio_model.mlp.layers.{1,2,4}``
(``vtc_tpu/models/torch_export.py``), so ``load_state_dict(strict=True)``
takes a reference checkpoint's keys. A MoE adapter's expert stacks sit
under ``final_transformer.resblocks.{i}.mlp_moe.*``, names of the port's own
(the reference has no MoE).

In training (``module.train()``, ``vtc_tpu/models/retrieval.py:287-349``)
the CAM models adapt ``branch_to_adapt`` (not ``branch_to_adapt_val``), mask
comments at random when ``random_comment_masking`` is set (the audio clips
too: they join the comment stack first), skip the adapter at random when
``random_skip_adapter`` is set, and refuse the eval-only shared-comment
broadcast. The audio MLP runs one clip after another, so its BatchNorm
running stats update once per clip, as in the reference. The random draws
come from the ``generator`` the caller passes, or are handed in as
``draws`` (``{"comment_mask": [n, b, 1] 0/1, "adapter_skip": [b, 1] bool,
"dropout": keep mask}``, the JAX rng streams' names; the audio MLP's
``dropout`` is ``[nclips, b, 512]``). ``freeze`` is kept as the configs give
it; ``create_model`` turns off the gradients of the frozen parameters
(``factory.frozen_predicate``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .cam import ContextAdapter, draw_adapter_skip, draw_comment_keep
from .clip_model import CLIP_VARIANTS, ClipModel, patch_input_dim
from .layers import DrawnDropout, TorchBatchNorm, dense, draw_dropout_keep, l2_normalize
from .timesformer import TimeSformer


class MLP(nn.Module):
    """Dropout -> fc1 -> BatchNorm -> ReLU -> fc2 (reference
    ``model/model.py:80-94``), as ``nn.Sequential`` indices ``layers.{0..4}``.
    ``draws={"dropout": keep}`` hands in the keep mask of the input's
    shape; else it is drawn from ``generator``."""

    def __init__(self, num_classes: int = 512, num_features: int = 512,
                 p: float = 0.2, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.Sequential(
            DrawnDropout(p), nn.Linear(num_features, num_features),
            TorchBatchNorm(num_features, dtype=dtype), nn.ReLU(),
            nn.Linear(num_features, num_classes))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        drop, fc1, bn, _, fc2 = self.layers
        x = drop(x.reshape(x.shape[0], -1), (draws or {}).get("dropout"), generator)
        return dense(torch.relu(bn(dense(x, fc1, self.dtype))), fc2, self.dtype)


class _EmbeddingBranch(nn.Module):
    """fc1 -> BatchNorm -> ReLU -> fc2 (reference ``model/model.py:104-111``),
    as ``nn.Sequential`` indices ``layers.{0,1,3}``."""

    def __init__(self, in_dim: int, num_features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.Sequential(
            nn.Linear(in_dim, num_features), TorchBatchNorm(num_features, dtype=dtype),
            nn.ReLU(), nn.Linear(num_features, num_features))

    def forward(self, x):
        fc1, bn, _, fc2 = self.layers
        return dense(torch.relu(bn(dense(x, fc1, self.dtype))), fc2, self.dtype)


class JointEmbedding(nn.Module):
    """Two-branch joint embedding of two feature sets (reference
    ``model/model.py:97-119``): ``(feats_a, feats_b)``, L2-normalized with
    ``F.normalize``'s 1e-12 floor when ``normalize``."""

    def __init__(self, input_dims_a: int = 512, input_dims_b: int = 512,
                 embedding_dims: int = 512, normalize: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.normalize = normalize
        self.branch_a = _EmbeddingBranch(input_dims_a, embedding_dims, dtype)
        self.branch_b = _EmbeddingBranch(input_dims_b, embedding_dims, dtype)

    def forward(self, x_a, x_b, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        # no random draws: ``generator``/``draws`` are the train step's call
        feats_a, feats_b = self.branch_a(x_a), self.branch_b(x_b)
        if self.normalize:
            feats_a = nn.functional.normalize(feats_a, dim=-1, eps=1e-12)
            feats_b = nn.functional.normalize(feats_b, dim=-1, eps=1e-12)
        return feats_a, feats_b


class CLIP(JointEmbedding):
    """The joint embedding with a learned temperature (reference
    ``model/model.py:122-130``): ``(feats_a, feats_b, temperature · a @ bᵀ)``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.temperature = nn.Parameter(torch.ones(()))

    def forward(self, x_a, x_b, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        feats_a, feats_b = super().forward(x_a, x_b)
        return feats_a, feats_b, self._sim(feats_a, feats_b)

    def _sim(self, feats_a, feats_b):
        return (feats_a @ feats_b.T) * self.temperature


class AudioHead(nn.Module):
    """The reference's ``audio_model`` as far as a model with cached audio
    features keeps it: the ``mlp`` from GDT's 512-d clip embeddings to CLIP
    space (``model/model.py:438``)."""

    def __init__(self, feature_dim: int, dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(num_classes=feature_dim, num_features=512, dtype=dtype)


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
        variant = CLIP_VARIANTS[model_type]
        super().__init__(
            feature_dim=variant.embed_dim, n_layers=n_layers, n_heads=n_heads,
            init_from_avg=init_from_avg, residual_activation=residual_activation,
            random_skip_adapter=random_skip_adapter, dtype=dtype,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
        )
        self.freeze = freeze
        self.random_comment_masking = random_comment_masking
        self.branch_to_adapt = branch_to_adapt  # the training branch
        self.branch_to_adapt_val = branch_to_adapt_val  # the eval branch
        self.model = ClipModel(variant, dtype, **(clip_kwargs or {}))

    @property
    def finaltf_frozen(self) -> bool:
        return isinstance(self.freeze, str) and "finaltf" in self.freeze

    def training_draws(self, vis, title, comments, *rest,
                       generator: Optional[torch.Generator] = None) -> dict:
        """The random draws a training forward on these inputs makes, drawn
        from ``generator`` (on the model's device) to hand over as
        ``draws``: the accumulating train step draws each microbatch's once
        for its two passes."""
        b, n = comments.shape[:2]
        device = comments.device
        audio_feats = rest[0] if rest else None
        draws = {}
        if audio_feats is not None:  # the audio clips join the comment stack
            n += audio_feats.shape[1]
            draws["dropout"] = draw_dropout_keep(
                audio_feats.shape[1::-1] + audio_feats.shape[2:],
                self.audio_model.mlp.layers[0].p, generator, device)
        if self.random_comment_masking:
            draws["comment_mask"] = draw_comment_keep(n, b, generator, device)
        if self.random_skip_adapter:
            draws["adapter_skip"] = draw_adapter_skip(b, generator, device)
        return draws

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
                              draws: Optional[dict] = None, audio_feats=None):
        draws = draws or {}
        if audio_feats is not None:
            # cached GDT clip embeddings [b, nclips, 512] through the audio
            # MLP one clip after another, after the comments
            # (vtc_tpu/models/retrieval.py:295-303)
            keep = draws.get("dropout")
            fa = audio_feats.transpose(0, 1)
            fa = torch.stack([
                self.audio_model.mlp(fa[i], generator,
                                     None if keep is None else {"dropout": keep[i]})
                for i in range(fa.shape[0])])
            feats_comm = torch.cat([feats_comm, fa.to(feats_comm.dtype)], 0)
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

    def __init__(self, model_type: str = "ViT-B/32", dtype=torch.float32,
                 init_audio_model: bool = False, **kwargs):
        super().__init__(model_type, dtype, **kwargs)
        self.init_audio_model = init_audio_model
        if init_audio_model:
            self.audio_model = AudioHead(self.feature_dim, dtype)

    def forward(self, vis, title, comments, audio_feats=None,
                branch_override: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        if audio_feats is not None and not self.init_audio_model:
            raise ValueError("audio features need the audio MLP: build the model "
                             "with init_audio_model=True")
        feats_vis = self._encode_vis(vis)
        feats_title, feats_comm = self._encode_title_and_comments(title, comments)
        feats_vis, feats_text = self._encode_with_comments(
            feats_vis, feats_title, feats_comm, branch_override, generator, draws,
            audio_feats,
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
