"""Decode video segments on the host with OpenCV: ``read_video_segment``,
``read_video_full``, ``video_duration_sec`` and the reference's segment
reader with its fallbacks, ``read_segment_with_fallbacks``.

The port's own copy of ``vtc_tpu/data/video.py`` on its OpenCV route
(``VTC_DECODE=cv2``): the same frames, the same floor-linspace selection
and the same random draws in the same order. The JAX package's libav
worker (``native/vtc_decode.cpp``) is not ported, since neither machine
the port runs on has libav's headers, so OpenCV's ``VideoCapture`` (its
FFmpeg) is the only backend: ``VTC_DECODE=native`` raises
``NotImplementedError``, and a missing ``cv2`` raises ``ImportError`` at
the first decode rather than reading as an empty video. A video that
OpenCV cannot open or read is an empty array, on which the callers take
the reference's fallback chain and log it.

Segment endpoints are in OpenCV's ``CAP_PROP_POS_MSEC`` domain, which
starts at the container's start time (t0 = 0). The JAX package's OpenCV
route re-bases them to absolute stream time by the container start offset
that only its libav probe reads; where that probe is absent it keeps t0 =
0 too, which is the domain matched here. On a container with a non-zero
start offset (the reddit videos' 1.4 s, ``dataset_loaders.py:362-372``)
the native worker's segments would start that much later (ROADMAP: an
open question, untested here).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

FALLBACK_SHAPE = (8, 300, 300, 3)
# a raw frame of more pixels is resized and converted as it is read, not
# after the selection (a 256-frame buffer of raw high-resolution frames
# would take GBs); per-frame processing commutes with the selection
_DEFER_MAX_PIXELS = 1_000_000


def _cv2():
    """OpenCV, imported at the first decode."""
    if os.environ.get("VTC_DECODE", "auto") == "native":
        raise NotImplementedError(
            "VTC_DECODE=native: the libav worker (native/vtc_decode.cpp) is not ported; the "
            "port decodes video with OpenCV only (unset VTC_DECODE or set it to cv2)")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"the port decodes video with OpenCV, and cv2 does not import: "
                          f"{e}") from e
    return cv2


def _empty() -> np.ndarray:
    return np.zeros((0,) + FALLBACK_SHAPE[1:], np.uint8)


def _resize_dims(w: int, h: int, target_w: int, target_h: int) -> Tuple[int, int]:
    """ffmpeg-style: a 0 dimension preserves aspect ratio."""
    if target_w == 0 and target_h == 0:
        return w, h
    if target_w == 0:
        return max(1, round(w * target_h / h)), target_h
    if target_h == 0:
        return target_w, max(1, round(h * target_w / w))
    return target_w, target_h


def read_video_segment(
    path: str,
    start_sec: float = 0.0,
    end_sec: Optional[float] = None,
    resize_width: int = 0,
    resize_height: int = 0,
    max_frames: Optional[int] = None,
    subsample_to: Optional[int] = None,
) -> np.ndarray:
    """Decode ``[start_sec, end_sec]`` -> uint8 ``[t, h, w, 3]`` RGB, each
    frame resized (``INTER_AREA``) to ``resize_width`` x ``resize_height``
    where either is non-zero (a 0 keeps the aspect ratio). An empty array
    where OpenCV cannot open or read the file (callers implement the
    reference's fallback chain).

    ``max_frames=n`` stops after n frames. ``subsample_to=n`` returns only
    the floor-linspace selection of n frames over the decoded range, the
    frames that decoding everything and then ``linspace_subsample`` give,
    resizing and converting only the selected ones."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return _empty()

    def _process(frame):
        w, h = frame.shape[1], frame.shape[0]
        nw, nh = _resize_dims(w, h, resize_width, resize_height)
        if (nw, nh) != (w, h):
            frame = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    try:
        if start_sec > 0:
            cap.set(cv2.CAP_PROP_POS_MSEC, start_sec * 1000.0)
        frames = []
        defer = subsample_to is not None
        while True:
            if end_sec is not None:
                pos = cap.get(cv2.CAP_PROP_POS_MSEC)
            ok, frame = cap.read()
            if not ok:
                break
            if end_sec is not None and pos > end_sec * 1000.0:
                break
            if defer and not frames and frame.shape[0] * frame.shape[1] > _DEFER_MAX_PIXELS:
                defer = False
            frames.append(frame if defer else _process(frame))
            if max_frames is not None and len(frames) >= max_frames:
                break
        if not frames:
            return _empty()
        if subsample_to is not None:
            idxs = np.floor(np.linspace(0, len(frames) - 1, subsample_to)).astype(np.int64)
            return np.stack([_process(frames[i]) if defer else frames[i] for i in idxs])
        return np.stack(frames)
    finally:
        cap.release()


def read_video_full(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Every frame of the file (the first ``max_frames`` where given: the
    same frames as a full decode cut to them)."""
    return read_video_segment(path, max_frames=max_frames)


def video_duration_sec(path: str) -> float:
    """OpenCV's ``FRAME_COUNT / FPS``; 0 where the rate is unknown or the
    file does not open."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 0
        n = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0
        return float(n / fps) if fps > 0 else 0.0
    finally:
        cap.release()


def linspace_subsample(vid: np.ndarray, nframes: int) -> np.ndarray:
    """floor-linspace frame selection (``dataset_loaders.py:430-433``)."""
    idxs = np.floor(np.linspace(0, len(vid) - 1, nframes)).astype(np.int64)
    return vid[idxs]


def read_segment_with_fallbacks(
    path: str,
    *,
    video_length: float,
    nframes: int = 8,
    frame_strides=(4, 8, 16, 32),
    reference_fps: float = 30.0,
    is_reddit: bool = True,
    train: bool = True,
    resize_width: int = 0,
    resize_height: int = 300,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """The reference's segment reader (``dataset_loaders.py:353-437``): a
    random stride, the reddit videos' 1.4 s start offset, a random (train)
    or zero start, then two fallbacks, each logged as a warning: the
    segment ``[0, 5]`` s where the segment decodes to nothing, black frames
    where that does too; the floor-linspace selection of ``nframes``."""
    rng = rng or np.random.default_rng()
    video_length = min(60, video_length)
    frame_stride = frame_strides[int(rng.integers(0, len(frame_strides)))]
    segment_duration = nframes / (reference_fps / frame_stride)

    start_time = 1.4 if is_reddit else 0.0
    if train:
        start_lower = start_time
        start_upper = max(0.0, video_length - segment_duration)
        segment_start = (start_lower - start_upper) * float(rng.random()) + start_upper
    else:
        segment_start = 0.0
    segment_end = segment_start + segment_duration

    vid = read_video_segment(path, segment_start, segment_end, resize_width=resize_width,
                             resize_height=resize_height, subsample_to=nframes)
    if vid.shape[0] == 0:
        logger.warning("zero-length segment, retrying [0, 5]s: %s", path)
        vid = read_video_segment(path, 0, 5, resize_width=resize_width,
                                 resize_height=resize_height, subsample_to=nframes)
    if vid.shape[0] == 0:
        logger.warning("decode fallback failed, emitting black frames: %s", path)
        vid = np.zeros(FALLBACK_SHAPE, np.uint8)
    return linspace_subsample(vid, nframes)
