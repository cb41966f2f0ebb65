"""Audio -> log spectrograms, GDT's preprocessing for the audio tower
(reference ``scripts/get_audio_embeddings.py:88-112``).

The port's own numpy copy of ``vtc_tpu/audio/spectrogram.py``, on the host:
2-second clips at 24 kHz, a Hann window of 480 samples (20 ms), hop 240
(10 ms), n_fft 512, ``log(|STFT| + 1e-6)`` padded or cut to
``(1, 257, 199)``. Audio decodes with PyAV where ``av`` imports; a clip that
cannot be read (no ``av``, no audio stream, a failed decode) is the
all-ones spectrogram, the reference's behaviour for missing audio
(``get_audio_embeddings.py:111-112``), logged as a warning; a real log
spectrogram is never all ones, so ``is_fallback`` tells the two apart.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATE = 24000
NUM_SEC = 2
N_FFT = 512
WIN_LENGTH = 480  # 20 ms
HOP_LENGTH = 240  # 10 ms
N_FREQ = N_FFT // 2 + 1  # 257
N_FRAMES = (NUM_SEC * SAMPLE_RATE - WIN_LENGTH) // HOP_LENGTH + 1  # 199
TIME_POINTS = (0.15, 0.3, 0.45, 0.6, 0.85)
FALLBACK = np.ones((1, N_FREQ, N_FRAMES), np.float32)



def is_fallback(clips: np.ndarray) -> np.ndarray:
    """``[..., 257, 199]`` -> bool ``[...]``: which clips are the fallback."""
    return np.all(clips == 1, axis=(-2, -1))


def stft_magnitude(wav: np.ndarray) -> np.ndarray:
    """``[n_samples]`` -> ``[257, n_frames]`` magnitude STFT, Hann window."""
    window = np.hanning(WIN_LENGTH).astype(np.float32)
    n_frames = (len(wav) - WIN_LENGTH) // HOP_LENGTH + 1
    if n_frames <= 0:
        return np.zeros((N_FREQ, 0), np.float32)
    idx = np.arange(WIN_LENGTH)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(wav[idx] * window, n=N_FFT, axis=-1)
    return np.abs(spec).T.astype(np.float32)


def log_spectrogram(wav: np.ndarray, z_normalize: bool = False) -> np.ndarray:
    """A waveform, padded or cut to 2 s -> ``(1, 257, 199)``."""
    target = NUM_SEC * SAMPLE_RATE
    if len(wav) < target:
        wav = np.pad(wav, (0, target - len(wav)))
    spec = np.log(stft_magnitude(wav[:target].astype(np.float32)) + 1e-6)
    if spec.shape[1] > N_FRAMES:
        spec = spec[:, :N_FRAMES]
    elif spec.shape[1] < N_FRAMES:
        spec = np.pad(spec, ((0, 0), (0, N_FRAMES - spec.shape[1])))
    if z_normalize:
        spec = (spec - spec.mean()) / (spec.std() + 1e-6)
    return spec[None]


def av_available() -> bool:
    try:
        import av  # noqa: F401
    except ImportError:
        return False
    return True


def load_audio_clip(path: str, fr_sec: float, num_sec: int = NUM_SEC,
                    sample_rate: int = SAMPLE_RATE) -> Optional[np.ndarray]:
    """``num_sec`` of mono audio from ``fr_sec`` on, resampled to
    ``sample_rate``, through PyAV; None where it cannot be read."""
    if not av_available():
        return None
    import av

    try:
        with av.open(path) as container:
            if not container.streams.audio:
                return None
            stream = container.streams.audio[0]
            # a container seek counts in av.time_base (1/1e6 s) units
            container.seek(int(fr_sec / av.time_base), any_frame=False)
            resampler = av.AudioResampler(format="s16", layout="mono", rate=sample_rate)
            samples: List[np.ndarray] = []
            for frame in container.decode(stream):
                for rf in resampler.resample(frame):
                    samples.append(rf.to_ndarray().reshape(-1))
                if sum(len(s) for s in samples) >= num_sec * sample_rate:
                    break
    except Exception:  # a file or stream PyAV cannot decode: the fallback
        return None
    if not samples:
        return None
    wav = np.concatenate(samples).astype(np.float32) / 32768.0
    return wav[: num_sec * sample_rate]


def video_audio_clips(path: str, n_clips: int = 5) -> np.ndarray:
    """``[n_clips, 257, 199]``: spectrograms at the reference's relative
    time points, the all-ones fallback (logged) where a clip cannot be
    read."""
    from ..data.video import video_duration_sec

    duration = video_duration_sec(path)
    clips = []
    for tp in TIME_POINTS[:n_clips]:
        wav = load_audio_clip(path, duration * tp) if duration > 0 else None
        if wav is None:
            logger.warning("no audio at %.2f s of %s: the all-ones spectrogram",
                           duration * tp, path)
            clips.append(FALLBACK)
        else:
            clips.append(log_spectrogram(wav))
    return np.concatenate(clips, axis=0)
