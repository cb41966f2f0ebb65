"""The audio tower of the port: GDT's ResNet-9 and its log spectrograms."""

from .resnet9 import AudioResNet9, load_gdt_state_dict
from .spectrogram import is_fallback, log_spectrogram, stft_magnitude, video_audio_clips

__all__ = ["AudioResNet9", "is_fallback", "load_gdt_state_dict", "log_spectrogram",
           "stft_magnitude", "video_audio_clips"]
