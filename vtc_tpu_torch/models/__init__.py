"""The port's models: CLIP towers, the CAM and the retrieval wrappers."""

from .factory import ARCHS, convert_weights, create_model
from .from_jax import state_dict_from_jax

__all__ = ["ARCHS", "convert_weights", "create_model", "state_dict_from_jax"]
