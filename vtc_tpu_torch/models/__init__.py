"""The port's models: CLIP towers, the CAM, the retrieval wrappers, the
feature baselines and R(2+1)D-34."""

from .factory import ARCHS, convert_weights, create_model, frozen_predicate
from .from_jax import plain_state_dict_from_jax, state_dict_from_jax

__all__ = ["ARCHS", "convert_weights", "create_model", "frozen_predicate",
           "plain_state_dict_from_jax", "state_dict_from_jax"]
