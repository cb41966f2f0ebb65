"""The port's models: CLIP towers, the CAM, the retrieval wrappers, the
feature baselines, R(2+1)D-34 and the joint-layout TimeSformer
(``timesformer_joint``, outside the factory)."""

from .factory import ARCHS, convert_weights, create_model, frozen_predicate
from .from_jax import joint_state_dict_from_jax, plain_state_dict_from_jax, state_dict_from_jax

__all__ = ["ARCHS", "convert_weights", "create_model", "frozen_predicate",
           "joint_state_dict_from_jax", "plain_state_dict_from_jax", "state_dict_from_jax"]
