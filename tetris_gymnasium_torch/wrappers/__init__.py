"""Gymnasium wrappers over the port's shell (thin numpy boundaries).

Port of ``tetris_gymnasium_tpu/wrappers``.
"""
from tetris_gymnasium_torch.wrappers.grouped import GroupedActionsObservations
from tetris_gymnasium_torch.wrappers.observation import (
    FeatureVectorObservation,
    RgbObservation,
)

__all__ = [
    "FeatureVectorObservation",
    "GroupedActionsObservations",
    "RgbObservation",
]
