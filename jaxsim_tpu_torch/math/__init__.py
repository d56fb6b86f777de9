"""Offline spatial math of the model-description layer (NumPy)."""

from . import np_spatial
from .joint_model import JointModel, JointType
