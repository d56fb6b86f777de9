from . import batched_engine, contacts, cuda_rollout
from .batched_engine import BatchedEngine, BatchedState
