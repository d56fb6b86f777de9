from . import (
    batched_engine,
    contacts,
    cuda_build,
    cuda_env_rollout,
    cuda_rollout,
    cuda_step,
    cuda_step_vjp,
    diff_step,
    philox,
    policies,
)
from .batched_engine import BatchedEngine, BatchedState
