from .env import BatchedEnv, EnvState

__all__ = ["BatchedEnv", "EnvState"]
