from mppi_playground_tpu_torch.envs.racing_controller import RacingController
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv

__all__ = ["RacingController", "RacingEnv"]
