from mppi_playground_tpu_torch.envs.goal_in_danger_zone import DangerZone, GoalInDangerZoneEnv
from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv
from mppi_playground_tpu_torch.envs.racing_controller import RacingController
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv

__all__ = [
    "DangerZone",
    "GoalInDangerZoneEnv",
    "Navigation2DEnv",
    "RacingController",
    "RacingEnv",
]
