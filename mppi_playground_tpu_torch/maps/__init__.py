from mppi_playground_tpu_torch.maps.grid_cost import GridMapData, grid_cost
from mppi_playground_tpu_torch.maps.lane_map import LaneMap
from mppi_playground_tpu_torch.maps.obstacle_map import (
    CircleObstacle,
    ObstacleMap,
    RectangleObstacle,
    generate_random_obstacles,
)

__all__ = [
    "CircleObstacle",
    "GridMapData",
    "LaneMap",
    "ObstacleMap",
    "RectangleObstacle",
    "generate_random_obstacles",
    "grid_cost",
]
