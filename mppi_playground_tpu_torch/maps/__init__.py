from mppi_playground_tpu_torch.maps.feature_query import (
    FeatureMapData,
    build_feature_map,
    feature_cost,
)
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData, grid_cost, map_query
from mppi_playground_tpu_torch.maps.lane_map import LaneMap
from mppi_playground_tpu_torch.maps.obstacle_map import (
    CircleObstacle,
    ObstacleMap,
    RectangleObstacle,
    generate_random_obstacles,
)

__all__ = [
    "CircleObstacle",
    "FeatureMapData",
    "GridMapData",
    "LaneMap",
    "ObstacleMap",
    "RectangleObstacle",
    "build_feature_map",
    "feature_cost",
    "generate_random_obstacles",
    "grid_cost",
    "map_query",
]
