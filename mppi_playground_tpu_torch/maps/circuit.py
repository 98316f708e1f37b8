"""Circuit/track reference-path pipeline (pure numpy).

A copy of ``mppi_playground_tpu/maps/circuit.py``, carried into the port so
that it never imports the JAX package (whose ``maps/__init__.py`` pulls in
JAX).  The same seed gives byte-identical paths in both packages.

* :func:`make_csv_paths` loads a track CSV with columns
  ``x_m, y_m, w_tr_right_m, w_tr_left_m``, mean-centers it, builds the
  left/right boundaries from per-point normals and arc-length resamples
  at ``DL`` with headings attached.
* :func:`interpolate_path` is the arc-length linear resampling.
* :func:`make_side_lane` offsets a path by +-width/2 along its normals.
* :func:`generate_circuit` synthesizes a closed circuit in the same CSV
  schema (a smooth Fourier-perturbed loop sized for the 80x80 m map).
"""

from __future__ import annotations

import csv
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Path utilities
# ---------------------------------------------------------------------------

def interpolate_path(path: np.ndarray, DL: float) -> np.ndarray:
    """Arc-length resample ``[N, 2]`` -> points spaced ~DL apart.

    Cumulative chord length, a linspace of ``int(L // DL) + 1`` points,
    linear interpolation per coordinate.
    """
    distances = np.sqrt(np.sum(np.diff(path, axis=0) ** 2, axis=1))
    cumulative = np.concatenate(([0], np.cumsum(distances)))
    if np.isnan(cumulative).any():
        cumulative = np.nan_to_num(cumulative, nan=0.0)
    num_points = int(cumulative[-1] // DL) + 1
    new_distances = np.linspace(0, cumulative[-1], num_points)
    new_x = np.interp(new_distances, cumulative, path[:, 0])
    new_y = np.interp(new_distances, cumulative, path[:, 1])
    return np.column_stack((new_x, new_y))


def _attach_angles(path: np.ndarray) -> np.ndarray:
    """Append per-point headings.

    The first point's heading comes from the wrap-around direction
    ``path[0] - path[-1]``; the rest from forward differences.
    """
    initial_dir = path[0] - path[-1]
    norm = np.linalg.norm(initial_dir)
    initial_dir = initial_dir / norm if norm != 0 else np.array([1.0, 0.0])
    initial_angle = np.arctan2(initial_dir[1], initial_dir[0])

    diffs = path[1:] - path[:-1]
    angles = np.arctan2(diffs[:, 1], diffs[:, 0])
    angles = np.concatenate(([initial_angle], angles))
    return np.concatenate((path, angles[:, None]), axis=1)


def make_paths(
    xs: np.ndarray,
    ys: np.ndarray,
    w_right: np.ndarray,
    w_left: np.ndarray,
    DL: float = 0.1,
    offset: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Center/boundary paths from raw track columns.

    Returns (center, right, left), each ``[N, 3]`` of x, y, heading.
    """
    if offset:
        x_off, y_off = xs.mean(), ys.mean()
    else:
        x_off = y_off = 0.0
    xs = xs - x_off
    ys = ys - y_off
    center = np.column_stack((xs, ys))

    # Per-point direction from the previous point, wrapping at index 0.
    prev = np.roll(center, 1, axis=0)
    direction = center - prev
    norms = np.linalg.norm(direction, axis=1, keepdims=True)
    direction = np.where(norms != 0, direction / np.where(norms == 0, 1, norms),
                         np.array([1.0, 0.0]))
    right_vec = np.column_stack((-direction[:, 1], direction[:, 0]))
    left_vec = -right_vec

    right = center + w_right[:, None] * right_vec
    left = center + w_left[:, None] * left_vec

    center = _attach_angles(interpolate_path(center, DL))
    right = _attach_angles(interpolate_path(right, DL))
    left = _attach_angles(interpolate_path(left, DL))
    return center, right, left


def make_csv_paths(
    csv_file: str, DL: float = 0.1, offset: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a reference-format track CSV.

    Columns: ``x_m, y_m, w_tr_right_m, w_tr_left_m`` with a header row.
    """
    data = np.genfromtxt(csv_file, delimiter=",", names=True)
    return make_paths(
        np.asarray(data["x_m"], float),
        np.asarray(data["y_m"], float),
        np.asarray(data["w_tr_right_m"], float),
        np.asarray(data["w_tr_left_m"], float),
        DL=DL,
        offset=offset,
    )


def make_side_lane(
    road: np.ndarray, lane_width: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Offset a ``[N, 3]`` path by +-lane_width/2."""
    angle = road[:, 2]
    right = np.column_stack(
        (
            lane_width / 2 * np.cos(angle - np.pi / 2) + road[:, 0],
            lane_width / 2 * np.sin(angle - np.pi / 2) + road[:, 1],
            angle,
        )
    )
    left = np.column_stack(
        (
            lane_width / 2 * np.cos(angle + np.pi / 2) + road[:, 0],
            lane_width / 2 * np.sin(angle + np.pi / 2) + road[:, 1],
            angle,
        )
    )
    return right, left


# ---------------------------------------------------------------------------
# Procedural circuit generation (replaces the reference's bundled CSV data)
# ---------------------------------------------------------------------------

def generate_circuit(
    seed: int = 7,
    num_points: int = 360,
    base_radius: float = 26.0,
    track_width: float = 3.7,
    gap_points: int = 6,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Synthesize a smooth closed circuit in the reference CSV schema.

    A Fourier-perturbed loop: ``r(t) = R0 + sum_k a_k cos(k t + phi_k)``
    with low harmonics, scaled to stay inside the 80x80 m racing map with
    margin for the lane corridor.  The loop is left open by ``gap_points``
    samples so the start (path[0]) and goal (path[-1]) of the racing task
    are distinct, mirroring the near-closed layout of real track data.

    Returns (x, y, w_right, w_left) arrays of length ``num_points``.
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0 * np.pi, num_points + gap_points, endpoint=False)[
        : num_points
    ]

    radius = np.full_like(t, base_radius)
    for k in (2, 3, 5):
        amplitude = rng.uniform(1.0, 3.0) / k
        phase = rng.uniform(0.0, 2.0 * np.pi)
        radius += amplitude * k * np.cos(k * t + phase) / 2.0
    # keep the lane corridor inside the +-40 m map with margin
    radius = np.clip(radius, 14.0, 33.0)

    x = radius * np.cos(t)
    y = radius * np.sin(t)
    w_right = track_width + 0.15 * np.sin(4 * t)
    w_left = track_width + 0.15 * np.cos(3 * t)
    return x, y, w_right, w_left


def write_circuit_csv(path: str, seed: int = 7) -> str:
    """Write a generated circuit in the reference CSV schema."""
    x, y, w_right, w_left = generate_circuit(seed=seed)
    with open(path, "w", newline="") as handle:
        writer = csv.writer(handle)
        writer.writerow(["x_m", "y_m", "w_tr_right_m", "w_tr_left_m"])
        for row in zip(x, y, w_right, w_left):
            writer.writerow([f"{v:.10f}" for v in row])
    return path


def default_circuit_paths(
    DL: float = 0.1, seed: int = 7
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(center, right, left) paths of the bundled procedural circuit."""
    x, y, w_right, w_left = generate_circuit(seed=seed)
    return make_paths(x, y, w_right, w_left, DL=DL, offset=True)
