"""Shared matplotlib and GIF rendering for the environments.

Counterpart of ``mppi_playground_tpu/envs/rendering.py``: the top-k sample
trajectories drawn with weight-proportional alpha, the nominal trajectory
coloured by collision, the two modes (``"human"``: an interactive pause;
``"rgb_array"``: a captured frame) and the GIF written on ``close`` (with
imageio).  Tensors are read on the host (``.cpu()``) here, inside a
render, never in a tick.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def host(values) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array on the host."""
    if hasattr(values, "detach"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def fig_to_rgb(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to an RGB uint8 array."""
    fig.canvas.draw()
    # buffer_rgba carries its own (physical-pixel) shape; the logical
    # get_width_height() differs from it on HiDPI backends
    buf = np.asarray(fig.canvas.buffer_rgba(), dtype=np.uint8)
    return buf[..., :3].copy()


def draw_top_samples(ax, top_samples, top_weights) -> None:
    """The sample trajectories ``[n, T+1, >=2]``, each with alpha from its weight."""
    top_samples = host(top_samples)
    top_weights = host(top_weights)
    top_weights = 0.7 * top_weights / np.max(top_weights)
    top_weights = np.clip(top_weights, 0.1, 0.7)
    for i in range(top_samples.shape[0]):
        ax.plot(top_samples[i, :, 0], top_samples[i, :, 1], color="lightblue",
                alpha=float(top_weights[i]), zorder=1)


def draw_predicted_trajectory(ax, predicted_trajectory, is_collisions=None) -> None:
    """The nominal trajectory ``[1, T+1, >=2]``, its points red where any row of
    ``is_collisions [*, T+1]`` collides."""
    predicted_trajectory = host(predicted_trajectory)
    colors = np.array(["darkblue"] * predicted_trajectory.shape[1])
    if is_collisions is not None:
        colors[np.any(host(is_collisions), axis=0)] = "red"
    ax.scatter(predicted_trajectory[0, :, 0], predicted_trajectory[0, :, 1], color=colors,
               marker="o", s=3, zorder=2)


def save_gif(frames, path: str, fps: int = 10) -> Optional[str]:
    """Write captured frames as a GIF; ``None`` (and no file) when there are none."""
    if not frames:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    import imageio.v2 as imageio

    # imageio >= 2.28 takes a frame's duration in milliseconds, not fps
    imageio.mimsave(path, frames, duration=1000.0 / fps)
    return path


# ----------------------------------------------------------------------
# Geometry helpers
# ----------------------------------------------------------------------


def circle(x: float, y: float, size: float = 0.5, steps: int = 100):
    """Points of a closed circle of radius ``size`` around ``(x, y)``."""
    rad = np.deg2rad(np.linspace(0.0, 360.0, steps))
    return x + size * np.cos(rad), y + size * np.sin(rad)


def plot_arrow(ax, x, y, yaw, length: float = 1.0, width: float = 0.5, fc="r", ec="k"):
    """A heading arrow at a pose."""
    ax.arrow(float(x), float(y), length * np.cos(yaw), length * np.sin(yaw), fc=fc, ec=ec,
             head_width=width, head_length=width)


def plot_robot(ax, x, y, yaw, robot_length: float = 1.0, robot_width: float = 0.5):
    """The rectangular footprint of a robot at a pose."""
    outline = np.array([
        [-robot_length / 2, robot_length / 2, robot_length / 2, -robot_length / 2,
         -robot_length / 2],
        [robot_width / 2, robot_width / 2, -robot_width / 2, -robot_width / 2,
         robot_width / 2],
    ])
    rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    outline = rot @ outline
    ax.plot(outline[0] + float(x), outline[1] + float(y), "-k")
