"""The port's rendering on the CPU (matplotlib's Agg backend).

Mirrors ``tests/test_rendering.py`` on ``envs/rendering.py`` (the helpers also
take tensors), then each environment's ``render`` in ``rgb_array`` mode
followed by ``close(path)``, which writes a GIF of the frames, and the maps'
and the danger zone's drawing.
"""

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mppi_playground_tpu_torch.envs.rendering import (  # noqa: E402
    circle,
    draw_predicted_trajectory,
    draw_top_samples,
    fig_to_rgb,
    plot_arrow,
    plot_robot,
    save_gif,
)


@pytest.fixture
def ax():
    fig, ax = plt.subplots()
    yield ax
    plt.close(fig)


def test_circle_points_lie_on_radius():
    xs, ys = circle(2.0, -1.0, size=0.5, steps=64)
    assert xs.shape == (64,) and ys.shape == (64,)
    np.testing.assert_allclose(np.hypot(xs - 2.0, ys + 1.0), 0.5, atol=1e-12)
    np.testing.assert_allclose([xs[0], ys[0]], [xs[-1], ys[-1]], atol=1e-12)  # closed


def test_plot_arrow_adds_heading_arrow(ax):
    before = len(ax.patches)
    plot_arrow(ax, 1.0, 2.0, yaw=np.pi / 2, length=2.0)
    assert len(ax.patches) == before + 1
    assert ax.patches[-1].get_verts()[:, 1].max() >= 3.9  # the tip reaches y ~ 2 + length


def test_plot_robot_draws_rotated_footprint(ax):
    plot_robot(ax, 0.0, 0.0, yaw=np.pi / 2, robot_length=2.0, robot_width=1.0)
    (line,) = ax.lines
    xs, ys = line.get_data()
    assert len(xs) == 5  # a closed rectangle
    np.testing.assert_allclose(np.max(np.abs(ys)), 1.0, atol=1e-12)
    np.testing.assert_allclose(np.max(np.abs(xs)), 0.5, atol=1e-12)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_top_samples_alpha_scales_with_weight(ax, as_tensor):
    samples = np.zeros((3, 4, 2))
    samples[:, :, 0] = np.arange(4)
    weights = np.array([1.0, 0.5, 0.01])
    if as_tensor:
        samples, weights = torch.from_numpy(samples), torch.from_numpy(weights)
    draw_top_samples(ax, samples, weights)
    alphas = [line.get_alpha() for line in ax.lines]
    assert len(alphas) == 3
    assert alphas[0] == pytest.approx(0.7)  # the largest weight clamps at 0.7
    assert alphas[2] == pytest.approx(0.1)  # the floor
    assert alphas[0] > alphas[1] > alphas[2]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_predicted_trajectory_marks_collisions(ax, as_tensor):
    traj = np.zeros((1, 5, 3))
    traj[0, :, 0] = np.arange(5)
    collisions = np.zeros((2, 5), dtype=bool)
    collisions[1, 3] = True
    if as_tensor:
        traj, collisions = torch.from_numpy(traj), torch.from_numpy(collisions)
    draw_predicted_trajectory(ax, traj, collisions)
    colors = ax.collections[-1].get_facecolor()
    assert colors.shape[0] == 5
    np.testing.assert_allclose(colors[3], matplotlib.colors.to_rgba("red"))
    np.testing.assert_allclose(colors[0], matplotlib.colors.to_rgba("darkblue"))


def test_fig_to_rgb_and_save_gif_roundtrip(tmp_path):
    fig, ax = plt.subplots(figsize=(2, 2))
    ax.plot([0, 1], [0, 1])
    frame = fig_to_rgb(fig)
    plt.close(fig)
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8

    path = os.path.join(tmp_path, "clip.gif")
    assert save_gif([frame, 255 - frame], path, fps=5) == path and os.path.getsize(path) > 0
    import imageio.v2 as imageio

    assert len(imageio.mimread(path)) == 2
    assert save_gif([], os.path.join(tmp_path, "empty.gif")) is None


# ---------------------------------------------------------------------------
# The environments: render, then close(path) writes a GIF
# ---------------------------------------------------------------------------

def _gif_frames(path) -> int:
    import imageio.v2 as imageio

    return len(imageio.mimread(path))


def test_navigation_renders_frames_and_writes_a_gif(tmp_path):
    from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

    env = Navigation2DEnv(device="cpu")
    x = env.reset()
    traj = x.expand(5, 3).clone()[None]
    samples = (traj.repeat(3, 1, 1), torch.tensor([1.0, 0.5, 0.2]))
    for i in range(2):
        x, _ = env.step(torch.tensor([1.0, 0.1]))
        env.render(predicted_trajectory=traj, is_collisions=env.collision_check(traj),
                   top_samples=samples, mode="rgb_array")
    path = str(tmp_path / "nav.gif")
    assert env.close(path) == path and _gif_frames(path) == 2
    env.reset()  # closes the figure and drops the frames
    assert env.close(str(tmp_path / "none.gif")) is None


def test_racing_renders_frames_and_writes_a_gif(tmp_path):
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv

    env = RacingEnv(device="cpu")
    x = env.reset()
    traj = x.expand(6, 4).clone()
    for _ in range(2):
        env.step(torch.tensor([1.0, 0.05]))
        env.render(action=torch.tensor([1.0, 0.05]), predicted_trajectory=traj,
                   is_collisions=env.collision_check(traj[None]),
                   top_samples=(traj[None].repeat(2, 1, 1), torch.tensor([1.0, 0.3])),
                   reference_trajectory=env.racing_center_path[:6], mode="rgb_array")
    path = str(tmp_path / "racing.gif")
    assert env.close(path) == path and _gif_frames(path) == 2
    env.reset()


def test_danger_zone_renders_frames_and_writes_a_gif(tmp_path):
    from mppi_playground_tpu_torch.envs.goal_in_danger_zone import GoalInDangerZoneEnv

    env = GoalInDangerZoneEnv(seed=42, render_mode="rgb_array")
    env.reset(seed=42)
    for _ in range(3):
        env.step(np.array([0.5, 0.1]))
        env.set_render_info(is_colllision=False, predicted_trajectory=torch.zeros(5, 2),
                            top_samples=(torch.zeros(2, 5, 2), torch.tensor([1.0, 0.5])))
        frame = env.render()
        assert frame.ndim == 3 and frame.dtype == np.uint8
    path = str(tmp_path / "dz.gif")
    assert env.close(path) == path and _gif_frames(path) == 3
    assert env.close(str(tmp_path / "again.gif")) is None  # the frames were cleared


def test_maps_and_the_danger_zone_draw(ax):
    from mppi_playground_tpu_torch.envs.goal_in_danger_zone import DangerZone
    from mppi_playground_tpu_torch.maps import LaneMap, ObstacleMap

    m = ObstacleMap(map_size=(20, 20), cell_size=0.1, device="cpu")
    m.add_circle_obstacle(np.array([1.0, 1.0]), 1.0)
    m.add_rectangle_obstacle(np.array([-3.0, 2.0]), 2.0, 1.0)
    m.render(ax)
    assert len(ax.patches) == 2 and ax.get_xlim() == tuple(m.x_lim)
    m.render_occupancy(ax)
    theta = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    lane = np.stack([6 * np.cos(theta), 4 * np.sin(theta), np.zeros_like(theta)], axis=1)
    LaneMap(lane=lane, lane_width=2.0, map_size=(20, 20), cell_size=0.1,
            device="cpu").render_occupancy(ax)
    assert len(ax.images) == 2
    before = len(ax.patches) + len(ax.artists)
    DangerZone(cfg={"radius": 3.0, "center": [0.0, 0.0]}).render(ax)
    assert len(ax.patches) + len(ax.artists) == before + 1 and ax.get_xlim() == (-6.0, 6.0)
