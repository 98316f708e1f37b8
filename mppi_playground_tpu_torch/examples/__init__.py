"""The example scripts on the card: counterparts of the repo's ``examples/*.py``.

Each script keeps its JAX counterpart's flags, ``main(...)`` keywords,
defaults and printed lines, and adds ``--device`` (``device=None``, the
card; ``"cpu"`` runs the kernels' plain twins).  Each exposes the solver or
controller it builds (``make_solver`` / ``make_controller``).  Run one as
``python -m mppi_playground_tpu_torch.examples.<name>``:

* ``pendulum``, ``cartpole``, ``mountaincar``: gymnasium's classic control
  envs, or the model's own dynamics as the simulator (``--no-gym``);
* ``navigation2d``, ``goal_in_danger_zone``, ``racing``: the port's envs,
  rendered with matplotlib and written as gifs with imageio (``--save-mode``);
* ``mujoco_cartpole``: gymnasium's ``InvertedPendulum-v4`` (mujoco);
* ``make_media``: the three gymnasium gifs.

gymnasium, mujoco, pygame, matplotlib and imageio are imported only where a
script uses them.
"""
