"""Checkpoint / resume for solver state.

Counterpart of ``mppi_playground_tpu/utils/checkpoint.py``, with its two
interchangeable backends:

* :func:`save_state` / :func:`load_state` — a single ``.npz`` file of the
  state's leaves, gathered to the host;
* :func:`save_state_orbax` / :func:`wait_until_saved` /
  :func:`load_state_orbax` — a directory checkpoint.  The JAX package writes
  it with Orbax; here the backend is ``torch.distributed.checkpoint``, under
  the JAX names so that a reader finds the counterpart.  A state whose
  tensors are DTensors on a mesh (a fleet's state sharded over the scenario
  axis) comes back with the template's placements, each rank reading only
  its own rows: the sharded restore of a large serving state, with no
  gather.

The port's :class:`MPPIState` is
more than tensors: its leaves are its tensors (the warm start, the SG
history, lambda, the device key, MPO's temperature and Adam moments) and its
host numbers (the seed and the tick), in the order of its fields; a ``None``
(no MPO state) is no leaf, as in a JAX pytree.  Tensors keep their bits;
host numbers are stored as JSON text, so a 64-bit seed round-trips.  The
device key is saved as it is: after a closed loop's ``done_fn`` fired it
names another stream than ``make_key(seed, tick)``, and the restored state
draws from it.  A batched fleet state (``parallel.make_batched_fused_solver``)
round-trips the same way.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

_HOST = (bool, int, float)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree, out: list) -> list:
    """The leaves of ``tree`` (tensors and host numbers) in field order; ``None`` has none."""
    if tree is None:
        return out
    if isinstance(tree, (torch.Tensor,) + _HOST):
        out.append(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _flatten(leaf, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")
    return out


def _unflatten(template, leaves):
    """``template`` with its leaves taken in turn from the iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, (torch.Tensor,) + _HOST):
        return next(leaves)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(leaf, leaves) for leaf in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(leaf, leaves) for leaf in template)
    return {k: _unflatten(template[k], leaves) for k in sorted(template)}


def save_state(path: str, state) -> str:
    """Persist a solver-state tree to ``path`` (.npz); returns the file's path."""
    arrays = {}
    for i, leaf in enumerate(_flatten(state, [])):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        else:
            arrays[f"leaf_{i}"] = np.array(json.dumps(leaf))
    np.savez(_npz(path), **arrays)
    return _npz(path)


def load_state(path: str, template):
    """Restore a tree saved by :func:`save_state`.

    Args:
        template: a tree with the target structure (e.g. ``solver.init()``, or
            a fleet's ``init_batch()``) whose tensor leaves give the shapes,
            dtypes and the device each restored tensor goes to.
    """
    with np.load(_npz(path)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    template_leaves = _flatten(template, [])
    if len(leaves) != len(template_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves; template expects {len(template_leaves)}"
        )
    restored = []
    for i, (leaf, tmpl) in enumerate(zip(leaves, template_leaves)):
        host = leaf.dtype.kind == "U"
        shape = () if isinstance(tmpl, _HOST) else tuple(tmpl.shape)
        if host != isinstance(tmpl, _HOST) or tuple(leaf.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(leaf.shape)}; template expects "
                f"{shape} — was this state saved from a different solver config?"
            )
        if host:
            restored.append(type(tmpl)(json.loads(str(leaf))))
        else:
            restored.append(torch.from_numpy(leaf.copy()).to(
                dtype=tmpl.dtype, device=tmpl.device))
    return _unflatten(template, iter(restored))


# ----------------------------------------------------------------------
# The directory checkpoint (torch.distributed.checkpoint)
# ----------------------------------------------------------------------

_PENDING: list = []  # the futures of saves still in flight (wait=False)


def _state_dict(tree) -> dict:
    """``{"leaf_i": tensor or the host number's JSON text}`` of ``tree``'s leaves."""
    return {f"leaf_{i}": leaf if isinstance(leaf, torch.Tensor) else json.dumps(leaf)
            for i, leaf in enumerate(_flatten(tree, []))}


def _no_dist() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


def save_state_orbax(path: str, state, *, wait: bool = True) -> str:
    """Persist a solver-state tree as a directory checkpoint; returns its absolute path.

    Args:
        path: the checkpoint directory (created; overwritten if it exists).
        state: a state tree (``solver.init()``, a solve's ``.state``, a
            fleet's state, or one whose tensors are DTensors on a mesh: every
            rank of the process group calls with its own shards).
        wait: block until the checkpoint is written.  With ``wait=False``
            the write goes on in the background
            (``torch.distributed.checkpoint.async_save``); call
            :func:`wait_until_saved` before reading it back.
    """
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    writer = dcp.FileSystemWriter(path, overwrite=True)
    state_dict = _state_dict(state)
    if wait:
        dcp.save(state_dict, storage_writer=writer, no_dist=_no_dist())
    else:
        _PENDING.append(dcp.async_save(state_dict, storage_writer=writer, no_dist=_no_dist()))
    return path


def wait_until_saved() -> None:
    """Join every ``save_state_orbax(..., wait=False)`` still in flight."""
    while _PENDING:
        _PENDING.pop(0).result()


def load_state_orbax(path: str, template):
    """Restore a tree saved by :func:`save_state_orbax`.

    Every tensor comes back with the shape, dtype and device of the
    corresponding ``template`` tensor, and a DTensor with its mesh and
    placements: each rank reads only its own shard.  ``template`` itself is
    left as it is.

    Raises:
        ValueError: the checkpoint does not match the template (another
            solver config), with the JAX package's message.
    """
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException

    template_leaves = _flatten(template, [])
    state_dict = {f"leaf_{i}": torch.empty_like(leaf) if isinstance(leaf, torch.Tensor)
                  else json.dumps(leaf) for i, leaf in enumerate(template_leaves)}
    try:
        reader = dcp.FileSystemReader(os.path.abspath(path))
        saved = reader.read_metadata().state_dict_metadata
        if set(saved) != set(state_dict):
            raise ValueError(f"the checkpoint has {len(saved)} leaves; the template "
                             f"{len(state_dict)}")
        dcp.load(state_dict, storage_reader=reader, no_dist=_no_dist())
    except (ValueError, RuntimeError, CheckpointException) as exc:
        raise ValueError(
            f"checkpoint at {path!r} does not match the template state "
            "(was it saved from a different solver config?): "
            f"{exc}"
        ) from exc
    restored = []
    for i, tmpl in enumerate(template_leaves):
        value = state_dict[f"leaf_{i}"]
        restored.append(value if isinstance(tmpl, torch.Tensor)
                        else type(tmpl)(json.loads(value)))
    return _unflatten(template, iter(restored))
