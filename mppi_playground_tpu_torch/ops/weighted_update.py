"""Softmin weighting and weighted-average update: the CUDA kernel, its twin and the plain route.

Counterpart of ``mppi_playground_tpu/ops/weighted_update.py`` (the
dispatcher and ``_xla_weighted_update``) and of
``mppi_playground_tpu/ops/pallas_kernels.py`` (the streaming Pallas
kernel): ``weights = softmax(-costs / lambda)``, ``update = sum_k
weights[k] * samples[k]`` and the effective sample size ``1 / sum(w^2)``.

* :func:`weighted_update_partials` (``csrc/weighted_update.cu``) — per
  block of 256 samples the softmin partials of ``[K, D]`` samples: the max
  of ``-c / lambda``, ``sum e``, ``sum e^2`` and the numerator ``sum e *
  sample``, streamed with neighbouring threads on neighbouring columns.  Its
  statistics are the code the fused solve and auto-lambda phase 2 share
  (``csrc/softmin_partials.cuh``).  It launches its kernel for CUDA
  tensors and raises on what the kernel does not take; its ``launches``
  reads the eager launches in ``utils/timing``'s registry (a launch a CUDA
  graph captures counts there once a replay); CPU tensors take
  :func:`block_partials_plain`, the twin of every kernel's block partials.
* :func:`weighted_update_partials_batch` (``weighted_update_batch``) — the
  same kernel over an unfused fleet's B scenarios in one launch, the
  scenario on ``blockIdx.y``: scenario b's partials are bit for bit its own
  launch's.  :func:`weighted_update_partials` is it on a batch of one.
* :func:`combine_partials` merges block partials into ``(update, weights,
  ess)`` in torch, for this kernel and the fused ones.
* :func:`weighted_update` dispatches on the JAX package's backend names:
  ``"auto"`` and ``"pallas"`` take the kernel (its twin on the CPU),
  ``"xla"`` the plain softmax and einsum (:func:`xla_weighted_update`).
  :func:`weighted_update_batch` is its fleet form: one launch of the kernel,
  then each scenario's partials merged as its own solve merges them.
  Unlike the JAX package there is no gate on ``D = T * m``: that gate is a
  TPU VMEM limit, and the kernel takes any ``D``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.utils import timing

BLOCK = 256  # samples per block of partials, the kernels' block size
BACKENDS = ("auto", "xla", "pallas")


def block_partials_plain(costs, flat, lam):
    """Softmin partials per block of 256: ``(stats [B, 3], numer [B, D])``.

    ``flat [K, D]`` holds each sample's slots; padded samples cost 1e30 and
    weigh 0.  ``lam`` holds one element; ``-c / lam`` divides by a tensor
    (IEEE division, as the kernels do).  The twin of the kernels' block
    partials (``softmin_partials.cuh`` ``block_partials`` and
    ``weighted_update.cu``), which sum the numerator in other orders.
    """
    num_samples, slots = flat.shape
    blocks = -(-num_samples // BLOCK)
    pad = blocks * BLOCK - num_samples
    c = torch.cat([costs, costs.new_full((pad,), 1e30)]).view(blocks, BLOCK)
    s = -c / lam.reshape(())
    mx = s.max(dim=1).values
    e = torch.exp(s - mx[:, None])
    stats = torch.stack([mx, e.sum(dim=1), (e * e).sum(dim=1)], dim=1)
    flat = torch.cat([flat, flat.new_zeros(pad, slots)])
    numer = (e[:, :, None] * flat.view(blocks, BLOCK, slots)).sum(dim=1)
    return stats, numer


def combine_partials(costs, stats, numer, lam, horizon: int, dim_control: int):
    """Merge block partials into ``(update [T, m], weights [K], ess)``.

    Flash-attention-style rescaling of each block's ``sum e`` and numerator
    by ``exp(block max - global max)``; plain tensor ops, as the JAX
    package leaves this epilogue to XLA.
    """
    lam = lam.reshape(())
    tile_max = stats[:, 0]
    mx = torch.max(tile_max)
    alpha = torch.exp(tile_max - mx)
    z = torch.sum(alpha * stats[:, 1])
    sumsq = torch.sum(alpha * alpha * stats[:, 2])
    numer_g = torch.sum(alpha[:, None] * numer, dim=0)
    update = (numer_g / z).reshape(horizon, dim_control)
    weights = torch.exp(-costs / lam - mx) / z
    ess = (z * z) / sumsq
    return update, weights, ess


def xla_weighted_update(
    costs: torch.Tensor, samples: torch.Tensor, lam: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain route, ``_xla_weighted_update``'s counterpart: softmax and einsum."""
    weights = torch.softmax(-costs / lam, dim=0)
    update = torch.einsum("k,ktm->tm", weights, samples)
    ess = 1.0 / torch.sum(weights * weights)
    return update, weights, ess


_BATCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


@timing.counted_launches("weighted_update_batch")
def weighted_update_partials(costs: torch.Tensor, samples: torch.Tensor, lam: torch.Tensor):
    """Block partials ``(stats [B, 3], numer [B, D])`` of ``samples [K, D]`` at ``lam``.

    ``costs [K]``, ``samples [K, D]`` (contiguous) and ``lam`` (one element,
    read by the kernel, never by the host), all float32 on one device;
    ``B = ceil(K / 256)``.  :func:`weighted_update_partials_batch` of a batch
    of one, which counts the launch here; CPU tensors take
    :func:`block_partials_plain`.
    """
    if costs.dim() != 1 or samples.dim() != 2 or samples.shape[0] != costs.shape[0]:
        raise ValueError(
            f"costs must be [K] and samples [K, D], got {tuple(costs.shape)} and "
            f"{tuple(samples.shape)}"
        )
    if lam.numel() != 1:
        raise ValueError("lam must hold one element")
    stats, numer = weighted_update_partials_batch(costs[None], samples[None], lam.reshape(1))
    return stats[0], numer[0]



def weighted_update_partials_batch_plain(costs, samples, lam):
    """:func:`weighted_update_partials_batch`'s twin: :func:`block_partials_plain` scenario by
    scenario."""
    parts = [block_partials_plain(costs[b], samples[b], lam[b]) for b in range(costs.shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def weighted_update_partials_batch(costs: torch.Tensor, samples: torch.Tensor,
                                   lam: torch.Tensor):
    """Block partials of B scenarios in one launch -> ``(stats [B, blocks, 3], numer [B,
    blocks, D])``.

    ``costs [B, K]``, ``samples [B, K, D]`` (contiguous) and ``lam [B]``
    (read by the kernel), all float32 on one device.  Scenario b's partials
    are bit for bit :func:`weighted_update_partials` on b's inputs; the
    launch counts in that wrapper's ``launches``.  CPU tensors take
    :func:`weighted_update_partials_batch_plain`.
    """
    if costs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"weighted_update_partials runs on cuda or cpu, not {costs.device}")
    if costs.device.type == "cpu":
        return weighted_update_partials_batch_plain(costs, samples, lam)
    dev = costs.device
    if (costs.dim() != 2 or samples.dim() != 3 or samples.shape[:2] != costs.shape
            or costs.shape[0] < 1):
        raise ValueError(
            f"costs must be [B, K] and samples [B, K, D], got {tuple(costs.shape)} and "
            f"{tuple(samples.shape)}"
        )
    batch, num_samples, slots = samples.shape
    if not 1 <= num_samples < 2**31 - BLOCK or not 1 <= slots < 2**31:
        raise ValueError(f"K and D out of range: K={num_samples}, D={slots}")
    for name, t in (("costs", costs), ("samples", samples), ("lam", lam)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(lam.shape) != (batch,):
        raise ValueError(f"lam must be [{batch}], one a scenario, got {tuple(lam.shape)}")
    blocks = -(-num_samples // BLOCK)
    stats = torch.empty(batch, blocks, 3, dtype=torch.float32, device=dev)
    numer = torch.empty(batch, blocks, slots, dtype=torch.float32, device=dev)
    cuda_build.launch("weighted_update", "weighted_update_batch", _BATCH_ARGTYPES, dev,
                      costs.data_ptr(), samples.data_ptr(), lam.data_ptr(), slots, num_samples,
                      batch, stats.data_ptr(), numer.data_ptr())
    return stats, numer


def weighted_update(
    costs: torch.Tensor, samples: torch.Tensor, lam: torch.Tensor, backend: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(update [T, m], weights [K], ess)`` from costs ``[K]`` and samples ``[K, T, m]``.

    ``backend``: ``"auto"`` or ``"pallas"`` (the kernel; its twin for CPU
    tensors), ``"xla"`` (softmax and einsum).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "xla":
        return xla_weighted_update(costs, samples, lam)
    num_samples, horizon, dim_control = samples.shape
    stats, numer = weighted_update_partials(
        costs, samples.reshape(num_samples, horizon * dim_control).contiguous(), lam.reshape(1)
    )
    return combine_partials(costs, stats, numer, lam, horizon, dim_control)


def own_row(t: torch.Tensor, b: int) -> torch.Tensor:
    """Row ``b`` of ``t``, copied where it does not start 16-byte aligned.

    A torch reduction or product of a row reads it as the single solve reads
    its own tensor (a fresh allocation), whose order of operations may
    depend on the start's alignment on the card; a row of a ``[B, K]``
    tensor starts ``b * K`` floats on.
    """
    row = t[b]
    return row if row.data_ptr() % 16 == 0 else row.clone()


def weighted_update_batch(
    costs: torch.Tensor, samples: torch.Tensor, lam: torch.Tensor, backend: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`weighted_update` of B scenarios -> ``(update [B, T, m], weights [B, K], ess [B])``.

    ``costs [B, K]``, ``samples [B, K, T, m]``, ``lam [B]``.  ``"auto"`` and
    ``"pallas"`` launch the kernel once for every scenario
    (:func:`weighted_update_partials_batch`) and merge each scenario's
    partials by :func:`combine_partials`, the single solve's merge, whose
    sums take their order from the shape; ``"xla"`` runs the plain route
    scenario by scenario.  Scenario b's results are bit for bit
    :func:`weighted_update` on b's inputs.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    batch, num_samples, horizon, dim_control = samples.shape
    if backend == "xla":
        parts = [xla_weighted_update(own_row(costs, b), own_row(samples, b), lam[b])
                 for b in range(batch)]
    else:
        stats, numer = weighted_update_partials_batch(
            costs.contiguous(), samples.reshape(batch, num_samples, -1).contiguous(),
            lam.reshape(batch).contiguous())
        parts = [combine_partials(own_row(costs, b), stats[b], numer[b], lam[b], horizon,
                                  dim_control) for b in range(batch)]
    return tuple(torch.stack(column) for column in zip(*parts))
