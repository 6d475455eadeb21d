"""Elastic rescaling: rebuild mesh + reshard state when the fleet changes
(port of ``repro/runtime/elastic.py``).

Checkpoints are topology-free (full arrays, host-local), so a rescale is:
(1) build a mesh over the surviving/added ranks, (2) recompute sharding
specs for the new mesh, (3) restore the latest checkpoint against the new
mesh's placements (``Checkpointer.restore(shardings=...)``), (4) re-slice
the data stream across the new host count.  This module composes them and
validates the resulting configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch._device import DeviceLike


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_devices: int
    new_devices: int
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    data_parallel: int
    model_parallel: int


def plan_rescale(
    n_devices: int,
    *,
    model_parallel: int,
    min_data_parallel: int = 1,
    pods: int = 1,
) -> ElasticPlan:
    """Choose a mesh for ``n_devices``: keep TP fixed, flex the DP axis.

    TP size is architectural (weight shards); DP absorbs fleet changes —
    the standard elastic policy.  Raises when the fleet can't support it.
    """
    if n_devices % (model_parallel * pods):
        raise ValueError(
            f"{n_devices} devices not divisible by TP={model_parallel} x pods={pods}"
        )
    dp = n_devices // (model_parallel * pods)
    if dp < min_data_parallel:
        raise ValueError(f"data parallel {dp} < minimum {min_data_parallel}")
    if pods > 1:
        return ElasticPlan(
            -1, n_devices, (pods, dp, model_parallel), ("pod", "data", "model"),
            dp * pods, model_parallel,
        )
    return ElasticPlan(
        -1, n_devices, (dp, model_parallel), ("data", "model"), dp, model_parallel
    )


def build_mesh(plan: ElasticPlan, *, device: DeviceLike = None):
    """A ``DeviceMesh`` of the plan's shape over the first ranks of the
    initialised world; raises "need n devices, have m" when it is smaller."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(plan.mesh_shape, plan.axis_names, device=device)


def rescale_batch_boundaries(global_batch: int, new_hosts: int):
    """Fresh fair boundaries after a host-count change."""
    return [
        (i * global_batch // new_hosts, (i + 1) * global_batch // new_hosts - 1)
        for i in range(new_hosts)
    ]
