"""Carry state between the reference package and the port, through numpy.

The reference's values are given here as numpy (``jax.device_get`` or
``np.asarray`` on the reference side); this module turns them into the
port's tensors and back.  It imports numpy and torch only, so the tests can
feed both packages the same inputs without the port depending on JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.core._tree import tree_map
from repro_torch.core.registration import RegElement, RegistrationConfig


def to_numpy(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` as a numpy array (ints stay ints)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
        tree,
    )


def deformation_from_numpy(d: Mapping[str, Any],
                           device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """``{"angle": (), "shift": (2,)}`` (or batched) numpy -> f32 tensors."""
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in d.items()
    }


def elements_from_numpy(
    elems: Iterable[Tuple[Mapping[str, Any], int, int]],
    device: DeviceLike = "cpu",
) -> List[RegElement]:
    """Reference ``RegElement``s (deformation as numpy, i, k) -> the port's."""
    return [
        RegElement(deformation_from_numpy(d, device), int(i), int(k))
        for d, i, k in elems
    ]


def elements_to_numpy(elems: Iterable[RegElement]) -> List[Tuple[Dict, int, int]]:
    return [(to_numpy(e.deformation), e.i, e.k) for e in elems]


def registration_config(fields: Mapping[str, Any]) -> RegistrationConfig:
    """The port's :class:`RegistrationConfig` from the reference config's
    field dict (``dataclasses.asdict`` of it); unknown fields raise."""
    names = {f.name for f in dataclasses.fields(RegistrationConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown RegistrationConfig fields: {sorted(unknown)}")
    return RegistrationConfig(**dict(fields))


def params_from_numpy(tree: Any, device: DeviceLike = "cpu",
                      dtype: torch.dtype = None) -> Any:
    """A parameter tree given as numpy (the reference's ``lm.init_params``
    through ``jax.device_get``) as the port's tensors, leaf for leaf.

    Each leaf keeps its dtype (numpy has no bfloat16: ml_dtypes' bfloat16
    arrays are carried as float32 and cast back) unless ``dtype`` is given,
    which applies to every floating leaf."""
    def leaf(x):
        arr = np.asarray(x)
        want = dtype
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
            want = want or torch.bfloat16
        t = torch.as_tensor(np.array(arr), device=device)
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t

    return tree_map(leaf, tree)
