"""Bridge that carries state from the JAX reference into the port.

The system has no learned weights: what a comparison hands to both sides
is the parameter set, patch templates, patch results and flow fields. The
port never sees a JAX object — callers pass plain dicts and numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from of_dis_tpu_torch.params import DISParams


def params_from_reference(fields: dict, mesh=None) -> DISParams:
    """DISParams from `dataclasses.asdict` of a reference parameter set.

    A reference set that routes TV through a row-sharded mesh routes over
    the caller's port `mesh` (a `parallel.mesh.Mesh`) instead, with its
    threshold and axis name; such a set without a port mesh is refused
    rather than silently run unrouted. `mesh` is not read for a set that
    does not route."""
    names = {f.name for f in dataclasses.fields(DISParams)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown DISParams fields: {sorted(unknown)}")
    if fields.get("spatial_tv_mesh") is not None:
        if mesh is None:
            raise ValueError(
                "the reference set routes TV over a row-sharded mesh: pass "
                "the port's own as params_from_reference(fields, mesh=...)")
        fields = dict(fields, spatial_tv_mesh=mesh)
    return DISParams(**fields)


def tensors_from_numpy(kind, *arrays, device="cpu"):
    """Build a port NamedTuple (`PatchTemplates`, `PatchResult`) from numpy
    arrays in field order, each moved to `device` unchanged in dtype."""
    return kind(*(torch.as_tensor(np.asarray(a), device=device)
                  for a in arrays))
