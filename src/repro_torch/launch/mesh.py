"""Production mesh construction on torch ``DeviceMesh``.

Functions, not module-level constants: importing this module builds no
mesh and touches no process group.  Each mesh is built with
``init_device_mesh`` over the current process group (which the caller
initialises, with as many ranks as the mesh has) on ``device_type``:
``cuda`` unless the caller asks for ``cpu``.  Without a card a ``cuda``
mesh raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import os

from repro_torch.dist.sharding import TP_AXIS, data_axes

__all__ = ["make_production_mesh", "make_mesh", "dp_axes", "tp_axis"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    ADSALA_TP overrides the model-axis degree (total chips preserved) —
    the knob for shifting the TP<->DP balance.
    """
    tp = int(os.environ.get("ADSALA_TP", "16"))
    if multi_pod:
        return make_mesh((2, 512 // (2 * tp), tp), ("pod", "data", "model"),
                         device_type=device_type)
    return make_mesh((256 // tp, tp), ("data", "model"),
                     device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    process group (ranks laid out row-major) on ``device_type``; raises
    for ``cuda`` without a card."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise ValueError("make_mesh: no CUDA device for a 'cuda' mesh; "
                         "pass device_type='cpu' to build it on the CPU")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return data_axes(mesh)


def tp_axis(mesh) -> str:
    return TP_AXIS
