"""Production meshes.  Functions, not module-level state, so that importing
initialises no process group.

Port of ``repro.launch.mesh``: the same shapes and axis names, built with
``torch.distributed.device_mesh.init_device_mesh`` over the default
process group, which the caller starts first (torchrun's environment, or
the fake backend of ``launch.dryrun`` with 256 or 512 ranks).
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The planning meshes: (16, 16) ``("data", "model")`` (256 ranks) or
    (2, 16, 16) ``("pod", "data", "model")`` (512 ranks).  Data parallelism
    spans pod x data; tensor parallelism stays on the model axis."""
    if multi_pod:
        shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        shape, axes = (16, 16), ("data", "model")
    return make_debug_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A mesh of any shape over the default group (its world size must be
    the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
