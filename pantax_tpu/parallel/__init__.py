"""Multi-chip execution: device mesh, sharded profiling, default-mesh registry.

The process default mesh, once set (CLI --mesh auto, or set_default_mesh in
code), makes every device compute path — aligner query batches and the
full-parity coverage engine — shard its read batch across the mesh's "reads"
axis, with XLA inserting the collectives from the sharding annotations.
"""
from .mesh import make_mesh

_DEFAULT_MESH = None


def set_default_mesh(mesh) -> None:
    """Install (or clear, with None) the process-wide read-sharding mesh."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def default_mesh():
    return _DEFAULT_MESH


def auto_mesh(spec: str = "auto"):
    """Resolve a --mesh flag value: "auto" builds a mesh over all LOCAL
    devices when more than one is visible, "off" disables sharding, an
    integer uses that many devices.  Installs and returns the default mesh
    (None when single-device).

    Local devices only: in a multi-host run (jax.distributed) the cross-host
    axis is the per-process read shard (parallel/distributed.py), so each
    process meshes over its own chips — a mesh containing another host's
    devices could not receive this process's uploads."""
    import jax

    if spec == "off":
        set_default_mesh(None)
        return None
    n = len(jax.local_devices()) if spec == "auto" else int(spec)
    if n <= 1:
        set_default_mesh(None)
        return None
    mesh = make_local_mesh(n)
    set_default_mesh(mesh)
    return mesh


def make_local_mesh(n: int):
    """("reads", "graph") mesh over the first n LOCAL devices."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devices = jax.local_devices()
    if len(devices) < n:
        raise ValueError(f"need {n} local devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(n, 1), ("reads", "graph"))


__all__ = [
    "make_mesh",
    "set_default_mesh",
    "default_mesh",
    "auto_mesh",
]
