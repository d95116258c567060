"""Production mesh construction, as the JAX package's `repro/launch/mesh.py`.

The port's meshes are abstract (`repro_torch.parallel.sharding.Mesh`: axis
sizes and names), so building one needs no devices and no counterpart of
the JAX dry run's forced host-device count.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def mesh_label(mesh: Mesh) -> str:
    """"16x16", "2x16x16": the axis sizes joined by "x"."""
    return "x".join(str(s) for s in mesh.axis_sizes)
