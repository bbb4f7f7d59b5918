"""Production mesh construction on ``torch.distributed`` (port of
``repro.launch.mesh``).

Defined as functions (never module-level constants) so importing this
module never touches devices or process groups.  Each builds a
``DeviceMesh`` with ``init_device_mesh`` on the default process group,
whose world size must be the mesh's size: the dry-run gives it a ``fake``
group of 256 or 512 ranks in one process (see ``dryrun.py``), tests a gloo
group of real ranks.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape: tuple, multi_pod: bool, device_type: str):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return _mesh((2, 16, 16) if multi_pod else (16, 16), multi_pod, device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Reduced mesh for tests on a handful of ranks (8)."""
    return _mesh((2, 2, 2) if multi_pod else (2, 4), multi_pod, device_type)
