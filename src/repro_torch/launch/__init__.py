"""Process meshes, partition specs and the launch tools (roofline,
cost counter, cell specs, dry-run) of the port."""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
