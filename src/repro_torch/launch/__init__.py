"""Process meshes, partition specs and the launch tools (roofline,
cost counter, cell specs, dry-run) of the port."""
from .mesh import Mesh, ProcessMesh, make_mesh, make_process_mesh

__all__ = ["Mesh", "ProcessMesh", "make_mesh", "make_process_mesh"]
