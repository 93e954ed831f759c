"""Process meshes for the port."""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
