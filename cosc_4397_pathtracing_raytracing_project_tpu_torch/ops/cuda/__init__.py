from . import megakernel, mesh_kernel

__all__ = ["megakernel", "mesh_kernel"]
