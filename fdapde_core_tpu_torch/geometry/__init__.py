"""Geometry: host triangulations (``Triangulation``, ``unit_square_mesh``),
batched affine maps (``affine``) and the device-side irregular
triangulations of the unit square (``structured.irregular_mesh_device(_soa)``)."""

from .affine import affine_maps, affine_maps_np
from .structured import irregular_mesh_device, irregular_mesh_device_soa, unit_square_mesh
from .triangulation import Triangulation

__all__ = ["Triangulation", "affine_maps", "affine_maps_np", "irregular_mesh_device",
           "irregular_mesh_device_soa", "unit_square_mesh"]
