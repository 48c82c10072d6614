"""Geometry: host triangulations (``Triangulation``, ``Interval``,
``unit_square_mesh``), batched affine maps (``affine``), point location on
the host and on a device (``point_location``) and the device-side irregular
triangulations of the unit square (``structured.irregular_mesh_device(_soa)``)."""

from .affine import affine_maps, affine_maps_np
from .interval import Interval
from .point_location import CellLocator, DeviceCellLocator
from .structured import irregular_mesh_device, irregular_mesh_device_soa, unit_square_mesh
from .triangulation import Triangulation

__all__ = ["CellLocator", "DeviceCellLocator", "Interval", "Triangulation", "affine_maps",
           "affine_maps_np", "irregular_mesh_device", "irregular_mesh_device_soa",
           "unit_square_mesh"]
