"""Geometry: host triangulations (``Triangulation``, ``Interval``,
``unit_square_mesh``, ``unit_cube_mesh``), batched affine maps
(``affine``), point location on the host and on a device
(``point_location``), the device-side irregular triangulations of the unit
square (``structured.irregular_mesh_device(_soa)``) and tetrahedralizations
of the unit cube (``structured.cube_mesh_device(_soa)``), red refinement and strip
renumbering on a device (``refine_device``), and the host copies of the
remaining geometry: 1.5D networks (``LinearNetwork``), the KD-tree,
projection, Voronoi tessellation, hyperplanes, the simplex helpers and the
barycentric walk (``walk_search``)."""

from .affine import affine_maps, affine_maps_np
from .hyperplane import HyperPlane
from .interval import Interval
from .kd_tree import KDTree
from .network import LinearNetwork
from .point_location import CellLocator, DeviceCellLocator
from .projection import project
from .refine_device import (
    device_edges,
    refine_once,
    strip_order,
    strip_order_binned,
    uniform_refine_device,
)
from .structured import (
    cube_mesh_device,
    cube_mesh_device_soa,
    irregular_mesh_device,
    irregular_mesh_device_soa,
    unit_cube_mesh,
    unit_interval_mesh,
    unit_square_mesh,
)
from .triangulation import Triangulation
from .voronoi import Voronoi

__all__ = ["CellLocator", "DeviceCellLocator", "HyperPlane", "Interval", "KDTree",
           "LinearNetwork", "Triangulation", "Voronoi", "affine_maps", "affine_maps_np",
           "cube_mesh_device", "cube_mesh_device_soa", "device_edges", "irregular_mesh_device",
           "irregular_mesh_device_soa", "project", "refine_once", "strip_order",
           "strip_order_binned", "uniform_refine_device", "unit_cube_mesh", "unit_interval_mesh",
           "unit_square_mesh"]
