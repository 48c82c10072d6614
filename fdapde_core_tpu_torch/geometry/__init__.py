"""Mesh generators ported so far: the device-side irregular triangulations
of the unit square (``structured.irregular_mesh_device(_soa)``)."""

from .structured import irregular_mesh_device, irregular_mesh_device_soa

__all__ = ["irregular_mesh_device", "irregular_mesh_device_soa"]
