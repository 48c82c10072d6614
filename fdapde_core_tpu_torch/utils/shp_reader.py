"""ESRI shapefile reader (.shp geometry + .dbf attributes).

Host-only copy of ``fdapde_core_tpu/utils/shp_reader.py`` (counterpart of
fdaPDE-core's fdaPDE/utils/IO/shp_reader.h:49-408): supports
Point (1), PolyLine (3), Polygon (5), MultiPoint (8) and their M/Z variants
INCLUDING the measure/elevation payloads (sf_point_t / sf_multipoint_t /
sf_polygon_t read z and m blocks after the XY data, shp_reader.h:62-155),
plus the dBASE attribute table. Pure-Python struct parsing, host-side.

As in the reference, the M/Z interpretation follows the FILE-header shape
type (the per-record type field is skipped, shp_reader.h:190-195).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["ShapeFile", "ShapeRecord", "read_shp", "read_dbf"]

_SHAPE_NAMES = {
    0: "Null", 1: "Point", 3: "PolyLine", 5: "Polygon", 8: "MultiPoint",
    11: "PointZ", 13: "PolyLineZ", 15: "PolygonZ", 18: "MultiPointZ",
    21: "PointM", 23: "PolyLineM", 25: "PolygonM", 28: "MultiPointM",
}
_POINT_TYPES = (1, 11, 21)
_POLY_TYPES = (3, 5, 13, 15, 23, 25)
_MULTIPOINT_TYPES = (8, 18, 28)
_Z_TYPES = (11, 13, 15, 18)
_M_TYPES = (21, 23, 25, 28)


@dataclass
class ShapeRecord:
    shape_type: int
    points: np.ndarray  # (n, 2)
    parts: np.ndarray  # part/ring start offsets into points
    z: np.ndarray | None = None  # (n,) elevation values (Z variants)
    m: np.ndarray | None = None  # (n,) measure values (Z/M variants)
    z_range: tuple[float, float] | None = None
    m_range: tuple[float, float] | None = None

    def rings(self):
        """Iterate (start, end) offsets per part — the reference's
        ring_iterator semantics (shp_reader.h:157-181)."""
        ends = np.append(self.parts[1:], self.points.shape[0])
        return list(zip(self.parts.tolist(), ends.tolist()))


def _zm_block(rec, off, n):
    """(range, values, new_off); NaN-filled when the optional block is
    absent (truncated record)."""
    if off + 16 + 8 * n > len(rec):
        return None, None, off
    rng = struct.unpack("<2d", rec[off : off + 16])
    vals = np.frombuffer(rec, "<f8", n, off + 16).copy()
    return rng, vals, off + 16 + 8 * n


def read_shp(path: str):
    """Parse a .shp file -> (shape_type, bbox, [ShapeRecord])."""
    with open(path, "rb") as fh:
        header = fh.read(100)
        (magic,) = struct.unpack(">i", header[:4])
        if magic != 9994:  # shp_reader.h file-code check
            raise ValueError(f"{path}: not a shapefile (code {magic})")
        (file_len_words,) = struct.unpack(">i", header[24:28])
        version, shape_type = struct.unpack("<ii", header[28:36])
        bbox = struct.unpack("<8d", header[36:100])  # x/y/z/m min-max
        records = []
        body = fh.read(2 * file_len_words - 100)
    has_z = shape_type in _Z_TYPES
    has_m = shape_type in _M_TYPES or has_z
    off = 0
    while off < len(body):
        _, content_len = struct.unpack(">ii", body[off : off + 8])
        off += 8
        rec = body[off : off + 2 * content_len]
        off += 2 * content_len
        (stype,) = struct.unpack("<i", rec[:4])
        if stype == 0:
            records.append(ShapeRecord(0, np.empty((0, 2)), np.zeros(1, np.int64)))
            continue
        # the reference interprets every record by the HEADER's type
        if shape_type in _POINT_TYPES:
            x, y = struct.unpack("<2d", rec[4:20])
            p = 20
            z = m = None
            if shape_type == 21 and len(rec) >= p + 8:  # PointM: x, y, m
                m = np.array(struct.unpack("<d", rec[p : p + 8]))
            if shape_type == 11:  # PointZ: x, y, z, m
                z = np.array(struct.unpack("<d", rec[p : p + 8]))
                if len(rec) >= p + 16:
                    m = np.array(struct.unpack("<d", rec[p + 8 : p + 16]))
            records.append(
                ShapeRecord(stype, np.array([[x, y]]), np.zeros(1, np.int64),
                            z=z, m=m)
            )
        elif shape_type in _POLY_TYPES:
            n_parts, n_points = struct.unpack("<2i", rec[36:44])
            parts = np.frombuffer(rec, "<i4", n_parts, 44).astype(np.int64)
            p = 44 + 4 * n_parts
            pts = np.frombuffer(rec, "<f8", 2 * n_points, p).reshape(
                n_points, 2
            )
            p += 16 * n_points
            z = m = z_rng = m_rng = None
            if has_z:
                z_rng, z, p = _zm_block(rec, p, n_points)
            if has_m:
                m_rng, m, p = _zm_block(rec, p, n_points)
            records.append(
                ShapeRecord(stype, pts.copy(), parts, z=z, m=m,
                            z_range=z_rng, m_range=m_rng)
            )
        elif shape_type in _MULTIPOINT_TYPES:
            (n_points,) = struct.unpack("<i", rec[36:40])
            pts = np.frombuffer(rec, "<f8", 2 * n_points, 40).reshape(
                n_points, 2
            )
            p = 40 + 16 * n_points
            z = m = z_rng = m_rng = None
            if has_z:
                z_rng, z, p = _zm_block(rec, p, n_points)
            if has_m:
                m_rng, m, p = _zm_block(rec, p, n_points)
            records.append(
                ShapeRecord(stype, pts.copy(), np.zeros(1, np.int64), z=z,
                            m=m, z_range=z_rng, m_range=m_rng)
            )
        else:
            raise NotImplementedError(f"shape type {stype}")
    return shape_type, np.asarray(bbox), records


def read_dbf(path: str):
    """Parse a dBASE III .dbf attribute table -> (field_names, rows)."""
    with open(path, "rb") as fh:
        header = fh.read(32)
        n_records = struct.unpack("<I", header[4:8])[0]
        header_size, record_size = struct.unpack("<2H", header[8:12])
        fields = []
        while True:
            desc = fh.read(32)
            if desc[0:1] == b"\r":
                break
            name = desc[:11].split(b"\0")[0].decode("ascii")
            ftype = desc[11:12].decode("ascii")
            length = desc[16]
            fields.append((name, ftype, length))
            if fh.tell() >= header_size - 1:
                fh.read(1)
                break
        fh.seek(header_size)
        rows = []
        for _ in range(n_records):
            rec = fh.read(record_size)
            if not rec or rec[0:1] == b"\x1a":
                break
            offp = 1  # skip deletion flag
            row = {}
            for name, ftype, length in fields:
                raw = rec[offp : offp + length].decode("latin1").strip()
                offp += length
                if ftype in ("N", "F"):
                    row[name] = float(raw) if raw else np.nan
                elif ftype == "L":
                    row[name] = raw in ("Y", "y", "T", "t")
                else:
                    row[name] = raw
            rows.append(row)
    return [f[0] for f in fields], rows


class ShapeFile:
    """A .shp/.dbf pair (shp_reader.h:354 ShapeFile)."""

    def __init__(self, path: str):
        base = path[:-4] if path.lower().endswith(".shp") else path
        self.shape_type, self.bbox, self.records = read_shp(base + ".shp")
        dbf = base + ".dbf"
        if os.path.exists(dbf):
            self.field_names, self.attributes = read_dbf(dbf)
        else:
            self.field_names, self.attributes = [], []

    @property
    def shape_type_name(self) -> str:
        return _SHAPE_NAMES.get(self.shape_type, str(self.shape_type))

    def __len__(self):
        return len(self.records)

    def points(self, i: int) -> np.ndarray:
        return self.records[i].points
