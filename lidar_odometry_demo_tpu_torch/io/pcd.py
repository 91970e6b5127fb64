"""Minimal PCD (Point Cloud Data) reader/writer.

Covers what the reference uses PCL's pcd_io for (test fixtures,
test/test.cpp:194 loadPCDFile): ascii and binary encodings, arbitrary
field layouts with padding columns (the bundled fixture
test/test_data/intersection00056.pcd uses `FIELDS rgb _ x y z _` with
multi-count pad fields). Pure NumPy, host-side.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
}


def read_pcd(path: str) -> dict[str, np.ndarray]:
    """Read a PCD file; returns {field_name: (N,) array} (pad fields skipped)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = list(map(int, header["SIZE"]))
        types = header["TYPE"]
        counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
        n_points = int(header["POINTS"][0])
        encoding = header["DATA"][0].lower()

        dtype_fields = []
        for i, (name, size, typ, cnt) in enumerate(zip(fields, sizes, types, counts)):
            base = _TYPE_MAP.get((typ, size), None)
            if base is None:  # pad/unknown: raw bytes
                base = np.uint8
                shape = (size * cnt,)
            else:
                shape = (cnt,) if cnt > 1 else ()
            dtype_fields.append((f"f{i}", base, shape) if shape else (f"f{i}", base))
        dt = np.dtype(dtype_fields)

        if encoding == "binary":
            raw = np.frombuffer(f.read(dt.itemsize * n_points), dtype=dt, count=n_points)
        elif encoding == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            rows = np.atleast_2d(rows)
            raw = np.zeros(n_points, dtype=dt)
            col = 0
            for i, (name, cnt) in enumerate(zip(fields, counts)):
                w = cnt
                vals = rows[:, col:col + w]
                col += w
                if dt[f"f{i}"].shape:
                    raw[f"f{i}"] = vals.astype(dt[f"f{i}"].base)
                else:
                    raw[f"f{i}"] = vals[:, 0].astype(dt[f"f{i}"])
        elif encoding == "binary_compressed":
            raise NotImplementedError("binary_compressed PCD not supported")
        else:
            raise ValueError(f"unknown PCD DATA encoding: {encoding}")

    out = {}
    for i, name in enumerate(fields):
        if name == "_":
            continue
        out[name] = np.ascontiguousarray(raw[f"f{i}"])
    return out


def read_pcd_xyz(path: str) -> np.ndarray:
    """(N, 3) float32 xyz, NaN rows dropped."""
    d = read_pcd(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    return xyz[np.isfinite(xyz).all(axis=-1)]


def write_pcd(path: str, xyz: np.ndarray, normals: np.ndarray | None = None):
    """Write ascii PCD with xyz (+ optional normal_x/y/z) fields."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    fields = ["x", "y", "z"]
    cols = [xyz]
    if normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
        cols.append(np.asarray(normals, np.float32))
    data = np.concatenate(cols, axis=-1)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {' '.join(fields)}\n")
        f.write(f"SIZE {' '.join(['4'] * len(fields))}\n")
        f.write(f"TYPE {' '.join(['F'] * len(fields))}\n")
        f.write(f"COUNT {' '.join(['1'] * len(fields))}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        np.savetxt(f, data, fmt="%.6f")
