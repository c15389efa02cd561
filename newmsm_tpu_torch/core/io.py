"""Surface-file I/O: GIFTI (.surf.gii/.func.gii/.shape.gii), FreeSurfer
ASCII (.asc), legacy VTK, .dpv and whitespace matrix (.txt).

Self-contained stdlib implementation (no nibabel needed), the port's own
copy of the JAX package's core/io.py. Format
selection mirrors the reference sniffing rules (mesh.cpp:296-330); GIFTI
payloads use GZipBase64Binary encoding like Workbench/FSL outputs.
"""
from __future__ import annotations

import base64
import io as _stdio
import gzip
import zlib
import xml.etree.ElementTree as ET

import numpy as np

from .mesh import Mesh

_GIFTI_DTYPES = {
    "NIFTI_TYPE_FLOAT32": np.float32,
    "NIFTI_TYPE_FLOAT64": np.float64,
    "NIFTI_TYPE_INT32": np.int32,
    "NIFTI_TYPE_UINT8": np.uint8,
}


def _file_type(filename: str) -> str:
    name = filename[:-3] if filename.endswith(".gz") else filename
    ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
    if ext == "gii":
        return "GIFTI"
    if ext == "txt":
        return "MATRIX"
    if ext == "dpv":
        return "DPV"
    if ext == "asc":
        return "ASCII"
    if ext == "vtk":
        return "VTK"
    # sniff header
    try:
        with open(filename, "rb") as f:
            head = f.read(256)
        if b"# vtk DataFile Version" in head:
            return "VTK"
        if b"#!ascii" in head:
            return "ASCII"
        if b"<GIFTI" in head or head[:2] == b"\x1f\x8b":
            return "GIFTI"
    except OSError:
        pass
    return "DEFAULT"


# --------------------------------------------------------------------------
# GIFTI
# --------------------------------------------------------------------------

def _decode_data(da: ET.Element) -> np.ndarray:
    dtype = _GIFTI_DTYPES[da.get("DataType", "NIFTI_TYPE_FLOAT32")]
    dims = []
    for i in range(int(da.get("Dimensionality", "1"))):
        dims.append(int(da.get(f"Dim{i}", "0")))
    enc = da.get("Encoding", "GZipBase64Binary")
    data_el = da.find("Data")
    text = (data_el.text or "") if data_el is not None else ""
    if enc == "ASCII":
        arr = np.fromstring(text, dtype=dtype, sep=" ") if text else np.zeros(0, dtype)
    else:
        raw = base64.b64decode(text)
        if enc == "GZipBase64Binary":
            raw = zlib.decompress(raw)
        arr = np.frombuffer(raw, dtype=dtype)
    order = da.get("ArrayIndexingOrder", "RowMajorOrder")
    arr = arr.reshape(dims, order="C" if order == "RowMajorOrder" else "F")
    if da.get("Endian", "LittleEndian") == "BigEndian":
        arr = arr.byteswap()
    return np.ascontiguousarray(arr)


def read_gifti(filename: str):
    """Returns (coords | None, faces | None, data_rows list of (N,) arrays)."""
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rb") as f:
        content = f.read()
    if content[:2] == b"\x1f\x8b":
        content = gzip.decompress(content)
    root = ET.fromstring(content)
    coords = faces = None
    rows = []
    for da in root.iter("DataArray"):
        intent = da.get("Intent", "NIFTI_INTENT_NONE")
        arr = _decode_data(da)
        if intent == "NIFTI_INTENT_POINTSET":
            coords = arr.astype(np.float64)
        elif intent == "NIFTI_INTENT_TRIANGLE":
            faces = arr.astype(np.int32)
        else:
            a = arr.astype(np.float64)
            if a.ndim == 1:
                rows.append(a)
            else:
                # 2-D non-surface array: treat columns as feature maps
                for j in range(a.shape[1]):
                    rows.append(np.ascontiguousarray(a[:, j]))
    return coords, faces, rows


def _gifti_data_array(arr: np.ndarray, intent: str, dtype_name: str) -> ET.Element:
    da = ET.Element(
        "DataArray",
        {
            "Intent": intent,
            "DataType": dtype_name,
            "ArrayIndexingOrder": "RowMajorOrder",
            "Dimensionality": str(arr.ndim),
            "Encoding": "GZipBase64Binary",
            "Endian": "LittleEndian",
            "ExternalFileName": "",
            "ExternalFileOffset": "",
        },
    )
    for i, d in enumerate(arr.shape):
        da.set(f"Dim{i}", str(d))
    payload = base64.b64encode(zlib.compress(np.ascontiguousarray(arr).tobytes()))
    data_el = ET.SubElement(da, "Data")
    data_el.text = payload.decode("ascii")
    return da


def write_gifti_surface(filename: str, coords: np.ndarray, faces: np.ndarray) -> None:
    root = ET.Element("GIFTI", {"Version": "1.0", "NumberOfDataArrays": "2"})
    root.append(_gifti_data_array(coords.astype(np.float32),
                                  "NIFTI_INTENT_POINTSET", "NIFTI_TYPE_FLOAT32"))
    root.append(_gifti_data_array(faces.astype(np.int32),
                                  "NIFTI_INTENT_TRIANGLE", "NIFTI_TYPE_INT32"))
    _write_xml(root, filename)


def write_gifti_metric(filename: str, data: np.ndarray) -> None:
    """data: (D,N) feature rows, one DataArray per row."""
    data = np.atleast_2d(data)
    root = ET.Element("GIFTI", {"Version": "1.0",
                                "NumberOfDataArrays": str(data.shape[0])})
    for row in data:
        root.append(_gifti_data_array(row.astype(np.float32),
                                      "NIFTI_INTENT_NONE", "NIFTI_TYPE_FLOAT32"))
    _write_xml(root, filename)


def _write_xml(root: ET.Element, filename: str) -> None:
    buf = _stdio.BytesIO()
    tree = ET.ElementTree(root)
    buf.write(b'<?xml version="1.0" encoding="UTF-8"?>\n'
              b'<!DOCTYPE GIFTI SYSTEM "http://www.nitrc.org/frs/download.php/115/gifti.dtd">\n')
    tree.write(buf, encoding="utf-8", xml_declaration=False)
    payload = buf.getvalue()
    if filename.endswith(".gz"):
        with gzip.open(filename, "wb") as f:
            f.write(payload)
    else:
        with open(filename, "wb") as f:
            f.write(payload)


# --------------------------------------------------------------------------
# ASCII / VTK / matrix
# --------------------------------------------------------------------------

def read_ascii(filename: str):
    with open(filename) as f:
        header = f.readline()
        if "#!ascii" not in header:
            raise ValueError(f"{filename}: bad FreeSurfer ascii header")
        nv, nf = (int(x) for x in f.readline().split())
        rows = np.loadtxt(f, max_rows=nv)
        coords = rows[:, :3]
        vals = rows[:, 3]
        frows = np.loadtxt(f, max_rows=nf)
        faces = frows[:, :3].astype(np.int32)
    return coords, faces, vals


def write_ascii(filename: str, coords: np.ndarray, faces: np.ndarray,
                vals: np.ndarray | None = None) -> None:
    n = coords.shape[0]
    v = vals if vals is not None else np.zeros(n)
    with open(filename, "w") as f:
        f.write("#!ascii from newmsm_tpu_torch\n")
        f.write(f"{n} {faces.shape[0]}\n")
        for i in range(n):
            f.write(f"{coords[i,0]:.6f} {coords[i,1]:.6f} {coords[i,2]:.6f} {v[i]:.6f}\n")
        for t in range(faces.shape[0]):
            f.write(f"{faces[t,0]} {faces[t,1]} {faces[t,2]} 0\n")


def read_vtk(filename: str):
    with open(filename) as f:
        lines = f.read().split("\n")
    if "# vtk DataFile Version" not in lines[0]:
        raise ValueError(f"{filename}: bad VTK header")
    idx = 4
    tok = lines[idx].split()
    nv = int(tok[1])
    flat = []
    idx += 1
    while len(flat) < nv * 3:
        flat.extend(float(x) for x in lines[idx].split())
        idx += 1
    coords = np.array(flat).reshape(nv, 3)
    tok = lines[idx].split()
    nf = int(tok[1])
    idx += 1
    faces = np.zeros((nf, 3), dtype=np.int32)
    for i in range(nf):
        t = lines[idx + i].split()
        faces[i] = [int(t[1]), int(t[2]), int(t[3])]
    return coords, faces


def write_vtk(filename: str, coords: np.ndarray, faces: np.ndarray,
              vals: np.ndarray | None = None) -> None:
    n, t = coords.shape[0], faces.shape[0]
    v = vals if vals is not None else np.zeros(n)
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\nsurface written by newmsm_tpu_torch\n"
                "ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n")
        for i in range(n):
            f.write(f"{coords[i,0]:.6f} {coords[i,1]:.6f} {coords[i,2]:.6f}\n")
        f.write(f"POLYGONS {t} {t*4}\n")
        for i in range(t):
            f.write(f"3 {faces[i,0]} {faces[i,1]} {faces[i,2]}\n")
        f.write(f"POINT_DATA {n}\nSCALARS scalars float\nLOOKUP_TABLE default\n")
        for i in range(n):
            f.write(f"{v[i]:.6f}\n")


def read_matrix(filename: str, dpv: bool = False) -> np.ndarray:
    tmp = np.loadtxt(filename, ndmin=2)
    if dpv:
        if tmp.shape[1] != 5:
            raise ValueError(f"{filename}: dpv file must have 5 columns")
        if not np.array_equal(tmp[:, 0], np.arange(tmp.shape[0])):
            raise ValueError(f"{filename}: dpv index column malformed")
        return tmp[:, 4:5].T  # one feature row
    return tmp.T if tmp.shape[0] > tmp.shape[1] else tmp


def write_dpv(filename: str, coords: np.ndarray, vals: np.ndarray) -> None:
    n = coords.shape[0]
    with open(filename, "w") as f:
        for i in range(n):
            f.write(f"{i} {coords[i,0]:.6f} {coords[i,1]:.6f} {coords[i,2]:.6f} {vals[i]:.6f}\n")


def write_matrix(filename: str, data: np.ndarray) -> None:
    np.savetxt(filename, np.atleast_2d(data).T, fmt="%.6f")


# --------------------------------------------------------------------------
# Mesh-level dispatch
# --------------------------------------------------------------------------

def load_mesh(filename: str) -> Mesh:
    t = _file_type(filename)
    if t == "GIFTI":
        coords, faces, rows = read_gifti(filename)
        if coords is None:
            # data-only file: caller must already hold a surface
            data = np.stack(rows) if rows else None
            return Mesh(coords=np.zeros((0, 3)), faces=np.zeros((0, 3), np.int32),
                        data=data)
        data = np.stack(rows) if rows else np.zeros((1, coords.shape[0]))
        return Mesh(coords=coords, faces=faces, data=data)
    if t == "ASCII":
        coords, faces, vals = read_ascii(filename)
        return Mesh(coords=coords, faces=faces, data=vals[None, :])
    if t == "VTK":
        coords, faces = read_vtk(filename)
        return Mesh(coords=coords, faces=faces, data=np.zeros((1, coords.shape[0])))
    if t in ("MATRIX", "DPV"):
        data = read_matrix(filename, dpv=(t == "DPV"))
        return Mesh(coords=np.zeros((0, 3)), faces=np.zeros((0, 3), np.int32), data=data)
    raise ValueError(f"unknown mesh format: {filename}")


def read_spmat(filename: str) -> np.ndarray:
    """FSL/MATLAB `spconvert` sparse-matrix text: one `row col value` triplet
    per line (1-based), final line `nrows ncols 0` carrying the dimensions
    (MISCMATHS::SpMat's file constructor, consumed by the reference's sparse
    connectivity path, reg_tools.cpp:846-855). Returns the DENSE (R,C)
    matrix — mirroring the reference's own caveat that densification "may
    not be desirable ... if dimensions are v high"."""
    trip = np.loadtxt(filename, comments="%", ndmin=2)
    if trip.shape[1] != 3:
        raise ValueError(f"{filename}: expected 3-column sparse triplets")
    r, c, v = trip[:, 0].astype(int), trip[:, 1].astype(int), trip[:, 2]
    nr, nc = int(r.max()), int(c.max())
    # spconvert semantics: the trailing `nrows ncols 0` row only carries the
    # dimensions, and duplicate triplets SUM (not overwrite)
    if v[-1] == 0.0 and r[-1] == nr and c[-1] == nc:
        r, c, v = r[:-1], c[:-1], v[:-1]
    out = np.zeros((nr, nc))
    np.add.at(out, (r - 1, c - 1), v)
    return out


def load_data(filename: str, mesh: Mesh, sparse: bool = False) -> np.ndarray:
    """Load per-vertex data for an existing surface (reference set_data,
    reg_tools.cpp:846-867): accepts GIFTI func/shape, dpv, txt matrix, asc;
    `sparse=True` reads spconvert-format sparse connectivity instead
    (the reference's `issparse` branch). Returns (D,N)."""
    if sparse:
        data = read_spmat(filename)
        if data.shape[1] != mesh.nvertices:
            if data.shape[0] == mesh.nvertices:
                data = data.T
            else:
                raise ValueError("data does not match mesh dimensions")
        return np.ascontiguousarray(data)
    t = _file_type(filename)
    if t == "GIFTI":
        _, _, rows = read_gifti(filename)
        data = np.stack(rows)
    elif t in ("MATRIX", "DPV"):
        data = read_matrix(filename, dpv=(t == "DPV"))
    elif t == "ASCII":
        _, _, vals = read_ascii(filename)
        data = vals[None, :]
    else:
        raise ValueError(f"unknown data format: {filename}")
    if data.shape[1] != mesh.nvertices:
        if data.shape[0] == mesh.nvertices:
            data = data.T
        else:
            raise ValueError("data does not match mesh dimensions")
    return np.ascontiguousarray(data.astype(np.float64))


def save_mesh(mesh: Mesh, filename: str) -> None:
    t = _file_type(filename)
    base = filename[:-3] if filename.endswith(".gz") else filename
    if t == "GIFTI":
        stem = base[:-4]  # strip .gii
        if stem.endswith(".func") or stem.endswith(".shape"):
            write_gifti_metric(filename, mesh.data if mesh.data is not None
                               else np.zeros((1, mesh.nvertices)))
        else:
            write_gifti_surface(filename, mesh.coords, mesh.faces)
    elif t == "ASCII":
        vals = mesh.data[0] if mesh.data is not None and mesh.data.size else None
        write_ascii(filename, mesh.coords, mesh.faces, vals)
    elif t == "VTK":
        vals = mesh.data[0] if mesh.data is not None and mesh.data.size else None
        write_vtk(filename, mesh.coords, mesh.faces, vals)
    elif t == "DPV":
        write_dpv(filename, mesh.coords, mesh.data[0] if mesh.data is not None
                  else np.zeros(mesh.nvertices))
    elif t == "MATRIX":
        write_matrix(filename, mesh.data)
    else:
        raise ValueError(f"unknown output format: {filename}")
