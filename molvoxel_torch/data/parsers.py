"""Minimal dependency-free molecular file readers (SDF V2000/V3000, PDB, XYZ, MOL2).

The reference's chemistry layer is RDKit-only (reference molvoxel/etc/
rdkit/): without RDKit installed it cannot load a molecule at all.  Here the
point-cloud pipeline works out of the box on plain structure files; the RDKit
adapter (data/rdkit_adapter.py) remains available as an optional richer
front-end (bond perception, sanitization, feature callbacks).

These parsers extract exactly what voxelization needs: coordinates, element
symbols, and (for SDF) the explicit bond list with order — enough to drive the
bond-midpoint pseudo-atom feature of the reference point-cloud maker
(reference molvoxel/etc/rdkit/pointcloud.py:79-89).
"""

from __future__ import annotations

import dataclasses
import gzip
from collections.abc import Iterator
from pathlib import Path

import numpy as np

# SDF bond-order codes -> canonical bond type names (MDL CTfile spec)
SDF_BOND_TYPES = {1: "SINGLE", 2: "DOUBLE", 3: "TRIPLE", 4: "AROMATIC"}


@dataclasses.dataclass
class SimpleMolecule:
    """A parsed molecule: the minimal structure the voxelizer pipeline needs."""

    coords: np.ndarray  # (V, 3) float64
    symbols: list[str]  # element symbols, len V
    bonds: list[tuple[int, int, str]] = dataclasses.field(default_factory=list)  # (i, j, bond_type)
    name: str = ""

    @property
    def num_atoms(self) -> int:
        return len(self.symbols)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def bond_midpoints(self) -> np.ndarray:
        """(num_bonds, 3) midpoints of bonded atom pairs."""
        if not self.bonds:
            return np.zeros((0, 3), dtype=self.coords.dtype)
        i = np.asarray([b[0] for b in self.bonds])
        j = np.asarray([b[1] for b in self.bonds])
        return (self.coords[i] + self.coords[j]) / 2.0

    def without_hydrogens(self) -> "SimpleMolecule":
        keep = [i for i, s in enumerate(self.symbols) if s not in ("H", "D")]
        remap = {old: new for new, old in enumerate(keep)}
        bonds = [
            (remap[i], remap[j], t) for (i, j, t) in self.bonds if i in remap and j in remap
        ]
        return SimpleMolecule(
            coords=self.coords[keep],
            symbols=[self.symbols[i] for i in keep],
            bonds=bonds,
            name=self.name,
        )


def _open_text(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path)


def read_sdf(path: str | Path) -> SimpleMolecule:
    """Read the first molecule of an SDF/MOL (V2000) file."""
    return next(iter_sdf(path))


def iter_sdf(path: str | Path) -> Iterator[SimpleMolecule]:
    """Iterate all molecules in a (possibly multi-record) SDF file."""
    with _open_text(path) as fh:
        lines = fh.read().splitlines()
    yield from iter_sdf_lines(lines)


def _parse_v3000(lines: list[str], start: int, name: str) -> tuple[SimpleMolecule, int]:
    """Parse one V3000 record body (the >999-atom SDF extension).

    Lines are ``M  V30 ...`` continuation records: COUNTS, BEGIN/END ATOM
    (idx element x y z), BEGIN/END BOND (idx order a1 a2).  Atom indices may
    be arbitrary, so bonds remap through an index table.  Returns the
    molecule and the line position after its terminator.
    """
    pos = start
    n = len(lines)
    coords_l: list[tuple[float, float, float]] = []
    symbols: list[str] = []
    idx_map: dict[int, int] = {}
    bonds: list[tuple[int, int, str]] = []
    section = None
    while pos < n and lines[pos].strip() != "$$$$":
        t = lines[pos].split()
        if len(t) >= 3 and t[0] == "M" and t[1] == "V30":
            if t[2] == "BEGIN" and len(t) > 3:
                section = t[3]
            elif t[2] == "END" and len(t) > 3:
                section = None
            elif section == "ATOM" and len(t) >= 7:
                idx_map[int(t[2])] = len(symbols)
                symbols.append(t[3])
                coords_l.append((float(t[4]), float(t[5]), float(t[6])))
            elif section == "BOND" and len(t) >= 6:
                order = int(t[3])
                bonds.append(
                    (idx_map[int(t[4])], idx_map[int(t[5])], SDF_BOND_TYPES.get(order, "SINGLE"))
                )
        pos += 1
    coords = np.asarray(coords_l, np.float64).reshape(len(symbols), 3)
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name=name), pos + 1


def iter_sdf_lines(lines: list[str]) -> Iterator[SimpleMolecule]:
    """Iterate molecules over already-split SDF text lines (V2000 or V3000)."""
    start = 0
    n = len(lines)
    while start < n:
        # skip blank padding between records
        while start < n and not lines[start].strip() and lines[start : start + 1] != []:
            if start + 3 < n and lines[start + 3].strip():
                break
            start += 1
        if start + 3 >= n:
            return
        name = lines[start].strip()
        counts = lines[start + 3]
        if "V3000" in counts:
            mol, start = _parse_v3000(lines, start + 4, name)
            yield mol
            continue
        try:
            num_atoms = int(counts[0:3])
            num_bonds = int(counts[3:6])
        except ValueError:
            return
        atom_lines = lines[start + 4 : start + 4 + num_atoms]
        bond_lines = lines[start + 4 + num_atoms : start + 4 + num_atoms + num_bonds]
        coords = np.empty((num_atoms, 3), dtype=np.float64)
        symbols: list[str] = []
        for i, line in enumerate(atom_lines):
            coords[i, 0] = float(line[0:10])
            coords[i, 1] = float(line[10:20])
            coords[i, 2] = float(line[20:30])
            symbols.append(line[31:34].strip())
        bonds: list[tuple[int, int, str]] = []
        for line in bond_lines:
            i = int(line[0:3]) - 1
            j = int(line[3:6]) - 1
            order = int(line[6:9])
            bonds.append((i, j, SDF_BOND_TYPES.get(order, "SINGLE")))
        yield SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name=name)
        # advance to after "M  END" / "$$$$"
        pos = start + 4 + num_atoms + num_bonds
        while pos < n and lines[pos].strip() != "$$$$":
            pos += 1
        start = pos + 1


_PDB_TWO_LETTER = {
    "BR", "CL", "FE", "ZN", "MG", "MN", "CA", "NA", "CU", "NI", "CO", "SE", "CD", "HG", "AS", "LI", "AL", "SI",
}


def _pdb_element(line: str) -> str:
    # columns 77-78 hold the element when present
    if len(line) >= 78:
        elem = line[76:78].strip()
        if elem:
            return elem.capitalize() if len(elem) == 2 else elem.upper()
    # fall back to the atom-name field (columns 13-16).  PDB convention:
    # two-letter elements start in column 13 (line[12]); names starting in
    # column 14 are single-letter elements (" CA " = alpha carbon, "CA  " =
    # calcium).
    name = line[12:16]
    head = "".join(ch for ch in name.strip() if ch.isalpha())[:2].upper()
    if name[:1] != " " and head in _PDB_TWO_LETTER:
        return head.capitalize()
    return head[:1]


def read_pdb(path: str | Path, *, include_hetatm: bool = True) -> SimpleMolecule:
    """Read coordinates + elements from a PDB file (first MODEL)."""
    return next(iter_pdb_models(path, include_hetatm=include_hetatm))


def iter_pdb_models(path: str | Path, *, include_hetatm: bool = True) -> Iterator[SimpleMolecule]:
    """Iterate every MODEL of a PDB file (NMR ensembles, MD snapshots).

    Single-model files yield exactly one molecule; MODEL/ENDMDL records
    delimit members otherwise (names get a ``/model-N`` suffix).  Ensemble
    members voxelize as a batch — structural uncertainty becomes grid-level
    augmentation the reference workflow has no equivalent for."""
    coords: list[tuple[float, float, float]] = []
    symbols: list[str] = []
    name = Path(path).stem
    model = 0
    with _open_text(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec == "ENDMDL":
                model += 1
                yield SimpleMolecule(
                    coords=np.asarray(coords, dtype=np.float64).reshape(len(symbols), 3),
                    symbols=symbols, bonds=[], name=f"{name}/model-{model}",
                )
                coords, symbols = [], []
            elif rec == "ATOM  " or (include_hetatm and rec == "HETATM"):
                coords.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
                symbols.append(_pdb_element(line))
    if coords or model == 0:
        yield SimpleMolecule(
            coords=np.asarray(coords, dtype=np.float64).reshape(len(symbols), 3),
            symbols=symbols, bonds=[], name=name,
        )


_SDF_BOND_ORDERS = {"SINGLE": 1, "DOUBLE": 2, "TRIPLE": 3, "AROMATIC": 4}


def write_sdf(mol: SimpleMolecule, path: str | Path) -> None:
    """Write a SimpleMolecule as a single-record SDF (V2000)."""
    lines = [mol.name or "molvoxel_torch", "  molvoxel_torch", ""]
    lines.append(f"{mol.num_atoms:3d}{mol.num_bonds:3d}  0  0  0  0  0  0  0  0999 V2000")
    for (x, y, z), sym in zip(mol.coords, mol.symbols):
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {sym:<3s} 0  0  0  0  0")
    for i, j, t in mol.bonds:
        lines.append(f"{i + 1:3d}{j + 1:3d}{_SDF_BOND_ORDERS.get(t, 1):3d}  0")
    lines.append("M  END")
    lines.append("$$$$")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_pdb(mol: SimpleMolecule, path: str | Path) -> None:
    """Write a SimpleMolecule as a minimal PDB (HETATM records)."""
    lines = []
    for idx, ((x, y, z), sym) in enumerate(zip(mol.coords, mol.symbols), start=1):
        name = sym[:4]
        lines.append(
            f"HETATM{idx:5d} {name:<4s} UNL A   1    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {sym:>2s}"
        )
    lines.append("END")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def iter_xyz(path: str | Path) -> Iterator[SimpleMolecule]:
    """Iterate a (possibly multi-record, QM9-style) XYZ file.

    Format per record: atom count line, comment line, then ``symbol x y z``
    rows (extra columns — e.g. QM9's Mulliken charges — are ignored).
    Fortran-style ``1.234*^-5`` exponents (as found in QM9) are accepted.
    No bonds: XYZ carries none, so bond-channel getters see an empty list
    (the reference has no XYZ path at all — its users must detour through
    RDKit, reference molvoxel/etc/rdkit/wrapper.py).
    """

    def _f(tok: str) -> float:
        return float(tok.replace("*^", "e"))

    with _open_text(path) as fh:
        lines = fh.read().splitlines()
    i, n = 0, len(lines)
    while i < n:
        if not lines[i].strip():
            i += 1
            continue
        try:
            na = int(lines[i].strip())
        except ValueError as e:
            raise ValueError(f"XYZ: expected an atom count at line {i + 1}") from e
        if i + 2 + na > n:
            raise ValueError(f"XYZ: record at line {i + 1} claims {na} atoms but the file ends")
        name = lines[i + 1].strip()
        rows = lines[i + 2 : i + 2 + na]
        symbols = []
        coords = np.empty((na, 3), np.float64)
        for j, row in enumerate(rows):
            t = row.split()
            if len(t) < 4:
                raise ValueError(f"XYZ: truncated atom row at line {i + 3 + j}")
            symbols.append(t[0])
            coords[j] = (_f(t[1]), _f(t[2]), _f(t[3]))
        yield SimpleMolecule(coords=coords, symbols=symbols, bonds=[], name=name)
        i += 2 + na


def read_xyz(path: str | Path) -> SimpleMolecule:
    """Read the first molecule of an XYZ file."""
    return next(iter_xyz(path))


def write_xyz(mol: SimpleMolecule, path: str | Path) -> None:
    """Write one molecule as an XYZ record (appendable multi-record format)."""
    lines = [str(mol.num_atoms), mol.name or ""]
    for sym, (x, y, z) in zip(mol.symbols, mol.coords):
        lines.append(f"{sym} {x:.8f} {y:.8f} {z:.8f}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


MOL2_BOND_TYPES = {"1": "SINGLE", "2": "DOUBLE", "3": "TRIPLE", "ar": "AROMATIC",
                   "am": "SINGLE", "du": "SINGLE", "un": "SINGLE", "nc": "SINGLE"}


def iter_mol2(path: str | Path) -> Iterator[SimpleMolecule]:
    """Iterate a (possibly multi-record) Tripos MOL2 file.

    The docking ecosystem's format (AutoDock/DOCK/Sybyl).  Element symbols
    come from the SYBYL atom type's element part (``C.3`` -> ``C``,
    ``N.ar`` -> ``N``); aromatic/amide/dummy bond types map onto the SDF
    bond-type vocabulary the channel getters use.  The reference reads mol2
    only through RDKit (etc/rdkit/wrapper.py); this parser needs no
    dependency.
    """
    with _open_text(path) as fh:
        lines = fh.read().splitlines()
    i, n = 0, len(lines)
    while i < n:
        if lines[i].strip() != "@<TRIPOS>MOLECULE":
            i += 1
            continue
        name = lines[i + 1].strip() if i + 1 < n else ""
        counts = lines[i + 2].split() if i + 2 < n else ["0"]
        na = int(counts[0])
        nb = int(counts[1]) if len(counts) > 1 else 0
        i += 3
        # find the atom section of this record
        while i < n and lines[i].strip() != "@<TRIPOS>ATOM":
            if lines[i].strip() == "@<TRIPOS>MOLECULE":
                break
            i += 1
        if i >= n or lines[i].strip() != "@<TRIPOS>ATOM":
            continue
        i += 1
        if i + na > n:
            raise ValueError(f"MOL2: record '{name}' claims {na} atoms but the file ends")
        coords = np.empty((na, 3), np.float64)
        symbols = []
        for j in range(na):
            t = lines[i + j].split()
            if len(t) < 6:
                raise ValueError(f"MOL2: truncated atom row at line {i + j + 1}")
            coords[j] = (float(t[2]), float(t[3]), float(t[4]))
            symbols.append(t[5].split(".")[0])
        i += na
        bonds: list[tuple[int, int, str]] = []
        while i < n and lines[i].strip() != "@<TRIPOS>BOND":
            if lines[i].strip() == "@<TRIPOS>MOLECULE":
                break
            i += 1
        if i < n and lines[i].strip() == "@<TRIPOS>BOND":
            i += 1
            if i + nb > n:
                raise ValueError(f"MOL2: record '{name}' claims {nb} bonds but the file ends")
            for j in range(nb):
                t = lines[i + j].split()
                if len(t) < 4:
                    raise ValueError(f"MOL2: truncated bond row at line {i + j + 1}")
                bonds.append((int(t[1]) - 1, int(t[2]) - 1, MOL2_BOND_TYPES.get(t[3], "SINGLE")))
            i += nb
        yield SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name=name)


def read_mol2(path: str | Path) -> SimpleMolecule:
    """Read the first molecule of a Tripos MOL2 file."""
    return next(iter_mol2(path))


def read_molecule(path: str | Path, **kwargs) -> SimpleMolecule:
    """Dispatch by file extension (.sdf/.mol -> SDF, .pdb -> PDB, .xyz, .mol2)."""
    suffixes = Path(path).suffixes
    ext = suffixes[-2] if suffixes and suffixes[-1] == ".gz" and len(suffixes) > 1 else Path(path).suffix
    if ext in (".sdf", ".mol"):
        return read_sdf(path)
    if ext in (".pdb", ".ent"):
        return read_pdb(path, **kwargs)
    if ext == ".xyz":
        return read_xyz(path)
    if ext == ".mol2":
        return read_mol2(path)
    raise ValueError(f"unsupported molecular file type: {path}")
