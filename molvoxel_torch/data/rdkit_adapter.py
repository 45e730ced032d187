"""Optional RDKit bridge.

The getters, makers and wrappers of this package already duck-type RDKit
Atom / Bond / Mol objects (data/getter.py, data/pointcloud.py), so an
``rdkit.Chem.Mol`` goes wherever a SimpleMolecule does.  This module adds
the explicit conversions and loaders for RDKit-centric code.  A numpy copy
of ``molvoxel_tpu/data/rdkit_adapter.py``.  rdkit is optional: without it
the module imports and ``RDKIT_AVAILABLE`` is False, and the functions that
need it raise ImportError.
"""

from __future__ import annotations

import numpy as np
import torch

from .parsers import SimpleMolecule

try:
    from rdkit import Chem

    RDKIT_AVAILABLE = True
except ImportError:  # pragma: no cover - environment without rdkit
    Chem = None
    RDKIT_AVAILABLE = False


def _require_rdkit():
    if not RDKIT_AVAILABLE:
        raise ImportError("rdkit is not installed; install it or use data.parsers")


def from_rdkit(mol, conformer_id: int = -1) -> SimpleMolecule:
    """rdkit.Chem.Mol -> SimpleMolecule (coordinates from the conformer)."""
    _require_rdkit()
    conf = mol.GetConformer(conformer_id)
    coords = np.asarray(conf.GetPositions(), dtype=np.float64)
    symbols = [atom.GetSymbol() for atom in mol.GetAtoms()]
    bonds = [
        (b.GetBeginAtomIdx(), b.GetEndAtomIdx(), str(b.GetBondType())) for b in mol.GetBonds()
    ]
    name = mol.GetProp("_Name") if mol.HasProp("_Name") else ""
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name=name)


def to_rdkit(mol: SimpleMolecule):
    """SimpleMolecule -> editable rdkit.Chem.Mol with a 3D conformer."""
    _require_rdkit()
    em = Chem.RWMol()
    for sym in mol.symbols:
        em.AddAtom(Chem.Atom(sym))
    order_map = {
        "SINGLE": Chem.BondType.SINGLE,
        "DOUBLE": Chem.BondType.DOUBLE,
        "TRIPLE": Chem.BondType.TRIPLE,
        "AROMATIC": Chem.BondType.AROMATIC,
    }
    for i, j, t in mol.bonds:
        em.AddBond(int(i), int(j), order_map.get(t, Chem.BondType.SINGLE))
    out = em.GetMol()
    conf = Chem.Conformer(mol.num_atoms)
    for idx, pos in enumerate(mol.coords):
        conf.SetAtomPosition(idx, [float(pos[0]), float(pos[1]), float(pos[2])])
    out.AddConformer(conf)
    if mol.name:
        out.SetProp("_Name", mol.name)
    return out


def load_rdkit_mol(path: str, sanitize: bool = True):
    """Load a molecule with RDKit (SDF or PDB by extension)."""
    _require_rdkit()
    path = str(path)
    if path.endswith((".sdf", ".mol")):
        supplier = Chem.SDMolSupplier(path, sanitize=sanitize, removeHs=False)
        return next(iter(supplier))
    if path.endswith(".pdb"):
        return Chem.MolFromPDBFile(path, sanitize=sanitize, removeHs=False)
    raise ValueError(f"unsupported file type: {path}")


def apply_coords(mol, coords):
    """Write transformed coordinates back into a molecule (new object).

    For both RDKit Mols and SimpleMolecules: used to visualize augmented
    poses next to their grids.  ``coords`` may be a torch tensor on any
    device.
    """
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    coords = np.asarray(coords, dtype=np.float64)
    if isinstance(mol, SimpleMolecule):
        return SimpleMolecule(coords.copy(), list(mol.symbols), list(mol.bonds), mol.name)
    _require_rdkit()
    out = Chem.Mol(mol)
    conf = out.GetConformer()
    for i, pos in enumerate(coords):
        conf.SetAtomPosition(i, [float(pos[0]), float(pos[1]), float(pos[2])])
    return out
