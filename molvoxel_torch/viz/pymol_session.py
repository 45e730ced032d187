"""PyMOL session builder for voxel images.

Writes the molecule(s) plus one OpenDX volume per channel, loads everything
into headless PyMOL, colors and groups the objects, and saves a ``.pse``
session.  A copy of ``molvoxel_tpu/viz/pymol_session.py`` that also takes
torch grids, on the card or on the CPU.

- Toolkit-free molecules: SimpleMolecule is written by the built-in SDF/PDB
  writers; RDKit Mols by RDKit's writers when it is installed.
- Without PyMOL: when the ``pymol`` module is missing, the same artifacts
  (.sdf/.pdb + .dx files) are written next to the requested session path,
  with a ``.pml`` script that rebuilds the session in any PyMOL install.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from ..data.parsers import SimpleMolecule, write_pdb, write_sdf
from .atom_colors import channel_color
from .dx import write_dx


def _have_pymol() -> bool:
    try:
        import pymol  # noqa: F401

        return True
    except ImportError:
        return False


def _host(array) -> np.ndarray:
    """A grid, center or coordinate array as numpy (f32 for a bf16 / fp8 grid)."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn) else t).numpy()
    return np.asarray(array)


def _write_molecule(mol, path_base: Path, new_coords=None) -> Path:
    """Write a molecule next to the session; returns the file written."""
    if new_coords is not None:
        new_coords = _host(new_coords)
    if isinstance(mol, SimpleMolecule):
        if new_coords is not None:
            mol = SimpleMolecule(np.asarray(new_coords, np.float64), list(mol.symbols), list(mol.bonds), mol.name)
        path = path_base.with_suffix(".sdf") if mol.bonds else path_base.with_suffix(".pdb")
        (write_sdf if mol.bonds else write_pdb)(mol, path)
        return path
    # RDKit molecule
    from rdkit import Chem

    if new_coords is not None:
        mol = Chem.Mol(mol)
        conf = mol.GetConformer()
        for i, pos in enumerate(np.asarray(new_coords, np.float64)):
            conf.SetAtomPosition(i, pos.tolist())
    path = path_base.with_suffix(".sdf")
    writer = Chem.SDWriter(str(path))
    writer.write(mol)
    writer.close()
    return path


class Visualizer:
    """Build .pse sessions (or .pml scripts when PyMOL is absent)."""

    def __init__(self, isosurface_threshold: float = 0.5, keep_artifacts: bool = False):
        self.threshold = isosurface_threshold
        self.keep_artifacts = keep_artifacts

    # -------------------------------------------------------------- internals

    def _build(self, pse_path: str, groups: list[tuple[str, Path, dict, np.ndarray]], resolution: float):
        """groups: list of (name, molecule file, channel dict, center)."""
        pse_path = Path(pse_path)
        workdir = pse_path.parent / (pse_path.stem + "_artifacts")
        workdir.mkdir(parents=True, exist_ok=True)

        script: list[str] = ["bg_color white"]
        chan_index = 0
        for name, mol_file, channel_dict, center in groups:
            script.append(f"load {mol_file.name}, {name}")
            members = [name]
            for cname, grid in channel_dict.items():
                grid = _host(grid)
                if not np.any(grid > self.threshold):
                    # skip channels with nothing above the threshold, to keep
                    # sessions light
                    chan_index += 1
                    continue
                obj = f"{name}_{_safe(cname)}"
                dx_file = workdir / f"{obj}.dx"
                write_dx(dx_file, grid, center, resolution)
                script.append(f"load {dx_file.name}, {obj}_map")
                script.append(f"isosurface {obj}, {obj}_map, {self.threshold}")
                script.append(f"color {channel_color(cname, chan_index)}, {obj}")
                script.append(f"set transparency, 0.3, {obj}")
                members += [f"{obj}_map", obj]
                chan_index += 1
            script.append(f"group {name}_group, {' '.join(members)}")
        script.append("zoom")
        script.append(f"save {pse_path.name}")

        pml_path = workdir / (pse_path.stem + ".pml")
        with open(pml_path, "w") as fh:
            fh.write("\n".join(script) + "\n")

        if _have_pymol():
            import pymol
            from pymol import cmd

            pymol.finish_launching(["pymol", "-pcq", "-K"])
            cmd.reinitialize()
            cmd.cd(str(workdir))
            for line in script:
                cmd.do(line)
            cmd.sync()
            saved = workdir / pse_path.name
            if saved.exists():
                shutil.move(str(saved), str(pse_path))
            if not self.keep_artifacts:
                shutil.rmtree(workdir, ignore_errors=True)
            return pse_path
        # no pymol: leave artifacts + script for the user
        return pml_path

    # ----------------------------------------------------------------- public

    def visualize_mol(self, pse_path: str, mol, channel_dict, center, resolution: float, new_coords=None):
        """One molecule + its channel surfaces."""
        workdir = Path(pse_path).parent / (Path(pse_path).stem + "_artifacts")
        workdir.mkdir(parents=True, exist_ok=True)
        mol_file = _write_molecule(mol, workdir / "molecule", new_coords)
        return self._build(pse_path, [("Molecule", mol_file, channel_dict, _host(center))], resolution)

    def visualize_system(
        self, pse_path: str, mol_list, name_list, channel_dict_list, center, resolution: float, new_coords_list=None
    ):
        """Several molecules with disjoint channel blocks."""
        workdir = Path(pse_path).parent / (Path(pse_path).stem + "_artifacts")
        workdir.mkdir(parents=True, exist_ok=True)
        groups = []
        for i, (mol, name, channel_dict) in enumerate(zip(mol_list, name_list, channel_dict_list)):
            nc = None if new_coords_list is None else new_coords_list[i]
            mol_file = _write_molecule(mol, workdir / _safe(name), nc)
            groups.append((_safe(name), mol_file, channel_dict, _host(center)))
        return self._build(pse_path, groups, resolution)

    def visualize_complex(
        self,
        pse_path: str,
        ligand_mol,
        protein_mol,
        ligand_channel_dict,
        protein_channel_dict,
        center,
        resolution: float,
        ligand_new_coords=None,
        protein_new_coords=None,
    ):
        """Ligand + protein session."""
        return self.visualize_system(
            pse_path,
            [ligand_mol, protein_mol],
            ["Ligand", "Protein"],
            [ligand_channel_dict, protein_channel_dict],
            center,
            resolution,
            None if ligand_new_coords is None else [ligand_new_coords, protein_new_coords],
        )


def _safe(name: str) -> str:
    return "".join(ch if (ch.isalnum() or ch in "-_") else "_" for ch in name)
