"""End-to-end wrappers: molecule(s) -> point cloud -> voxel image (-> PyMOL session).

Counterpart of ``molvoxel_tpu/data/wrapper.py``, with its class names,
``run()`` signatures and radii-list semantics, on the port's ``Voxelizer``:
one shared ``_voxelize`` engine handles the ``asarray`` / ``forward``
plumbing for every wrapper, and per-molecule radii lists expand through
``np.repeat`` over block point counts.  ``key=`` is a ``torch.Generator`` or
an int seed, as ``Voxelizer.forward`` takes it; images are torch tensors on
the voxelizer's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .pointcloud import (
    ComplexPointCloudMaker,
    MolPointCloudMaker,
    MolSystemPointCloudMaker,
    _mol_num_atoms,
)


class MolWrapper:
    """Single-molecule pipeline: maker -> voxelizer (-> visualizer)."""

    def __init__(self, pointcloudmaker: MolPointCloudMaker, voxelizer, visualizer: Any | None = None):
        self.maker = pointcloudmaker
        self.voxelizer = voxelizer
        self.visualizer = visualizer
        self.num_channels = self.maker.num_channels
        self.channel_type = self.maker.channel_type
        self.grid_dimension = self.voxelizer.grid_dimension(self.num_channels)
        self.resolution = self.voxelizer.resolution

    # -- shared engine -------------------------------------------------------

    def _voxelize(self, coords, channels, radii, center, random_translation, random_rotation, out_grid, key):
        if out_grid is not None and tuple(out_grid.shape) != tuple(self.grid_dimension):
            raise ValueError(f"out_grid must be {tuple(self.grid_dimension)}, got {tuple(out_grid.shape)}")
        vox = self.voxelizer
        return vox.forward(
            vox.asarray(coords, "coords"),
            None if center is None else vox.asarray(center, "center"),
            vox.asarray(channels, self.channel_type),
            radii if np.isscalar(radii) else vox.asarray(radii, "radii"),
            random_translation,
            random_rotation,
            out_grid,
            key=key,
        )

    # -- public surface ------------------------------------------------------

    def run(
        self,
        mol,
        center=None,
        radii=1.0,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
        **kwargs,
    ):
        coords, channels = self.maker.run(mol, **kwargs)
        return self._voxelize(coords, channels, radii, center, random_translation, random_rotation, out_grid, key)

    __call__ = run

    def get_coords(self, mol):
        return self.voxelizer.asarray(self.maker.get_coords(mol), "coords")

    def get_channels(self, mol):
        return self.voxelizer.asarray(self.maker.get_channels(mol), self.channel_type)

    def split_channel(self, image):
        return self.maker.split_channel(image)

    def get_empty_grid(self, batch_size: int | None = None, init_zero: bool = False):
        return self.voxelizer.get_empty_grid(self.num_channels, batch_size, init_zero)

    def visualize(self, pse_path: str, mol, image, center, new_coords=None):
        if self.visualizer is None:
            raise ValueError("this wrapper has no visualizer")
        channel_dict = self.split_channel(image)
        if center is None:
            center = np.zeros(3)
        return self.visualizer.visualize_mol(pse_path, mol, channel_dict, center, self.resolution, new_coords)


class MolSystemWrapper(MolWrapper):
    """Multi-molecule pipeline over a MolSystemPointCloudMaker."""

    def __init__(
        self,
        pointcloudmaker: MolSystemPointCloudMaker,
        voxelizer,
        name_list: list[str] | None = None,
        visualizer: Any | None = None,
    ):
        super().__init__(pointcloudmaker, voxelizer, visualizer)
        self.name_list = name_list

    def _expand_radii(self, radii, mol_list):
        """Per-molecule radii list -> one flat per-point array.

        With atom-wise radii each list entry is a scalar repeated over that
        molecule's points; with channel-wise radii the per-molecule vectors
        concatenate."""
        if not isinstance(radii, list):
            return radii
        vox = self.voxelizer
        if vox.is_radii_type_atom_wise:
            if len(radii) != len(mol_list):
                raise ValueError(f"{len(radii)} radii for {len(mol_list)} molecules")
            counts = [elem.num_points(mol) for mol, elem in zip(mol_list, self.maker.maker_list)]
            return np.repeat(np.asarray(radii, np.float32), counts)
        if vox.is_radii_type_channel_wise:
            return np.concatenate([np.asarray(r, np.float32).reshape(-1) for r in radii])
        return radii

    def run(
        self,
        mol_list: list,
        center=None,
        radii=1.0,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
        **kwargs,
    ):
        coords, channels = self.maker.run(mol_list, **kwargs)
        radii = self._expand_radii(radii, mol_list)
        return self._voxelize(coords, channels, radii, center, random_translation, random_rotation, out_grid, key)

    __call__ = run

    def visualize(self, pse_path: str, mol_list, image, center, new_coords=None):
        if self.visualizer is None:
            raise ValueError("this wrapper has no visualizer")
        if self.name_list is None:
            raise ValueError("name_list should be set")
        channel_dict_list = self.split_channel(image)
        if center is None:
            center = np.zeros(3)
        new_coords_list = None
        if new_coords is not None:
            sizes = [_mol_num_atoms(mol) for mol in mol_list]
            cuts = np.cumsum([0] + sizes)
            new_coords_list = [new_coords[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])]
        return self.visualizer.visualize_system(
            pse_path, mol_list, self.name_list, channel_dict_list, center, self.resolution, new_coords_list
        )


class ComplexWrapper(MolSystemWrapper):
    """Fixed ["Ligand", "Protein"] system."""

    def __init__(self, pointcloudmaker: ComplexPointCloudMaker, voxelizer, visualizer: Any | None = None):
        super().__init__(pointcloudmaker, voxelizer, ["Ligand", "Protein"], visualizer)

    def run(
        self,
        ligand_mol,
        protein_mol,
        center=None,
        radii=1.0,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
        **kwargs,
    ):
        return super().run(
            [ligand_mol, protein_mol], center, radii, random_translation, random_rotation, out_grid, key=key,
            **kwargs
        )

    __call__ = run

    def get_coords(self, ligand_mol, protein_mol):
        return super().get_coords([ligand_mol, protein_mol])

    def get_channels(self, ligand_mol, protein_mol):
        return super().get_channels([ligand_mol, protein_mol])

    def visualize(self, pse_path: str, ligand_mol, protein_mol, image, center, new_coords=None):
        if self.visualizer is None:
            raise ValueError("this wrapper has no visualizer")
        ligand_channel_dict, protein_channel_dict = self.split_channel(image)
        if center is None:
            center = np.zeros(3)
        if new_coords is not None:
            n = _mol_num_atoms(ligand_mol)
            ligand_new_coords, protein_new_coords = new_coords[:n], new_coords[n:]
        else:
            ligand_new_coords = protein_new_coords = None
        return self.visualizer.visualize_complex(
            pse_path,
            ligand_mol,
            protein_mol,
            ligand_channel_dict,
            protein_channel_dict,
            center,
            self.resolution,
            ligand_new_coords,
            protein_new_coords,
        )
