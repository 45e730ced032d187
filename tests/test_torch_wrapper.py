"""molvoxel_torch.data.wrapper and data.rdkit_adapter against the JAX package, on the CPU.

The three wrappers (types and features, scalar, atom-wise and channel-wise
radii lists, duck-typed RDKit molecules as in tests/test_rdkit_duck.py) give
the JAX wrappers' grids at 1e-5 without augmentation; with a seeded random
transform they equal the port's own voxelizer under the same generator.
The complex of tests/goldens/pocket_types_gaussian.npz (61 ligand and 407
pocket atoms) reproduces its golden at 1e-5.  The RDKit bridge runs through
duck molecules (rdkit is not installed).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import molvoxel_torch.data as tdata
from molvoxel_torch import create_voxelizer
from molvoxel_torch.data import (
    AtomTypeGetter,
    BondTypeGetter,
    ComplexPointCloudMaker,
    ComplexWrapper,
    MolPointCloudMaker,
    MolSystemPointCloudMaker,
    MolSystemWrapper,
    MolWrapper,
    SimpleMolecule,
)
from molvoxel_torch.data import rdkit_adapter
from molvoxel_torch.viz import Visualizer
from molvoxel_tpu import create_voxelizer as jax_create_voxelizer
from molvoxel_tpu import data as jdata
from molvoxel_tpu.data import rdkit_adapter as jax_rdkit_adapter

from .test_rdkit_duck import DuckMol

GOLDENS = Path(__file__).resolve().parent / "goldens"
SYMBOLS = ["C", "N", "O", "S"]


def make_pair(rng, n=8, nb=4):
    """(SimpleMolecule of this package, the same molecule duck-typed as an RDKit Mol)."""
    coords = rng.uniform(-3, 3, (n, 3))
    symbols = [SYMBOLS[i % 4] for i in range(n)]
    bonds = [(i, i + 1, ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"][i % 4]) for i in range(nb)]
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name="duck"), DuckMol(coords, symbols, bonds)


def _as_jax(mol):
    """The same molecule as the JAX package's SimpleMolecule."""
    return jdata.SimpleMolecule(mol.coords, list(mol.symbols), list(mol.bonds), mol.name)


def _vox(dim=16, **kw):
    return create_voxelizer(resolution=0.5, dimension=dim, device="cpu", **kw)


def _jvox(dim=16, **kw):
    return jax_create_voxelizer(resolution=0.5, dimension=dim, impl="dense", **kw)


def _mol_makers(channel_type, jax=False):
    mod = jdata if jax else tdata
    return mod.MolPointCloudMaker(mod.AtomTypeGetter(SYMBOLS), mod.BondTypeGetter.default(), channel_type=channel_type)


@pytest.mark.parametrize("channel_type", ["types", "features"])
@pytest.mark.parametrize("duck", [False, True])
def test_mol_wrapper_equals_jax(rng, channel_type, duck):
    simple, duckmol = make_pair(rng, n=12, nb=6)
    mol = duckmol if duck else simple
    center = simple.coords.mean(0)
    got = MolWrapper(_mol_makers(channel_type), _vox()).run(mol, center=center, radii=1.0)
    jwrapper = jdata.MolWrapper(_mol_makers(channel_type, jax=True), _jvox())
    want = np.asarray(jwrapper.run(_as_jax(simple), center=center, radii=1.0))
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("radii_kind", ["scalar", "atom-wise", "channel-wise"])
def test_system_wrapper_radii_lists_equal_jax(rng, radii_kind):
    """Per-molecule radii lists expand as the JAX package expands them."""
    lig, prot = make_pair(rng, n=6, nb=0)[0], make_pair(rng, n=9, nb=0)[0]
    radii_type = {"scalar": "scalar"}.get(radii_kind, radii_kind)
    radii = {"scalar": 1.2, "atom-wise": [0.9, 1.4], "channel-wise": [[0.8, 1.0, 1.2, 1.4], [1.1, 1.3, 0.9, 1.0]]}[
        radii_kind]
    center = lig.coords.mean(0)

    def run(mod, vox, mols):
        ag = mod.AtomTypeGetter(SYMBOLS)
        maker = mod.MolSystemPointCloudMaker((ag, None), (ag, None), channel_type="features")
        wrapper = mod.MolSystemWrapper(maker, vox, ["Lig", "Prot"])
        return wrapper.run(mols, center=center, radii=radii)

    got = run(tdata, _vox(radii_type=radii_type), [lig, prot])
    want = np.asarray(run(jdata, _jvox(radii_type=radii_type), [_as_jax(lig), _as_jax(prot)]))
    assert tuple(got.shape) == want.shape == (8, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _golden_complex():
    """(ligand, pocket, center, expected) of the 8-channel complex golden."""
    g = np.load(GOLDENS / "pocket_types_gaussian.npz")
    sym = np.asarray(SYMBOLS)
    t = g["channels"].astype(int)
    lig = SimpleMolecule(g["coords"][:61].astype(np.float64), list(sym[t[:61]]), [], "ligand")
    pocket = SimpleMolecule(g["coords"][61:].astype(np.float64), list(sym[t[61:] - 4]), [], "pocket")
    return lig, pocket, g["center"], g["expected"]


def _complex(vox, visualizer=None):
    ag = AtomTypeGetter(SYMBOLS)
    return ComplexWrapper(ComplexPointCloudMaker(ag, None, ag, None, channel_type="types"), vox, visualizer)


def test_complex_wrapper_reproduces_the_golden_and_jax():
    lig, pocket, center, expected = _golden_complex()
    got = _complex(_vox(48)).run(lig, pocket, center=center, radii=1.0)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-5)
    jag = jdata.AtomTypeGetter(SYMBOLS)
    jwrap = jdata.ComplexWrapper(jdata.ComplexPointCloudMaker(jag, None, jag, None, channel_type="types"), _jvox(48))
    want = np.asarray(jwrap.run(_as_jax(lig), _as_jax(pocket), center=center, radii=1.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_complex_wrapper_augmentation_is_the_voxelizers(rng):
    """key= seeds the transform: the wrapper's grid is the voxelizer's
    forward under the same generator, and reproducible."""
    lig, pocket, center, _ = _golden_complex()
    vox = _vox(24)
    wrapper = _complex(vox)
    a = wrapper.run(lig, pocket, center=center, radii=1.0, random_translation=0.5, random_rotation=True, key=7)
    b = wrapper.run(lig, pocket, center=center, radii=1.0, random_translation=0.5, random_rotation=True,
                    key=torch.Generator().manual_seed(7))
    coords, types = wrapper.maker.run([lig, pocket])
    want = vox.forward_types(coords, center, types, 1.0, 0.5, True, key=7)
    assert torch.equal(a, b) and torch.equal(a, want)
    assert not torch.equal(a, wrapper.run(lig, pocket, center=center, radii=1.0))


def test_wrapper_helpers_and_out_grid(rng):
    simple, _ = make_pair(rng, n=10, nb=4)
    wrapper = MolWrapper(_mol_makers("features"), _vox())
    assert wrapper.num_channels == 8 and wrapper.grid_dimension == (8, 16, 16, 16)
    coords = wrapper.get_coords(simple)  # 10 atoms + 4 bond midpoints
    assert coords.shape == (14, 3) and wrapper.get_channels(simple).shape == (14, 8)
    np.testing.assert_allclose(coords[:10].numpy(), simple.coords.astype(np.float32))
    grid = wrapper.get_empty_grid(init_zero=True)
    assert grid.shape == (8, 16, 16, 16) and float(grid.abs().sum()) == 0.0
    out = wrapper.run(simple, center=simple.coords.mean(0), out_grid=grid)
    assert out is grid and float(grid.sum()) > 0
    assert set(wrapper.split_channel(grid)) == set(wrapper.maker.channels)
    with pytest.raises(ValueError, match="out_grid"):
        wrapper.run(simple, out_grid=torch.zeros(3, 16, 16, 16))
    with pytest.raises(ValueError, match="visualizer"):
        wrapper.visualize("x.pse", simple, grid, None)


def test_complex_visualize_fallback(tmp_path):
    """visualize writes the pymol-less fallback: .pml, molecule files and
    the non-empty channels' .dx volumes, which read back."""
    from molvoxel_torch.viz import read_dx

    lig, pocket, center, _ = _golden_complex()
    wrapper = _complex(_vox(24), Visualizer())
    image = wrapper.run(lig, pocket, center=center, radii=1.0)
    result = wrapper.visualize(str(tmp_path / "complex.pse"), lig, pocket, image, center)
    assert result.suffix == ".pml"
    script = result.read_text()
    assert "Ligand" in script and "Protein" in script
    dx = sorted(result.parent.glob("*.dx"))
    assert dx and all(f.stem.split("_")[0] in ("Ligand", "Protein") for f in dx)
    values, _, res = read_dx(dx[0])
    assert values.shape == (24, 24, 24) and res == 0.5
    assert (result.parent / "Ligand.pdb").exists() and (result.parent / "Protein.pdb").exists()


def test_system_visualize_splits_new_coords(rng, tmp_path):
    lig, prot = make_pair(rng, n=5, nb=2)[0], make_pair(rng, n=7, nb=0)[0]
    ag = AtomTypeGetter(SYMBOLS)
    maker = MolSystemPointCloudMaker((ag, BondTypeGetter.default()), (ag, None), channel_type="features")
    wrapper = MolSystemWrapper(maker, _vox(), ["Lig", "Prot"], Visualizer(isosurface_threshold=0.05))
    image = wrapper.run([lig, prot], center=lig.coords.mean(0))
    moved = torch.as_tensor(np.concatenate([lig.coords, prot.coords]) + 1.0)
    result = wrapper.visualize(str(tmp_path / "sys.pse"), [lig, prot], image, None, new_coords=moved)
    lig_file = (result.parent / "Lig.sdf").read_text()
    assert f"{lig.coords[0, 0] + 1.0:10.4f}" in lig_file
    with pytest.raises(ValueError, match="name_list"):
        MolSystemWrapper(maker, _vox(), None, Visualizer()).visualize("y.pse", [lig, prot], image, None)


# ------------------------------------------------------------- RDKit bridge


class PropDuckMol(DuckMol):
    """The duck molecule plus the conformer id and the _Name property."""

    def GetConformer(self, conformer_id=-1):  # noqa: N802
        return super().GetConformer()

    def HasProp(self, name):  # noqa: N802
        return name == "_Name"

    def GetProp(self, name):  # noqa: N802
        return "duck"


@pytest.mark.parametrize("module", [rdkit_adapter, jax_rdkit_adapter], ids=["torch", "jax"])
def test_from_rdkit_through_the_duck_api(rng, monkeypatch, module):
    simple, _ = make_pair(rng, n=7, nb=4)
    duck = PropDuckMol(simple.coords, simple.symbols, simple.bonds)
    monkeypatch.setattr(module, "RDKIT_AVAILABLE", True)
    got = module.from_rdkit(duck)
    assert got.symbols == simple.symbols and got.bonds == simple.bonds and got.name == "duck"
    np.testing.assert_array_equal(got.coords, simple.coords)


def test_rdkit_bridge_without_rdkit(rng):
    assert rdkit_adapter.RDKIT_AVAILABLE == jax_rdkit_adapter.RDKIT_AVAILABLE
    simple, duck = make_pair(rng, n=5, nb=2)
    if not rdkit_adapter.RDKIT_AVAILABLE:
        for fn, arg in ((rdkit_adapter.from_rdkit, duck), (rdkit_adapter.to_rdkit, simple),
                        (rdkit_adapter.load_rdkit_mol, "x.sdf")):
            with pytest.raises(ImportError, match="rdkit"):
                fn(arg)
    before = simple.coords.copy()
    moved = rdkit_adapter.apply_coords(simple, torch.as_tensor(simple.coords + 2.0))
    want = jax_rdkit_adapter.apply_coords(_as_jax(simple), simple.coords + 2.0)
    assert isinstance(moved, SimpleMolecule) and moved is not simple
    np.testing.assert_array_equal(moved.coords, want.coords)
    assert moved.symbols == simple.symbols and moved.bonds == simple.bonds
    np.testing.assert_array_equal(simple.coords, before)  # the source is untouched
