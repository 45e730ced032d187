"""molvoxel_torch.viz: colors and the PyMOL session builder against the JAX package, on the CPU.

Mirrors tests/test_viz.py: the color tables, and the Visualizer's fallback
without PyMOL (a .pml script, the molecule files and one .dx volume per
non-empty channel).  The port takes torch grids (f32 and bf16) where the
JAX package takes numpy, and writes the same script and volumes.
"""

import numpy as np
import pytest
import torch

from molvoxel_torch.data import SimpleMolecule
from molvoxel_torch.viz import ELEMENT_COLORS, Visualizer, atom_color, channel_color, read_dx
from molvoxel_torch.viz.atom_colors import _ELEMENT_NAMES, CHANNEL_PALETTE
from molvoxel_tpu import viz as jviz
from molvoxel_tpu.data import SimpleMolecule as JSimpleMolecule
from molvoxel_tpu.viz import atom_colors as jax_atom_colors


def make_mol(rng, n=8, nb=4):
    coords = rng.uniform(-3, 3, (n, 3))
    symbols = [["C", "N", "O", "S"][i % 4] for i in range(n)]
    bonds = [(i, i + 1, ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"][i % 4]) for i in range(nb)]
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name="test")


def test_colors():
    assert atom_color("O") == "red"
    assert atom_color("Xx") == "wheat"
    assert channel_color("C", 0) == "gray"
    assert isinstance(channel_color("SingleBond", 5), str)


def test_colors_full_periodic_table():
    assert len(_ELEMENT_NAMES) == 118
    for sym in _ELEMENT_NAMES:
        assert atom_color(sym) != "wheat"
    assert atom_color("Pr") == "praseodymium"
    assert atom_color("Og") == "oganesson"


def test_color_tables_equal_jax():
    assert ELEMENT_COLORS == jax_atom_colors.ELEMENT_COLORS and _ELEMENT_NAMES == jax_atom_colors._ELEMENT_NAMES
    assert CHANNEL_PALETTE == jax_atom_colors.CHANNEL_PALETTE
    for i, name in enumerate(["C", "Fe", "Xx", "SingleBond", "HBondDonor", "Pr", "aromatic"] * 3):
        assert channel_color(name, i) == jviz.channel_color(name, i)


def test_visualizer_fallback_builds_pml(rng, tmp_path):
    mol = make_mol(rng)
    grid = torch.zeros((2, 8, 8, 8))
    grid[0, 4, 4, 4] = 1.0  # one non-empty channel, one empty
    result = Visualizer().visualize_mol(str(tmp_path / "session.pse"), mol, {"C": grid[0], "N": grid[1]},
                                        torch.zeros(3), 0.5)
    assert result.suffix == ".pml"
    script = result.read_text()
    assert "isosurface" in script and "Molecule_C" in script
    assert "Molecule_N" not in script.replace("Molecule_N_map", "")  # the empty channel is skipped
    assert (result.parent / "molecule.sdf").exists()
    values, origin, res = read_dx(result.parent / "Molecule_C.dx")
    assert res == 0.5 and values[4, 4, 4] == pytest.approx(1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_visualizer_complex_equals_jax(rng, tmp_path, dtype):
    """The same script and the same volumes as the JAX package's Visualizer
    given the numpy grids; new coordinates move the written molecules."""
    lig, prot = make_mol(rng), make_mol(rng, n=12, nb=0)
    g = torch.zeros((2, 8, 8, 8), dtype=dtype)
    g[0, 4, 4, 4] = 1.0
    g[1, 2:5, 3, 3] = 0.75
    center = np.array([0.5, -1.0, 2.0])
    moved = [lig.coords + 1.0, prot.coords - 1.0]
    got = Visualizer().visualize_complex(str(tmp_path / "t" / "cplx.pse"), lig, prot, {"C": g[0], "N": g[1]},
                                         {"C": g[1]}, torch.as_tensor(center), 0.5, torch.as_tensor(moved[0]),
                                         moved[1])
    host = g.float().numpy()
    jmols = [JSimpleMolecule(m.coords, list(m.symbols), list(m.bonds), m.name) for m in (lig, prot)]
    want = jviz.Visualizer().visualize_complex(str(tmp_path / "j" / "cplx.pse"), *jmols, {"C": host[0], "N": host[1]},
                                               {"C": host[1]}, center, 0.5, *moved)
    assert got.read_text() == want.read_text()
    assert "Ligand" in got.read_text() and "Protein" in got.read_text()
    for f in sorted(want.parent.iterdir()):
        if f.suffix == ".dx":
            assert (got.parent / f.name).read_bytes() == f.read_bytes(), f.name
        elif f.suffix in (".sdf", ".pdb"):  # the same atoms; the writer names its package in the header
            mine, theirs = (p.read_text().splitlines() for p in (got.parent / f.name, f))
            assert [ln for ln in mine if "molvoxel" not in ln] == [ln for ln in theirs if "molvoxel" not in ln]
