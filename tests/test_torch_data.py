"""molvoxel_torch's host data layer against the JAX package's, on the CPU.

Parsers, writers, getters and point-cloud makers on SDF (V2000, V3000,
.sdf.gz), multi-MODEL PDB, XYZ and MOL2 text written by the JAX package's
writers; the native parser against the Python parser against the JAX
package's; SDFBatchFeeder batches, morton_presort, pack_wire and the wire
assembly; the sharded grid store read across packages; the OpenDX writer.
Inputs come from tests/goldens and numpy seeds.  Tolerance: exact
(array_equal) unless a line says otherwise.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import molvoxel_torch.data.feed as tfeed
import molvoxel_torch.data.gridstore as tstore
import molvoxel_torch.data.parsers as tparse
import molvoxel_torch.data.pointcloud as tpc
import molvoxel_torch.native as tnative
import molvoxel_torch.viz.dx as tdx
import molvoxel_tpu.data.feed as jfeed
import molvoxel_tpu.data.gridstore as jstore
import molvoxel_tpu.data.parsers as jparse
import molvoxel_tpu.data.pointcloud as jpc
import molvoxel_tpu.native.fastparse as jnative
import molvoxel_tpu.viz.dx as jdx
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.data import getter as tget
from molvoxel_torch.native import build as tbuild
from molvoxel_torch.native import fastparse as tfast
from molvoxel_torch.ops.deposit import morton_keys, sort_atoms_spatially
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.data import getter as jget

ROOT = Path(__file__).resolve().parents[1]
SYMBOLS = ["C", "N", "O", "S"]
V3000 = """big mol
  program
  comment
  0  0  0     0  0            999 V3000
M  V30 BEGIN CTAB
M  V30 COUNTS 3 2 0 0 0
M  V30 BEGIN ATOM
M  V30 1 C 0.0 0.0 0.0 0
M  V30 2 O 1.2 0.0 0.0 0
M  V30 7 N 0.0 1.3 0.0 0
M  V30 END ATOM
M  V30 BEGIN BOND
M  V30 1 2 1 2
M  V30 2 1 2 7
M  V30 END BOND
M  V30 END CTAB
M  END
$$$$
"""
MOL2 = """@<TRIPOS>MOLECULE
benzene-ish
 4 3 0 0 0
SMALL
NO_CHARGES
@<TRIPOS>ATOM
      1 C1    0.0000  0.0000  0.0000 C.ar  1 LIG1  0.0
      2 C2    1.4000  0.0000  0.0000 C.ar  1 LIG1  0.0
      3 N1    2.1000  1.2000  0.0000 N.3   1 LIG1 -0.3
      4 H1    0.5000  0.9000  0.0000 H     1 LIG1  0.1
@<TRIPOS>BOND
     1    1    2 ar
     2    2    3 1
     3    1    4 1
"""


def golden_mol(pkg, hydrogens: int = 3):
    """The 61-atom golden ligand (types 0-3 as C, N, O, S) as the package's
    SimpleMolecule, with a chain of bonds of every order and ``hydrogens``
    extra H atoms bonded to the first atoms."""
    g = np.load(ROOT / "tests" / "goldens" / "lig_types_gaussian.npz")
    coords = g["coords"].astype(np.float64)
    symbols = [SYMBOLS[t] for t in g["channels"]]
    orders = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]
    bonds = [(i, i + 1, orders[i % 4]) for i in range(20)]
    h = coords[:hydrogens] + np.array([0.0, 0.0, 1.09])
    bonds += [(i, len(symbols) + i, "SINGLE") for i in range(hydrogens)]
    return pkg.SimpleMolecule(coords=np.concatenate([coords, h]), symbols=symbols + ["H"] * hydrogens,
                              bonds=bonds, name="golden")


def same_mol(a, b, name: bool = True):
    assert a.symbols == b.symbols
    assert a.bonds == b.bonds
    assert a.name == b.name or not name
    np.testing.assert_array_equal(a.coords, b.coords)


def write_input(fmt: str, tmp_path: Path) -> Path:
    """A file of format ``fmt`` written by the JAX package's writers (or, for
    V3000 and MOL2, which have no writer, the JAX tests' fixtures)."""
    mol = golden_mol(jparse)
    if fmt in ("sdf", "sdf_gz"):
        jparse.write_sdf(mol, tmp_path / "one.sdf")
        text = (tmp_path / "one.sdf").read_bytes() * 2
        if fmt == "sdf":
            (tmp_path / "m.sdf").write_bytes(text)
            return tmp_path / "m.sdf"
        (tmp_path / "m.sdf.gz").write_bytes(gzip.compress(text))
        return tmp_path / "m.sdf.gz"
    if fmt == "v3000":
        jparse.write_sdf(mol, tmp_path / "one.sdf")
        (tmp_path / "m.sdf").write_text((tmp_path / "one.sdf").read_text() + V3000)
        return tmp_path / "m.sdf"
    if fmt == "pdb_models":
        body = []
        for k, shift in enumerate((0.0, 2.5)):
            m = jparse.SimpleMolecule(coords=mol.coords + shift, symbols=mol.symbols)
            jparse.write_pdb(m, tmp_path / "one.pdb")
            lines = [ln for ln in (tmp_path / "one.pdb").read_text().splitlines() if ln != "END"]
            body += [f"MODEL     {k + 1:4d}", *lines, "ENDMDL"]
        (tmp_path / "m.pdb").write_text("\n".join(body + ["END"]) + "\n")
        return tmp_path / "m.pdb"
    if fmt == "xyz":
        jparse.write_xyz(mol, tmp_path / "a.xyz")
        (tmp_path / "m.xyz").write_text((tmp_path / "a.xyz").read_text() * 2)
        return tmp_path / "m.xyz"
    (tmp_path / "m.mol2").write_text(MOL2 + MOL2)
    return tmp_path / "m.mol2"


READERS = {
    "sdf": lambda p, m: list(m.iter_sdf(p)),
    "sdf_gz": lambda p, m: list(m.iter_sdf(p)),
    "v3000": lambda p, m: list(m.iter_sdf(p)),
    "pdb_models": lambda p, m: list(m.iter_pdb_models(p)) + [m.read_pdb(p)],
    "xyz": lambda p, m: list(m.iter_xyz(p)) + [m.read_xyz(p)],
    "mol2": lambda p, m: list(m.iter_mol2(p)) + [m.read_mol2(p)],
}


@pytest.mark.parametrize("fmt", sorted(READERS))
def test_parsers_equal_jax(fmt, tmp_path):
    path = write_input(fmt, tmp_path)
    got = READERS[fmt](path, tparse)
    want = READERS[fmt](path, jparse)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        same_mol(a, b)
        same_mol(a.without_hydrogens(), b.without_hydrogens())
        np.testing.assert_array_equal(a.bond_midpoints(), b.bond_midpoints())
    same_mol(tparse.read_molecule(path), jparse.read_molecule(path))


def test_writers_equal_jax(tmp_path):
    """The port's writers emit the JAX package's text, up to the program
    name in the SDF header."""
    for name in ("write_sdf", "write_pdb", "write_xyz"):
        getattr(tparse, name)(golden_mol(tparse), tmp_path / "t")
        getattr(jparse, name)(golden_mol(jparse), tmp_path / "j")
        got = (tmp_path / "t").read_text().replace("molvoxel_torch", "molvoxel_tpu")
        assert got == (tmp_path / "j").read_text(), name


def _makers(pkg, get):
    atoms = get.AtomTypeGetter(SYMBOLS)
    atoms_unk = get.AtomTypeGetter(["C", "N"], unknown=True)
    bonds = get.BondTypeGetter.default()
    return {
        "mol_types": pkg.MolPointCloudMaker(atoms, None, channel_type="types"),
        "mol_features_bonds": pkg.MolPointCloudMaker(atoms, bonds, channel_type="features"),
        "mol_unknown_bonds": pkg.MolPointCloudMaker(atoms_unk, bonds),
        "complex": pkg.ComplexPointCloudMaker(atoms, bonds, atoms_unk, None),
        "system_types": pkg.MolSystemPointCloudMaker((atoms, None), (atoms_unk, None), channel_type="types"),
    }


@pytest.mark.parametrize("name", ["mol_types", "mol_features_bonds", "mol_unknown_bonds", "complex", "system_types"])
def test_getters_and_pointclouds_equal_jax(name):
    """Bond-midpoint channels, unknown channels, complexes and systems."""
    t_maker, j_maker = _makers(tpc, tget)[name], _makers(jpc, jget)[name]
    # hydrogens only where the atom getter has an unknown channel
    t_mol, j_mol = golden_mol(tparse), golden_mol(jparse)
    if name in ("complex", "system_types"):
        t_arg = [t_mol.without_hydrogens(), t_mol]
        j_arg = [j_mol.without_hydrogens(), j_mol]
    elif name == "mol_unknown_bonds":
        t_arg, j_arg = t_mol, j_mol
    else:
        t_arg, j_arg = t_mol.without_hydrogens(), j_mol.without_hydrogens()
    got, want = t_maker.run(t_arg), j_maker.run(j_arg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t_maker.channels == j_maker.channels


def test_getters_equal_jax():
    for t_g, j_g in ((tget.AtomTypeGetter(SYMBOLS, unknown=True), jget.AtomTypeGetter(SYMBOLS, unknown=True)),
                     (tget.BondTypeGetter.default(), jget.BondTypeGetter.default())):
        assert t_g.channels == j_g.channels and t_g.num_channels == j_g.num_channels
        for key in ("C", "S", "Fe", "SINGLE", "AROMATIC"):
            try:
                want = j_g.get_type(key)
            except (KeyError, ValueError):
                with pytest.raises((KeyError, ValueError)):
                    t_g.get_type(key)
                continue
            assert t_g.get_type(key) == want
            np.testing.assert_array_equal(t_g.get_feature(key), j_g.get_feature(key))


@pytest.fixture
def library(tmp_path):
    """40 records from chip_smoke's synthesizer: the golden ligand rotated,
    jittered and cut to 20-61 atoms, one all-H record (3) and one empty (11)."""
    return chip_smoke.write_library(tmp_path / "lib.sdf", 40, seed=3, all_h_at=3, empty_at=11)


def test_native_builds_outside_the_package():
    path = tbuild.build()
    assert path is not None and path.parent == ROOT / "build" / "molvoxel_torch"
    assert tnative.NATIVE_AVAILABLE is True
    assert not list((ROOT / "molvoxel_torch" / "native").glob("*.so"))


def test_native_python_and_jax_parsers_agree(library):
    buf = library.read_bytes()
    native = tfast.parse_sdf_flat(buf)
    want = jnative.parse_sdf_flat(buf)
    assert native is not None and native.num_molecules == 40
    for field in ("coords", "symbols", "atom_offsets", "bonds", "bond_offsets"):
        np.testing.assert_array_equal(getattr(native, field), getattr(want, field))
    python = list(tparse.iter_sdf_lines(buf.decode().splitlines()))
    natives = tfast.parse_sdf_buffer(buf)
    assert len(python) == len(natives) == 40
    for a, b in zip(natives, python):
        same_mol(a, b, name=False)  # the native parser reads no record titles
    assert natives[3].symbols == ["H"] * 5 and natives[11].num_atoms == 0
    table = {s: i for i, s in enumerate(SYMBOLS)}
    np.testing.assert_array_equal(native.types(table, unknown=4), want.types(table, unknown=4))


def test_python_fallback_equals_native(library, monkeypatch):
    """With no native library (NATIVE_AVAILABLE false), the feeder and the
    wire assembly give the same batches through numpy."""
    spec = GridSpec(0.5, 16)
    native = list(tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8, compact=True))
    native_wire = list(tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8).iter_wire(spec))
    monkeypatch.setitem(tfast._state, "lib", None)
    assert tnative.NATIVE_AVAILABLE is False
    feeder = tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8, compact=True)
    python = list(feeder)
    assert feeder.native_shards == 0 and feeder.records_fed == 40
    for a, b in zip(native, python):
        for f in ("coords", "mask", "centers", "num_atoms", "types"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=1e-6)
    python_wire = list(tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8).iter_wire(spec))
    for (wa, na, _), (wb, nb, _) in zip(native_wire, python_wire):
        np.testing.assert_array_equal(na, nb)
        assert np.abs(wa.astype(np.int32) - wb.astype(np.int32)).max() <= 1  # one fixed-point step


FEEDER_CASES = {
    "default": dict(),
    "workers1": dict(workers=1),
    "shards5": dict(shards=5, workers=2),
    "compact": dict(compact=True),
    "presort": dict(presort=True, bucket=256, compact=True),
    "shuffle": dict(shuffle_seed=7, shards=6),
    "stripe": dict(shuffle_seed=7, shards=6, span_offset=1, span_stride=2),
    "unknown_h": dict(unknown=True, keep_hydrogens=True),
    "radii": dict(radii_by_type=np.array([0.9, 1.2, 1.4, 1.7], np.float32)),
}


@pytest.mark.parametrize("case", sorted(FEEDER_CASES))
def test_feeder_batches_equal_jax(case, library):
    kw = dict(FEEDER_CASES[case])
    jkw = dict(kw)
    if kw.get("presort"):
        kw["spec"], jkw["spec"] = GridSpec(0.5, 16), JSpec(0.5, 16)
    got_f = tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8, **kw)
    want_f = jfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=8, **jkw)
    got, want = list(got_f), list(want_f)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in ("coords", "weights", "mask", "radii", "centers", "num_atoms", "types", "num_channels"):
            u, v = getattr(a, f), getattr(b, f)
            assert (u is None) == (v is None), f
            if u is not None:
                np.testing.assert_array_equal(u, v)
    assert (got_f.records_fed, got_f.molecules_fed) == (want_f.records_fed, want_f.molecules_fed)
    assert got_f.native_shards > 0


@pytest.mark.parametrize("presort", [False, True])
def test_iter_wire_equal_jax(presort, library):
    spec, jspec = GridSpec(0.5, 16), JSpec(0.5, 16)
    kw = dict(batch_size=8, bucket=256 if presort else None, presort=presort)
    got = list(tfeed.SDFBatchFeeder(library, SYMBOLS, spec=spec if presort else None, **kw).iter_wire(spec))
    want = list(jfeed.SDFBatchFeeder(library, SYMBOLS, spec=jspec if presort else None, **kw).iter_wire(jspec))
    assert len(got) == len(want) == 5
    for (wa, na, ca), (wb, nb, cb) in zip(got, want):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(na, nb)
        assert ca == cb == 4
    assert tfeed.wire_scale(spec) == jfeed.wire_scale(jspec) == 2048.0
    assert tfeed.wire_scale(GridSpec(0.5, 64)) == 1024.0


def test_morton_presort_and_pack_wire_equal_jax(library):
    spec, jspec = GridSpec(0.5, 16), JSpec(0.5, 16)
    (batch,) = list(tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=40, compact=True, bucket=256))
    got, want = tfeed.morton_presort(batch, spec), jfeed.morton_presort(batch, jspec)
    for f in ("coords", "mask", "types", "centers", "num_atoms"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for scale in (1024.0, 512.0):
        np.testing.assert_array_equal(tfeed.pack_wire(batch, scale), jfeed.pack_wire(batch, scale))


def test_morton_presort_keys_equal_the_device_sort(library):
    """The host presort orders atoms exactly as ops.deposit.sort_atoms_spatially
    does (the same keys, both stable), dims 16 and 24."""
    (batch,) = list(tfeed.SDFBatchFeeder(library, SYMBOLS, batch_size=40, bucket=256))
    for spec in (GridSpec(0.5, 16), GridSpec(0.375, 24)):
        centered = torch.as_tensor(batch.coords - batch.centers[:, None, :])
        mask = torch.as_tensor(batch.mask)
        host = tfeed.morton_presort(batch, spec)
        crd, w, _, m = sort_atoms_spatially(centered, torch.as_tensor(batch.weights), torch.ones(mask.shape), mask,
                                            spec)
        np.testing.assert_array_equal(host.coords - host.centers[:, None, :], crd.numpy())
        np.testing.assert_array_equal(host.weights, w.numpy())
        np.testing.assert_array_equal(host.mask, m.numpy())
        keys = morton_keys(centered, spec, mask).numpy()
        assert (np.diff(np.take_along_axis(keys, np.argsort(keys, axis=1, kind="stable"), 1), axis=1) >= 0).all()


def test_wire_assemble_native_bounds():
    coords = np.zeros((10, 3), np.float32)
    types = np.zeros(10, np.int32)
    with pytest.raises(ValueError, match="exceeds bucket"):
        tfast.wire_assemble_native(coords, types, np.array([10]), 8, 1024.0, False, -8.0, 1.0)
    with pytest.raises(ValueError, match="claim more atoms"):
        tfast.wire_assemble_native(coords, types, np.array([6, 6]), 8, 1024.0, False, -8.0, 1.0)


def _grid_batches(dtype, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        g = torch.as_tensor(rng.uniform(0, 2, size=(3, 2, 4, 4, 4)).astype(np.float32)).to(dtype)
        out.append((g, rng.integers(0, 30, size=3).astype(np.int32)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_gridstore_reads_across_packages(dtype, tmp_path):
    """A store written by either package reads in the other, bit for bit
    (bf16 and fp8 as raw 2- and 1-byte items), with the same manifest."""
    ml_dtypes = pytest.importorskip("ml_dtypes")  # the JAX package's reader needs it
    batches = _grid_batches(getattr(torch, dtype))
    tw = tstore.GridShardWriter(tmp_path / "t", ["a", "b"], resolution=0.5, dimension=4, target_bytes=1000)
    jw = jstore.GridShardWriter(tmp_path / "j", ["a", "b"], resolution=0.5, dimension=4, target_bytes=1000)
    np_dtype = getattr(ml_dtypes, dtype) if dtype != "float32" else np.float32
    for g, n in batches:
        tw.append(g, n)
        jw.append(np.asarray(g.float().numpy(), np_dtype), n)
    tw.finalize(8)
    jw.finalize(8)
    t_manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    j_manifest = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert t_manifest == j_manifest and t_manifest["dtype"] == dtype and t_manifest["num_molecules"] == 8
    want = torch.cat([g for g, _ in batches])[:8]
    for root in ("t", "j"):
        got, manifest = tstore.read_grid_shards(tmp_path / root)  # the port reads both
        assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        reader = tstore.GridShardReader(tmp_path / root)
        assert torch.equal(reader[5].float(), want[5].float()) and torch.equal(reader[-1].float(), want[7].float())
        np.testing.assert_array_equal(reader.num_atoms(), np.concatenate([n for _, n in batches])[:8])
        jgot, _ = jstore.read_grid_shards(tmp_path / root)  # and the JAX package reads both
        np.testing.assert_array_equal(np.asarray(jgot, np.float32), want.float().numpy())


def test_gridstore_resume_and_context(tmp_path):
    batches = _grid_batches(torch.float32)
    w = tstore.GridShardWriter(tmp_path / "s", ["a", "b"], resolution=0.5, dimension=4, target_bytes=1)
    w.append(*batches[0])
    w.append(*batches[1])  # both flushed (target 1 byte), provisional manifest
    resumed = tstore.GridShardWriter(tmp_path / "s", ["a", "b"], resolution=0.5, dimension=4, resume=True)
    assert resumed.rows == 6
    with resumed:
        resumed.append(*batches[2])
    got, manifest = tstore.read_grid_shards(tmp_path / "s")
    assert manifest["final"] and torch.equal(got, torch.cat([g for g, _ in batches]))


def test_dx_equal_jax(tmp_path):
    grid = np.random.default_rng(0).uniform(0, 1, size=(5, 4, 3)).astype(np.float32)
    tdx.write_dx(tmp_path / "t.dx", grid, [1.0, 2.0, 3.0], 0.5)
    jdx.write_dx(tmp_path / "j.dx", grid, [1.0, 2.0, 3.0], 0.5)
    assert (tmp_path / "t.dx").read_text() == (tmp_path / "j.dx").read_text()
    values, origin, res = tdx.read_dx(tmp_path / "t.dx")
    np.testing.assert_allclose(values, grid, rtol=0, atol=5e-6)
    paths = tdx.write_channels_dx(tmp_path / "ch", {"C": grid, "N/x": grid}, [0, 0, 0], 0.5)
    assert sorted(p.name for p in paths.values()) == ["C.dx", "N_x.dx"]
