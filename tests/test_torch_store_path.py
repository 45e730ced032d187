"""The CLI's grid store path, ``voxelize lib.sdf -o store/``, on the CPU.

The library is the benchmark's (``portbench/sources/library_sdf.py``: the
seeded ligands written as SDF V2000, one all-hydrogen and one empty record
among them).  Every stored grid is held against the benchmark's plain
reference (``portbench/reference/grid.py``), its transforms replayed batch
by batch as ``drivers/store_pass.py`` replays them; the store's structure
against ``portbench/reference/store.py``; and the stream's and the writer's
spans and counters against what the pass did.  Imports no JAX.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from molvoxel_torch import cli
from molvoxel_torch.data.feed import SDFBatchFeeder
from molvoxel_torch.utils import timing
from portbench import harness
from portbench.reference import grid as ref_grid
from portbench.reference import store as ref_store

ROOT = Path(__file__).resolve().parents[1]
STORE_PASS = harness.load_module(ROOT / "portbench" / "drivers" / "store_pass.py")
SOURCE = harness.load_module(ROOT / "portbench" / "sources" / "library_sdf.py")
BATCH = 40  # 96 records: two whole batches and a padded tail of 24
EMPTY = (7, 70)  # the all-hydrogen record and the empty one
CFG = {**harness.load_json(ROOT / "portbench" / "configs" / "lib_ligand64_store.json"), "dimension": 24}
CFG["molecules"] = {**CFG["molecules"], "records": 96, "empty_record": EMPTY[1]}
SPANS = ("molvoxel.stream.next", "molvoxel.stream.dispatch", "molvoxel.stream.consume", "molvoxel.store.copy_out",
         "molvoxel.store.write")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    path = tmp_path_factory.mktemp("library") / "lib.sdf"
    return path, SOURCE.write(ROOT, CFG, 20260817, path)


def voxelize(sdf, store, seed, out_dtype="bfloat16"):
    argv = ["voxelize", str(sdf), "-o", str(store), "--out-dtype", out_dtype, "--random-rotation",
            "--random-translation", "0.5", "--seed", str(seed), "--dimension", "24", "--resolution", "0.5",
            "--sigma", "0.5", "--radii", "1.0", "--channels", "C,N,O,S", "--batch", str(BATCH), "--workers", "2",
            "--device", "cpu"]
    assert cli.main(argv) == 0


def digests(store: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(store.iterdir())}


def test_the_sdf_file_holds_the_library(library):
    sdf, mols = library
    batches = list(SDFBatchFeeder(sdf, CFG["molecules"]["symbols"], batch_size=BATCH))
    atoms = np.concatenate([b.num_atoms for b in batches])[:len(mols)]
    assert atoms.tolist() == [len(m[1]) for m in mols] and atoms[list(EMPTY)].tolist() == [0, 0]
    for k, b in enumerate(batches):
        for row, n in enumerate(b.num_atoms.tolist()):
            i = k * BATCH + row
            if i < len(mols) and n:  # the text's four decimals parse back to the float32 coordinates
                np.testing.assert_allclose(b.coords[row, :n], mols[i][0], rtol=0, atol=1e-6)
                np.testing.assert_allclose(b.centers[row], mols[i][2], rtol=0, atol=1e-5)
                np.testing.assert_array_equal(b.weights[row, :n].argmax(-1), mols[i][1])


@pytest.mark.parametrize("out_dtype,bar", [("bfloat16", 2**-7), ("float32", 1e-5)])
def test_store_equals_the_reference(library, tmp_path, out_dtype, bar):
    sdf, mols = library
    seed = 2**31 + 99
    voxelize(sdf, tmp_path / "store", seed, out_dtype)
    heavy = np.array([len(m[1]) for m in mols], np.int32)
    assert ref_store.problems(tmp_path / "store", records=len(mols), dtype=out_dtype, grid_shape=[4, 24, 24, 24],
                              heavy_counts=heavy) == []
    store = ref_store.Store(tmp_path / "store")
    worst = 0.0
    for i, mol in enumerate(mols):
        grid = store.grid(i)
        lo, hi, _ = STORE_PASS.replay(CFG, mol, seed, BATCH, i)
        worst = max(worst, ref_grid.interval_excess(grid[None], lo, hi) / max(float(hi.max()), 1.0))
        if i in EMPTY:
            assert not grid.to(torch.float32).any()
        else:
            assert grid.to(torch.float32).amax() > 0.5
    assert worst <= bar


def test_two_seeds_differ_and_one_seed_repeats(library, tmp_path):
    sdf, _ = library
    for name, seed in (("a", 11), ("b", 11), ("c", 12)):
        voxelize(sdf, tmp_path / name, seed)
    a, b, c = (digests(tmp_path / n) for n in "abc")
    assert a == b
    shards = [k for k in a if k.startswith("shard_")]
    assert shards and all(a[k] != c[k] for k in shards)
    assert a["num_atoms.npy"] == c["num_atoms.npy"] and a["manifest.json"] == c["manifest.json"]


def test_profiler_sees_the_spans_and_counters(library, tmp_path):
    sdf, mols = library
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        voxelize(sdf, tmp_path / "store", 5)
    snap = timing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    batches = -(-len(mols) // BATCH)
    assert set(SPANS) <= set(spans)
    assert spans["molvoxel.stream.dispatch"]["count"] == batches
    assert spans["molvoxel.stream.consume"]["count"] == batches
    assert spans["molvoxel.store.copy_out"]["count"] == batches
    assert spans["molvoxel.stream.next"]["count"] == batches + 1  # the last finds the feeder done
    store = ref_store.Store(tmp_path / "store")
    shards = [store.shard(i) for i in range(len(store.manifest["shards"]))]
    assert counters["molvoxel.store_bytes"] == sum(s.nbytes for s in shards)
    assert counters["molvoxel.store_shards"] == len(shards)
    for name in ("molvoxel.stream.consume", "molvoxel.stream.dispatch"):
        assert 0 < spans[name]["self_s"] <= spans[name]["total_s"]


def test_without_a_profiler_the_record_gains_nothing(library, tmp_path):
    sdf, _ = library
    before = timing.snapshot()
    voxelize(sdf, tmp_path / "store", 5)
    assert timing.snapshot() == before
