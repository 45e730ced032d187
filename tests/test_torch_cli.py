"""molvoxel_torch's CLI with ``--device cpu`` against the JAX package's CLI, on the same files.

``info``; ``voxelize`` to an .npz, to a sharded store, to .dx volumes, from
.xyz, .sdf.gz and several files, with bond channels, ``--npz-limit`` and
``--throughput --trials``.  Tolerances: 1e-5 (f32 grids), 2^-7 x max
(bf16 grids), 1e-5 (.dx values, printed to 5 decimals), rtol 1e-5
(throughput checksums).  Records come from chip_smoke's synthesizer; dims 16.
"""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import molvoxel_tpu.cli as jcli
from molvoxel_torch import cli
from molvoxel_torch.data.gridstore import read_grid_shards
from molvoxel_torch.data.parsers import SimpleMolecule, write_sdf, write_xyz
from molvoxel_torch.viz.dx import read_dx
from molvoxel_tpu.data.gridstore import read_grid_shards as jax_read_grid_shards

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--dimension", "16"]


@pytest.fixture
def work(tmp_path, monkeypatch):
    """A working directory (the JAX CLI writes its compilation cache into
    the current one) holding a 20-record library."""
    monkeypatch.chdir(tmp_path)
    chip_smoke.write_library(tmp_path / "lib.sdf", 20, seed=2, all_h_at=4, empty_at=13)
    return tmp_path


def run_both(argv_t, argv_j, capsys):
    """Run the port (``--device cpu``) and the JAX CLI; return their stdouts."""
    assert cli.main(argv_t + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert jcli.main(argv_j) == 0
    return out_t, capsys.readouterr().out


def npz_grids(path):
    data = np.load(path)
    return data, data["grids"]


def test_info(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    for word in ("molvoxel-torch", "torch", "cuda:", "nvcc:", "g++:", "native fast parser: yes", "rdkit:"):
        assert word in out


def test_module_entry_point_runs_info():
    res = subprocess.run([sys.executable, "-m", "molvoxel_torch", "info"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "native fast parser" in res.stdout


@pytest.mark.parametrize("src", ["sdf", "sdf_gz", "xyz", "two_files", "bonds"])
def test_voxelize_npz_equal_jax(src, work, capsys):
    lib = work / "lib.sdf"
    inputs = [str(lib)]
    if src == "sdf_gz":
        (work / "lib.sdf.gz").write_bytes(gzip.compress(lib.read_bytes()))
        inputs = [str(work / "lib.sdf.gz")]
    elif src == "xyz":
        rng = np.random.default_rng(0)
        mol = SimpleMolecule(coords=rng.uniform(-3, 3, (9, 3)), symbols=["C", "N", "O", "S", "C", "H", "C", "O", "N"])
        write_xyz(mol, work / "m.xyz")
        inputs = [str(work / "m.xyz")]
    elif src == "two_files":
        inputs = [str(lib), str(lib)]
    elif src == "bonds":
        rng = np.random.default_rng(1)
        mol = SimpleMolecule(coords=rng.uniform(-3, 3, (8, 3)), symbols=["C", "N", "O", "S"] * 2,
                             bonds=[(i, i + 1, ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"][i % 4]) for i in range(7)])
        write_sdf(mol, work / "b.sdf")
        inputs = [str(work / "b.sdf")]
    extra = ["--bonds"] if src == "bonds" else []
    run_both(["voxelize", *inputs, "-o", "t.npz", *COMMON, *extra],
             ["voxelize", *inputs, "-o", "j.npz", *COMMON, *extra], capsys)
    (dt, gt), (dj, gj) = npz_grids(work / "t.npz"), npz_grids(work / "j.npz")
    assert gt.shape == gj.shape and gt.shape[0] == {"xyz": 1, "two_files": 40, "bonds": 1}.get(src, 20)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    assert list(dt["channels"]) == list(dj["channels"])
    assert float(dt["resolution"]) == float(dj["resolution"]) and int(dt["dimension"]) == int(dj["dimension"])


def test_voxelize_store_and_dx_equal_jax(work, capsys):
    """A bf16 sharded store and the first molecule's .dx volumes; each
    package reads the other's store."""
    lib = str(work / "lib.sdf")
    run_both(["voxelize", lib, "-o", "t_store", "--out-dtype", "bfloat16", "--dx", "t_dx", *COMMON],
             ["voxelize", lib, "-o", "j_store", "--out-dtype", "bfloat16", "--dx", "j_dx", *COMMON], capsys)
    got, manifest = read_grid_shards(work / "t_store")
    want, jmanifest = read_grid_shards(work / "j_store")
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (20, 4, 16, 16, 16)
    manifest.pop("shards"), jmanifest.pop("shards")
    assert manifest == jmanifest
    scale = max(float(want.float().abs().max()), 1.0)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0, atol=2**-7 * scale)
    cross, _ = jax_read_grid_shards(work / "t_store")
    np.testing.assert_array_equal(np.asarray(cross, np.float32), got.float().numpy())
    assert sorted(p.name for p in (work / "t_dx").iterdir()) == ["C.dx", "N.dx", "O.dx", "S.dx"]
    for name in ("C.dx", "S.dx"):
        vt, ot, rt = read_dx(work / "t_dx" / name)
        vj, oj, rj = read_dx(work / "j_dx" / name)
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5 + 2**-7 * scale)
        np.testing.assert_array_equal(ot, oj)
        assert rt == rj


def test_voxelize_grids_to_stdout_and_npz_limit(work, capsys):
    lib = str(work / "lib.sdf")
    out_t, out_j = run_both(["voxelize", lib, *COMMON], ["voxelize", lib, *COMMON], capsys)
    assert json.loads(out_t.strip().splitlines()[-1]) == json.loads(out_j.strip().splitlines()[-1])
    with pytest.raises(SystemExit, match="npz-limit"):
        cli.main(["voxelize", lib, "-o", "t.npz", "--npz-limit", "5", "--batch", "8", "--device", "cpu", *COMMON])
    with pytest.raises(SystemExit, match="npz-limit"):
        jcli.main(["voxelize", lib, "-o", "j.npz", "--npz-limit", "5", "--batch", "8", *COMMON])
    # --shards writes a store even for an .npz path
    assert cli.main(["voxelize", lib, "-o", "s.npz", "--shards", "--device", "cpu", *COMMON]) == 0
    assert (work / "s.npz" / "manifest.json").exists()


@pytest.mark.parametrize("flags", [[], ["--wire"], ["--full-read", "--presort"]])
def test_throughput_equal_jax(flags, work, capsys):
    """The throughput payload's checksum equals the JAX CLI's (rtol 1e-5) and
    the trials are reported."""
    argv = ["voxelize", str(work / "lib.sdf"), "--throughput", "--trials", "2", "--batch", "8", "--chunk", "4",
            *COMMON, *flags]
    out_t, out_j = run_both(argv, argv, capsys)
    got, want = json.loads(out_t.strip().splitlines()[-1]), json.loads(out_j.strip().splitlines()[-1])
    assert got["metric"] == want["metric"] == "stream_from_disk_mols_per_s"
    assert got["molecules"] == want["molecules"] == 18 and got["superbatches"] == want["superbatches"] == 3
    assert got["checksum"] == pytest.approx(want["checksum"], rel=1e-5)
    assert len(got["trials"]) == 2 and got["min_mols_per_s"] <= got["median_mols_per_s"] <= got["max_mols_per_s"]
    assert got["device"] == "cpu" and got["native_shards"] > 0


def test_the_card_is_the_default(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["voxelize", str(work / "lib.sdf"), *COMMON])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["bench"])
