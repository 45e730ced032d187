"""Every input the benchmark makes comes from the seed: the same seed, the same inputs."""

import json
from pathlib import Path

import numpy as np

from portbench.harness import Reservoir, load_module
from portbench.sources import complex as complex_source
from portbench.sources import library

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
CFG = {"molecules": {"kind": "library", "records": 200, "template": "portbench/data/lig_types_gaussian.npz",
                     "symbols": ["C", "N", "O", "S"], "min_atoms": 20, "jitter": 0.3, "all_h_record": 7,
                     "empty_record": 150}}
BIG_SEED = 2**31 + 987654321


def test_library_is_fixed_by_its_seed():
    a, b, c = (library.generate(ROOT, CFG, s) for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.sym, b.sym)
    assert not np.array_equal(a.counts, c.counts)
    assert a.heavy_counts[7] == 0 and a.heavy_counts[150] == 0 and a.counts[7] == 5
    ma, mb = library.molecules(ROOT, CFG, BIG_SEED), library.molecules(ROOT, CFG, BIG_SEED)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[2], y[2]) for x, y in zip(ma, mb))


def test_complex_is_the_whole_frozen_complex():
    cfg = json.loads((BENCH / "configs" / "mv10gs_complex48.json").read_text())
    (coords, types, center), = complex_source.molecules(ROOT, cfg, BIG_SEED)
    assert coords.shape == (61 + 3262, 3) and not types.any()
    lig = np.load(ROOT / "tests" / "goldens" / "lig_types_gaussian.npz")
    prot = np.load(ROOT / "tests" / "goldens" / "protein_single_gaussian.npz")
    np.testing.assert_array_equal(coords, np.concatenate([lig["coords"], prot["coords"]]))
    np.testing.assert_allclose(center, lig["coords"].mean(0), atol=1e-4)


def test_batch_keys_follow_the_seed():
    batch = load_module(BENCH / "drivers" / "batch_loop.py")
    keys = [batch.key(BIG_SEED, k) for k in range(-3, 100)]
    assert keys == [batch.key(BIG_SEED, k) for k in range(-3, 100)] and len(set(keys)) == len(keys)
    assert not set(keys) & {batch.key(BIG_SEED + 1, k) for k in range(-3, 100)}


def test_reservoir_sample_is_fixed_by_its_seed():
    def sample(seed):
        r = Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        return r.items

    assert sample(5) == sample(5) and sample(5) != sample(6) and len(sample(5)) == 4
