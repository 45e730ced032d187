"""molvoxel_torch.interop against the JAX package's interop, on the CPU.

to_torch / from_torch keep every bit (bf16 and fp8 included); the
VoxelGridDataset's grids equal the JAX dataset's on the same synthesized
library (1e-5 f32, 2^-7 x max bf16, no augmentation) and ``voxelize_batch``
on the same padded batch; DataLoader workers (``device="cpu"``, spawned)
cover the file once; the epoch shuffle and ``set_epoch``; the
GridStoreDataset's items equal the store reader's and the JAX dataset's,
bit for bit, through a shuffling DataLoader with two workers.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import chip_smoke
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.data.feed import SDFBatchFeeder
from molvoxel_torch.data.gridstore import GridShardReader
from molvoxel_torch.interop import GridStoreDataset, VoxelGridDataset, from_torch, to_torch
from molvoxel_torch.ops.batch import voxelize_batch
from molvoxel_tpu import interop as jax_interop
from molvoxel_tpu.core.config import GridSpec as JSpec

SYMBOLS = ["C", "N", "O", "S"]
RECORDS = 24


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return chip_smoke.write_library(tmp_path_factory.mktemp("interop") / "lib.sdf", RECORDS, seed=7, all_h_at=3,
                                    empty_at=14)


def _molecule_sums(batches):
    """Sorted per-molecule grid sums of the real (atom-bearing) slots."""
    return sorted(float(g.double().sum()) for grids, n in batches for g, k in zip(grids, n) if int(k) > 0)


# ----------------------------------------------------------- conversions


def test_to_torch_f32_roundtrip_shares_memory():
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    t = to_torch(x)
    assert t.dtype == torch.float32 and t.data_ptr() == x.ctypes.data
    np.testing.assert_array_equal(from_torch(t), x)
    assert to_torch(t) is t


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn"])
def test_to_torch_low_precision_bit_exact(name):
    """ml_dtypes arrays (the JAX package's bf16 / fp8 grids) cross with
    their bits unchanged, the same bits the JAX package's to_torch gives."""
    x = np.linspace(-3, 3, 64, dtype=np.float32).astype(getattr(ml_dtypes, name))
    t = to_torch(x)
    assert t.dtype == getattr(torch, name)
    int_type = np.int16 if name == "bfloat16" else np.uint8
    assert np.array_equal(t.view(getattr(torch, np.dtype(int_type).name)).numpy(), x.view(int_type))
    assert torch.equal(t.float(), jax_interop.to_torch(jnp.asarray(x)).float())
    np.testing.assert_array_equal(from_torch(t), x.astype(np.float32))


def test_to_torch_copies_a_read_only_array():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    x.flags.writeable = False
    t = to_torch(x)
    t[0, 0] = 99.0
    assert float(x[0, 0]) == 0.0 and float(t[0, 0]) == 99.0


def test_from_torch_detaches_and_upcasts():
    t = torch.linspace(-1, 1, 16, dtype=torch.bfloat16)
    arr = from_torch(t)
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, t.float().numpy())
    g = torch.ones(3, requires_grad=True) * 2
    assert from_torch(g).tolist() == [2.0, 2.0, 2.0]
    np.testing.assert_array_equal(from_torch(g), jax_interop.from_torch(g))


# ------------------------------------------------------------- the stream


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dataset_equals_jax_dataset(library, out_dtype):
    ds = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=8, unknown=True, out_dtype=out_dtype,
                          device="cpu")
    jds = jax_interop.VoxelGridDataset(library, SYMBOLS, JSpec(0.5, 16), batch_size=8, unknown=True,
                                       out_dtype=out_dtype)
    got, want = list(ds), list(jds)
    assert len(got) == len(want) == 3
    for (g, n), (wg, wn) in zip(got, want):
        assert g.dtype == getattr(torch, out_dtype) and g.shape == (8, 5, 16, 16, 16) and g.device.type == "cpu"
        assert n.dtype == torch.int64 and torch.equal(n, wn.long())
        ref = wg.float().numpy()
        tol = 1e-5 if out_dtype == "float32" else 2**-7 * max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=tol)
    counts = torch.cat([n for _, n in got])
    assert int((counts > 0).sum()) == RECORDS - 2


def test_dataset_equals_voxelize_batch(library):
    """The dataset's grids are voxelize_batch's on the feeder's batch."""
    (got, _), = list(VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=RECORDS, device="cpu"))
    (batch,) = list(SDFBatchFeeder(library, SYMBOLS, batch_size=RECORDS))
    want = voxelize_batch(torch.from_numpy(batch.coords), torch.from_numpy(batch.weights),
                          torch.ones(batch.padded_atoms), torch.from_numpy(batch.mask),
                          torch.from_numpy(batch.centers), None, 0.0, spec=GridSpec(0.5, 16))
    assert torch.equal(got, want)


def test_dataset_augmentation_is_seeded_per_epoch(library):
    def grids(ds):
        return torch.cat([g for g, _ in ds])

    kw = dict(batch_size=8, augment=True, random_translation=0.5, seed=3, device="cpu")
    a = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), **kw)
    b = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), **kw)
    first = grids(a)
    assert torch.equal(first, grids(b))  # same seed, same epoch
    assert not torch.equal(first, grids(a))  # the next pass is the next epoch
    plain = grids(VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=8, device="cpu"))
    assert not torch.equal(first, plain)


def test_dataset_worker_striping_no_duplication(library, monkeypatch):
    """Two simulated DataLoader workers cover the file disjointly."""
    class Info:
        def __init__(self, wid, n):
            self.id, self.num_workers = wid, n

    whole = _molecule_sums(VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=4, device="cpu"))
    parts = []
    for wid in range(2):
        monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda w=wid: Info(w, 2))
        ds = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=4, device="cpu",
                              feeder_kwargs={"shards": 4})
        part = _molecule_sums(ds)
        assert part
        parts += part
    assert len(whole) == RECORDS - 2
    np.testing.assert_allclose(sorted(parts), whole, rtol=1e-6)


def test_dataloader_spawned_workers_cover_the_file_once(library):
    ds = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=4, device="cpu", shuffle=True, seed=5,
                          feeder_kwargs={"shards": 6})
    whole = _molecule_sums(VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=4, device="cpu"))
    loader = DataLoader(ds, batch_size=None, num_workers=2, multiprocessing_context="spawn")
    for epoch in range(2):
        ds.set_epoch(epoch)
        np.testing.assert_allclose(_molecule_sums(loader), whole, rtol=1e-6)


def test_dataset_shuffle_reorders_per_epoch(library):
    ds = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=2, shuffle=True, seed=3, device="cpu",
                          feeder_kwargs={"shards": 5})
    orders = []
    for _ in range(3):  # three epochs, each complete
        counts = torch.cat([n for _, n in ds])
        assert int((counts > 0).sum()) == RECORDS - 2
        orders.append(counts.tolist())
    assert len({tuple(o) for o in orders}) > 1


def test_dataset_set_epoch_drives_the_shuffle(library):
    ds = VoxelGridDataset(library, SYMBOLS, GridSpec(0.5, 16), batch_size=2, shuffle=True, seed=11, device="cpu",
                          feeder_kwargs={"shards": 5})
    ds.set_epoch(0)
    f0 = ds._feeder(0, 1, ds._epoch)
    ds.set_epoch(3)
    f3 = ds._feeder(0, 1, ds._epoch)
    assert f0.shuffle_seed == 11 and f3.shuffle_seed == 14
    jds = jax_interop.VoxelGridDataset(library, SYMBOLS, JSpec(0.5, 16), batch_size=2, shuffle=True, seed=11,
                                       feeder_kwargs={"shards": 5})
    assert jds._feeder(0, 1, 3).shuffle_seed == f3.shuffle_seed
    ds.set_epoch(5)
    assert sum(int((n > 0).sum()) for _, n in ds) == RECORDS - 2


def test_dataset_on_cuda_without_a_card_raises(library, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VoxelGridDataset(library, SYMBOLS)


# -------------------------------------------------------------- the store


@pytest.fixture(scope="module")
def store(library, tmp_path_factory):
    from molvoxel_torch.cli import main as cli_main

    root = tmp_path_factory.mktemp("store") / "store"
    rc = cli_main(["voxelize", str(library), "-o", str(root), "--dimension", "16", "--batch", "8",
                   "--out-dtype", "bfloat16", "--device", "cpu"])
    assert rc == 0
    return root


def test_grid_store_dataset_items(store):
    ds = GridStoreDataset(store)
    reader = GridShardReader(store)
    jds = jax_interop.GridStoreDataset(store)
    assert len(ds) == len(jds) == RECORDS and ds.channels == jds.channels == SYMBOLS
    for i in range(RECORDS):
        g, n = ds[i]
        jg, jn = jds[i]
        assert g.dtype == torch.bfloat16 and g.shape == (4, 16, 16, 16) and n == jn
        assert torch.equal(g.view(torch.int16), reader[i].view(torch.int16))
        assert torch.equal(g.view(torch.int16), jg.view(torch.int16))
    assert ds[3][1] == 0 and ds[14][1] == 0  # the all-hydrogen and the empty record


def test_grid_store_dataset_shuffling_workers(store):
    ds = GridStoreDataset(store)
    ds[0]  # the reader's mmaps are open in this process; workers reopen the store
    seen, atoms = 0, []
    loader = DataLoader(ds, batch_size=4, shuffle=True, num_workers=2, multiprocessing_context="spawn",
                        generator=torch.Generator().manual_seed(0))
    for grids, counts in loader:
        assert grids.shape[1:] == (4, 16, 16, 16) and grids.dtype == torch.bfloat16
        seen += grids.shape[0]
        atoms += counts.tolist()
    assert seen == RECORDS
    assert sorted(atoms) == sorted(int(n) for n in GridShardReader(store).num_atoms())
