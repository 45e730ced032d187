"""molvoxel_torch.parallel.stream_dp_multiprocess over two gloo ranks on the CPU.

Two fresh interpreters (tests/torch_dist_worker.py) stream a synthesized
library (zero-atom records among its 33) striped between them into per-rank
grid stores at 16^3: the manifests name their rank; each rank's rows are its
stripe's records, bit for bit the single-process stream over that stripe;
together they hold every record, and their grid sum is the JAX package's at
rtol 1e-5.  A run whose ranks crash after one flushed batch and restart with
``resume=True`` ends with stores equal, bit for bit, to the uninterrupted
augmented run's.  A one-rank group runs in this process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.data.feed import SDFBatchFeeder
from molvoxel_torch.data.gridstore import read_grid_shards
from molvoxel_torch.parallel import StreamingVoxelizer, make_mesh, stream_dp_multiprocess
from molvoxel_torch.parallel.multihost import step_generator
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.data.feed import SDFBatchFeeder as JFeeder
from molvoxel_tpu.ops.batch import voxelize_batch as jax_voxelize_batch

from .torch_dist_worker import run_ranks

SPEC = GridSpec(0.5, 16)
SYMBOLS = ["C", "N", "O", "S"]
RECORDS = 33  # striped 17 / 16: the ranks drain a step apart
STRIPE = dict(batch_size=4, bucket=64, target_shard_bytes=512)  # the worker's feed


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return chip_smoke.write_library(tmp_path_factory.mktemp("mp") / "lib.sdf", RECORDS, seed=4, all_h_at=5,
                                    empty_at=17)


@pytest.fixture(scope="module")
def uninterrupted(library, tmp_path_factory):
    out = tmp_path_factory.mktemp("full")
    outs = run_ranks("stream", 2, library, out)
    return out, outs


@pytest.fixture(scope="module")
def crashed_and_resumed(library, tmp_path_factory):
    out = tmp_path_factory.mktemp("resumed")
    crashed = run_ranks("crash", 2, library, out, 1)
    manifests = [json.loads((out / "aug" / f"proc-{r:03d}" / "manifest.json").read_text()) for r in range(2)]
    resumed = run_ranks("resume", 2, library, out)
    return out, crashed, manifests, resumed


def _stripe_grids(library, rank, world):
    """The single-process stream over one rank's stripe."""
    grids = []
    feeder = SDFBatchFeeder(library, SYMBOLS, batch_size=STRIPE["batch_size"], bucket=STRIPE["bucket"],
                            span_offset=rank, span_stride=world, target_shard_bytes=STRIPE["target_shard_bytes"])
    StreamingVoxelizer(SPEC, batch_size=4, device="cpu").run_batches(feeder, lambda im, b: grids.append(im))
    return torch.cat(grids)[:feeder.records_fed]


def test_two_rank_stores_name_their_rank_and_hold_every_record(uninterrupted):
    out, outs = uninterrupted
    records = 0
    for rank in range(2):
        grids, manifest = read_grid_shards(out / "plain" / f"proc-{rank:03d}")
        assert manifest["process_index"] == rank and manifest["num_processes"] == 2 and manifest["final"]
        assert grids.shape[0] == manifest["num_molecules"] > 0
        records += manifest["num_molecules"]
    assert records == RECORDS  # the all-hydrogen and the empty record keep their slots
    molecules = [int(text.split("plain molecules=")[1].split()[0]) for text in outs]
    batches = [int(text.split("plain molecules=")[1].split()[1].removeprefix("batches=")) for text in outs]
    assert sum(molecules) == RECORDS - 2 and batches == [5, 4]  # rank 1 fed one all-padding step


def test_two_rank_stores_equal_the_single_process_stripes(uninterrupted, library):
    out, _ = uninterrupted
    for rank in range(2):
        grids, _ = read_grid_shards(out / "plain" / f"proc-{rank:03d}")
        assert torch.equal(grids, _stripe_grids(library, rank, 2))


def test_two_rank_store_sum_equals_jax(uninterrupted, library):
    out, _ = uninterrupted
    total = sum(float(read_grid_shards(out / "plain" / f"proc-{r:03d}")[0].double().sum()) for r in range(2))
    want = 0.0
    for b in JFeeder(library, SYMBOLS, batch_size=4, bucket=64):
        want += float(np.asarray(jax_voxelize_batch(
            jnp.asarray(b.coords), jnp.asarray(b.weights), jnp.ones((64,), jnp.float32), jnp.asarray(b.mask),
            jnp.asarray(b.centers), jax.random.split(jax.random.PRNGKey(0), b.batch_size), 0.0, spec=JSpec(0.5, 16),
        ), np.float64).sum())
    assert total == pytest.approx(want, rel=1e-5)


def test_crash_leaves_a_provisional_prefix(crashed_and_resumed):
    _, crashed, manifests, _ = crashed_and_resumed
    for rank, (text, m) in enumerate(zip(crashed, manifests)):
        assert f"CRASHED rank={rank} after=1" in text
        assert m["final"] is False and m["num_molecules"] == 4 and m["process_index"] == rank


def test_resumed_run_equals_the_uninterrupted_run(crashed_and_resumed, uninterrupted):
    """Augmented (rotation and translation): the resumed stores equal the
    uninterrupted run's bit for bit, so the resumed steps drew what the
    uninterrupted ones drew."""
    out, _, _, resumed = crashed_and_resumed
    full, _ = uninterrupted
    for rank, text in enumerate(resumed):
        assert "skipped=4" in text.split(f"STREAM rank={rank}")[1]
        got, m = read_grid_shards(out / "aug" / f"proc-{rank:03d}")
        want, _ = read_grid_shards(full / "aug" / f"proc-{rank:03d}")
        assert m["final"] is True and torch.equal(got, want)
        plain, _ = read_grid_shards(full / "plain" / f"proc-{rank:03d}")
        assert not torch.equal(got, plain)  # the augmentation was on


@pytest.fixture
def one_rank():
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_one_rank_stream_equals_the_plain_stream(one_rank, library, tmp_path):
    consumed = []
    stats = stream_dp_multiprocess(library, SYMBOLS, SPEC, mesh=one_rank, batch_size=8, bucket=64,
                                   store_root=tmp_path / "store", consumer=lambda im, b: consumed.append(im))
    grids, manifest = read_grid_shards(tmp_path / "store" / "proc-000")
    assert manifest["process_index"] == 0 and manifest["num_processes"] == 1
    assert stats.molecules == RECORDS - 2 and stats.batches == 5 and grids.shape[0] == RECORDS
    want = []
    StreamingVoxelizer(SPEC, batch_size=8, device="cpu").run_batches(
        SDFBatchFeeder(library, SYMBOLS, batch_size=8, bucket=64), lambda im, b: want.append(im))
    assert torch.equal(grids, torch.cat(want)[:RECORDS])
    assert torch.equal(torch.cat(consumed), torch.cat(want))


def test_one_rank_augmentation_follows_the_step_generator(one_rank, library, tmp_path):
    """Step k's transforms are step_generator(seed, k)'s draws for the batch."""
    from molvoxel_torch.ops.batch import voxelize_batch

    got = []
    stream_dp_multiprocess(library, SYMBOLS, SPEC, mesh=one_rank, batch_size=8, bucket=64, random_rotation=True,
                           random_translation=0.5, seed=3, consumer=lambda im, b: got.append(im))
    for step, b in enumerate(SDFBatchFeeder(library, SYMBOLS, batch_size=8, bucket=64)):
        want = voxelize_batch(torch.from_numpy(b.coords), torch.from_numpy(b.weights), torch.ones(64),
                              torch.from_numpy(b.mask), torch.from_numpy(b.centers), step_generator(3, step), 0.5,
                              spec=SPEC, random_rotation=True)
        assert torch.equal(got[step], want)


def test_stream_rejects_resume_without_a_store(one_rank, library):
    with pytest.raises(ValueError, match="store_root"):
        stream_dp_multiprocess(library, SYMBOLS, SPEC, mesh=one_rank, resume=True)
