"""molvoxel_torch.parallel.stream against the JAX package, on the CPU.

``StreamingVoxelizer.run_batches`` grids equal the JAX package's at 1e-5
(no augmentation: the PRNG streams differ by design); checkpoint and
resume; ``stream_checksum`` (witness and full read, compact and wire,
per-type radii) equal to the JAX package's at rtol 1e-5, and to the sum of
the port's own grids (the mesh route: tests/test_torch_parallel.py).  Dims 16,
records synthesized from the golden ligand.  Also the timing helpers.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.data.feed import SDFBatchFeeder
from molvoxel_torch.parallel import StreamingVoxelizer, stream_checksum
from molvoxel_torch.utils import timing
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.data.feed import SDFBatchFeeder as JFeeder
from molvoxel_tpu.parallel.stream import StreamingVoxelizer as JStreamingVoxelizer
from molvoxel_tpu.parallel.stream import stream_checksum as jax_stream_checksum

SYMBOLS = ["C", "N", "O", "S"]
SPEC, JSPEC = GridSpec(0.5, 16), JSpec(0.5, 16)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    path = tmp_path_factory.mktemp("lib") / "lib.sdf"
    return chip_smoke.write_library(path, 24, seed=5, all_h_at=2, empty_at=9)


def _clouds(rng, n, c=3):
    out = []
    for _ in range(n):
        v = int(rng.integers(5, 30))
        out.append((rng.uniform(-3, 3, size=(v, 3)).astype(np.float32),
                    rng.uniform(0, 1, size=(v, c)).astype(np.float32)))
    return out


def _inputs_of(batches):
    """{coords, centers, weights} of a stream's batches, concatenated."""
    return {k: np.concatenate([np.asarray(getattr(b, k)) for b in batches]) for k in ("coords", "centers", "weights")}


def _mismatch_report(got, want, tol, got_batches, want_batches, shown=12):
    """Where two packages' grids differ beyond ``tol``: the molecules, the
    worst voxels (molecule, channel, d, h, w: port / JAX) and, for each
    molecule, whether the two packages' inputs (coords, centers, weights)
    agree, with those inputs."""
    bad = np.argwhere(np.abs(got - want) > tol)
    mols = sorted(set(bad[:, 0].tolist()))
    worst = bad[np.argsort(-np.abs(got - want)[tuple(bad.T)])[:shown]]
    lines = [f"{len(bad)} voxels beyond {tol:g} in molecules {mols}"]
    lines += [f"  voxel {tuple(v)}: port {got[tuple(v)]!r} jax {want[tuple(v)]!r}" for v in worst.tolist()]
    mine, theirs = _inputs_of(got_batches), _inputs_of(want_batches)
    for m in mols:
        same = {k: bool(np.array_equal(mine[k][m], theirs[k][m])) for k in mine}
        lines.append(f"  molecule {m}: inputs equal {same}")
        lines += [f"    {k}: port {mine[k][m].tolist()} jax {theirs[k][m].tolist()}" for k in mine]
    return "\n".join(lines)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_run_batches_equal_jax(out_dtype, library):
    """Grids of the feeder stream: 1e-5 (f32) or 2^-7 x max (bf16).  On a
    failure the report names the molecules, the voxels and both packages'
    inputs."""
    got, want, got_batches, want_batches = [], [], [], []
    sv = StreamingVoxelizer(SPEC, out_dtype=out_dtype, device="cpu")
    stats = sv.run_batches(SDFBatchFeeder(library, SYMBOLS, batch_size=8),
                           lambda im, b: (got.append(im.float()), got_batches.append(b)))
    JStreamingVoxelizer(JSPEC, out_dtype=out_dtype).run_batches(
        JFeeder(library, SYMBOLS, batch_size=8),
        lambda im, b: (want.append(np.asarray(im, np.float32)), want_batches.append(b)))
    got, want = torch.cat(got).numpy(), np.concatenate(want)
    assert got.shape == want.shape == (24, 4, 16, 16, 16)
    assert stats.molecules == 22 and stats.batches == 3
    tol = 1e-5 if out_dtype == "float32" else 2**-7 * max(float(np.abs(want).max()), 1.0)
    if not np.all(np.abs(got - want) <= tol):
        pytest.fail(_mismatch_report(got, want, tol, got_batches, want_batches))
    assert (got[2] == 0).all() and (got[9] == 0).all()  # the all-H and the empty record


def test_mismatch_report_names_molecules_voxels_and_inputs(library):
    """The report test_run_batches_equal_jax gives on a failure."""
    batches = list(SDFBatchFeeder(library, SYMBOLS, batch_size=8))
    want = np.zeros((24, 4, 2, 2, 2), np.float32)
    got = want.copy()
    got[5, 1, 0, 1, 1] = 3e-5
    other = [dataclasses.replace(b, coords=b.coords + (i == 0)) for i, b in enumerate(batches)]
    report = _mismatch_report(got, want, 1e-5, batches, other)
    assert "1 voxels beyond 1e-05 in molecules [5]" in report
    assert "voxel (5, 1, 0, 1, 1): port" in report
    assert "molecule 5: inputs equal {'coords': False, 'centers': True, 'weights': True}" in report


def test_run_from_clouds_equal_jax(rng):
    clouds = _clouds(rng, 7)
    got, want = [], []
    StreamingVoxelizer(SPEC, batch_size=3, device="cpu").run(clouds, lambda im, b: got.append(im))
    JStreamingVoxelizer(JSPEC, batch_size=3).run(clouds, lambda im, b: want.append(np.asarray(im)))
    np.testing.assert_allclose(torch.cat(got).numpy(), np.concatenate(want), rtol=0, atol=1e-5)


def test_checkpoint_and_resume(rng, tmp_path):
    """The manifest {"molecules_done", "ts"}; a restart skips the molecules
    done, and the resumed grids equal the uninterrupted run's tail."""
    clouds = _clouds(rng, 10)
    ckpt = tmp_path / "ckpt.json"
    full = []
    StreamingVoxelizer(SPEC, batch_size=2, device="cpu").run(clouds, lambda im, b: full.append(im))
    first = StreamingVoxelizer(SPEC, batch_size=2, device="cpu", checkpoint_path=ckpt, checkpoint_every=1)
    stats = first.run(clouds[:6])
    manifest = json.loads(ckpt.read_text())
    assert manifest["molecules_done"] == 6 == stats.molecules and set(manifest) == {"molecules_done", "ts"}
    rest = []
    stats = StreamingVoxelizer(SPEC, batch_size=2, device="cpu", checkpoint_path=ckpt).run(
        clouds, lambda im, b: rest.append(im))
    assert stats.skipped == 6 and stats.molecules == 4
    assert json.loads(ckpt.read_text())["molecules_done"] == 10
    np.testing.assert_array_equal(torch.cat(rest).numpy(), torch.cat(full)[6:].numpy())


def test_slab_mode_equals_full(rng):
    clouds = _clouds(rng, 4)
    full, sliced = [], []
    StreamingVoxelizer(SPEC, batch_size=4, device="cpu", random_rotation=True, seed=3).run(
        clouds, lambda im, b: full.append(im))
    StreamingVoxelizer(SPEC, batch_size=4, device="cpu", random_rotation=True, seed=3, slab_depth=8).run(
        clouds, lambda im, b: sliced.append(im))
    np.testing.assert_array_equal(sliced[0].numpy(), full[0].numpy())


CHECKSUM_CASES = {
    "full": dict(),
    "witness": dict(witness=True),
    "wire": dict(wire=True),
    "wire_witness": dict(wire=True, witness=True),
    "radii_by_type": dict(radii_by_type=(0.9, 1.2, 1.4, 1.7)),
    "radii_by_type_wire": dict(radii_by_type=(0.9, 1.2, 1.4, 1.7), wire=True),
    "bf16": dict(out_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CHECKSUM_CASES))
def test_stream_checksum_equal_jax(case, library):
    """rtol 1e-5 against the JAX package's fused step on the same compact
    batches (no augmentation)."""
    kw = CHECKSUM_CASES[case]
    batches = list(SDFBatchFeeder(library, SYMBOLS, batch_size=8, compact=True))
    stats, got = stream_checksum(iter(batches), SPEC, chunk=4, device="cpu", **kw)
    _, want = jax_stream_checksum(iter(batches), JSPEC, chunk=4, **kw)
    assert stats.molecules == 22 and stats.batches == 3
    assert got == pytest.approx(want, rel=1e-5)


def test_stream_checksum_native_wire_and_grid_sum(library):
    """The pre-packed wire of iter_wire gives the JAX package's checksum,
    and the full checksum is the sum of run_batches' grids (rtol 1e-5)."""
    wires = list(SDFBatchFeeder(library, SYMBOLS, batch_size=8).iter_wire(SPEC))
    _, got = stream_checksum(iter(wires), SPEC, chunk=4, wire=True, device="cpu")
    _, want = jax_stream_checksum(iter(wires), JSPEC, chunk=4, wire=True)
    assert got == pytest.approx(want, rel=1e-5)
    total = []
    StreamingVoxelizer(SPEC, batch_size=8, device="cpu").run_batches(
        SDFBatchFeeder(library, SYMBOLS, batch_size=8), lambda im, b: total.append(float(im.double().sum())))
    _, full = stream_checksum(SDFBatchFeeder(library, SYMBOLS, batch_size=8, compact=True), SPEC, chunk=8,
                              device="cpu")
    assert full == pytest.approx(sum(total), rel=1e-5)
    with pytest.raises(ValueError, match="wire=True"):
        stream_checksum(iter(wires), SPEC, chunk=4, device="cpu")


def test_stream_checksum_augmented_equals_dense_path(library):
    """With rotation on, the checksum equals the port's own dense path under
    a generator replaying the same draws (chunk by chunk)."""
    from molvoxel_torch.ops.batch import voxelize_batch

    (batch,) = list(SDFBatchFeeder(library, SYMBOLS, batch_size=24, compact=True))
    _, got = stream_checksum(iter([batch]), SPEC, chunk=8, random_rotation=True, random_translation=0.4, seed=4,
                             device="cpu")
    gen = torch.Generator().manual_seed(4)
    t = torch.as_tensor(batch.types).long()
    want = 0.0
    for c0 in range(0, 24, 8):
        sl = slice(c0, c0 + 8)
        w = (t[sl, :, None] == torch.arange(4)).float()
        out = voxelize_batch(torch.as_tensor(batch.coords[sl]), w, torch.ones(t.shape[1]), t[sl] >= 0,
                             torch.as_tensor(batch.centers[sl]), gen, 0.4, spec=SPEC, random_rotation=True)
        want += float(out.double().sum())
    assert got == pytest.approx(want, rel=1e-5)


def test_stream_rejects_what_it_cannot_run(library):
    batches = list(SDFBatchFeeder(library, SYMBOLS, batch_size=8))
    with pytest.raises(ValueError, match="compact"):
        stream_checksum(iter(batches), SPEC, chunk=4, device="cpu")
    compact = list(SDFBatchFeeder(library, SYMBOLS, batch_size=8, compact=True))
    with pytest.raises(ValueError, match="multiple of chunk"):
        stream_checksum(iter(compact), SPEC, chunk=3, device="cpu")
    with pytest.raises(ValueError, match="slab_depth"):  # the mesh route runs: tests/test_torch_parallel.py
        StreamingVoxelizer(SPEC, device="cpu", slab_depth=5).run_batches(iter(batches))


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingVoxelizer(SPEC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_checksum(iter([]), SPEC)


def test_timing_helpers(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.measure_device_fn(lambda i: None)
    with timing.trace(str(tmp_path / "t" / "trace.json")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0 and prof is not None
