"""forward_batch's one-pass staging and the pinned ring (molvoxel_torch/data/staging.py), on the CPU.

The batch ``forward_batch`` hands to ``voxelize_batch`` must be, bit for bit,
what the JAX package's ``pad_point_clouds`` and ``types_to_onehot`` make,
whichever placement writes it (per-molecule slices, or one gather), and so
must the port's ``pad_point_clouds`` and ``iter_batches``, which write
through the same ``stage_batch``; the ring reuses a slot only
after the event behind its last copy has completed, and counts its
allocations and waits while a profiler records.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import molvoxel_torch
import molvoxel_torch.ops.batch as batch_ops
from molvoxel_torch.data import pipeline, staging
from molvoxel_torch.utils import timing
from molvoxel_tpu.data import pipeline as jax_pipeline
from molvoxel_tpu.data.pipeline import pad_point_clouds, types_to_onehot

C = 3
SIZES = {
    "ragged_small": (5, 0, 40, 33, 61),  # a molecule of zero atoms; 28 atoms a molecule
    "ragged_large": (300, 0, 521, 410),  # 308 a molecule
    "one_size": (37, 37, 37),
}


def _clouds(sizes, kind, as_torch, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for v in sizes:
        crd = rng.normal(scale=3.0, size=(v, 3)).astype(np.float32)
        ch = rng.integers(0, C, v) if kind == "types" else rng.uniform(size=(v, C)).astype(np.float32)
        out.append((torch.as_tensor(crd), torch.as_tensor(ch)) if as_torch else (crd, ch))
    return out


def _radii(kind, sizes, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "scalar":
        return 0.9
    if kind == "per_molecule":
        return [rng.uniform(0.5, 1.5, v).astype(np.float32) for v in sizes]
    return rng.uniform(0.5, 1.5, C).astype(np.float32)  # channel-wise


def _numpy(a, dtype=None):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a if dtype is None else a.astype(dtype)


def _reference(clouds, radii, centers, num_channels, typed):
    """The padded batch as forward_batch built it before the one-pass staging."""
    if typed:
        types = [_numpy(ch) for _, ch in clouds]
        c = num_channels if num_channels is not None else max(int(t.max()) + 1 for t in types if t.size)
        clouds = [(_numpy(crd, np.float32), types_to_onehot(t, c)) for (crd, _), t in zip(clouds, types)]
    else:
        clouds = [(_numpy(crd, np.float32), _numpy(ch, np.float32)) for crd, ch in clouds]
    batch = pad_point_clouds(clouds, centers=centers)
    b, vp = batch.batch_size, batch.padded_atoms
    if isinstance(radii, float):
        radii_arr = np.full((vp,), radii, np.float32)
    elif isinstance(radii, list):
        radii_arr = np.ones((b, vp), np.float32)
        for i, r in enumerate(radii):
            radii_arr[i, : r.shape[0]] = r
    else:
        radii_arr = _numpy(radii, np.float32)
    return batch.coords, batch.weights, radii_arr, batch.mask, batch.centers


@contextlib.contextmanager
def _captured(monkeypatch):
    """forward_batch's arguments to voxelize_batch, in place of voxelizing."""
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return torch.zeros(1)

    monkeypatch.setattr(batch_ops, "voxelize_batch", capture)
    yield calls


@pytest.fixture(params=["slices", "gather"])
def placement(request, monkeypatch):
    monkeypatch.setattr(staging, "GATHER_MAX_ATOMS", -1 if request.param == "slices" else 10**9)
    return request.param


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("with_centers", [False, True], ids=["no_centers", "centers"])
@pytest.mark.parametrize("radii_kind", ["scalar", "per_molecule", "channel_wise"])
@pytest.mark.parametrize("channels", ["types_c_given", "types_c_inferred", "features"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_staged_batch_is_the_padded_batch_bit_for_bit(monkeypatch, placement, sizes, channels, radii_kind,
                                                      with_centers, as_torch):
    typed = channels != "features"
    sizes = SIZES[sizes]
    clouds = _clouds(sizes, "types" if typed else "features", as_torch)
    radii = _radii(radii_kind, sizes)
    rng = np.random.default_rng(2)
    centers = [rng.normal(size=3) for _ in sizes] if with_centers else None
    num_channels = C if channels == "types_c_given" else None
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=16, device="cpu",
                                          radii_type="channel-wise" if radii_kind == "channel_wise" else "scalar")
    with _captured(monkeypatch) as calls:
        vox.forward_batch(clouds, radii=radii, centers=centers, num_channels=num_channels)
    (coords, weights, radii_t, mask, centers_t, *_), kw = calls[0]
    want = _reference(clouds, radii, centers, num_channels, typed)
    got = (coords, weights, radii_t, mask, centers_t)
    for name, g, w in zip(("coords", "weights", "radii", "mask", "centers"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.from_numpy(w).dtype and tuple(g.shape) == w.shape, name
        assert g.is_contiguous(), name
        assert np.array_equal(g.numpy().view(np.uint8), np.ascontiguousarray(w).view(np.uint8)), name
    assert kw["radii_batched"] == (radii_kind == "per_molecule")
    assert kw["channelwise"] == (radii_kind == "channel_wise")


def _same_batch(got, want):
    """Two ``PaddedBatch``es field by field, bit for bit."""
    for field in ("coords", "weights", "mask", "radii", "centers", "num_atoms", "types", "num_channels"):
        g, w = getattr(got, field), getattr(want, field)
        if not isinstance(w, np.ndarray):
            assert g == w, field
            continue
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(np.ascontiguousarray(g).view(np.uint8), w.view(np.uint8)), field


# (route, per-molecule radii, centers): iter_batches takes neither radii nor centers
PAD_CASES = [("pad", radii, centers) for radii in ("none", "scalar", "array") for centers in (False, True)]
PAD_CASES.append(("iter_batches", "none", False))


@pytest.mark.parametrize("route,radii_kind,with_centers", PAD_CASES, ids=["-".join(map(str, c)) for c in PAD_CASES])
@pytest.mark.parametrize("bucket", [None, 640], ids=["bucket_inferred", "bucket_given"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_pad_point_clouds_and_iter_batches_equal_the_jax_package(placement, sizes, bucket, route, radii_kind,
                                                                 with_centers):
    """``pad_point_clouds`` (through ``stage_batch``) against the JAX
    package's: per-molecule radii as scalars or (V_i,) arrays, a given
    bucket, centers; and ``iter_batches`` over the same molecules in
    batches of 2, its short tail filled with empty molecules or dropped."""
    sizes = SIZES[sizes]
    clouds = _clouds(sizes, "features", False)
    if route == "iter_batches":
        for drop in (False, True):
            got = list(pipeline.iter_batches(iter(clouds), 2, bucket=bucket, drop_remainder=drop))
            want = list(jax_pipeline.iter_batches(iter(clouds), 2, bucket=bucket, drop_remainder=drop))
            assert len(got) == len(want) == (len(sizes) // 2 if drop else -(-len(sizes) // 2))
            for g, w in zip(got, want):
                _same_batch(g, w)
        return
    rng = np.random.default_rng(3)
    radii = {"none": None, "scalar": [float(r) for r in rng.uniform(0.5, 1.5, len(sizes))],
             "array": [rng.uniform(0.5, 1.5, v).astype(np.float32) for v in sizes]}[radii_kind]
    centers = [rng.normal(size=3) for _ in sizes] if with_centers else None
    kw = dict(radii=radii, centers=centers, bucket=bucket)
    _same_batch(pipeline.pad_point_clouds(clouds, **kw), jax_pipeline.pad_point_clouds(clouds, **kw))


def test_both_placements_meet_in_the_benchmarks_shapes():
    """The crossover puts many small molecules on the gather and large ones
    on the slices: 64 ligands of 20-61 atoms, 16 complexes of 3,323."""
    assert 61 <= staging.GATHER_MAX_ATOMS < 3323


@pytest.mark.parametrize("bad", [-1, -C, C, -C - 1], ids=["minus_one", "minus_c", "c", "below_minus_c"])
def test_a_type_outside_the_channels_indexes_as_types_to_onehot(monkeypatch, placement, bad):
    """A negative type counts from the end; one of C or more, or below -C,
    raises IndexError, as ``types_to_onehot``'s fancy index does."""
    clouds = _clouds((4, 6), "types", False)
    clouds[1][1][2] = bad
    try:
        want = types_to_onehot(clouds[1][1], C)
    except IndexError:
        want = None
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    with _captured(monkeypatch) as calls:
        if want is None:
            with pytest.raises(IndexError):
                vox.forward_batch(clouds, num_channels=C)
            return
        vox.forward_batch(clouds, num_channels=C)
    weights = calls[0][0][1]
    assert torch.equal(weights[1, :6], torch.from_numpy(want))


def test_centers_must_match_the_molecules():
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    with pytest.raises(ValueError, match="centers"):
        vox.forward_batch(_clouds((4, 6), "types", False), centers=[np.zeros(3)])


def test_two_cpu_calls_share_no_storage():
    """Each CPU call writes a fresh buffer: neither the grids nor the staged
    inputs of one call share memory with another's, and a later call leaves
    an earlier result as it was."""
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    kw = dict(random_rotation=True, random_translation=0.5, num_channels=C)
    first = vox.forward_batch(_clouds((20, 30), "types", False, seed=3), key=1, **kw)
    kept = first.clone()
    second = vox.forward_batch(_clouds((25, 12), "types", False, seed=4), key=2, **kw)
    assert first.untyped_storage().data_ptr() != second.untyped_storage().data_ptr()
    assert torch.equal(first, kept)
    assert first.abs().sum() > 0 and not torch.equal(first, second)


def test_two_cpu_calls_stage_into_separate_buffers(monkeypatch):
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    with _captured(monkeypatch) as calls:
        vox.forward_batch(_clouds((20, 30), "types", False), num_channels=C)
        vox.forward_batch(_clouds((20, 30), "types", False), num_channels=C)
    a, b = (call[0][0].untyped_storage() for call in calls)
    assert a.data_ptr() != b.data_ptr()
    assert vox._ring is None  # nothing pinned, no ring, on the CPU


def test_the_payload_counts_no_alignment_gap():
    layout = staging.batch_layout(3, 32, 3, (32,), True)
    # coords, weights, radii, mask, centers; the gaps that align each section are not payload
    assert layout.payload == 3 * 32 * 3 * 4 + 3 * 32 * 3 * 4 + 32 * 4 + 3 * 32 + 3 * 3 * 4
    starts = [s[3] for s in layout.sections]
    assert all(s % staging.ALIGN == 0 for s in starts)
    assert layout.total % staging.ALIGN == 0 and layout.total >= layout.sections[-1][4]
    assert staging.batch_layout(3, 32, 3, (32,), True) is layout  # one layout a shape


# ------------------------------------------------------------------ the ring


class StandInEvent:
    """An event whose ``record``/``query``/``synchronize`` calls are logged in
    ``log``; it completes only when told (``done``) or synchronised."""

    log: list = []

    def __init__(self):
        self.done = False
        self.name = f"e{sum(1 for x in StandInEvent.log if x[0] == 'new')}"
        StandInEvent.log.append(("new", self.name))

    def record(self, stream=None):
        self.done = False
        StandInEvent.log.append(("record", self.name))

    def query(self):
        StandInEvent.log.append(("query", self.name))
        return self.done

    def synchronize(self):
        StandInEvent.log.append(("synchronize", self.name))
        self.done = True


@pytest.fixture
def ring():
    StandInEvent.log = []
    return staging.PinnedRing(2, "cpu", event=StandInEvent)


def _layout(n):
    return staging.Layout.of([((n, 3), np.float32), ((n,), np.bool_)])


def _use(ring, layout, value=0.0):
    """One call's use of a slot: write, send, give back; the device views."""
    with ring.taken(layout) as staged:
        staged.arrays[0][...] = value
        staged.arrays[1][...] = True
        return ring.send(staged)


def test_a_slot_is_written_again_only_after_its_event(ring):
    _use(ring, _layout(4))
    _use(ring, _layout(4))
    assert [s.event.name for s in ring.slots] == ["e0", "e1"]
    StandInEvent.log.clear()
    with ring.taken(_layout(4)) as staged:  # slot 0 again: the work behind its event has not finished
        assert staged.slot is ring.slots[0]
        assert StandInEvent.log == [("query", "e0"), ("synchronize", "e0")]
    assert StandInEvent.log[-1] == ("record", "e0")  # given back behind this call's work
    StandInEvent.log.clear()
    ring.slots[1].event.done = True
    with ring.taken(_layout(4)) as staged:
        assert staged.slot is ring.slots[1]
    assert StandInEvent.log == [("query", "e1"), ("record", "e1")]  # finished: no wait


def test_send_copies_the_slot_into_its_device_buffer_with_views_made_once(ring):
    four = _layout(4)
    first = _use(ring, four, 1.5)
    assert torch.equal(first[0], torch.full((4, 3), 1.5)) and first[1].dtype == torch.bool and bool(first[1].all())
    assert first[0].untyped_storage().data_ptr() != ring.slots[0].host.untyped_storage().data_ptr()
    _use(ring, four)
    again = _use(ring, four, 2.5)  # slot 0, the same layout: its views serve again, refilled
    assert again[0] is first[0] and torch.equal(first[0], torch.full((4, 3), 2.5))
    _use(ring, _layout(4))
    grown = _use(ring, _layout(9), 3.5)  # slot 0 grows: new buffers, new views
    assert grown[0].shape == (9, 3) and torch.equal(grown[0], torch.full((9, 3), 3.5))


def test_a_slot_goes_back_when_its_block_fails(ring):
    with pytest.raises(RuntimeError):
        with ring.taken(_layout(4)):
            raise RuntimeError("the writer failed")
    assert not any(s.busy for s in ring.slots) and ring.slots[0].event is not None


def test_the_ring_counts_allocations_and_waits_while_a_profiler_records(ring):
    with timing.span("molvoxel.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (4, 4, 4, 9):  # two slots made, a wait on the first, a wait on and a growth of the second
            _use(ring, _layout(n))
    counters = timing.snapshot()["counters"]
    assert counters["molvoxel.staging_allocs"] == 3
    assert counters["molvoxel.staging_waits"] == 2
    assert ring.slots[1].host.numel() >= _layout(9).total
    waits = [e for e in StandInEvent.log if e[0] == "synchronize"]
    assert waits == [("synchronize", "e0"), ("synchronize", "e1")]


def test_the_ring_counts_nothing_untraced(ring):
    before = timing.snapshot()["counters"]
    for n in (4, 4, 4):
        _use(ring, _layout(n))
    assert not timing.recording()
    assert timing.snapshot()["counters"] == before


def test_a_slot_being_written_is_passed_over_and_the_ring_grows(ring):
    with ring.taken(_layout(4)) as held:  # another thread is still writing this one
        with ring.taken(_layout(4)) as second, ring.taken(_layout(4)) as third:
            assert len({id(held.slot), id(second.slot), id(third.slot)}) == 3 and len(ring.slots) == 3
    assert not any(s.busy for s in ring.slots)


def test_slots_taken_from_many_threads_are_never_shared(ring):
    seen, lock, errors = [], threading.Lock(), []

    def work(k):
        try:
            for _ in range(50):
                with ring.taken(_layout(8)) as staged:
                    staged.arrays[0][...] = k
                    with lock:
                        seen.append(staged.slot)
                    views = ring.send(staged)
                    assert (staged.arrays[0] == k).all() and bool((views[0] == k).all())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and len(seen) == 400


def test_stage_packs_arrays_as_the_stream_sends_them(ring, monkeypatch):
    """``stage`` (the stream's use), on a CPU stand-in of the card's copy."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    arrays = [np.arange(12, dtype=np.float32).reshape(4, 3), np.array([[1, -1, 3]], np.int8),
              np.array([True, False, True])]
    views, event = ring.stage(arrays)
    assert event is ring.slots[0].event and not ring.slots[0].busy
    for v, a in zip(views, arrays):
        assert np.array_equal(v.numpy(), a) and v.numpy().dtype == a.dtype
    # the stream's byte layout: each array at a multiple of 16, the copy a multiple of 16
    layout = staging.Layout.of((a.shape, a.dtype) for a in arrays)
    assert [s[3] for s in layout.sections] == [0, 48, 64] and layout.total == 80


def test_a_ring_on_the_cpu_pins_nothing(ring):
    with ring.taken(_layout(4)) as staged:
        assert staged.host.device.type == "cpu" and not staged.host.is_pinned()


@pytest.mark.parametrize("first_in_inference_mode", [True, False])
def test_a_slot_first_used_under_inference_mode_serves_normal_calls(ring, first_in_inference_mode):
    """A slot's buffers and views are normal tensors, whichever mode the call
    that made them ran in: an evaluation pass under ``torch.inference_mode()``
    and a normal call after it (or before it) both write and send the slot."""
    first, then = first_in_inference_mode, not first_in_inference_mode
    # both slots made in one mode, then reused in the other and back
    for value, inference in enumerate([first, first, then, then, first, first]):
        with torch.inference_mode(inference):
            views = _use(ring, _layout(4), float(value))
            assert torch.equal(views[0], torch.full((4, 3), float(value)))
    for slot in ring.slots:
        assert not slot.host.is_inference() and not slot.dev.is_inference()
        assert not any(v.is_inference() for v in slot.sent[3])
