"""Grid-based shape screening in PyTorch: rank a library by density overlap.

The torch counterpart of examples/screen_library.py: stream an SDF library
through ``data.SDFBatchFeeder`` and ``ops.batch.voxelize_batch`` (on the
card the forward kernel, csrc/deposit_fwd.cu) and score each molecule by
the cosine overlap of its grid with the query's, one matvec per batch on
the device.

The default library is the JAX example's, built with the same numpy draws:
the query (the golden ligand of tests/goldens/lig_types_gaussian.npz,
centred; the JAX example reads it from an SDF file and drops its
hydrogens), 4 jittered near-neighbours and ``n_decoys`` scrambled decoys.
The query must rank first and at least 3 neighbours must reach the top 5.
With ``library=`` a given SDF file is screened against its first record,
which must rank first; there each record is centred on its own centroid,
since a library's records need not share a frame.  Records without a C, N,
O or S atom score nothing and are left out.

Run:  python examples/torch_screen_library.py                 (the card)
      python examples/torch_screen_library.py --device cpu --n-decoys 6 --dim 16
      python examples/torch_screen_library.py --library lib.sdf
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from molvoxel_torch.core import GridSpec  # noqa: E402
from molvoxel_torch.data import SDFBatchFeeder, SimpleMolecule  # noqa: E402
from molvoxel_torch.data.parsers import write_sdf  # noqa: E402
from molvoxel_torch.ops.batch import voxelize_batch  # noqa: E402

DIM = 24
BATCH = 8
SYMBOLS = ["C", "N", "O", "S"]
LIGAND = ROOT / "tests" / "goldens" / "lig_types_gaussian.npz"


def query_molecule() -> SimpleMolecule:
    """The golden ligand (types 0-3 = C, N, O, S), centred."""
    g = np.load(LIGAND)
    coords = g["coords"].astype(np.float64)
    return SimpleMolecule(coords=coords - coords.mean(0), symbols=[SYMBOLS[t] for t in g["channels"]], bonds=[],
                          name="query")


def make_library(query: SimpleMolecule, path: Path, rng, n_decoys=30):
    """Query + jittered near-neighbors + scrambled decoys, one SDF."""
    records = [query]  # the query itself: must rank first
    for i in range(4):  # near-neighbors: small coordinate jitter
        records.append(SimpleMolecule(
            coords=query.coords + rng.normal(0, 0.15 + 0.1 * i, query.coords.shape),
            symbols=list(query.symbols), bonds=[], name=f"neighbor-{i}"))
    for i in range(n_decoys):  # decoys: same composition, scrambled shape
        records.append(SimpleMolecule(
            coords=rng.permutation(query.coords, axis=0) * rng.uniform(0.6, 1.4)
            + rng.normal(0, 1.5, query.coords.shape),
            symbols=list(query.symbols), bonds=[], name=f"decoy-{i}"))
    tmp = path.with_suffix(".tmp")
    parts = []
    for m in records:
        write_sdf(m, tmp)
        parts.append(tmp.read_bytes())
    path.write_bytes(b"".join(parts))
    tmp.unlink()
    return [m.name for m in records]


def grids_of(batch, spec: GridSpec, dev, center: bool) -> torch.Tensor:
    """(B, C * D * H * W) grids of a PaddedBatch: gaussian at sigma 0.5, no
    transform; each record centred on its centroid when ``center``, else
    the coordinates as the file gives them."""
    coords, weights, mask = (torch.as_tensor(a, device=dev) for a in (batch.coords, batch.weights, batch.mask))
    centers = torch.as_tensor(batch.centers, device=dev) if center else None
    radii = torch.ones(coords.shape[1], device=dev)
    return voxelize_batch(coords, weights, radii, mask, centers, spec=spec, sigma=0.5).reshape(coords.shape[0], -1)


def screen(path, spec: GridSpec, device="cuda", center: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Cosine overlap of every record of ``path`` that has atoms with the
    first record's grid: (scores, record indices), in file order."""
    dev = torch.device(device)
    query = grids_of(next(iter(SDFBatchFeeder(path, SYMBOLS, batch_size=1, shards=1))), spec, dev, center)[0]
    qnorm = torch.linalg.vector_norm(query)
    scores, keep = [], []
    for batch in SDFBatchFeeder(path, SYMBOLS, batch_size=BATCH):
        grids = grids_of(batch, spec, dev, center)
        # cosine overlap on the device: one (B, V) @ (V,) matvec per batch
        scores.append((grids @ query) / (torch.linalg.vector_norm(grids, dim=1) * qnorm + 1e-8))
        keep.append(batch.num_atoms > 0)  # padded rows and atom-less records score 0/0
    keep = np.concatenate(keep)
    return torch.cat(scores).cpu().numpy()[keep], np.nonzero(keep)[0]


def main(n_decoys: int = 30, dim: int = DIM, library=None, device="cuda"):
    """Screen the built library (or ``library``); returns (scores, names)
    of the records that have atoms, in file order."""
    spec = GridSpec(resolution=0.5, dimension=dim)
    with tempfile.TemporaryDirectory() as tmp:
        if library is None:
            path = Path(tmp) / "library.sdf"
            names = make_library(query_molecule(), path, np.random.default_rng(0), n_decoys=n_decoys)
        else:
            path, names = Path(library), None
        t0 = time.perf_counter()
        scores, records = screen(path, spec, device, center=library is not None)
        seconds = time.perf_counter() - t0
    names = [names[i] if names else f"record-{i}" for i in records]

    order = np.argsort(scores)[::-1]
    print("rank  score   molecule")
    for r, i in enumerate(order[:6]):
        print(f"{r + 1:4d}  {scores[i]:.4f}  {names[i]}")
    assert order[0] == 0 and records[0] == 0, "the query must rank itself first"
    print(f"\nscreened {len(scores)} molecules in {seconds:.3f} s; query ranked 1st")
    if library is None:
        top5 = sum(names[i].startswith("neighbor") for i in order[:5])
        assert top5 >= 3, "near-neighbors should dominate the top ranks"
        print(f"{top5}/4 neighbors in the top 5")
    return scores, names


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-decoys", type=int, default=30)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--library", help="an SDF file to screen against its first record")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.n_decoys, args.dim, args.library, args.device)
