"""The protein-ligand complex workflow in PyTorch: wrapper, grid, session.

The torch counterpart of examples/voxelize_complex.py: a ``ComplexWrapper``
over a ligand and its pocket voxelizes atom-type and bond channels at 48^3,
res 0.5 (on the card through the forward kernel, csrc/deposit_fwd.cu),
saves the image, and writes a PyMOL session (or, without PyMOL, a ``.pml``
script and one OpenDX volume per channel).

The complex is the golden of tests/goldens/pocket_types_gaussian.npz: its
first 61 atoms are the ligand and the other 407 the pocket, with
coordinates and element types but no bonds.  The JAX example reads the
same complex from an SDF and a PDB file, whose ligand bonds fill the four
bond channels; here those channels stay zero, and the eight atom-type
channels are the golden's.

Run:  python examples/torch_voxelize_complex.py [output_dir]              (the card)
      python examples/torch_voxelize_complex.py [output_dir] --device cpu
"""

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from molvoxel_torch import create_voxelizer  # noqa: E402
from molvoxel_torch.data import (  # noqa: E402
    AtomTypeGetter,
    BondTypeGetter,
    ComplexPointCloudMaker,
    ComplexWrapper,
    SimpleMolecule,
)
from molvoxel_torch.viz import Visualizer  # noqa: E402

COMPLEX = ROOT / "tests" / "goldens" / "pocket_types_gaussian.npz"
SYMBOLS = ["C", "N", "O", "S"]


def golden_complex() -> tuple[SimpleMolecule, SimpleMolecule, np.ndarray]:
    """(ligand, pocket, center): the golden's first 61 atoms (types 0-3) and
    the other 407 (types 4-7) as molecules of C, N, O and S, and its grid
    center."""
    g = np.load(COMPLEX)
    sym = np.asarray(SYMBOLS)
    t = g["channels"].astype(np.int64)
    coords = g["coords"].astype(np.float64)
    ligand = SimpleMolecule(coords[:61], list(sym[t[:61]]), [], "ligand")
    pocket = SimpleMolecule(coords[61:], list(sym[t[61:] - 4]), [], "pocket")
    return ligand, pocket, g["center"]


def main(out=None, device="cuda") -> tuple[torch.Tensor, torch.Tensor, Path]:
    """Voxelize the golden complex into ``out`` (a new temporary directory
    when None); returns (image, augmented image, session path).  Fails
    unless two augmented runs with the same seed give the same grid."""
    ligand, pocket, center = golden_complex()
    # the JAX example's channel layout: ligand atom and bond types, pocket atom types
    atom_getter = AtomTypeGetter(SYMBOLS)
    maker = ComplexPointCloudMaker(atom_getter, BondTypeGetter.default(), atom_getter, None, channel_type="features")
    voxelizer = create_voxelizer(resolution=0.5, dimension=48, density_type="gaussian", device=device)
    wrapper = ComplexWrapper(maker, voxelizer, visualizer=Visualizer())
    out = Path(out) if out is not None else Path(tempfile.mkdtemp(prefix="molvoxel_torch_complex_"))
    out.mkdir(parents=True, exist_ok=True)

    image = wrapper.run(ligand, pocket, center=center, radii=1.0)
    print(f"image: {tuple(image.shape)}, occupied voxels: {int((image > 0.1).sum())}")

    np.savez_compressed(out / "complex.npz", image=image.cpu().numpy(), channels=np.asarray(maker.channels))
    result = wrapper.visualize(str(out / "complex.pse"), ligand, pocket, image, center)
    print(f"session artifacts: {result}")

    # reproducible augmentation: the same seed -> the same transform
    aug1 = wrapper.run(ligand, pocket, center=center, radii=1.0, random_translation=0.5, random_rotation=True, key=7)
    aug2 = wrapper.run(ligand, pocket, center=center, radii=1.0, random_translation=0.5, random_rotation=True, key=7)
    assert torch.equal(aug1, aug2), "the same seed must give the same grid"
    print("augmentation reproducible by seed: OK")
    return image, aug1, result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help="output directory (default: a new temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.out, args.device)
