"""Gradient-based rigid-body pose recovery through the voxelizer, in PyTorch.

The torch counterpart of examples/pose_optimize.py.  Given only the target
density grid of a ligand in an unknown pose, recover the rigid transform
(quaternion, shift) by gradient descent through ``ops.voxelize.voxelize``.
On the card the gradient in the coordinates runs through the backward
kernel (csrc/deposit_bwd.cu); on the CPU through the dense path's autograd.

The ligand is the 61-atom golden of tests/goldens/lig_types_gaussian.npz,
centred, with one channel and radii 1.0 (the JAX example reads the same
ligand from an SDF file).  The hidden pose comes from numpy's
``default_rng(0)``: a quaternion shrunk toward the identity and a shift in
U(-0.8, 0.8) A.

Run:  python examples/torch_pose_optimize.py                    (the card)
      python examples/torch_pose_optimize.py --device cpu --steps 120 --dim 24
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from molvoxel_torch.core import GridSpec  # noqa: E402
from molvoxel_torch.core.transform import apply_quaternion  # noqa: E402
from molvoxel_torch.ops.voxelize import voxelize  # noqa: E402

LIGAND = ROOT / "tests" / "goldens" / "lig_types_gaussian.npz"
SIGMA = 1.0


def ligand_coords() -> np.ndarray:
    """(61, 3) float32 coordinates of the golden ligand, centred on their mean."""
    coords = np.load(LIGAND)["coords"]
    return (coords - coords.mean(0)).astype(np.float32)


def hidden_pose(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(quaternion (4,), shift (3,)) float32: a refinement-scale perturbation
    (the convex basin of a density-overlap objective), drawn from numpy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=3)
    q = np.array([np.sqrt(1 - u[0]) * np.sin(2 * np.pi * u[1]), np.sqrt(1 - u[0]) * np.cos(2 * np.pi * u[1]),
                  np.sqrt(u[0]) * np.sin(2 * np.pi * u[2]), np.sqrt(u[0]) * np.cos(2 * np.pi * u[2])])
    q = q * 0.25 + np.array([1.0, 0.0, 0.0, 0.0]) * 0.75  # shrink toward identity
    t = rng.uniform(-0.8, 0.8, 3)
    return (q / np.linalg.norm(q)).astype(np.float32), t.astype(np.float32)


def pose_coords(coords0: torch.Tensor, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return apply_quaternion(coords0, q / q.norm()) + t


def density(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """(1, D, H, W) grid of the ligand: one channel, radii 1.0, sigma 1.0."""
    ones = torch.ones(coords.shape[0], device=coords.device)
    return voxelize(coords, ones[:, None], ones, spec=spec, sigma=SIGMA)


def pose_loss(coords0, q, t, target, spec: GridSpec) -> torch.Tensor:
    return ((density(pose_coords(coords0, q, t), spec) - target) ** 2).mean() * 1e4


def rmsd(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b) ** 2).sum(-1).mean().sqrt())


def main(steps: int = 400, dim: int = 32, device="cuda") -> tuple[float, float]:
    """Recover the hidden pose with Adam at 3e-2; returns the RMSD (A)
    before and after.  Fails unless it ends below 0.05 A."""
    dev = torch.device(device)
    spec = GridSpec(resolution=0.5, dimension=dim)
    coords0 = torch.as_tensor(ligand_coords(), device=dev)
    q_true, t_true = (torch.as_tensor(a, device=dev) for a in hidden_pose(0))
    target_coords = pose_coords(coords0, q_true, t_true)
    target = density(target_coords, spec)

    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev, requires_grad=True)
    t = torch.zeros(3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([q, t], lr=3e-2)
    with torch.no_grad():
        r0 = rmsd(pose_coords(coords0, q, t), target_coords)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = pose_loss(coords0, q, t, target, spec)
        loss.backward()
        opt.step()
        if i % 50 == 0 or i == steps - 1:
            with torch.no_grad():
                r = rmsd(pose_coords(coords0, q, t), target_coords)
            print(f"step {i:4d}  loss {float(loss.detach()):9.5f}  rmsd {r:7.4f} A")
    with torch.no_grad():
        r1 = rmsd(pose_coords(coords0, q, t), target_coords)
        shift_err = float((t - t_true).norm())
    print(f"\npose recovered: RMSD {r0:.3f} -> {r1:.4f} A (shift error {shift_err:.4f} A)")
    assert r1 < 0.05, "pose optimization failed to converge"
    return r0, r1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.steps, args.dim, args.device)
