"""End-to-end training demo in PyTorch: the voxelizer inside the train step.

The torch counterpart of examples/train_cnn.py.  A tiny 3-D CNN learns to
count nitrogen atoms from voxel grids; every step voxelizes a fresh batch,
each molecule under its own random rotation and translation, through
``ops.batch.voxelize_batch`` (on the card the forward kernel,
csrc/deposit_fwd.cu).  As in the JAX example only the CNN's parameters are
trained, so the grids carry no gradient and no deposit backward runs.

The data are the JAX example's: 256 random molecules of 8-20 atoms from
numpy's ``default_rng(0)``, two channels (not-N, N), label = the N count.
Batches are picked by numpy, augmentation comes from a ``torch.Generator``
and the initial weights from ``torch.manual_seed``.  ``load_flax_params``
carries the JAX example's flax parameters into this model.

Run:  python examples/torch_train_cnn.py                 (the card)
      python examples/torch_train_cnn.py --device cpu --steps 30
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from molvoxel_torch.core import GridSpec  # noqa: E402
from molvoxel_torch.nn import _same_pad  # noqa: E402  (flax's SAME padding)
from molvoxel_torch.ops.batch import voxelize_batch  # noqa: E402

SPEC = GridSpec(resolution=0.5, dimension=16)
BATCH, VP, C = 16, 128, 2  # channels: C-like, N-like


def make_dataset(rng, n=256):
    """Random 'molecules': 8-20 atoms, channel 1 marks nitrogens; the label
    is the nitrogen count.  numpy arrays, drawn as the JAX example draws them."""
    coords = np.zeros((n, VP, 3), np.float32)
    weights = np.zeros((n, VP, C), np.float32)
    mask = np.zeros((n, VP), bool)
    labels = np.zeros((n,), np.float32)
    for i in range(n):
        v = int(rng.integers(8, 21))
        coords[i, :v] = rng.normal(scale=1.5, size=(v, 3))
        is_n = rng.uniform(size=v) < 0.3
        weights[i, :v, 0] = ~is_n
        weights[i, :v, 1] = is_n
        mask[i, :v] = True
        labels[i] = is_n.sum()
    return coords, weights, mask, labels


def voxelize(coords, weights, mask, generator=None, transforms=None):
    """(B, C, 16, 16, 16) grids, gaussian at sigma 0.5, each molecule under a
    random rotation and a translation of up to 0.5 A drawn from
    ``generator`` (or the explicit (quaternions, translations) pair)."""
    radii = torch.ones(coords.shape[1], device=coords.device)
    return voxelize_batch(coords, weights, radii, mask, None, generator, 0.5, spec=SPEC, sigma=0.5,
                          random_rotation=True, transforms=transforms)


class VoxelCNN(nn.Module):
    """The JAX example's network: two stride-2 3x3x3 convolutions with ReLU,
    then Dense(32) + ReLU and Dense(1) over the flattened features."""

    def __init__(self, in_channels: int = C, dim: int = SPEC.dimension):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv3d(in_channels, 8, 3, stride=2), nn.Conv3d(8, 16, 3, stride=2)])
        out = -(-dim // 4)  # two stride-2 SAME convolutions
        self.hidden = nn.Linear(16 * out**3, 32)
        self.head = nn.Linear(32, 1)

    def forward(self, x):  # (B, C, D, H, W)
        for conv in self.convs:
            pads = [p for size in reversed(x.shape[2:]) for p in _same_pad(size)]  # F.pad: last axis first
            x = F.relu(conv(F.pad(x, pads)))
        x = F.relu(self.hidden(x.flatten(1)))
        return self.head(x)[:, 0]


def load_flax_params(model: VoxelCNN, params) -> VoxelCNN:
    """Load the JAX example's flax parameters (``Conv_0``, ``Conv_1``,
    ``Dense_0``, ``Dense_1``; with or without the ``"params"`` level) into
    ``model``.  flax flattens channels-last (B, D', H', W', C) and torch
    (B, C, D', H', W'), so ``Dense_0``'s rows are permuted, not just
    transposed."""
    params = params.get("params", params)
    state = {}
    for i in range(2):
        conv = params[f"Conv_{i}"]  # kernel (kd, kh, kw, in, out)
        state[f"convs.{i}.weight"] = torch.as_tensor(np.asarray(conv["kernel"]).transpose(4, 3, 0, 1, 2).copy())
        state[f"convs.{i}.bias"] = torch.as_tensor(np.asarray(conv["bias"]).copy())
    kernel = np.asarray(params["Dense_0"]["kernel"])  # (D' H' W' C, 32), rows in (d, h, w, c) order
    c_out = model.convs[-1].out_channels
    side = round((kernel.shape[0] // c_out) ** (1 / 3))
    kernel = kernel.reshape(side, side, side, c_out, -1).transpose(3, 0, 1, 2, 4).reshape(kernel.shape)
    state["hidden.weight"] = torch.as_tensor(kernel.T.copy())
    state["hidden.bias"] = torch.as_tensor(np.asarray(params["Dense_0"]["bias"]).copy())
    state["head.weight"] = torch.as_tensor(np.asarray(params["Dense_1"]["kernel"]).T.copy())
    state["head.bias"] = torch.as_tensor(np.asarray(params["Dense_1"]["bias"]).copy())
    model.load_state_dict(state)
    return model


def main(steps: int = 60, device="cuda") -> tuple[float, float, float]:
    """Train with Adam at 1e-3; returns (mean MSE of the first 10 steps, of
    the last 10, median host ms of a step after the first two).  Fails
    unless the loss falls below 0.8x its start."""
    dev = torch.device(device)
    coords, weights, mask, labels = (torch.as_tensor(a, device=dev) for a in make_dataset(np.random.default_rng(0)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VoxelCNN().to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    augment = torch.Generator().manual_seed(42)
    pick = np.random.default_rng(42)
    losses, step_ms = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        idx = torch.as_tensor(pick.choice(coords.shape[0], BATCH, replace=False), device=dev)
        grids = voxelize(coords[idx], weights[idx], mask[idx], augment)
        loss = F.mse_loss(model(grids), labels[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step % 10 == 0:
            print(f"step {step:3d}  mse {losses[-1]:.3f}")

    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"mse: first-10 {first:.3f} -> last-10 {last:.3f}")
    assert last < first * 0.8, "training should reduce the loss"
    print("OK: the voxelizer trains end-to-end inside the train step")
    return first, last, statistics.median(step_ms[2:])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.steps, args.device)
