"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy, computed in float64.  Nothing here imports
``jax``, the JAX package or ``molvoxel_torch``, and nothing takes what the
port has made: the reference draws each augmentation again from its key
(``recipe.py``) and deposits every molecule pair by pair (``grid.py``).
The molecules are the benchmark's own, handed to both sides.
"""
