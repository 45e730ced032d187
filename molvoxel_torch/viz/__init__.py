from .atom_colors import ELEMENT_COLORS, atom_color, channel_color
from .dx import read_dx, write_channels_dx, write_dx, write_grid_to_dx_file
from .pymol_session import Visualizer

__all__ = [
    "ELEMENT_COLORS",
    "atom_color",
    "channel_color",
    "read_dx",
    "write_channels_dx",
    "write_dx",
    "write_grid_to_dx_file",
    "Visualizer",
]
