from .dx import read_dx, write_channels_dx, write_dx, write_grid_to_dx_file

__all__ = ["read_dx", "write_channels_dx", "write_dx", "write_grid_to_dx_file"]
