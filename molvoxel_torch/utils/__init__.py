"""Utilities: device timing (utils/timing.py)."""
