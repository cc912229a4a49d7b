"""The "jax" backend: another name for the "device" backend (device.py)."""

from .device import decode, encode  # noqa: F401
