"""Device idle share of the traced window, in %: see _device_idle.py."""

from benchmark.metrics._device_idle import read  # noqa: F401
