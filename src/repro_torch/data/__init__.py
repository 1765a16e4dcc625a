"""Synthetic tables generated on the device from a seed."""
