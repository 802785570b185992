"""Mamba-2 SSD (state-space duality) forward: a Hopper kernel and its plain version."""
