"""Distributed helpers of the port (shard extents only, so far)."""
