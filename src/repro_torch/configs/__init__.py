"""The ten architecture configurations (pure data, one module per arch)."""
