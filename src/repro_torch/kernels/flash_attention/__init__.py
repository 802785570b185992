"""Flash-attention forward: a Hopper kernel and its plain version."""
