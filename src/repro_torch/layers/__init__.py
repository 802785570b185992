"""Model layers: norms, RoPE and MLPs, attention, the RG-LRU."""
