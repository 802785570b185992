"""RG-LRU recurrence: a Hopper kernel and its plain version."""
