"""GROUP-BY partial aggregation (segagg): two Hopper kernels and their plain version."""
