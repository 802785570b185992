"""Choice between the two segagg kernels for one call shape.

``narrow`` (a shared-memory table per block, the counterpart of the JAX
package's one-hot matmul kernel) serves narrow G; ``scatter`` (global
atomics into an L2-resident output) serves wide G.  ``MATMUL_MAX_G`` is the
largest group count still sent to ``narrow``; it is measured on the H100 by
``chip_smoke.py`` (its crossover table).  ``narrow`` also needs its (G, V)
f32 table to fit ``NARROW_TABLE_BYTES`` of shared memory.  Nothing else
limits ``scatter``: the reference's VMEM guard, which sent wide-G queries to
the O(N*G) one-hot path on the TPU, has no counterpart here.
"""
from __future__ import annotations

from .segagg import NARROW_TABLE_BYTES

# Shape-class boundaries (rows / groups), as in the reference.
_N_SMALL = 32_768
_G_NARROW = 1_024

# Largest G sent to the narrow kernel (the reference's XLA crossover was 64).
# Measured on an H100 SXM (700 W) by chip_smoke.py's crossover table, V = 1,
# uniform keys: at 1.26M rows narrow wins up to G = 2048 and loses from 4096
# (each block's final flush costs G*V global atomics); at 29.25M rows it wins
# at every G its table holds.
MATMUL_MAX_G = 2048


def shape_class(n: int, g: int) -> str:
    """Coarse (rows x groups) regime bucket: small/large x narrow/wide."""
    rows = "small" if n <= _N_SMALL else "large"
    width = "narrow" if g <= _G_NARROW else "wide"
    return f"{rows}-{width}"


def narrow_fits(g: int, v: int) -> bool:
    """Does the narrow kernel's (g, v) f32 table fit its shared memory?"""
    return g * v * 4 <= NARROW_TABLE_BYTES


def pick_formulation(g: int, v: int) -> str:
    """``narrow`` or ``scatter`` for a (G, V) output."""
    if g <= MATMUL_MAX_G and narrow_fits(g, v):
        return "narrow"
    return "scatter"
