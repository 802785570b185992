"""Choice of the segagg kernel, and of its launch, for one call shape.

``narrow`` (a shared-memory table per block, the counterpart of the JAX
package's one-hot matmul kernel) serves narrow G; ``scatter`` serves wide G.
``matmul_max_g(backend)`` is the largest group count still sent to
``narrow``, and ``tuned_blocks(backend, n, g)`` the scatter plan's launch
parameters for a shape class.  Both come from ``tuned_blocks.json`` next to
this module, which ``scripts/torch_hillclimb.py --segagg`` measures on the
card and writes through ``save``; a missing file or entry falls back to the
compiled-in defaults (``DEFAULT_MATMUL_MAX_G``, ``SCATTER_CLUSTER_SIZES[0]``
and ``SCATTER_MAX_RANGES``), so the package works untuned.  The backend key
of the card is ``"cuda"``.  ``narrow`` also needs its (G, V) f32 table to
fit ``NARROW_TABLE_BYTES`` of shared memory.  The reference's VMEM guard,
which sent wide-G queries to the O(N*G) one-hot path on the TPU, has no
counterpart here.

``scatter_plan`` lays out a ``scatter`` call: the f32 table of the flat
(G, V) index is cut into key ranges that each fit the pooled shared memory
of one thread-block cluster (route ``cluster``), or, past ``max_ranges``
ranges, the call goes to the global-atomic kernel (route ``atomic``), whose
(G, V) output lives in L2.  It is a pure function of the shape and of what
the card reports, so the CPU tests reach every branch; it never catches a
failed build or launch.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Dict, Optional, Tuple

TUNED_PATH = pathlib.Path(__file__).resolve().parent / "tuned_blocks.json"

# Shared-memory table of the narrow kernel: the default dynamic limit.
NARROW_TABLE_BYTES = 48 * 1024

# Shape-class boundaries (rows / groups), as in the reference.
_N_SMALL = 32_768
_G_NARROW = 1_024

# Largest G sent to the narrow kernel where no table says otherwise: all its
# 48 KB table holds at V = 1 (the reference's XLA crossover was 64).
# scripts/torch_hillclimb.py --segagg (H100 SXM, 700 W, V = 1, uniform
# keys, medians of 25 calls) had narrow ahead of scatter at every such G at
# 13,000, 1.26M and 29.25M rows.
DEFAULT_MATMUL_MAX_G = 12288


def shape_class(n: int, g: int) -> str:
    """Coarse (rows x groups) regime bucket: small/large x narrow/wide."""
    rows = "small" if n <= _N_SMALL else "large"
    width = "narrow" if g <= _G_NARROW else "wide"
    return f"{rows}-{width}"


def narrow_fits(g: int, v: int) -> bool:
    """Does the narrow kernel's (g, v) f32 table fit its shared memory?"""
    return g * v * 4 <= NARROW_TABLE_BYTES


@functools.lru_cache(maxsize=1)
def _load() -> Dict:
    try:
        return json.loads(TUNED_PATH.read_text())
    except (OSError, ValueError):
        return {}


def reload() -> None:
    """Drop the cached table (after the hill-climb rewrites the file)."""
    _load.cache_clear()


def tuned_blocks(backend: str, n: int, g: int) -> Tuple[int, int]:
    """(cluster, max_ranges) of the scatter plan for a call shape, tuned
    entry or defaults.  They stand where the reference's (block_n, block_g)
    stand: the cluster size ``scatter_plan`` tries first, and the most key
    ranges it takes before the global-atomic route."""
    entry = _load().get("blocks", {}).get(f"{backend}:{shape_class(n, g)}")
    if entry:
        return int(entry["cluster"]), int(entry["max_ranges"])
    return SCATTER_CLUSTER_SIZES[0], SCATTER_MAX_RANGES


def matmul_max_g(backend: str) -> int:
    """Largest group count at which the narrow kernel is still selected
    (the measured narrow/scatter crossover for ``backend``)."""
    entry = _load().get("crossover", {}).get(backend)
    if entry:
        return int(entry["matmul_max_g"])
    return DEFAULT_MATMUL_MAX_G


def pick_formulation(backend: str, n: int, g: int, v: int,
                     override: Optional[str] = None) -> str:
    """``narrow`` or ``scatter`` for one call shape.  ``override`` takes the
    reference's names: ``"matmul"`` forces the narrow kernel (a table that
    does not fit its shared memory raises), ``"scatter"`` the scatter."""
    if override is not None:
        if override not in ("matmul", "scatter"):
            raise ValueError(f"unknown segagg formulation: {override!r} "
                             "(expected 'matmul' or 'scatter')")
        if override == "scatter":
            return "scatter"
        if not narrow_fits(g, v):
            raise ValueError(
                f"formulation='matmul': a ({g}, {v}) f32 table exceeds the narrow "
                f"kernel's {NARROW_TABLE_BYTES} bytes of shared memory")
        return "narrow"
    if g <= matmul_max_g(backend) and narrow_fits(g, v):
        return "narrow"
    return "scatter"


def save(table: Dict) -> pathlib.Path:
    """Persist a tuned table (the hill-climb writes through this) and
    reload."""
    TUNED_PATH.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    reload()
    return TUNED_PATH


# Cluster sizes the cluster route takes, in order of preference at equal
# range counts: 8 is portable; 16 needs the non-portable attribute, which the
# card may refuse (the caller passes max_cluster_blocks = 8 then).  At CQ3's
# largest batches 8 beat 16 (PERF.md, scripts/torch_segagg_phases.py); at
# its one- and two-file batches 16 won (tuned_blocks.json, small-wide).
SCATTER_CLUSTER_SIZES = (8, 16)
# Floats of a table chunk (one 32-byte sector); ranges are whole chunks.
SCATTER_CHUNK = 8
# Most key ranges the cluster route takes.  Each range's clusters read every
# row; at CQ4's shape two ranges and four both lost to the global-atomic
# kernel (PERF.md, scripts/torch_segagg_phases.py), so a table that needs two
# goes to it.
SCATTER_MAX_RANGES = 1
# The cluster kernel's block (one an SM), the mail a block sends in one round
# (two of each thread's four elements), and the rounds of inboxes in flight
# (csrc/segagg.cu).
SCATTER_THREADS = 1024
SCATTER_ROUND = 2 * SCATTER_THREADS
SCATTER_BUFFERS = 3
# An inbox segment (one source block, one round) holds at least half the
# entries a uniform key mix sends it (SCATTER_ROUND / cluster); mail past its
# capacity goes to the output by global atomics.  A judgment, not measured:
# the measured plans had 1.06 to 4.7 times that mean.
SCATTER_MIN_FILL = 0.5


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How one ``scatter`` call runs.  ``route`` is ``"cluster"`` or
    ``"atomic"``; for ``cluster``: ``cluster`` blocks a cluster, ``ranges``
    the [lo, hi) key ranges over the flat index [0, G*V), each
    ``range_len`` floats (the last one cut at G*V), ``slice_chunks`` chunks
    of ``SCATTER_CHUNK`` floats of table in each block, and ``capacity``
    inbox entries a source block and round."""
    route: str
    cluster: int = 0
    range_len: int = 0
    ranges: Tuple[Tuple[int, int], ...] = ()
    slice_chunks: int = 0
    capacity: int = 0

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block: its table slice, its inboxes and
        the counts (``cluster_smem_bytes`` in csrc/segagg.cu)."""
        return cluster_smem_bytes(self.cluster, self.slice_chunks, self.capacity)


def cluster_smem_bytes(cluster: int, slice_chunks: int, capacity: int) -> int:
    """Table slice, inboxes of (position, value) entries, entry counts and
    send counters of one block."""
    return (slice_chunks * SCATTER_CHUNK * 4
            + SCATTER_BUFFERS * cluster * capacity * 8
            + (SCATTER_BUFFERS + 2) * cluster * 4)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _layout(chunks: int, ranges: int, cluster: int, smem_per_block: int):
    """(slice_chunks, capacity) of ``ranges`` ranges over ``chunks`` table
    chunks in clusters of ``cluster``, or None if the table and inboxes of
    enough capacity do not fit ``smem_per_block``."""
    slice_chunks = _ceil_div(_ceil_div(chunks, ranges), cluster)
    room = smem_per_block - cluster_smem_bytes(cluster, slice_chunks, 0)
    capacity = min(SCATTER_ROUND, room // (SCATTER_BUFFERS * cluster * 8))
    if capacity < SCATTER_MIN_FILL * SCATTER_ROUND / cluster:
        return None
    return slice_chunks, capacity


def scatter_plan(g: int, v: int, max_cluster_blocks: int, smem_per_block: int,
                 max_ranges: int = SCATTER_MAX_RANGES,
                 sizes: Tuple[int, ...] = SCATTER_CLUSTER_SIZES) -> ScatterPlan:
    """The ``scatter`` layout of a (g, v) f32 output on a card whose
    clusters take up to ``max_cluster_blocks`` blocks, each with up to
    ``smem_per_block`` bytes of shared memory: the fewest key ranges whose
    table slice and inboxes fit, then the first cluster size of ``sizes``
    that reaches them; ``atomic`` past ``max_ranges`` ranges.  A
    measurement may ask for more ranges or other sizes than the defaults."""
    chunks = _ceil_div(g * v, SCATTER_CHUNK)
    sizes = [c for c in sizes if c <= max_cluster_blocks]
    for count in range(1, max_ranges + 1):
        for size in sizes:
            layout = _layout(chunks, count, size, smem_per_block)
            if layout is None:
                continue
            range_len = _ceil_div(chunks, count) * SCATTER_CHUNK
            return ScatterPlan(
                "cluster", cluster=size, range_len=range_len,
                ranges=tuple((i * range_len, min(g * v, (i + 1) * range_len))
                             for i in range(count)),
                slice_chunks=layout[0], capacity=layout[1])
    return ScatterPlan("atomic")


def scatter_clusters(active_clusters: int, num_ranges: int) -> int:
    """Clusters to launch: the ``active_clusters`` the card runs at once
    (``cudaOccupancyMaxActiveClusters``), and at least one per range."""
    return max(active_clusters, num_ranges)
