"""DeviceMesh: the scheduling-side facade over real torch devices.

The port of the JAX package's ``repro/dist/mesh.py``:

* ``DeviceMesh`` — a 1-D list of devices over the scheduling data axis.  It
  maps ``batch_shard_extents`` (the pool's 1-D batch splits) onto
  per-device row ranges, and runs ``segagg``/``pane_segagg`` as one
  equal-row shard per device, each on a CUDA stream of its own slot, with a
  final cross-device ``merge_panes`` combine on the first device.  A device
  may be listed more than once: ``["cpu"] * 4`` in the CPU tests,
  ``["cuda:0"] * 2`` on one card (two slots, two streams, one card).

* ``MeshBackend`` — a ``repro_torch.core.runtime.WorkerBackend`` with one
  worker per mesh slot whose clocks are stitched from MEASURED wall seconds
  instead of cost-model predictions.  It prefers GROUP dispatch: a
  ``PolicyDecision``'s whole shard group becomes one mesh call, so
  per-dispatch overhead is paid once per logical batch instead of once per
  shard (see ``ShardedCostModel`` for the planning-side view).

``values`` is never consumed: torch has no buffer donation, so a caller may
pass the same tensor again.  Padding rows (to make N divisible by the
device count) carry ``key == num_groups``, which every segagg kernel and
the plain version drop.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.runtime import Dispatch, WorkerBackend
from ..device import resolve_device
from ..kernels.segagg import ops
from .sharding import batch_shard_extents, fallback_event

DeviceSpec = Union[str, torch.device]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _device(spec: DeviceSpec) -> torch.device:
    """``spec`` resolved, with a CUDA device's index made explicit so that
    ``"cuda"`` and ``"cuda:0"`` name one card."""
    dev = resolve_device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A 1-D device mesh over the scheduling data axis.

    ``devices`` may be an int (``cuda:0`` .. ``cuda:k-1``), an explicit
    device sequence (repeats allowed, all CPU or all CUDA), or None for every
    visible card.  There is no CPU fallback: an int or None needs the cards.

    ``on_event`` (plus the ``events`` list) receives ``sharding_fallback``
    dicts whenever a batch dim stays replicated because the device count
    does not divide it — under-sharding is correct but slow, so it is
    reported, never silent.
    """

    def __init__(
        self,
        devices: Union[int, Sequence[DeviceSpec], None] = None,
        *,
        on_event: Optional[Callable[[Dict], None]] = None,
    ):
        if devices is None:
            resolve_device(None)  # raises without a card
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif isinstance(devices, int):
            if devices < 1:
                raise ValueError(f"need at least one device, got {devices}")
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if visible < devices:
                raise ValueError(
                    f"need {devices} CUDA devices but torch sees {visible}; "
                    f"pass an explicit device list to repeat one device, "
                    f"e.g. ['cuda:0'] * {devices} or ['cpu'] * {devices}")
            devs = [torch.device("cuda", i) for i in range(devices)]
        else:
            devs = [_device(d) for d in devices]
            if not devs:
                raise ValueError("need at least one device")
            if len({d.type for d in devs}) > 1:
                raise ValueError(f"a mesh is all CPU or all CUDA, got {devs}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.events: List[Dict] = []
        self._on_event = on_event
        # One stream per slot, also where a card is listed twice.
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                         for d in self.devices]

    # -- introspection ----------------------------------------------------
    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    def _emit(self, event: Dict) -> None:
        self.events.append(event)
        if self._on_event is not None:
            self._on_event(event)

    def synchronize(self) -> None:
        """Wait for every card of the mesh (no-op on the CPU)."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- extents <-> shardings --------------------------------------------
    def shard_extents(self, num_tuples: int) -> Tuple[Tuple[int, int], ...]:
        """The pool's 1-D batch split for this mesh: ``batch_shard_extents``
        over the device count.  When the count divides ``num_tuples`` these
        extents are EXACTLY the per-device rows of ``batch_sharding``."""
        return batch_shard_extents(num_tuples, self.num_devices)

    def batch_sharding(self, batch_rows: int,
                       ndim: int) -> Optional[Tuple[Tuple[int, int], ...]]:
        """Where dim 0 of a ``(batch_rows, ...)`` array of rank ``ndim`` lives:
        the (offset, rows) on each device when the device count divides
        ``batch_rows``, else None (replicated), with a ``sharding_fallback``
        event."""
        if ndim < 1:
            raise ValueError(f"a batch array has rank >= 1, got {ndim}")
        d = self.num_devices
        if batch_rows % d:
            self._emit(fallback_event(batch_rows, ("data",), d))
            return None
        rows = batch_rows // d
        return tuple((i * rows, rows) for i in range(d))

    # -- sharded kernels ---------------------------------------------------
    def segagg(self, keys, values, num_groups: int) -> torch.Tensor:
        """GROUP-BY partial aggregation sharded across the mesh: rows split
        over the devices, one ``ops.segagg`` per device on its slot's
        stream, partials merged on the first device.  Bit-compatible with
        the single-device op for integer-valued f32 inputs.  ``keys`` and
        ``values`` are numpy arrays or tensors; ``values`` is not
        consumed."""
        keys, values = _tensor(keys), _tensor(values)
        if values.dim() == 1:
            values = values[:, None]
        dev0 = self.devices[0]
        D = self.num_devices
        if D == 1:
            return ops.segagg(keys.to(dev0), values.to(dev0), num_groups)
        keys = keys.to(torch.int32)
        N, V = keys.shape[0], values.shape[1]
        Np = -(-max(N, 1) // D) * D
        if Np != N:
            keys = torch.cat(
                [keys, torch.full((Np - N,), num_groups, dtype=torch.int32,
                                  device=keys.device)])
            values = torch.cat(
                [values, torch.zeros((Np - N, V), dtype=values.dtype,
                                     device=values.device)])
        rows = Np // D
        caller = torch.cuda.current_stream(dev0) if dev0.type == "cuda" else None
        parts, done = [], []
        for i, (dev, stream) in enumerate(zip(self.devices, self._streams)):
            k, v = keys[i * rows:(i + 1) * rows], values[i * rows:(i + 1) * rows]
            if stream is None:
                parts.append(ops.segagg(k.to(dev), v.to(dev), num_groups).to(dev0))
                continue
            # The slot's stream starts after the caller's work on its device
            # (the inputs may come from it), runs the shard and moves the
            # partial to the first device; the caller waits on its event.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                part = ops.segagg(k.to(dev), v.to(dev), num_groups).to(dev0)
                event = torch.cuda.Event()
                event.record(stream)
            parts.append(part)
            done.append(event)
        for event, part in zip(done, parts):
            caller.wait_event(event)
            # A partial made on a slot stream of the first card is read on
            # the caller's: keep its memory until that read is done.
            part.record_stream(caller)
        return ops.merge_panes(torch.stack(parts))

    def pane_segagg(self, keys, values, pane_ids, num_panes: int,
                    num_groups: int) -> torch.Tensor:
        """Pane-partial aggregation sharded across the mesh, via the same
        composite-key reduction as the single-device op: (N,) keys +
        pane_ids -> (num_panes, num_groups, V) per-pane group sums."""
        values = _tensor(values)
        if values.dim() == 1:
            values = values[:, None]
        total = ops.pane_composite_groups(num_panes, num_groups)
        composite = (_tensor(pane_ids).to(torch.int32) * num_groups
                     + _tensor(keys).to(torch.int32))
        flat = self.segagg(composite, values, total)
        return flat.reshape(num_panes, num_groups, values.shape[1])


class MeshBackend(WorkerBackend):
    """Worker backend over a ``DeviceMesh``: one worker per mesh slot, clocks
    stitched from MEASURED wall seconds.

    The worker clocks still form the scheduling timeline (decision
    instants, waits, deadlines) — but every dispatch advances them by the
    measured duration of the real mesh call instead of a cost-model
    prediction, so traces ARE wall-clock and the cost models can be
    validated against them.

    ``prefers_group_dispatch``: the runtime loop hands a whole shard group
    to ``run_shard_group``, which runs the covering tuple range as ONE mesh
    call (``_group_execute``) — all claimed workers share its start/end.
    Subclasses implement the three physical hooks
    (``_batch_execute``/``_group_execute``/``_agg_execute``); see
    ``repro_torch.serve.analytics.MeshAnalyticsBackend`` for the serving
    one.  A hook returns only when the devices have finished its work, so
    the measured seconds cover the device work.

    ``worker_weights`` reports measured per-worker throughput ratios from
    SOLO dispatches (group calls are indivisible, so they do not
    attribute).  A homogeneous mesh stays all-1.0 (below the heterogeneity
    threshold), which keeps shard splits on the balanced default path.
    """

    prefers_group_dispatch = True

    #: measured max/min throughput ratio above which the mesh is reported
    #: heterogeneous (weighted shard extents kick in).  Below it, noise.
    heterogeneity_threshold = 1.25

    def __init__(self, mesh: DeviceMesh, names: Optional[Sequence[str]] = None):
        self.mesh = mesh
        if names is None:
            names = tuple(f"d{i}" for i in range(mesh.num_devices))
        elif len(names) != mesh.num_devices:
            raise ValueError(
                f"{len(names)} names for {mesh.num_devices} devices"
            )
        super().__init__(names)
        self._solo_tuples: Dict[str, float] = {n: 0.0 for n in names}
        self._solo_secs: Dict[str, float] = {n: 0.0 for n in names}

    # -- measured heterogeneity -------------------------------------------
    @property
    def worker_weights(self) -> Tuple[float, ...]:
        tp = []
        for n in self.worker_names:
            if self._solo_secs[n] <= 0.0 or self._solo_tuples[n] <= 0.0:
                return (1.0,) * len(self.worker_names)
            tp.append(self._solo_tuples[n] / self._solo_secs[n])
        if max(tp) < self.heterogeneity_threshold * min(tp):
            return (1.0,) * len(self.worker_names)
        mean = sum(tp) / len(tp)
        return tuple(t / mean for t in tp)

    # -- dispatch ----------------------------------------------------------
    def _charge(self, query, dt: float) -> None:
        self.wall_seconds[query.query_id] = (
            self.wall_seconds.get(query.query_id, 0.0) + dt
        )

    def run_batch(self, query, num_tuples, offset, worker):
        start = self._clocks[worker]
        t0 = time.perf_counter()
        self._batch_execute(query, num_tuples, offset)
        dt = time.perf_counter() - t0
        self.last_batch_wall = dt
        self._charge(query, dt)
        self._solo_tuples[worker] += num_tuples
        self._solo_secs[worker] += dt
        end = start + dt
        self._clocks[worker] = end
        return Dispatch(worker=worker, start=start, end=end), dt

    def run_shard_group(self, query, sizes, base_offset, workers):
        # The group call cannot start before the LAST claimed worker frees
        # (all devices participate in it).
        start = max(self._clocks[w] for w in workers)
        t0 = time.perf_counter()
        self._group_execute(query, sizes, base_offset, workers)
        dt = time.perf_counter() - t0
        self.last_batch_wall = dt
        self._charge(query, dt)
        end = start + dt
        for w in workers:
            self._clocks[w] = end
        return tuple(
            Dispatch(worker=w, start=start, end=end) for w in workers
        )

    def run_agg(self, query, num_batches, worker, start, barrier):
        t0 = time.perf_counter()
        self._agg_execute(query, num_batches)
        dt = time.perf_counter() - t0
        self.last_agg_wall = dt
        self._charge(query, dt)
        if dt > 0:
            self._clocks[worker] = start + dt
            return Dispatch(worker=worker, start=start, end=start + dt), dt
        return Dispatch(worker=worker, start=barrier, end=barrier), dt

    # -- physical hooks ----------------------------------------------------
    def _batch_execute(self, query, num_tuples: int, offset: int) -> None:
        """Process tuples [offset, offset + num_tuples) on the mesh (solo
        dispatch: one shard)."""
        raise NotImplementedError

    def _group_execute(
        self,
        query,
        sizes: Tuple[int, ...],
        base_offset: int,
        workers: Tuple[str, ...],
    ) -> None:
        """Process the covering range [base_offset, base_offset +
        sum(sizes)) as ONE mesh call."""
        raise NotImplementedError

    def _agg_execute(self, query, num_batches: int) -> None:
        """Combine the query's partials into its final result."""
        raise NotImplementedError
