"""Whole-fabric epochs as one program: ``engine="device"``.

Counterpart of :mod:`repro.net.device_epoch`.  The reference lowers a whole
:class:`~repro_torch.net.topology.HopGraph` epoch -- route, rank, padded
block sort, emission order and ship-order packetization at every hop, the
round-robin uplink merges included -- into one jitted program with donated
buffers.  Here the program is a plain function of static-shape tensor ops
over the ingress columns (:func:`_epoch_program`).  On the card it is
captured once per cache key into a CUDA graph over static ingress buffers,
which every call copies the batch into (the stand-in for the reference's
donated buffers), and replayed; on the CPU it runs eagerly.

Stage math per hop (:func:`_device_hop`, the reference's, op for op):

* route: ``searchsorted`` over the installed range bounds;
* rank: one stable permutation by segment (a key-only sort of ``(segment <<
  bits) | index``, :func:`_stable_perm`) and a scatter;
* block sort: every segment's L-blocks as the rows of one padded ``(n//L +
  S, L)`` matrix, sorted by kernel K1 (``ops.sort_rows_padded``): bare keys
  as int32 with the int32-max pad where the installed ranges fit int32,
  else int64; record cells packed as ``(value << cbits) | column`` as int64,
  so that one key-only row sort also tells each key the slot it came from.
  Wide keys whose cells do not pack take a stable row argsort.  A width that
  is not a power of two is padded to the next one with the dtype max;
* emission order, wire order and each key's packet ordinal, by scatters and
  stable permutations.

The program never reads the device on the host: the per-segment and
per-row counts are searches over the grouped order, where the reference
counts with ``bincount`` and scatter-adds (``torch.bincount`` on the card
reads its maximum on the host, and a scatter-add of every key into 16
segment counters serialises on its atomics); masked writes go to a junk
slot ``n`` of an ``n + 1`` buffer through ``torch.where`` targets, and no
boolean-mask index is taken.  Keys outside the switch domain cannot fault
it (the route is clamped to the last segment); the program returns the
ingress minimum and maximum, and the host raises on them after it returns.

Transfers (:data:`TRANSFER_COUNTS`).  The reference's servers are numpy, so
its epoch moves the ingress to the device once and the result back once.
The port's arenas live on the card, so the egress columns stay there: an
epoch over a batch already on its device copies nothing in and reads one
tensor back -- every hop's segment counts and emitted runs, the ingress
group sizes and the ingress minimum and maximum -- from which
:func:`_stats_from_device` builds the ``HopStats``.  That needs two things
on the host beforehand: the range table (a host tensor is read for free; a
table on the card costs a counted read) and the ingress group sizes, which a
batch that :func:`~repro_torch.net.flow.interleave_batch` built carries as
``flow_sizes`` (any other batch costs a counted read).  Building a program
(once per cache key) uploads its range bounds, as the reference's compile
embeds them.

Observed runs (a recording tracer, ``metrics=``, ``network=``) build the
program with *taps* (``taps`` joins the cache key, so the unobserved program
is untouched): every hop also returns its output's packet-start flags, the
ship index of each output row (int32 below 2^31 keys) and its emitted-run
flags.  After the program, one more read brings every hop's packet starts,
ship indices and run starts to the host, from which the host replays the
reference's per-hop bookkeeping: the ``hop:<name>`` spans, the per-hop
metrics, ``HopStats.ship_emission`` and the timing overlay.  INT telemetry
raises the reference's ``ValueError``.  An empty batch goes through the
fused engine, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.partition import set_ranges
from ..kernels import build, ops
from ..obs.trace import NULL_TRACER
from .engine import HopSpec, HopStats
from .wire import WireBatch, empty_batch

#: Host<->device transfers of the epoch's own data, per call: the ingress
#: copied from the host into the program (0 for a batch on its device) and
#: reads back to the host (the one result fetch, plus the range table or
#: the group sizes where the host did not have them).
TRANSFER_COUNTS = {"to_device": 0, "to_host": 0}

_PROGRAM_CACHE: dict = {}
_PROGRAM_CACHE_MAX = 64

_I64 = torch.int64
_I32_MAX = torch.iinfo(torch.int32).max
_I64_MAX = torch.iinfo(torch.int64).max


def reset_transfer_counts() -> None:
    TRANSFER_COUNTS["to_device"] = 0
    TRANSFER_COUNTS["to_host"] = 0


def clear_program_cache() -> None:
    """Drop every cached program (and on the card its graph's memory)."""
    _PROGRAM_CACHE.clear()


def _fetch(t: torch.Tensor) -> np.ndarray:
    """Read a tensor of the epoch's device on the host (counted; on the CPU
    the epoch's device is the host, and the read counts all the same)."""
    TRANSFER_COUNTS["to_host"] += 1
    return t.cpu().numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceDelivery(WireBatch):
    """The device epoch's egress wire batch plus its grouped handoff view.

    ``grouped_values`` is the egress hop's emitted stream grouped by segment
    (each segment's slice is its emission-order stream, the order the
    server's reorder buffer would restore), ``grouped_rows`` its payload
    rows, ``seg_counts`` the per-segment key counts (on the host) and
    ``run_flags`` the maximal-ascending-run start flags the program already
    computed for the hop statistics.  A row gather (``take``, ``slice_keys``,
    jitter) gives a plain :class:`WireBatch`."""

    grouped_values: torch.Tensor | None = None
    grouped_rows: torch.Tensor | None = None
    seg_counts: torch.Tensor | None = None
    run_flags: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# The per-hop math (static shapes, no host reads)
# ---------------------------------------------------------------------------


def _stable_perm(key: torch.Tensor, n: int):
    """``argsort(key, stable=True)`` and ``key`` in that order, by one
    key-only sort of ``(key << bits(n)) | index``: the packed index is
    unique, so the plain sort's tie order is the arrival order.  Needs
    non-negative keys and ``bits(key) + bits(n) <= 63``."""
    ibits = max(1, (n - 1).bit_length()) if n > 1 else 1
    idx = torch.arange(n, dtype=_I64, device=key.device)
    packed = torch.sort((key.to(_I64) << ibits) | idx).values
    return packed & ((1 << ibits) - 1), packed >> ibits


def _scatter_junk(n: int, tgt: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``zeros(n + 1).at[tgt].set(src)[:n]``: targets ``n`` are dropped."""
    return torch.zeros(n + 1, dtype=_I64, device=src.device).scatter_(0, tgt, src)[:n]


def _device_hop(vals, rows, bounds, S: int, L: int, P: int, vbits: int, key_dtype,
                taps: bool = False):
    """One hop: the hop's wire columns and stat reductions.

    ``vals``/``rows`` are the arrival stream (``rows`` None outside record
    mode); ``vbits`` the key domain's bit width (0 where packed sorts do not
    fit: the stable-argsort forms, byte-identical); ``key_dtype`` the row
    sort's type for bare keys (int32 where the installed ranges fit).  The
    math is the reference's ``_device_hop``, which mirrors
    ``marathon_emission`` and the fused engine's packetization exactly.
    With ``taps`` the hop also returns its observed-run taps under
    ``"tap"``: packet-start flags and ship indices in wire order, emitted-run
    flags in grouped order."""
    dev = vals.device
    n = int(vals.numel())
    ar = torch.arange(n, dtype=_I64, device=dev)
    # A key outside the domain routes past the last segment; clamp it so
    # that no index leaves its buffer (the host rejects such a batch).
    seg = torch.searchsorted(bounds, vals, right=True).clamp_(max=S - 1)
    if vbits:
        order, seg_g = _stable_perm(seg, n)
    else:
        seg_g, order = torch.sort(seg, stable=True)
    # seg_g ascends: each segment's start is a search, not S-way atomics
    bounds_g = torch.searchsorted(seg_g, torch.arange(S + 1, dtype=_I64, device=dev))
    starts, counts = bounds_g[:-1], torch.diff(bounds_g)
    q = ar - starts[seg_g]  # in-segment position
    ranks = torch.empty(n, dtype=_I64, device=dev).scatter_(0, order, q)
    grouped = vals[order]

    # -- block sort: rows of one padded (R, L) matrix -------------------
    nblk = (counts + L - 1) // L
    blk_base = torch.cat([nblk.new_zeros(1), torch.cumsum(nblk, 0)[:-1]])
    R = n // L + S  # static row budget; used rows are 0..sum(nblk)-1
    row_of = blk_base[seg_g] + q // L  # ascends with the grouped position
    col_of = q % L
    bounds_r = torch.searchsorted(row_of, torch.arange(R + 1, dtype=_I64, device=dev))
    row_start, row_len = bounds_r[:-1], torch.diff(bounds_r)
    del bounds_r
    cols = torch.arange(L, dtype=_I64, device=dev)
    tgt = torch.where(cols[None, :] < row_len[:, None], row_start[:, None] + cols[None, :], n).reshape(-1)
    W = 1 << (L - 1).bit_length()  # K1's width: L padded to a power of two
    cell = row_of * W + col_of
    cbits = max(1, (L - 1).bit_length())
    stream_rows = None
    if rows is not None and vbits and vbits + cbits <= 63:
        # Record mode, packed: each cell is ``(value << cbits) | col``, so the
        # row sort also tells every key its grouped slot (row_start + col).
        # Pad cells keep the all-ones value and their own column: they sort
        # after every real key (a real max-valued key wins the tie by its
        # smaller column) and land on dropped slots.
        pad_val = (1 << vbits) - 1
        cmask = (1 << cbits) - 1
        pk = torch.full((R, W), _I64_MAX, dtype=_I64, device=dev)
        pk[:, :L] = (pad_val << cbits) | cols
        pk.view(-1).scatter_(0, cell, (grouped << cbits) | col_of)
        spk = ops.sort_rows_padded(pk)[:, :L]
        del pk
        src = (row_start[:, None] + (spk & cmask)).clamp_(0, max(n - 1, 0))
        stream = _scatter_junk(n, tgt, (spk >> cbits).reshape(-1))
        src_slot = _scatter_junk(n, tgt, src.reshape(-1))
        del spk, src
        stream_rows = rows[order][src_slot]
    elif rows is not None:
        # Record mode, wide keys: a stable row argsort keeps the in-block
        # arrival order on ties, as the fused engine's provenance does.
        mat = torch.full((R, L), _I64_MAX, dtype=_I64, device=dev)
        mat.view(-1).scatter_(0, row_of * L + col_of, grouped)
        pmat = torch.full((R, L), n, dtype=_I64, device=dev)
        pmat.view(-1).scatter_(0, row_of * L + col_of, ar)
        sorted_vals, perm = torch.sort(mat, dim=1, stable=True)
        sorted_pos = pmat.gather(1, perm)
        del mat, pmat, perm
        stream = _scatter_junk(n, tgt, sorted_vals.reshape(-1))
        src_slot = _scatter_junk(n, tgt, sorted_pos.reshape(-1))
        del sorted_vals, sorted_pos
        stream_rows = rows[order][src_slot]
    else:
        mat = torch.full((R, W), torch.iinfo(key_dtype).max, dtype=key_dtype, device=dev)
        mat.view(-1).scatter_(0, cell, grouped.to(key_dtype))
        srt = ops.sort_rows_padded(mat)[:, :L]
        del mat
        stream = _scatter_junk(n, tgt, srt.reshape(-1).to(_I64))
        del srt
    del tgt, cell, row_of, col_of, row_len, row_start

    # -- emission order: slot -> emission index --------------------------
    emit_mask = ranks >= L
    emit_slot = starts[seg] + ranks - L
    emit_ord = torch.cumsum(emit_mask, 0) - 1
    n_emitted = (counts - L).clamp(min=0)
    flush_mask = q >= n_emitted[seg_g]
    flush_ord = n_emitted.sum() + torch.cumsum(flush_mask, 0) - 1
    eidx = torch.zeros(n + 1, dtype=_I64, device=dev)
    eidx.scatter_(0, torch.where(emit_mask, emit_slot, n), torch.where(emit_mask, emit_ord, 0))
    eidx.scatter_(0, torch.where(flush_mask, ar, n), torch.where(flush_mask, flush_ord, 0))
    eidx = eidx[:n]
    del emit_mask, emit_slot, emit_ord, flush_mask, flush_ord, ranks

    # -- wire order: packets ship at their last key's emission ----------
    pkt_j = q // P
    last_q = torch.minimum((pkt_j + 1) * P, counts[seg_g]) - 1
    ship_key = eidx[(starts[seg_g] + last_q).clamp_(0, max(n - 1, 0))]
    del eidx, last_q
    if vbits:
        out_perm, ship_wire = _stable_perm(ship_key, n)  # ship index < n: fits
    else:
        ship_wire, out_perm = torch.sort(ship_key, stable=True)
    vals_out = stream[out_perm]
    sid_out = seg_g[out_perm]
    seq_out = pkt_j[out_perm]

    # -- per-key packet ordinal (the next hop's round-robin turn) -------
    if n:
        one = torch.ones(1, dtype=torch.bool, device=dev)
        chg = torch.cat([one, (seq_out[1:] != seq_out[:-1]) | (sid_out[1:] != sid_out[:-1])])
        turn = torch.cumsum(chg, 0) - 1
        seg_chg = torch.cat([one, seg_g[1:] != seg_g[:-1]])
        desc = torch.cat([~one, stream[1:] < stream[:-1]])
        brk = seg_chg | desc
    else:
        chg = torch.zeros(0, dtype=torch.bool, device=dev)
        turn = torch.zeros(0, dtype=_I64, device=dev)
        brk = torch.zeros(0, dtype=torch.bool, device=dev)

    hop = {
        "vals": vals_out,
        "seq": seq_out,
        "sid": sid_out,
        "turn": turn,
        "counts": counts,
        "runs": brk.sum().to(_I64),
        "stream": stream,
        "brk": brk,
    }
    if stream_rows is not None:
        hop["rows"] = stream_rows[out_perm]
        hop["stream_rows"] = stream_rows
    if taps:
        hop["tap"] = {
            "ship": ship_wire.to(torch.int32 if n < 1 << 31 else _I64),
            "pstart": chg,
            "brk": brk,
        }
    return hop


def _rr_merge(parts, carry_rows: bool, packable: bool):
    """Round-robin uplink interleave: the parents' outputs concatenated in
    parent order, stably sorted by each key's packet ordinal -- the order of
    :func:`~repro_torch.net.wire.merge_round_robin_batches`."""
    if len(parts) == 1:
        p = parts[0]
        return p["vals"], (p["rows"] if carry_rows else None)
    turn = torch.cat([p["turn"] for p in parts])
    m = int(turn.numel())
    if packable:
        order, _ = _stable_perm(turn, m)
    else:
        order = torch.sort(turn, stable=True).indices
    del turn
    vals = torch.cat([p["vals"] for p in parts])[order]
    rows = torch.cat([p["rows"] for p in parts])[order] if carry_rows else None
    return vals, rows


# ---------------------------------------------------------------------------
# The program: a function of the ingress columns, captured on the card
# ---------------------------------------------------------------------------


class _Program:
    """``fn`` over static-shape ingress columns.  On the card the first call
    copies the columns into static buffers, captures ``fn`` over them into
    :attr:`graph` (:func:`~repro_torch.kernels.build.capture`: one real call
    first, so K1 is built and loaded and the sorts' scratch set up outside
    the capture) and replays; later calls copy and replay.  The outputs are
    the graph's static tensors, overwritten by the next replay.  On the CPU
    every call runs ``fn`` eagerly."""

    def __init__(self, fn, device: torch.device) -> None:
        self.fn = fn
        self.device = device
        self.graph = None
        self._inputs: tuple = ()
        self._outputs = None

    def __call__(self, *cols):
        if self.device.type != "cuda":
            return self.fn(*cols)
        if self.graph is None:
            self._capture(cols)
        else:
            for buf, col in zip(self._inputs, cols):
                buf.copy_(col)
        self.graph.replay()
        return self._outputs

    def _capture(self, cols) -> None:
        self._inputs = tuple(c.clone() for c in cols)
        self.graph, self._outputs = build.capture(lambda: self.fn(*self._inputs), self.device)


def _key_dtype(ranges: np.ndarray):
    """int32 row sorts where every key of the installed domain fits below
    the int32 pad (the reference's kernel branch), else int64."""
    if int(ranges[0, 0]) >= 0 and int(ranges[-1, 1]) - 1 < _I32_MAX:
        return torch.int32
    return _I64


def _vbits(ranges: np.ndarray, n_total: int) -> int:
    """The key domain's bit width, or 0 where the packed key-only sorts do
    not fit in 63 bits (the reference's feasibility rule)."""
    vmax_dom = int(ranges[-1, 1]) - 1
    nbits = max(1, (n_total - 1).bit_length()) if n_total > 1 else 1
    if int(ranges[0, 0]) < 0 or vmax_dom < 0 or nbits > 31:
        return 0
    return max(1, vmax_dom.bit_length())


def _epoch_program(graph, spec: HopSpec, ranges: np.ndarray, group_ns: tuple,
                   carry_rows: bool, device: torch.device, taps: bool = False) -> _Program:
    """Build (or fetch from the cache) the whole-epoch program.

    The key is the reference's: the graph, the spec's shape fields, the
    installed ranges by value, the ingress group sizes and record mode, plus
    the device.  The program maps the batch's columns in wire order --
    ``values``, then ``flow_id`` with several ingress groups, then
    ``row_index`` in record mode -- to the egress columns and
    one int64 ``stats`` vector: every hop's segment counts, then every
    hop's emitted runs, then the ingress group sizes, then the ingress
    minimum and maximum.  With ``taps`` it also returns every hop's taps
    under ``"taps"``."""
    key = (graph, spec.num_segments, spec.segment_length, spec.payload_size,
           ranges.tobytes(), group_ns, carry_rows, str(device), taps)
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        return prog

    S, L, P = spec.num_segments, spec.segment_length, spec.payload_size
    bounds = torch.from_numpy(np.ascontiguousarray(ranges[:, 1], dtype=np.int64)).to(device)
    nodes = graph.nodes
    G = graph.num_groups
    n_total = int(sum(group_ns))
    vbits = _vbits(ranges, n_total)
    key_dtype = _key_dtype(ranges)
    bases = np.concatenate([[0], np.cumsum(group_ns)]).tolist()

    def epoch_fn(*cols):
        values = cols[0]
        flow_id = cols[1] if G > 1 else None
        row_index = cols[-1] if carry_rows else None
        # Ingress cabling: flow f feeds group f % G, each group's keys in
        # wire order -- a stable partition by group, by cumulative counts.
        if G == 1:
            groups, row_groups = [values], [row_index]
            group_sizes = torch.full((1,), n_total, dtype=_I64, device=values.device)
        else:
            grp = flow_id % G
            dest = torch.zeros(n_total, dtype=_I64, device=values.device)
            sizes = []
            for g in range(G):
                hit = grp == g
                pos = torch.cumsum(hit, 0)
                sizes.append(pos[-1])
                dest = torch.where(hit, pos - 1 + bases[g], dest)
            del grp, hit, pos
            # Sizes the host was told wrong must not fault the scatter; the
            # host compares them with the true ones after the program.
            dest.clamp_(0, n_total - 1)
            group_sizes = torch.stack(sizes)
            perm = torch.empty(n_total, dtype=_I64, device=values.device).scatter_(
                0, dest, torch.arange(n_total, dtype=_I64, device=values.device))
            del dest
            gv = values[perm]
            groups = [gv[bases[g]:bases[g + 1]] for g in range(G)]
            row_groups = [None] * G
            if carry_rows:
                gr = row_index[perm]
                row_groups = [gr[bases[g]:bases[g + 1]] for g in range(G)]
            del perm
        hops: list[dict] = []
        last = len(nodes) - 1
        for i, node in enumerate(nodes):
            if node.parents:
                vals, rows = _rr_merge([hops[p] for p in node.parents], carry_rows, vbits > 0)
                for p in node.parents:  # one consumer per uplink: keep only its stats
                    hops[p] = {k: hops[p][k] for k in ("counts", "runs", "tap") if k in hops[p]}
            else:
                vals, rows = groups[node.group], row_groups[node.group]
                groups[node.group] = row_groups[node.group] = None
            hop = _device_hop(vals, rows, bounds, S, L, P, vbits, key_dtype, taps)
            del vals, rows
            if i != last:
                hop = {k: hop[k] for k in ("vals", "rows", "turn", "counts", "runs", "tap") if k in hop}
            hops.append(hop)
        eg = hops[-1]
        stats = torch.cat([
            torch.stack([h["counts"] for h in hops]).reshape(-1),
            torch.stack([h["runs"] for h in hops]),
            group_sizes,
            torch.stack([values.min(), values.max()]),
        ])
        res = {k: eg[k] for k in ("vals", "seq", "sid", "stream", "brk")}
        res["stats"] = stats
        if carry_rows:
            res["rows"] = eg["rows"]
            res["stream_rows"] = eg["stream_rows"]
        if taps:
            res["taps"] = [h["tap"] for h in hops]
        return res

    prog = _Program(epoch_fn, device)
    if len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    _PROGRAM_CACHE[key] = prog
    return prog


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _stats_from_device(name: str, counts: np.ndarray, runs: int, L: int) -> HopStats:
    """``HopStats`` from the program's per-hop reductions: field for field
    the scalars of :meth:`HopStats._from_grouped`."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    runs = int(runs)
    recirc = int(np.where(counts == 0, 0, np.where((counts <= L) | (counts % L == 0), 1, 2)).sum())
    return HopStats(
        name=name,
        arrivals=total,
        segment_loads=torch.from_numpy(counts.copy()),
        load_imbalance=int(counts.max()) / (total / counts.size) if total else 1.0,
        emitted_runs=runs,
        mean_run_len=(total / runs) if runs else 0.0,
        recirculations=recirc,
    )


def _host_ranges(spec: HopSpec) -> np.ndarray:
    """The installed range table on the host (a table on the card is read,
    and counted)."""
    if spec.ranges is None:
        return set_ranges(spec.max_value, spec.num_segments, device="cpu").numpy()
    r = spec.ranges
    if r.device.type != "cpu":
        return _fetch(r)
    return r.numpy()


def _group_sizes(batch: WireBatch, num_groups: int) -> tuple[int, ...]:
    """Keys per ingress group (flow ``f`` feeds group ``f % num_groups``):
    from the batch's host-side ``flow_sizes`` where it has them, else read
    from the device (counted)."""
    sizes = getattr(batch, "flow_sizes", None)
    if num_groups == 1:
        return (len(batch),)
    if sizes is not None:
        out = [0] * num_groups
        for fid, size in sizes:
            out[fid % num_groups] += size
        return tuple(out)
    grp = batch.flow_id % num_groups
    counts = torch.zeros(num_groups, dtype=_I64, device=batch.device).scatter_add_(
        0, grp, torch.ones_like(grp))
    return tuple(int(c) for c in _fetch(counts))


def run_graph_device(
    graph,
    batch: WireBatch,
    spec: HopSpec,
    *,
    tracer=None,
    metrics=None,
    int_telemetry: bool = False,
    network=None,
):
    """Run a fabric epoch as one program: the contract of
    :func:`~repro_torch.net.topology.run_graph` -- the egress batch (a
    :class:`DeviceDelivery`) and the per-hop stats, byte-identical to the
    fused engine's wire, output and stat scalars; with ``network`` also the
    :class:`~repro_torch.net.timing.NetworkReport`, the delivered batch then
    being the egress link's raw wire.  The epoch runs on the batch's device;
    unobserved, it reads one tensor back per call (see
    :data:`TRANSFER_COUNTS`), observed, one more: the taps."""
    if int_telemetry or getattr(batch, "int_meta", None) is not None:
        raise ValueError(
            "engine 'device' does not support INT telemetry -- the compiled "
            "epoch never materializes the per-hop streams the stamp needs; "
            "use the 'fused' engine for INT runs"
        )
    tr = tracer or NULL_TRACER
    if len(batch) == 0:
        # Nothing to run for a drained epoch; the per-hop loop on an empty
        # stream is already output- and stats-identical.
        from .topology import run_graph

        return run_graph(graph, batch, spec, "fused", tracer=tracer, metrics=metrics,
                         network=network)
    collect = network is not None or metrics is not None or tr.enabled

    dev = batch.device
    carry_rows = batch.row_index is not None
    ranges = _host_ranges(spec)
    group_ns = _group_sizes(batch, graph.num_groups)
    prog = _epoch_program(graph, spec, ranges, group_ns, carry_rows, dev, collect)
    cols = [batch.values]
    if graph.num_groups > 1:
        cols.append(batch.flow_id)
    if carry_rows:
        cols.append(batch.row_index)
    res = prog(*cols)
    host = _fetch(res["stats"])

    H, S, L = len(graph.nodes), spec.num_segments, spec.segment_length
    counts = host[: H * S].reshape(H, S)
    runs = host[H * S : H * S + H]
    sizes = host[H * S + H : H * S + H + len(group_ns)]
    vmin, vmax = host[-2], host[-1]
    if vmin < int(ranges[0, 0]) or vmax >= int(ranges[-1, 1]):
        raise ValueError("value outside the switch domain")
    if tuple(int(s) for s in sizes) != group_ns:
        raise AssertionError(f"ingress group sizes {sizes.tolist()} != the batch's {list(group_ns)}")
    stats = [_stats_from_device(node.name, counts[i], runs[i], L) for i, node in enumerate(graph.nodes)]
    taps = res.get("taps")  # read below, before any other replay
    if prog.graph is not None:
        # The graph's static outputs are overwritten by its next replay.
        res = {k: v.clone() for k, v in res.items() if k != "taps"}
    n_out = int(res["vals"].numel())
    delivery = DeviceDelivery(
        res["vals"],
        torch.full((n_out,), H - 1, dtype=_I64, device=dev),
        res["seq"],
        res["sid"],
        epoch=batch.epoch,
        row_index=res.get("rows"),
        grouped_values=res["stream"],
        grouped_rows=res.get("stream_rows"),
        seg_counts=torch.from_numpy(counts[-1].copy()),
        run_flags=res["brk"],
    )
    if not collect:
        return delivery, stats
    return _replay_taps(graph, batch, taps, stats, delivery, tr, metrics, network)


def _replay_taps(graph, batch, taps, stats, delivery, tr, metrics, network):
    """The observed run's per-hop bookkeeping, replayed from the taps.

    Every hop's packet starts, ship indices (at the starts) and run starts
    come to the host in one read; from them the host sets each hop's
    ``ship_emission`` and replays the reference's hop spans, per-hop
    metrics and the timing overlay, hop by hop in node order."""
    from .topology import record_hop

    parts = []
    for tap in taps:
        starts = torch.nonzero(tap["pstart"]).reshape(-1)
        parts += [starts, tap["ship"][starts].to(_I64), torch.nonzero(tap["brk"]).reshape(-1)]
    lens = np.cumsum([int(t.numel()) for t in parts])[:-1]
    host = np.split(_fetch(torch.cat(parts)), lens)
    del parts
    timer = None
    if network is not None:
        from .timing import GraphTimer

        timer = GraphTimer(graph, batch, network, tracer=tr, metrics=metrics)
    for i, node in enumerate(graph.nodes):
        starts, ship, run_starts = host[3 * i : 3 * i + 3]
        keys = stats[i].arrivals
        stats[i] = dataclasses.replace(stats[i], ship_emission=torch.from_numpy(ship))
        with tr.span(f"hop:{node.name}", cat="hop", keys=keys) as hop_sp:
            hop_sp.set(keys_out=keys)
        if metrics is not None:
            record_hop(metrics, node.name, keys, keys, starts.size, stats[i],
                       np.diff(np.append(run_starts, keys)))
        if timer is not None:
            timer.after_hop(i, node, np.diff(np.append(starts, keys)), ship)
    if timer is not None:
        delivered, report = timer.egress_deliver(delivery)
        return delivered, stats, report
    return delivery, stats


def device_hop(
    batch: WireBatch,
    spec: HopSpec,
    name: str,
    *,
    tracer=None,
    hop_id: int = 0,
    int_telemetry: bool = False,
) -> tuple[WireBatch, HopStats]:
    """Single-hop view of the device epoch (the ``run_hop`` contract: the
    output flow ids are 0; the graph scheduler restamps them)."""
    del hop_id
    from .topology import HopGraph, HopNode

    dev = batch.device
    if len(batch) == 0:
        out = empty_batch(batch.epoch, device=dev)
        if batch.row_index is not None:
            out = out.with_row_index(torch.zeros(0, dtype=_I64, device=dev))
        st = _stats_from_device(name, np.zeros(spec.num_segments, dtype=np.int64), 0,
                                spec.segment_length)
        return out, dataclasses.replace(st, ship_emission=torch.zeros(0, dtype=_I64, device=dev))
    if int_telemetry or getattr(batch, "int_meta", None) is not None:
        raise ValueError("engine 'device' does not support INT telemetry -- use 'fused'")
    out, stats = run_graph_device(HopGraph((HopNode(name),), num_groups=1), batch, spec, tracer=tracer)
    return out, stats[0]


def device_self_check(n: int = 4096, seed: int = 0, device="cuda") -> None:
    """Probe: a small leaf-spine epoch on ``device`` (the card by default:
    K1 inside the captured program) must give the fused engine's bytes."""
    from .. import resolve_device
    from .flow import interleave_batch, split_flows
    from .topology import leaf_spine_graph, run_graph

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    max_value = (1 << 20) - 1
    values = torch.from_numpy(rng.integers(0, max_value + 1, n)).to(dev)
    arrivals = interleave_batch(split_flows(values, 4, 32), "round_robin")
    spec = HopSpec(8, 32, max_value, set_ranges(max_value, 8, device="cpu"), payload_size=32)
    graph = leaf_spine_graph(2)
    ref, ref_stats = run_graph(graph, arrivals, dataclasses.replace(spec, ranges=spec.ranges.to(dev)), "fused")
    out, stats = run_graph_device(graph, arrivals, spec)
    for col in ("values", "seq", "segment_id"):
        if not torch.equal(getattr(out, col), getattr(ref, col)):
            raise AssertionError(f"device epoch's {col} column differs from the fused engine's")
    if stats != ref_stats or not all(
        torch.equal(a.segment_loads, b.segment_loads.cpu()) for a, b in zip(stats, ref_stats)
    ):
        raise AssertionError("device stats diverge from fused")
