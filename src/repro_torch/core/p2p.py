"""Decentralized P2P meta-scheduling (paper §III/§IX), ported.

DIANA is a *decentralized* meta-scheduler: every site runs its own
scheduler instance, and the P2P layer exchanges cost and queue rows
between peers instead of assuming one omniscient global view.

* ``PeerScheduler`` — one site's DIANA instance. It owns its home
  site(s)' **authoritative** state and knows the other sites only
  through a *world view*: a ``SitePack`` on the peer's device whose
  remote columns were heard from peers, with per-column ``version``
  (int64, the owner's epoch) and ``stamp`` (float64, the owner's clock)
  vectors on the same device. Placement runs the pure
  ``PlacementEngine`` over that view, so a single peer owning every site
  (``single_peer``) places exactly as ``DianaScheduler``.
* ``SiteAdvert`` — the full wire's unit: one packed (8,) float64 row in
  ``PACK_FIELDS`` order (a host NumPy array) plus liveness, free slots,
  epoch and stamp.
* ``encode_packet``/``decode_packet`` — the delta wire's codec. It works
  on host bytes with ``struct``, ``zlib.crc32``, ``np.packbits`` and
  NumPy's dtype casts, so the f32/f16 quantization rounds exactly as the
  reference's does (a torch float64 → float16 cast rounds twice, through
  float32, and would change the bytes). A sender's device columns reach
  the codec in one device → host copy a round, shared by its packets.
* ``GossipExchange`` — the epoch-advertisement protocol: hierarchy-aware
  fan-out over a ``GridTopology``, the full and delta wires, per-receiver
  acks, heartbeats and full syncs, tier-summary rows, and the
  unreliable transport (seeded loss, duplication, reorder, corruption,
  retransmission, escalation, phi-accrual suspicion) drawn from a NumPy
  ``default_rng`` exactly as the reference draws it.

Every merge is version-gated on the device; every count, byte and
decision equals the reference's on the same inputs.
"""
from __future__ import annotations

import heapq
import itertools
import math
import struct
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device, sqrt_rn, to_device, to_host
from .batch import PACK_FIELDS, JobPack, SitePack, TierPack, merge_packed_rows
from .bulk import BulkGroup, BulkScheduler, GroupPlacement
from .costs import CostWeights, NetworkLink, SiteState
from .engine import PlacementEngine
from .queues import Job
from .scheduler import DianaScheduler, JobClass
from .topology import GridTopology

__all__ = [
    "OWNER_FIELDS",
    "QUANT_FIELDS",
    "SiteAdvert",
    "TierSummary",
    "ExchangeStats",
    "PeerScheduler",
    "GossipExchange",
    "single_peer",
    "advert_wire_bytes",
    "summary_wire_bytes",
    "encode_packet",
    "decode_packet",
    "PacketError",
    "ACK_WIRE_BYTES",
]

_F64 = torch.float64

# The advertised fields a receiver merges: path quality (bw/loss/rtt/mss)
# is receiver-relative, so the owner's values never apply.
OWNER_FIELDS = ("cap", "queue", "work", "load")

# The dynamic owner fields the delta wire quantizes and ships
# (``free_slots`` rides alongside); ``cap`` is static and stays off it.
QUANT_FIELDS = ("queue", "work", "load")


@dataclass(frozen=True)
class SiteAdvert:
    """One advertised site row: the packed (8,) float64 ``SitePack``
    column in ``PACK_FIELDS`` order plus liveness, free slots, the
    owner's epoch and the owner's clock at measurement."""

    site: str
    row: np.ndarray            # (8,) float64 — PACK_FIELDS order
    alive: bool
    free_slots: float
    version: int
    stamp: float


def advert_wire_bytes(advert: SiteAdvert) -> int:
    """Serialized size of one advert: 8 f64 row + version + stamp +
    free_slots + alive byte + site name."""
    return 8 * 8 + 8 + 8 + 8 + 1 + len(advert.site)


@dataclass(frozen=True)
class TierSummary:
    """One RootGrid tier's aggregate row (two-level gossip): the
    admissible per-component extrema a peer needs to know whether a
    remote tier could win a placement. Last-writer-wins by ``stamp``."""

    tier: str
    stamp: float               # owner clock at aggregation
    n: int                     # member sites
    n_alive: int
    net_min: float             # min member network cost
    eff_max: float             # max member effective bandwidth
    cap_max: float             # max member capacity
    comp_min: float            # min member job-independent comp term


def summary_wire_bytes(summary: TierSummary) -> int:
    """Serialized size of one tier summary: stamp + 4 aggregate f64 +
    two u16 counts + tier name."""
    return 8 + 4 * 8 + 2 + 2 + len(summary.tier)


@dataclass
class ExchangeStats:
    """The exchange's counters. ``bytes_sent`` counts real serialized
    sizes: ``len(payload)`` of each delta packet plus ``ACK_WIRE_BYTES``
    per acknowledgement, and ``advert_wire_bytes`` per full-wire advert.
    """

    rounds: int = 0
    adverts_sent: int = 0
    adverts_applied: int = 0
    bytes_sent: int = 0
    deliveries: int = 0
    heartbeats_sent: int = 0
    acks_sent: int = 0
    full_syncs: int = 0
    #: tier summary rows sent (0 with summaries off)
    summaries_sent: int = 0
    # -- unreliable-transport counters (zero on a reliable transport) ----
    dropped: int = 0
    duplicated: int = 0
    corrupted: int = 0
    dup_suppressed: int = 0
    reordered: int = 0
    retransmits: int = 0
    sync_escalations: int = 0

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "adverts_sent": self.adverts_sent,
            "adverts_applied": self.adverts_applied,
            "bytes_sent": self.bytes_sent,
            "deliveries": self.deliveries,
            "heartbeats_sent": self.heartbeats_sent,
            "acks_sent": self.acks_sent,
            "full_syncs": self.full_syncs,
            "summaries_sent": self.summaries_sent,
            "dropped": self.dropped,
            "duplicated": self.duplicated,
            "corrupted": self.corrupted,
            "dup_suppressed": self.dup_suppressed,
            "reordered": self.reordered,
            "retransmits": self.retransmits,
            "sync_escalations": self.sync_escalations,
        }


# ---------------------------------------------------------------------------
# Delta wire format: encode/decode one sender→receiver packet (host bytes).
# ---------------------------------------------------------------------------

#: Serialized acknowledgement size: 2 B magic + u16 sender + u64 packet
#: seq + u32 pad.
ACK_WIRE_BYTES = 16

_WIRE_MAGIC = b"DG"
_WIRE_VERSION = 2
_FLAG_TABLE = 1       # packet carries the interned site-id table
_FLAG_F16 = 2         # quantized payload is float16 (default float32)
_FLAG_WIDE_IDS = 4    # column ids are uint32 (>65535 sites)
_QUANT_DTYPES = {"f32": np.float32, "f16": np.float16}
# version, flags, pair seq, n_table, n_delta, n_hb
_HEADER = struct.Struct("<BBIIII")
_CRC = struct.Struct("<I")


class PacketError(ValueError):
    """A wire buffer could not be decoded as a delta packet: truncated,
    corrupted (checksum mismatch), garbage, or structurally invalid."""


def encode_packet(
    names: Sequence[str],
    ids: np.ndarray,
    qrows: np.ndarray,
    free: np.ndarray,
    alive: np.ndarray,
    versions: np.ndarray,
    stamps: np.ndarray,
    hb_ids: np.ndarray,
    hb_versions: np.ndarray,
    hb_stamps: np.ndarray,
    *,
    quant: str = "f32",
    include_table: bool = False,
    pair_seq: int = 0,
) -> bytes:
    """Serialize one delta packet (wire v2): magic, header, the interned
    site-id table when ``include_table``, then per advertised column its
    id, exact int64 epoch, f64 owner stamp, one alive bit and the
    ``QUANT_FIELDS`` + free_slots payload quantized to ``quant``, then
    (id, epoch echo, stamp) heartbeat triplets, and a trailing CRC32 of
    everything before it. Inputs are host arrays; the quantization is
    NumPy's float64 → float32/float16 cast, correctly rounded once."""
    dtype = _QUANT_DTYPES[quant]
    wide = len(names) > 0xFFFF
    id_dt = np.uint32 if wide else np.uint16
    flags = (
        (_FLAG_TABLE if include_table else 0)
        | (_FLAG_F16 if quant == "f16" else 0)
        | (_FLAG_WIDE_IDS if wide else 0)
    )
    n = len(ids)
    qrows = np.asarray(qrows, np.float64)
    if qrows.shape != (len(QUANT_FIELDS), n):
        raise ValueError(
            f"qrows must be ({len(QUANT_FIELDS)}, {n}), got {qrows.shape}"
        )
    parts = [
        _WIRE_MAGIC,
        _HEADER.pack(
            _WIRE_VERSION, flags, pair_seq & 0xFFFFFFFF,
            len(names) if include_table else 0, n, len(hb_ids),
        ),
    ]
    if include_table:
        for name in names:
            b = name.encode("utf-8")
            if len(b) > 255:
                raise ValueError(f"site name too long for wire: {name!r}")
            parts.append(struct.pack("<B", len(b)))
            parts.append(b)
    parts += [
        np.ascontiguousarray(ids, id_dt).tobytes(),
        np.ascontiguousarray(versions, np.int64).tobytes(),
        np.ascontiguousarray(stamps, np.float64).tobytes(),
        np.ascontiguousarray(qrows, dtype).tobytes(),
        np.ascontiguousarray(free, dtype).tobytes(),
        np.packbits(np.asarray(alive, bool)).tobytes(),
        np.ascontiguousarray(hb_ids, id_dt).tobytes(),
        np.ascontiguousarray(hb_versions, np.int64).tobytes(),
        np.ascontiguousarray(hb_stamps, np.float64).tobytes(),
    ]
    body = b"".join(parts)
    return body + _CRC.pack(zlib.crc32(body))


def decode_packet(buf: bytes) -> dict:
    """Inverse of ``encode_packet``: quantized fields come back as
    float64, epochs exactly. Returns ``table`` (list of names, or None),
    ``quant``, ``pair_seq``, the delta arrays and the heartbeat arrays.
    Raises :class:`PacketError` on any undecodable buffer."""
    if len(buf) < 2 + _HEADER.size + _CRC.size:
        raise PacketError(f"truncated packet ({len(buf)} bytes)")
    if buf[:2] != _WIRE_MAGIC:
        raise PacketError("not a delta-wire packet (bad magic)")
    (crc,) = _CRC.unpack_from(buf, len(buf) - _CRC.size)
    body = buf[: len(buf) - _CRC.size]
    if zlib.crc32(body) != crc:
        raise PacketError("checksum mismatch (corrupted packet)")
    try:
        return _decode_body(body)
    except PacketError:
        raise
    except Exception as exc:  # struct.error, IndexError, UnicodeDecodeError…
        raise PacketError(f"malformed packet: {exc}") from exc


def _decode_body(buf: bytes) -> dict:
    ver, flags, pair_seq, n_table, n, n_hb = _HEADER.unpack_from(buf, 2)
    if ver != _WIRE_VERSION:
        raise PacketError(f"unsupported wire version {ver}")
    off = 2 + _HEADER.size
    table: Optional[list[str]] = None
    if flags & _FLAG_TABLE:
        table = []
        for _ in range(n_table):
            if off >= len(buf):
                raise PacketError("truncated site-id table")
            ln = buf[off]
            off += 1
            if off + ln > len(buf):
                raise PacketError("truncated site-id table entry")
            table.append(buf[off : off + ln].decode("utf-8"))
            off += ln
    id_dt = np.uint32 if flags & _FLAG_WIDE_IDS else np.uint16
    dtype = np.float16 if flags & _FLAG_F16 else np.float32

    def take(dt, count, shape=None):
        nonlocal off
        dt = np.dtype(dt)
        if count < 0 or off + count * dt.itemsize > len(buf):
            raise PacketError("truncated packet section")
        out = np.frombuffer(buf, dt, count=count, offset=off)
        off += count * dt.itemsize
        return out if shape is None else out.reshape(shape)

    ids = take(id_dt, n).astype(np.int64)
    versions = take(np.int64, n).copy()
    stamps = take(np.float64, n).copy()
    qrows = take(dtype, len(QUANT_FIELDS) * n, (len(QUANT_FIELDS), n)).astype(np.float64)
    free = take(dtype, n).astype(np.float64)
    alive = np.unpackbits(take(np.uint8, -(-n // 8) if n else 0), count=n).astype(bool)
    hb_ids = take(id_dt, n_hb).astype(np.int64)
    hb_versions = take(np.int64, n_hb).copy()
    hb_stamps = take(np.float64, n_hb).copy()
    if off != len(buf):
        raise PacketError(f"{len(buf) - off} trailing byte(s) after packet")
    return {
        "table": table,
        "quant": "f16" if flags & _FLAG_F16 else "f32",
        "pair_seq": int(pair_seq),
        "ids": ids,
        "versions": versions,
        "stamps": stamps,
        "rows": qrows,
        "free": free,
        "alive": alive,
        "hb_ids": hb_ids,
        "hb_versions": hb_versions,
        "hb_stamps": hb_stamps,
    }


class PeerScheduler:
    """One home site's DIANA scheduler in the decentralized deployment.

    ``sites``/``links`` bootstrap the world view; afterwards only the
    home columns are read from authoritative state and every remote
    column changes through received adverts. ``home_sites`` lets one
    peer own a partition of sites (default: the single ``home``). The
    view, its ``version``/``stamp`` vectors, ``free`` and the speculation
    and published-content masks live on ``device`` (the CUDA card unless
    ``device="cpu"``; raises when there is none).
    """

    def __init__(
        self,
        home: str,
        sites: dict[str, SiteState],
        links: dict[str, NetworkLink],
        weights: CostWeights = CostWeights(),
        home_sites: Optional[Sequence[str]] = None,
        order: Optional[Sequence[str]] = None,
        now: float = 0.0,
        *,
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.home = home
        self.home_names = list(home_sites) if home_sites is not None else [home]
        if home not in self.home_names:
            raise ValueError(f"home {home!r} must be in home_sites {self.home_names!r}")
        self.home_sites = frozenset(self.home_names)
        unknown = self.home_sites - set(sites)
        if unknown:
            raise KeyError(f"home site(s) {sorted(unknown)!r} not in sites")
        self.links = dict(links)
        self.weights = weights
        self.engine = PlacementEngine(weights)
        # Authoritative references for the home partition only.
        self.authoritative: dict[str, SiteState] = {
            n: sites[n] for n in self.home_names
        }
        self.view = SitePack.from_scheduler(sites, links, order=order, device=dev)
        S = len(self.view.names)
        self._col = {n: i for i, n in enumerate(self.view.names)}
        self._set_home_cols()
        self.version = torch.zeros(S, dtype=torch.int64, device=dev)
        self.stamp = torch.full((S,), float(now), dtype=_F64, device=dev)
        self.free = torch.as_tensor(
            [sites[n].free_slots for n in self.view.names], dtype=_F64, device=dev
        )
        # Remote columns this peer has speculatively modified (optimistic
        # placement feedback): never re-advertised under the owner's
        # epoch; the owner's next applied advert cleans them.
        self._dirty = torch.zeros(S, dtype=torch.bool, device=dev)
        # Content of each column at its current epoch (queue, work, load,
        # free, alive): epochs open only when a stamped home measurement
        # differs from it.
        self._pub = self._published_content()
        # Optional measurement source (the simulator regenerates
        # SiteState snapshots per reading).
        self.state_provider: Optional[callable] = None
        # None = every provider-backed content refresh re-reads the whole
        # home partition; a set = only the named home sites changed.
        self._home_dirty: Optional[set] = None
        # Two-level placement cache over the world view (mode="hier").
        self._tp: Optional[TierPack] = None
        self._tp_tiers = None
        self._tp_version: Optional[torch.Tensor] = None
        # Remote RootGrid aggregates (tier label → freshest TierSummary).
        self.tier_summaries: dict[str, TierSummary] = {}

    def _set_home_cols(self) -> None:
        """The home-column mask and index on the device."""
        mask = [n in self.home_sites for n in self.view.names]
        self.home_cols = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        self._home_idx = torch.as_tensor(
            np.flatnonzero(mask), dtype=torch.int64, device=self.device
        )

    # -- incremental home refresh ---------------------------------------------
    def enable_home_dirty_tracking(self) -> None:
        """Opt in to narrowed content refreshes: a provider-backed
        ``refresh_home(now=None)`` then re-measures only the home sites
        reported through ``mark_home_dirty`` (all of them initially)."""
        self._home_dirty = set(self.home_names)

    def mark_home_dirty(self, name: str) -> None:
        """Note that one home site's authoritative state changed (a no-op
        unless tracking is enabled; foreign names are ignored)."""
        if self._home_dirty is not None and name in self.home_sites:
            self._home_dirty.add(name)

    def _published_content(self) -> torch.Tensor:
        """The (5, S) advertised-content snapshot: the dynamic owner
        fields + free + alive."""
        v = self.view
        return torch.stack([v.queue, v.work, v.load, self.free, v.alive.to(_F64)])

    def _write_home(self, names: Sequence[str]) -> None:
        """Re-read queue/work/load/alive and free of the named home
        columns from authoritative state: one host → device copy."""
        if not names:
            return
        sts = [self.authoritative[n] for n in names]
        block = torch.tensor(
            [[s.queue_length for s in sts], [s.waiting_work for s in sts],
             [s.load for s in sts], [s.free_slots for s in sts],
             [1.0 if s.alive else 0.0 for s in sts],
             [float(self._col[n]) for n in names]],
            dtype=_F64,
        ).to(self.device)
        cols = block[5].to(torch.int64)
        v = self.view
        for r, t in enumerate((v.queue, v.work, v.load, self.free)):
            t.index_copy_(0, cols, block[r])
        v.alive.index_copy_(0, cols, block[4] != 0.0)

    # -- world-view maintenance ------------------------------------------------
    def refresh_home(
        self,
        now: Optional[float] = None,
        states: Optional[dict[str, SiteState]] = None,
    ) -> None:
        """Re-measure the home columns from authoritative state.

        With ``now`` every home column gets the fresh stamp and the
        columns whose content changed open a new epoch; with
        ``now=None`` it is a content-only refresh (neither version nor
        stamp moves). ``states`` swaps in fresh authoritative snapshots
        first."""
        pulled_all = False
        if states is None and self.state_provider is not None:
            if now is None and self._home_dirty is not None:
                # Narrowed content-only refresh: unchanged columns would
                # re-read to identical floats.
                if not self._home_dirty:
                    return
                names = [n for n in self.home_names if n in self._home_dirty]
                for n in names:
                    self.authoritative[n] = self.state_provider(n)
                self._write_home(names)
                self._home_dirty.clear()
                return
            states = {n: self.state_provider(n) for n in self.home_names}
            pulled_all = True
        if states is not None:
            for n, st in states.items():
                if n not in self.home_sites:
                    raise KeyError(f"{n!r} is not a home site of peer {self.home!r}")
                self.authoritative[n] = st
        self._write_home(self.home_names)
        if pulled_all and self._home_dirty is not None:
            self._home_dirty.clear()
        if now is None:
            return
        cols = self._home_idx
        v = self.view
        cur = torch.stack([
            v.queue[cols], v.work[cols], v.load[cols], self.free[cols], v.alive[cols].to(_F64),
        ])
        changed = (cur != self._pub[:, cols]).any(dim=0)
        self.version[cols] += changed.to(torch.int64)
        self._pub[:, cols] = cur
        self.stamp[cols] = now

    def staleness(self, now: float) -> torch.Tensor:
        """Seconds since each column's row was measured by its owner, on
        the device; home columns are always fresh (0)."""
        return torch.clamp(now - self.stamp, min=0.0).masked_fill(self.home_cols, 0.0)

    # -- authoritative-state handover (peer churn) ------------------------------
    def handover(self, names: Optional[Sequence[str]] = None) -> dict:
        """Release (part of) this peer's home partition for another peer
        to ``adopt``: the authoritative ``SiteState`` references plus each
        column's epoch, stamp and published content, so the adopter
        continues the same epoch sequence. ``names=None`` releases the
        whole partition. Unknown / non-home names raise ``KeyError``."""
        released = list(self.home_names) if names is None else list(names)
        unknown = set(released) - self.home_sites
        if unknown:
            raise KeyError(
                f"cannot hand over {sorted(unknown)!r}: not home site(s) "
                f"of peer {self.home!r}"
            )
        cols = [self._col[n] for n in released]
        idx = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
        ver = self.version[idx].tolist()
        stamp = self.stamp[idx].tolist()
        pub = self._pub[:, idx].cpu().numpy()
        grant = {
            "names": released,
            "states": {n: self.authoritative[n] for n in released},
            "version": dict(zip(released, ver)),
            "stamp": dict(zip(released, stamp)),
            "pub": {n: pub[:, k].copy() for k, n in enumerate(released)},
        }
        gone = set(released)
        for n in released:
            del self.authoritative[n]
        self.home_names = [n for n in self.home_names if n not in gone]
        self.home_sites = frozenset(self.home_names)
        self._set_home_cols()
        if self._home_dirty is not None:
            self._home_dirty -= gone
        return grant

    def adopt(self, grant: dict) -> None:
        """Take authoritative ownership of a ``handover`` grant: version
        and stamp continue from the granted values (a ``max`` guards
        against an out-of-order grant), the published-content snapshot
        transfers, and the view re-reads authoritative truth at once."""
        names = list(grant["names"])
        unknown = [n for n in names if n not in self._col]
        if unknown:
            raise KeyError(
                f"cannot adopt {unknown!r}: unknown to peer {self.home!r}"
            )
        if names:
            dev = self.device
            idx = torch.as_tensor([self._col[n] for n in names], dtype=torch.int64, device=dev)
            gv = torch.as_tensor([grant["version"][n] for n in names], dtype=torch.int64, device=dev)
            gs = torch.as_tensor([grant["stamp"][n] for n in names], dtype=_F64, device=dev)
            self.version[idx] = torch.maximum(self.version[idx], gv)
            self.stamp[idx] = torch.maximum(self.stamp[idx], gs)
            self._pub[:, idx] = torch.as_tensor(
                np.stack([np.asarray(grant["pub"][n], np.float64) for n in names], axis=1),
                dtype=_F64, device=dev,
            )
            self._dirty[idx] = False
        for n in names:
            self.authoritative[n] = grant["states"][n]
            if n not in self.home_sites:
                self.home_names.append(n)
        self.home_sites = frozenset(self.home_names)
        self._set_home_cols()
        self._write_home(names)
        if self._home_dirty is not None:
            self._home_dirty.update(names)

    # -- gossip/epoch advertisement --------------------------------------------
    def adverts(self, cols: Optional[Sequence[int]] = None) -> list[SiteAdvert]:
        """Advertise packed rows (own rows and hearsay; the per-row
        version lets receivers keep only what's newer). Speculatively
        modified rows are withheld. The rows are frozen host copies, so
        one result may be fanned out to several receivers."""
        v = self.view
        *rows, alive, free, version, stamp, dirty = to_host(
            *(getattr(v, f) for f in PACK_FIELDS), v.alive, self.free, self.version,
            self.stamp, self._dirty,
        )
        rows = np.stack(rows)
        idx = np.arange(len(v.names)) if cols is None else np.asarray(cols, np.int64)
        idx = idx[~dirty[idx]]
        out = []
        for c in idx.tolist():
            row = rows[:, c].copy()
            row.setflags(write=False)
            out.append(
                SiteAdvert(
                    site=v.names[c],
                    row=row,
                    alive=bool(alive[c]),
                    free_slots=float(free[c]),
                    version=int(version[c]),
                    stamp=float(stamp[c]),
                )
            )
        return out

    def receive(self, adverts: Sequence[SiteAdvert]) -> int:
        """Merge advertised rows into the world view, row-versioned: only
        strictly newer epochs apply, home columns are never overwritten
        by hearsay, and only ``OWNER_FIELDS`` apply. Staleness is keyed to
        the owner's stamp carried in the advert. Returns the number of
        applied rows."""
        known = [a for a in adverts if a.site in self._col]
        if not known:
            return 0
        return self._merge(
            cols=np.asarray([self._col[a.site] for a in known], np.int64),
            rows=np.stack([a.row for a in known], axis=1),
            free=np.asarray([a.free_slots for a in known], np.float64),
            alive=np.asarray([a.alive for a in known], bool),
            versions=np.asarray([a.version for a in known], np.int64),
            stamps=np.asarray([a.stamp for a in known], np.float64),
            fields=OWNER_FIELDS,
        )

    def receive_packed(
        self,
        names: Sequence[str],
        qrows: np.ndarray,
        free: np.ndarray,
        alive: np.ndarray,
        versions: np.ndarray,
        stamps: np.ndarray,
    ) -> int:
        """Delta-wire merge of dequantized ``QUANT_FIELDS`` rows ((3, k)
        float64) for the named sites; the same row-versioned semantics as
        ``receive`` (epochs are exact)."""
        keep = [k for k, n in enumerate(names) if n in self._col]
        if not keep:
            return 0
        rows = np.zeros((len(PACK_FIELDS), len(keep)))
        for r, f in enumerate(QUANT_FIELDS):
            rows[PACK_FIELDS.index(f)] = np.asarray(qrows, np.float64)[r, keep]
        return self._merge(
            cols=np.asarray([self._col[names[k]] for k in keep], np.int64),
            rows=rows,
            free=np.asarray(free, np.float64)[keep],
            alive=np.asarray(alive, bool)[keep],
            versions=np.asarray(versions, np.int64)[keep],
            stamps=np.asarray(stamps, np.float64)[keep],
            fields=QUANT_FIELDS,
        )

    def refresh_stamps(
        self,
        names: Sequence[str],
        versions: np.ndarray,
        stamps: np.ndarray,
    ) -> int:
        """Heartbeat application: a stamp applies only when this peer
        holds exactly the echoed epoch of a non-home, non-speculative
        column and the stamp is newer (heartbeats for one column apply in
        turn). One readback of the named columns' entries, one write of
        the refreshed stamps. Returns the number refreshed."""
        keep = [k for k, n in enumerate(names) if n in self._col]
        if not keep:
            return 0
        cols = [self._col[names[k]] for k in keep]
        c = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
        ver, st, home, dirty = (a.tolist() for a in to_host(
            self.version[c], self.stamp[c], self.home_cols[c], self._dirty[c]))
        versions, stamps = np.asarray(versions, np.int64)[keep], np.asarray(stamps, np.float64)[keep]
        fresh: dict[int, float] = {}
        for k, (q, v, s) in enumerate(zip(cols, versions.tolist(), stamps.tolist())):
            if not home[k] and not dirty[k] and ver[k] == v and s > fresh.get(q, st[k]):
                fresh[q] = s
        if fresh:
            take, val = to_device(self.device, np.fromiter(fresh, np.int64, len(fresh)),
                                  np.fromiter(fresh.values(), np.float64, len(fresh)))
            self.stamp[take] = val
        return len(fresh)

    def _merge(self, cols, rows, free, alive, versions, stamps, fields) -> int:
        applied = merge_packed_rows(
            self.view, self.version, self.stamp, cols, rows, versions, stamps,
            alive=alive, protect=self.home_cols, fields=fields,
            # Speculatively-modified columns accept an equal-epoch owner
            # advert: canonical content replaces the speculation.
            reclaim=self._dirty,
        )
        if applied.any():
            take, f = to_device(self.device, cols[applied], free[applied])
            self.free[take] = f
            self._dirty[take] = False       # owner truth replaces speculation
        return int(applied.sum())

    # -- tier summaries (two-level gossip) --------------------------------------
    def tier_summary(
        self,
        tier: str,
        member_sites: Sequence[str],
        now: float = 0.0,
    ) -> TierSummary:
        """Aggregate this peer's view of one tier into a ``TierSummary``
        (one readback)."""
        cols = [self._col[n] for n in member_sites if n in self._col]
        if not cols:
            raise ValueError(f"tier {tier!r} has no known member sites")
        c = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
        v = self.view
        loss, bw = v.loss[c], v.bw[c]
        net = (loss / bw) * 1.0e6
        mathis = v.mss[c] / (v.rtt[c] * sqrt_rn(loss))
        eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
        w = self.weights
        comp = (
            w.w_queue * v.queue[c] / v.cap[c]
            + w.w_work * v.work[c] / v.cap[c]
            + w.w_load * v.load[c]
        )
        n_alive, net_min, eff_max, cap_max, comp_min = torch.stack([
            v.alive[c].to(_F64).sum(), net.amin(), eff.amax(), v.cap[c].amax(), comp.amin(),
        ]).tolist()
        return TierSummary(
            tier=tier, stamp=float(now), n=len(cols), n_alive=int(n_alive),
            net_min=net_min, eff_max=eff_max, cap_max=cap_max, comp_min=comp_min,
        )

    def receive_tier_summaries(self, summaries: Sequence[TierSummary]) -> int:
        """Merge received tier summary rows, last-writer-wins by the
        owner stamp; returns the number applied."""
        applied = 0
        for s in summaries:
            cur = self.tier_summaries.get(s.tier)
            if cur is None or s.stamp > cur.stamp:
                self.tier_summaries[s.tier] = s
                applied += 1
        return applied

    # -- placement over the world view -----------------------------------------
    def _tier_pack(self, tiers) -> TierPack:
        """The cached two-level structure over the world view, refreshed
        narrowly on gossip epoch changes (only a merge can move a remote
        column's static fields, and every merge bumps its version)."""
        if self._tp is None or self._tp_tiers is not tiers:
            self._tp = TierPack.from_site_pack(self.view, tiers)
            self._tp_tiers = tiers
            self._tp_version = self.version.clone()
        else:
            changed = (self.version != self._tp_version).nonzero()[:, 0]
            if changed.numel():
                self._tp.refresh(self.view, changed)
                self._tp_version[changed] = self.version[changed]
        return self._tp

    def _jobs(self, jobs, job_classes) -> JobPack:
        return self.engine.pack_jobs(jobs, job_classes, device=self.device)

    def rank_sites_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        now: Optional[float] = None,
    ) -> list[list[tuple[str, float]]]:
        """Per-job ranking over the world view (the ``cost_matrix_f64``
        plane on the card)."""
        self.refresh_home(now)
        return self.engine.rank(self._jobs(jobs, job_classes), self.view)

    def select_sites_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        now: Optional[float] = None,
        *,
        mode: str = "flat",
        tiers=None,
    ):
        """Snapshot selection over the world view (the fused
        ``cost_argmin_f64`` kernel on the card); ``mode="hier"`` through
        the cached ``TierPack``."""
        self.refresh_home(now)
        jp = self._jobs(jobs, job_classes)
        if mode == "hier":
            return self.engine.select_hier(jp, self.view, self._tier_pack(tiers))
        if mode != "flat":
            raise ValueError(f"mode must be 'flat' or 'hier', got {mode!r}")
        return self.engine.select(jp, self.view)

    def place_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        now: Optional[float] = None,
        *,
        mode: str = "flat",
        tiers=None,
    ):
        """Batched §V placement against the (possibly stale) world view.

        Remote columns keep this peer's optimistic feedback; home columns
        are committed back to the authoritative ``SiteState``. With every
        site home this is bit-identical to ``DianaScheduler.place_batch``.
        """
        self.refresh_home(now)
        jp = self._jobs(jobs, job_classes)
        if mode == "hier":
            placement = self.engine.replay_hier(jp, self.view, self._tier_pack(tiers))
        elif mode == "flat":
            placement = self.engine.replay(jp, self.view)
        else:
            raise ValueError(f"mode must be 'flat' or 'hier', got {mode!r}")
        for job, name in zip(jobs, placement.sites):
            job.site = name
        remote = sorted({self._col[n] for n in placement.sites if n not in self.home_sites})
        if remote:
            self._dirty[torch.as_tensor(remote, device=self.device)] = True
        self._commit_home()
        return placement

    def note_remote_placement(self, site: str, work: float) -> None:
        """Optimistic local feedback for a placement committed outside
        this class: bump the view so this peer's next placement sees it.
        Home columns are skipped (they get truth on the next refresh)."""
        if site in self.home_sites:
            return
        c = self._col[site]
        self.view.queue[c] += 1.0
        self.view.work[c] += work
        self._dirty[c] = True

    def _commit_home(self) -> None:
        q, w = to_host(self.view.queue, self.view.work)
        for n in self.home_names:
            st = self.authoritative[n]
            c = self._col[n]
            st.queue_length = float(q[c])
            st.waiting_work = float(w[c])

    # -- §VIII bulk groups over the world view ---------------------------------
    def view_states(self) -> dict[str, SiteState]:
        """The world view as a ``SiteState`` dict (for the dict-shaped
        §VIII group logic)."""
        v = self.view
        cap, queue, work, load, alive, free = to_host(
            v.cap, v.queue, v.work, v.load, v.alive, self.free)
        return {
            n: SiteState(
                name=n,
                capacity=float(cap[i]),
                queue_length=float(queue[i]),
                waiting_work=float(work[i]),
                load=float(load[i]),
                alive=bool(alive[i]),
                free_slots=float(free[i]),
            )
            for i, n in enumerate(v.names)
        }

    def schedule_group(
        self,
        group: BulkGroup,
        max_group_fraction: float = 1.0,
        now: Optional[float] = None,
    ) -> GroupPlacement:
        """§VIII group placement from this peer's world view, selected
        and split like ``BulkScheduler.schedule_group``; commits land in
        the view (and authoritatively for home columns)."""
        self.refresh_home(now)
        states = self.view_states()
        placement = BulkScheduler(
            DianaScheduler(states, self.links, self.weights, device=self.device),
            max_group_fraction,
        ).schedule_group(group)
        # Pull the committed queue/work deltas back into the packed view.
        q, w = to_host(self.view.queue, self.view.work)
        moved = [
            i for i, n in enumerate(self.view.names)
            if states[n].queue_length != q[i] or states[n].waiting_work != w[i]
        ]
        if moved:
            dev = self.device
            idx = torch.as_tensor(moved, dtype=torch.int64, device=dev)
            names = [self.view.names[i] for i in moved]
            self.view.queue[idx] = torch.as_tensor(
                [states[n].queue_length for n in names], dtype=_F64, device=dev)
            self.view.work[idx] = torch.as_tensor(
                [states[n].waiting_work for n in names], dtype=_F64, device=dev)
            remote = [i for i, n in zip(moved, names) if n not in self.home_sites]
            if remote:
                self._dirty[torch.as_tensor(remote, device=dev)] = True
        self._commit_home()
        return placement


def single_peer(
    sites: dict[str, SiteState],
    links: dict[str, NetworkLink],
    weights: CostWeights = CostWeights(),
    order: Optional[Sequence[str]] = None,
    *,
    device=None,
) -> PeerScheduler:
    """The degenerate 1-peer deployment: every site is home, nothing is
    ever stale — placements bit-identical to ``DianaScheduler``."""
    names = list(sites)
    return PeerScheduler(
        home=names[0], sites=sites, links=links, weights=weights,
        home_sites=names, order=order, device=device,
    )


@dataclass
class _PairState:
    """Per-directed-(sender → receiver) wire state.

    ``acked`` and ``hb_stamp`` live at the sender end (host NumPy);
    ``table`` at the receiver end (the sender's interned site-id table);
    ``sync_round`` is the round of the last full sync (None forces one).
    ``send_seq`` is the sender's per-pair packet counter;
    ``recv_max``/``recv_window`` the receiver's 64-seq replay window.
    """

    acked: Optional[np.ndarray] = None      # (S,) int64, -1 = never acked
    hb_stamp: Optional[np.ndarray] = None   # (S,) f64 stamp last sent
    table: Optional[list] = None
    sync_round: Optional[int] = None
    send_seq: int = 0
    recv_max: int = -1
    recv_window: int = 0

    def accept_seq(self, s: int) -> tuple[bool, bool]:
        """Advance the replay window with pair seq ``s``. Returns
        ``(fresh, reordered)``: not-fresh means duplicate (or older than
        the window); reordered means fresh but behind a seen packet."""
        if s > self.recv_max:
            shift = s - self.recv_max
            self.recv_window = (
                ((self.recv_window << shift) | (1 << (shift - 1)))
                & 0xFFFFFFFFFFFFFFFF
                if self.recv_max >= 0 else 0
            )
            self.recv_max = s
            return True, False
        if s == self.recv_max:
            return False, False  # window bits cover seqs BELOW the max
        behind = self.recv_max - 1 - s
        if behind >= 64:
            return False, False
        bit = 1 << behind
        if self.recv_window & bit:
            return False, False
        self.recv_window |= bit
        return True, True


class _FailureDetector:
    """Phi-accrual suspicion on the gaps between packets heard from one
    sender: ``phi(now)`` is −log10 P(gap ≥ now − last) under a normal
    fit of the recent inter-arrival gaps."""

    __slots__ = ("last", "gaps", "_moments_c", "_suspect_c")

    def __init__(self, window: int = 16):
        self.last: Optional[float] = None
        self.gaps: deque = deque(maxlen=window)
        self._moments_c: Optional[tuple[float, float]] = None
        self._suspect_c: Optional[tuple[float, float]] = None

    def heard(self, now: float) -> None:
        if self.last is not None and now > self.last:
            self.gaps.append(now - self.last)
            self._moments_c = None
            self._suspect_c = None
        self.last = max(self.last, now) if self.last is not None else now

    def _moments(self) -> tuple[float, float]:
        """(mean, floored stddev) of the gap window, cached until the
        next arrival."""
        if self._moments_c is None:
            m = sum(self.gaps) / len(self.gaps)
            var = sum((g - m) ** 2 for g in self.gaps) / len(self.gaps)
            self._moments_c = (m, max(math.sqrt(var), 0.1 * m, 1e-9))
        return self._moments_c

    @staticmethod
    def _phi_of_gap(gap: float, m: float, s: float) -> float:
        p = 0.5 * math.erfc((gap - m) / (s * math.sqrt(2.0)))
        return -math.log10(max(p, 1e-30))

    def phi(self, now: float) -> float:
        if self.last is None or not self.gaps:
            return 0.0
        gap = now - self.last
        if gap <= 0.0:
            return 0.0
        m, s = self._moments()
        return self._phi_of_gap(gap, m, s)

    def suspect_gap(self, threshold: float) -> float:
        """Smallest silence gap at which ``phi`` reaches ``threshold``
        (bisected on the float axis, cached); +inf when unreachable."""
        if not self.gaps:
            return math.inf
        c = self._suspect_c
        if c is not None and c[0] == threshold:
            return c[1]
        g = math.inf
        if threshold <= 30.0:            # -log10 clamp: phi never exceeds 30
            m, s = self._moments()
            hi = m + 40.0 * s
            while self._phi_of_gap(hi, m, s) < threshold:
                hi *= 2.0
            lo = 0.0
            while True:
                mid = (lo + hi) * 0.5
                if not lo < mid < hi:
                    break
                if self._phi_of_gap(mid, m, s) >= threshold:
                    hi = mid
                else:
                    lo = mid
            g = hi
        self._suspect_c = (threshold, g)
        return g

    def mean_gap(self) -> Optional[float]:
        if not self.gaps:
            return None
        return self._moments()[0]


class GossipExchange:
    """Drives advertisement rounds between N peers.

    ``topology`` groups peers by the RootGrid of their home site: within
    a group everyone exchanges with everyone, and each group's
    representative (lowest home name) with the other representatives;
    without one the fan-out is a full mesh. ``fanout`` caps a peer's
    per-round neighbor list, rotating across rounds. ``latency_s``
    delays delivery. ``wire`` is ``"delta"`` (version deltas, quantized
    payloads, heartbeats, a full sync every ``full_sync_every`` rounds
    per pair) or ``"full"``. ``transport`` attaches an unreliable
    transport (canonically ``repro_torch.sim.faults.TransportFaults``);
    None is the reliable exchange. ``summaries`` sends ``TierSummary``
    rows across tiers instead of dense rows.

    The peers' views live on ``device`` (the CUDA card unless
    ``device="cpu"``; every peer must be on it). The exchange's own state
    is host Python and NumPy, as in the reference: the event heap, the
    codec, the per-pair acked / heartbeat-stamp vectors, the replay
    windows, the failure detectors and the transport's ``default_rng``.
    A sender's columns reach the host once per round, in one device →
    host copy shared by all its packets; a received packet is merged in
    one device round trip.
    """

    def __init__(
        self,
        peers: Sequence[PeerScheduler],
        topology: Optional[GridTopology] = None,
        latency_s: float = 0.0,
        fanout: Optional[int] = None,
        wire: str = "delta",
        quant: str = "f32",
        full_sync_every: int = 32,
        transport=None,
        summaries: bool = False,
        *,
        device=None,
    ):
        if wire not in ("delta", "full"):
            raise ValueError(f"wire must be 'delta' or 'full', got {wire!r}")
        if quant not in _QUANT_DTYPES:
            raise ValueError(f"quant must be one of {sorted(_QUANT_DTYPES)}")
        if full_sync_every < 1:
            raise ValueError("full_sync_every must be ≥ 1")
        self.device = resolve_device(device)
        here = torch.empty(0, device=self.device).device
        for p in peers:
            if p.version.device != here:
                raise ValueError(
                    f"peer {p.home!r} lives on {p.version.device}, the exchange on {here}"
                )
        self.peers = list(peers)
        self.transport = transport
        # Seeded per-run transport state (reset_transport re-arms).
        self._t_rng = (
            np.random.default_rng(getattr(transport, "seed", 0))
            if transport is not None else None
        )
        self._ge_bad: dict[tuple[int, int], bool] = {}
        self._fd: dict[tuple[int, int], _FailureDetector] = {}
        self._fd_rev = 0
        self._susp_cache: Optional[tuple[int, float]] = None
        # Liveness bits for peer churn (must exist before the masks).
        self._active = [True] * len(self.peers)
        self.topology = topology
        self.latency_s = float(latency_s)
        self.fanout = fanout
        self.wire = wire
        self.quant = quant
        self.full_sync_every = int(full_sync_every)
        self.stats = ExchangeStats()
        self._seq = itertools.count()
        # Heap entries: (due, tiebreak, receiver, kind, payload), kind
        # "adverts" / "summaries" / "packet" / "ack" / "rto".
        self._in_flight: list[tuple[float, int, int, str, object]] = []
        # Delta wire: packets sent but not yet acknowledged, seq →
        # ((sender, receiver), advertised cols, their versions, the
        # encoded bytes — kept so a faulty transport can retransmit).
        self._pending: dict[
            int, tuple[tuple[int, int], np.ndarray, np.ndarray, bytes]
        ] = {}
        self._pairs: dict[tuple[int, int], _PairState] = {}
        self._groups = self._tier_groups()
        self._reps = [g[0] for g in self._groups]
        self._group_of = {
            i: gi for gi, g in enumerate(self._groups) for i in g
        }
        self._owner_suppress = self._owner_suppression_masks()
        self.summaries = bool(summaries)
        self._peer_tier = [self._rootgrid_of(p.home) for p in self.peers]
        if self.summaries:
            names = list(self.peers[0].view.names) if self.peers else []
            if self.topology is not None:
                self._tier_sites = self.topology.tier_members(names)
            else:
                self._tier_sites = {"mesh": names}

    # -- hierarchy-aware fan-out ----------------------------------------------
    def _rootgrid_of(self, home: str) -> str:
        """The RootGrid tier a peer's home site belongs to; an unknown
        site forms its own singleton tier."""
        if self.topology is None:
            return "mesh"
        roots = self.topology.rootgrids
        if home in roots:
            return home
        for site, root in roots.items():
            if home in root.node_table:
                return site
        return home

    def _tier_groups(self) -> list[list[int]]:
        groups: dict[str, list[int]] = {}
        for i, p in enumerate(self.peers):
            groups.setdefault(self._rootgrid_of(p.home), []).append(i)
        return [
            sorted(g, key=lambda i: self.peers[i].home)
            for _, g in sorted(groups.items())
        ]

    def neighbors(self, idx: int, rnd: int) -> list[int]:
        """This round's fan-out set for peer ``idx``. Inactive peers have
        none and appear in no set; representatives are the first active
        member of each group."""
        if not self._active[idx]:
            return []
        group = [j for j in self._groups[self._group_of[idx]] if self._active[j]]
        out = [j for j in group if j != idx]
        if idx == group[0]:  # the tier representative bridges tiers
            reps = []
            for g in self._groups:
                for m in g:
                    if self._active[m]:
                        reps.append(m)
                        break
            out += [r for r in reps if r != idx]
        if self.fanout is not None and len(out) > self.fanout:
            start = (rnd * self.fanout) % len(out)
            out = [out[(start + k) % len(out)] for k in range(self.fanout)]
        return out

    def set_active(self, idx: int, active: bool) -> None:
        """Peer churn: flip one peer's liveness, reset every directed pair
        that touches it, purge its un-acked packets, and rebuild the
        owner-direct suppression masks."""
        if self._active[idx] == bool(active):
            return
        self._active[idx] = bool(active)
        for key in [k for k in self._pairs if idx in k]:
            del self._pairs[key]
        for seq in [s for s, e in self._pending.items() if idx in e[0]]:
            del self._pending[seq]
        self._owner_suppress = self._owner_suppression_masks()

    def _owner_suppression_masks(self) -> dict[tuple[int, int], np.ndarray]:
        """Per directed pair (i → j): the sender-column mask of hearsay
        the receiver provably hears owner-direct every round (only with
        an uncapped fan-out), plus the receiver's own columns."""
        if self.wire != "delta":
            return {}
        owner_of: dict[str, Optional[int]] = {}
        for i, p in enumerate(self.peers):
            for n in p.home_names:
                owner_of[n] = None if n in owner_of else i  # ambiguous → off
        senders_to: dict[int, set[int]] = {
            j: {
                i
                for i in range(len(self.peers))
                if j in self.neighbors(i, 0)
            }
            for j in range(len(self.peers))
        }
        masks: dict[tuple[int, int], np.ndarray] = {}
        for i, p in enumerate(self.peers):
            for j in range(len(self.peers)):
                if j == i:
                    continue
                direct = (
                    (senders_to[j] if self.fanout is None else set()) | {j}
                )
                masks[(i, j)] = np.asarray(
                    [
                        owner_of.get(n) is not None
                        and owner_of[n] != i
                        and owner_of[n] in direct
                        for n in p.view.names
                    ]
                )
        return masks

    def _pair(self, i: int, j: int) -> _PairState:
        st = self._pairs.get((i, j))
        if st is None:
            S = len(self.peers[i].view.names)
            st = _PairState(
                acked=np.full(S, -1, np.int64),
                hb_stamp=np.full(S, -np.inf),
            )
            self._pairs[(i, j)] = st
        return st

    # -- unreliable transport --------------------------------------------------
    def reset_transport(self) -> None:
        """Re-arm the transport fault model for a fresh run (re-seeded
        RNG, cleared burst and suspicion state, nothing in flight). No-op
        without a model."""
        if self.transport is None:
            return
        self._t_rng = np.random.default_rng(getattr(self.transport, "seed", 0))
        self._ge_bad.clear()
        self._fd.clear()
        self._fd_rev += 1
        self._susp_cache = None
        self._in_flight.clear()
        self._pending.clear()

    def _rto_initial(self) -> float:
        """First ack-timeout: ``rto_s`` if set, else four one-way
        latencies floored at 1 s."""
        rto = getattr(self.transport, "rto_s", None)
        if rto is not None and rto > 0.0:
            return float(rto)
        return max(4.0 * self.latency_s, 1.0)

    def _transport_drops(self, i: int, j: int, now: float) -> bool:
        """One loss decision for a message i→j: partition windows, then
        the Gilbert–Elliott chain, then iid loss. Zero-rate layers draw
        nothing from the RNG."""
        t = self.transport
        if t.partitioned(self.peers[i].home, self.peers[j].home, now):
            return True
        if t.burst_p > 0.0:
            bad = self._ge_bad.get((i, j), False)
            if bad:
                if float(self._t_rng.random()) < t.burst_r:
                    bad = False
            elif float(self._t_rng.random()) < t.burst_p:
                bad = True
            self._ge_bad[(i, j)] = bad
            if bad and float(self._t_rng.random()) < t.burst_loss:
                return True
        return t.loss > 0.0 and float(self._t_rng.random()) < t.loss

    def _reorder_delay(self) -> float:
        t = self.transport
        if t.reorder_jitter_s <= 0.0:
            return 0.0
        return float(self._t_rng.random()) * t.reorder_jitter_s

    def _maybe_corrupt(self, buf: bytes) -> bytes:
        """Flip one random bit with probability ``transport.corrupt``."""
        t = self.transport
        if t.corrupt <= 0.0 or float(self._t_rng.random()) >= t.corrupt:
            return buf
        mutated = bytearray(buf)
        k = int(self._t_rng.integers(len(mutated)))
        mutated[k] ^= 1 << int(self._t_rng.integers(8))
        return bytes(mutated)

    def _send_message(
        self,
        now: float,
        i: int,
        j: int,
        kind: str,
        payload,
        seq_key: Optional[int] = None,
        tiebreak: Optional[int] = None,
    ) -> None:
        """Route one message through the (possibly faulty) transport:
        with no model, one copy at fixed latency, applied inline at zero
        latency; with a model, loss, an optional duplicate, reorder
        jitter and (for packets) bit corruption first."""
        t = self.transport
        delays: list[float] = []
        if t is None:
            delays.append(0.0)
        else:
            if self._transport_drops(i, j, now):
                self.stats.dropped += 1
            else:
                delays.append(self._reorder_delay())
                if t.duplicate > 0.0 and float(self._t_rng.random()) < t.duplicate:
                    self.stats.duplicated += 1
                    delays.append(self._reorder_delay())
        lat = max(self.latency_s, 0.0)
        for copy_idx, extra in enumerate(delays):
            pl = payload
            if t is not None and kind == "packet":
                pl = self._maybe_corrupt(pl)
            elif t is not None and kind in ("adverts", "summaries") and t.corrupt > 0.0:
                # A corrupted object datagram fails its checksum on arrival.
                if float(self._t_rng.random()) < t.corrupt:
                    self.stats.corrupted += 1
                    continue
            due = now + lat + extra
            if due <= now:
                if kind == "packet":
                    self._deliver_packet(now, i, j, pl, seq_key)
                elif kind == "adverts":
                    self._heard(j, i, now)
                    self.stats.adverts_applied += self.peers[j].receive(pl)
                    self.stats.deliveries += 1
                elif kind == "summaries":
                    self._heard(j, i, now)
                    self.peers[j].receive_tier_summaries(pl)
                    self.stats.deliveries += 1
                else:  # "ack"
                    self._apply_ack(pl)
                continue
            tb = (
                tiebreak
                if tiebreak is not None and copy_idx == 0
                else next(self._seq)
            )
            if kind == "packet":
                hp: object = (i, seq_key, pl)
            elif kind in ("adverts", "summaries"):
                hp = (i, pl)
            else:
                hp = pl
            heapq.heappush(self._in_flight, (due, tb, j, kind, hp))

    def _schedule_rto(
        self, now: float, i: int, j: int, seq: int, attempt: int, interval: float
    ) -> None:
        """Arm (or re-arm, backed off) the ack-timeout for packet
        ``seq``, jittered."""
        jitter = 1.0 + getattr(self.transport, "rto_jitter", 0.0) * float(
            self._t_rng.random()
        )
        heapq.heappush(
            self._in_flight,
            (now + interval * jitter, next(self._seq), i, "rto", (j, seq, attempt, interval)),
        )

    def _fire_rto(self, now: float, i: int, payload) -> None:
        """An ack-timeout fired at sender ``i``: retransmit the stored
        bytes and back off, or after ``max_retransmits`` escalate the
        pair to a forced table-bearing full sync."""
        j, pseq, attempt, interval = payload
        entry = self._pending.get(pseq)
        if entry is None:
            return  # acked in time (or churn purged the pair)
        if not (self._active[i] and self._active[j]):
            self._pending.pop(pseq, None)
            return
        t = self.transport
        if attempt > int(getattr(t, "max_retransmits", 0)):
            self._pending.pop(pseq, None)
            pair = self._pairs.get((i, j))
            if pair is not None:
                pair.sync_round = None
            self.stats.sync_escalations += 1
            return
        buf = entry[3]
        self.stats.retransmits += 1
        self.stats.bytes_sent += len(buf)
        self._send_message(now, i, j, "packet", buf, pseq)
        if pseq in self._pending:  # not delivered+acked inline
            self._schedule_rto(
                now, i, j, pseq, attempt + 1,
                interval * float(getattr(t, "rto_backoff", 2.0)),
            )

    def _heard(self, recv: int, sender: int, now: float) -> None:
        """Feed the (receiver, sender) failure detector (only under a
        transport model)."""
        if self.transport is None:
            return
        fd = self._fd.get((recv, sender))
        if fd is None:
            fd = self._fd[(recv, sender)] = _FailureDetector(
                int(getattr(self.transport, "phi_window", 16))
            )
        fd.heard(now)
        self._fd_rev += 1

    def suspicion_phi(self, recv: int, sender: int, now: float) -> float:
        """Phi-accrual suspicion of ``sender`` as seen by ``recv``."""
        fd = self._fd.get((recv, sender))
        return 0.0 if fd is None else fd.phi(now)

    def suspected_peers(self, recv: int, now: float) -> set[int]:
        """Active peers whose silence toward ``recv`` pushed phi past
        ``transport.phi_threshold``; empty without a transport model."""
        if self.transport is None:
            return set()
        thr = float(getattr(self.transport, "phi_threshold", 8.0))
        out: set[int] = set()
        for (r, s), fd in self._fd.items():
            if (
                r == recv
                and self._active[s]
                and fd.last is not None
                and now - fd.last >= fd.suspect_gap(thr)
            ):
                out.add(s)
        return out

    def suspicion_quiet_until(self) -> float:
        """Earliest time any tracked pair's phi can cross the threshold
        with no further arrivals; +inf with no transport or history."""
        if self.transport is None:
            return math.inf
        cache = self._susp_cache
        if cache is not None and cache[0] == self._fd_rev:
            return cache[1]
        thr = float(getattr(self.transport, "phi_threshold", 8.0))
        due = math.inf
        for fd in self._fd.values():
            if fd.last is None:
                continue
            g = fd.suspect_gap(thr)
            if math.isfinite(g):
                due = min(due, fd.last + g)
        self._susp_cache = (self._fd_rev, due)
        return due

    def suspect_mask(self, recv: int, now: float) -> Optional[torch.Tensor]:
        """Boolean mask over peer ``recv``'s view columns, on the device:
        True where the column's owning peer is currently suspect. None
        when no peer is suspect."""
        suspects = self.suspected_peers(recv, now)
        if not suspects:
            return None
        bad: set[str] = set()
        for k in suspects:
            bad.update(self.peers[k].home_names)
        bad -= set(self.peers[recv].home_names)  # own homes are never hearsay
        if not bad:
            return None
        return torch.as_tensor([n in bad for n in self.peers[recv].view.names],
                               dtype=torch.bool, device=self.device)

    def mean_delivery_gap(self, recv: Optional[int] = None) -> Optional[float]:
        """Mean observed inter-arrival gap across failure detectors
        (optionally of one receiver); None before any pair has two
        arrivals."""
        gaps = [
            g
            for (r, _s), fd in self._fd.items()
            if recv is None or r == recv
            for g in (fd.mean_gap(),)
            if g is not None
        ]
        return (sum(gaps) / len(gaps)) if gaps else None

    @property
    def in_flight(self) -> int:
        return len(self._in_flight)

    def next_due(self) -> float:
        """Arrival time of the earliest in-flight message."""
        if not self._in_flight:
            raise ValueError("no adverts in flight")
        return self._in_flight[0][0]

    # -- protocol --------------------------------------------------------------
    def deliver_due(self, now: float) -> int:
        """Deliver every in-flight message whose latency elapsed. Returns
        the number of advert columns applied."""
        applied = 0
        while self._in_flight and self._in_flight[0][0] <= now:
            due, _tb, j, kind, payload = heapq.heappop(self._in_flight)
            if kind == "adverts":
                sender, adverts = payload
                if not self._active[j]:
                    continue          # receiver departed mid-flight
                self._heard(j, sender, due)
                got = self.peers[j].receive(adverts)
                self.stats.deliveries += 1
                self.stats.adverts_applied += got
                applied += got
            elif kind == "summaries":
                sender, rows = payload
                if not self._active[j]:
                    continue
                self._heard(j, sender, due)
                self.peers[j].receive_tier_summaries(rows)
                self.stats.deliveries += 1
            elif kind == "packet":
                sender, pseq, buf = payload
                if not (self._active[j] and self._active[sender]):
                    # An end churned while the packet was airborne.
                    self._pending.pop(pseq, None)
                    continue
                applied += self._deliver_packet(due, sender, j, buf, pseq)
            elif kind == "rto":  # j is the retransmitting sender here
                self._fire_rto(due, j, payload)
            else:  # "ack" — j is the original packet's sender here
                if not self._active[j]:
                    continue
                self._apply_ack(payload)
        return applied

    def round(self, now: float) -> ExchangeStats:
        """One advertisement round: every active peer re-measures its home
        rows and gossips to its fan-out set (everything it knows on the
        full wire, deltas + heartbeats on the delta wire)."""
        self.stats.rounds += 1
        for k, p in enumerate(self.peers):
            if self._active[k]:
                p.refresh_home(now)
        for i, p in enumerate(self.peers):
            targets = self.neighbors(i, self.stats.rounds)
            if not targets:
                continue
            summary_rows = (
                self._summaries_payload(i, now) if self.summaries else None
            )
            adverts = None
            size = 0
            snap = None
            for j in targets:
                # With summaries on, cross-tier sends carry only the
                # summary rows; dense payloads travel within a tier.
                dense = not (
                    self.summaries and self._group_of[i] != self._group_of[j]
                )
                if dense:
                    if self.wire == "delta":
                        if snap is None:
                            snap = self._columns(p)
                        self._send_delta(i, j, now, snap)
                    else:
                        if adverts is None:
                            adverts = p.adverts()
                            size = sum(advert_wire_bytes(a) for a in adverts)
                        self.stats.adverts_sent += len(adverts)
                        self.stats.bytes_sent += size
                        self._send_message(now, i, j, "adverts", adverts)
                if summary_rows is not None:
                    self.stats.summaries_sent += len(summary_rows)
                    self.stats.bytes_sent += sum(
                        summary_wire_bytes(s) for s in summary_rows
                    )
                    self._send_message(now, i, j, "summaries", summary_rows)
        return self.stats

    def _summaries_payload(self, i: int, now: float) -> list[TierSummary]:
        """Sender ``i``'s summary rows: its own tier re-aggregated, plus
        every remote tier row it has heard."""
        p = self.peers[i]
        lab = self._peer_tier[i]
        own = p.tier_summary(lab, self._tier_sites.get(lab, [p.home]), now)
        p.receive_tier_summaries([own])
        return list(p.tier_summaries.values())

    # -- delta wire ------------------------------------------------------------
    @staticmethod
    def _columns(p: PeerScheduler) -> dict:
        """What a sender's delta packets read of its world view, on the
        host (one device → host copy; a sender's view does not change
        while it sends its round's packets)."""
        v = p.view
        names = ("queue", "work", "load", "free", "alive", "version", "stamp", "dirty")
        return dict(zip(names, to_host(v.queue, v.work, v.load, p.free, v.alive,
                                        p.version, p.stamp, p._dirty)))

    def _send_delta(self, i: int, j: int, now: float, snap: dict) -> None:
        """Encode and send one sender→receiver delta packet from the
        sender's host columns ``snap``."""
        p = self.peers[i]
        pair = self._pair(i, j)
        full_sync = (
            pair.sync_round is None
            or self.stats.rounds - pair.sync_round >= self.full_sync_every
        )
        version, stamp = snap["version"], snap["stamp"]
        sendable = ~snap["dirty"]  # speculation never travels under owner epochs
        if full_sync:
            # Join/resync: everything non-dirty, table included.
            delta = sendable.copy()
            pair.sync_round = self.stats.rounds
            self.stats.full_syncs += 1
        else:
            suppressed = self._owner_suppress.get(
                (i, j), np.zeros(len(sendable), bool)
            )
            sendable = sendable & ~suppressed
            delta = sendable & (version > pair.acked)
        cols = np.flatnonzero(delta)
        # Heartbeats: columns the receiver acked at this epoch whose stamp
        # moved since we last told it.
        hb = sendable & ~delta & (stamp > pair.hb_stamp) if not full_sync else (
            np.zeros(len(sendable), bool)
        )
        hb_cols = np.flatnonzero(hb)
        payload = encode_packet(
            names=p.view.names,
            ids=cols,
            qrows=np.stack([snap["queue"][cols], snap["work"][cols], snap["load"][cols]]),
            free=snap["free"][cols],
            alive=snap["alive"][cols],
            versions=version[cols],
            stamps=stamp[cols],
            hb_ids=hb_cols,
            hb_versions=version[hb_cols],
            hb_stamps=stamp[hb_cols],
            quant=self.quant,
            include_table=full_sync,
            pair_seq=pair.send_seq,
        )
        pair.send_seq += 1
        pair.hb_stamp[cols] = stamp[cols]
        pair.hb_stamp[hb_cols] = stamp[hb_cols]
        seq = next(self._seq)
        self._pending[seq] = ((i, j), cols, version[cols].copy(), payload)
        self.stats.adverts_sent += len(cols)
        self.stats.heartbeats_sent += len(hb_cols)
        self.stats.bytes_sent += len(payload)
        self._send_message(now, i, j, "packet", payload, seq, tiebreak=seq)
        t = self.transport
        if (
            t is not None
            and getattr(t, "can_lose", True)
            and seq in self._pending
        ):
            # Packet not delivered+acked inline: arm its ack-timeout.
            self._schedule_rto(now, i, j, seq, 1, self._rto_initial())

    def _deliver_packet(
        self, now: float, sender: int, j: int, buf: bytes, seq: int
    ) -> int:
        """Decode one delta packet at receiver ``j``, merge it and ack
        it. Undecodable packets are dropped un-acked; duplicates are not
        re-merged but re-acked; reordered arrivals merge as normal."""
        self._heard(j, sender, now)
        try:
            pkt = decode_packet(buf)
        except PacketError:
            self.stats.corrupted += 1
            return 0
        pair = self._pair(sender, j)
        if pkt["table"] is not None:
            pair.table = list(pkt["table"])
        if pair.table is None:
            # Churn reset the pair after the packet was sent: its ids are
            # meaningless, so drop it un-acked (the next send full-syncs).
            self._pending.pop(seq, None)
            return 0
        fresh, reordered = pair.accept_seq(pkt["pair_seq"])
        if reordered:
            self.stats.reordered += 1
        if not fresh:
            self.stats.dup_suppressed += 1
            self.stats.acks_sent += 1
            self.stats.bytes_sent += ACK_WIRE_BYTES
            self._send_message(now, j, sender, "ack", seq)
            return 0
        names = pair.table
        recv = self.peers[j]
        applied = recv.receive_packed(
            names=[names[c] for c in pkt["ids"]],
            qrows=pkt["rows"],
            free=pkt["free"],
            alive=pkt["alive"],
            versions=pkt["versions"],
            stamps=pkt["stamps"],
        )
        recv.refresh_stamps(
            names=[names[c] for c in pkt["hb_ids"]],
            versions=pkt["hb_versions"],
            stamps=pkt["hb_stamps"],
        )
        self.stats.deliveries += 1
        self.stats.adverts_applied += applied
        self.stats.acks_sent += 1
        self.stats.bytes_sent += ACK_WIRE_BYTES
        self._send_message(now, j, sender, "ack", seq)
        return applied

    def _apply_ack(self, seq: int) -> None:
        """The receiver holds everything packet ``seq`` advertised:
        advance the sender's per-receiver acked version vector."""
        entry = self._pending.pop(seq, None)
        if entry is None:
            return
        (i, j), cols, versions = entry[0], entry[1], entry[2]
        pair = self._pairs.get((i, j))
        if pair is None:
            return
        pair.acked[cols] = np.maximum(pair.acked[cols], versions)
