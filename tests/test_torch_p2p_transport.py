"""The port's delta-wire codec and unreliable transport against the
reference, on the host: tests/core/test_p2p_transport.py's fuzzed
packets, replay window, delivery edge cases and lossy runs (each lossy
run also equal to the reference's, draw for draw), and the cross-codec
check — packets either package encodes decode in the other, with the
bytes identical, for f32 and f16, int64 epoch extremes, u16 and u32 id
tables, heartbeats, and float64 values just off float16 rounding
midpoints (ROADMAP C4: a torch float64 → float16 cast rounds twice)."""
import copy

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import p2p as RP
from repro.sim.faults import PartitionWindow as RPW, TransportFaults as RTF
from repro_torch.core import p2p as PP
from repro_torch.core.p2p import PacketError, _PairState, decode_packet, encode_packet
from repro_torch.sim.faults import PartitionWindow, TransportFaults

CPU = "cpu"


def _grid(mod, rng, n_sites):
    sites, links = {}, {}
    for i in range(n_sites):
        name = f"s{i}"
        sites[name] = mod.SiteState(
            name=name, capacity=float(rng.integers(10, 2000)),
            queue_length=float(rng.integers(0, 100)),
            waiting_work=float(rng.uniform(0, 1000)),
            load=float(rng.uniform(0, 1)),
        )
        links[name] = mod.NetworkLink(
            bandwidth_Bps=float(rng.uniform(1e8, 1e10)),
            rtt_s=float(rng.uniform(0.001, 0.3)),
        )
    return sites, links


def _mesh(seed, n_sites=6, n_peers=3, mod=P, **kw):
    """tests/core/test_p2p_transport.py's mesh, in either package (the
    port's on the host)."""
    rng = np.random.default_rng(seed)
    sites, links = _grid(mod, rng, n_sites)
    names = list(sites)
    dev = {"device": CPU} if mod is P else {}
    peers = [
        mod.PeerScheduler(home=names[i], sites=copy.deepcopy(sites), links=dict(links),
                          home_sites=names[i::n_peers], order=names, **dev)
        for i in range(min(n_peers, len(names)))
    ]
    return peers, mod.GossipExchange(peers, **dev, **kw)


def _packet_args(seed, include_table=True, quant="f32"):
    rng = np.random.default_rng(seed)
    n_sites = int(rng.integers(4, 24))
    n = int(rng.integers(0, min(6, n_sites)))
    n_hb = int(rng.integers(0, min(6, n_sites)))
    names = [f"site-{i:03d}" for i in range(n_sites)]
    kw = dict(
        ids=rng.choice(n_sites, size=n, replace=False),
        qrows=rng.uniform(0, 1e4, size=(3, n)),
        free=rng.uniform(0, 64, size=n),
        alive=rng.uniform(size=n) > 0.3,
        versions=rng.integers(0, 2**40, size=n).astype(np.int64),
        stamps=rng.uniform(0, 1e6, size=n),
        hb_ids=rng.choice(n_sites, size=n_hb, replace=False),
        hb_versions=rng.integers(0, 2**40, size=n_hb).astype(np.int64),
        hb_stamps=rng.uniform(0, 1e6, size=n_hb),
        include_table=include_table, quant=quant,
        pair_seq=int(rng.integers(0, 2**32)),
    )
    return names, kw


def _valid_buffer(seed, include_table=True):
    names, kw = _packet_args(seed, include_table)
    return encode_packet(names, **kw)


def _decoded_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _f16_midpoints(n, seed=0):
    """float64 values on and just off the midpoints between adjacent
    float16 numbers (normal range): NumPy rounds each once, to the
    nearest float16; a cast through float32 first lands exactly on the
    midpoint and ties to even."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0x0400, 0x7BFF, size=n).astype(np.uint16)
    lo = bits.view(np.float16).astype(np.float64)
    hi = (bits + 1).view(np.float16).astype(np.float64)
    mid = (lo + hi) / 2.0
    off = np.ldexp(1.0, np.frexp(mid)[1] - 42)          # far below float32's precision
    return np.concatenate([[1 + 2**-11 + 2**-40, 1 + 2**-11 - 2**-40, 1 + 2**-11],
                           mid + off, mid - off, mid])


class TestCrossCodec:
    """Bytes the reference encodes decode in the port and the reverse,
    and both encoders emit the same bytes."""

    def _both_ways(self, names, kw):
        ref = RP.encode_packet(names, **kw)
        port = encode_packet(names, **kw)
        assert port == ref
        _decoded_equal(decode_packet(ref), RP.decode_packet(ref))
        _decoded_equal(RP.decode_packet(port), decode_packet(port))
        return decode_packet(port)

    @pytest.mark.parametrize("quant", ["f32", "f16"])
    @pytest.mark.parametrize("seed", range(6))
    def test_seeded_packets(self, seed, quant):
        names, kw = _packet_args(seed, include_table=bool(seed % 2), quant=quant)
        out = self._both_ways(names, kw)
        assert out["quant"] == quant and out["pair_seq"] == kw["pair_seq"]

    @pytest.mark.parametrize("quant", ["f32", "f16"])
    def test_epochs_exact_at_int64_extremes(self, quant):
        big = np.asarray([2**62, 0, 1, 2**63 - 1], np.int64)
        out = self._both_ways(["a", "b", "c", "d"], dict(
            ids=np.arange(4), qrows=np.zeros((3, 4)), free=np.zeros(4), alive=np.ones(4, bool),
            versions=big, stamps=np.zeros(4), hb_ids=np.asarray([0, 3]),
            hb_versions=np.asarray([2**62 + 1, -(2**63)], np.int64), hb_stamps=np.asarray([0.0, 1.5]),
            quant=quant, include_table=True, pair_seq=2**32 + 5))
        assert (out["versions"] == big).all()
        assert out["hb_versions"].tolist() == [2**62 + 1, -(2**63)]
        assert out["pair_seq"] == 5          # the header keeps the low 32 bits

    @pytest.mark.parametrize("n_names,wide", [(65_535, False), (70_000, True)])
    def test_u16_and_u32_id_tables(self, n_names, wide):
        names = [f"n{i}" for i in range(n_names)]
        last = n_names - 1
        out = self._both_ways(names, dict(
            ids=np.asarray([0, last]), qrows=np.zeros((3, 2)), free=np.zeros(2),
            alive=np.ones(2, bool), versions=np.zeros(2, np.int64), stamps=np.zeros(2),
            hb_ids=np.asarray([last - 1]), hb_versions=np.zeros(1, np.int64),
            hb_stamps=np.zeros(1), include_table=True))
        assert out["ids"].tolist() == [0, last] and out["hb_ids"].tolist() == [last - 1]
        assert len(out["table"]) == n_names
        flags = encode_packet(names, ids=np.asarray([0]), qrows=np.zeros((3, 1)), free=np.zeros(1),
                              alive=np.ones(1, bool), versions=np.zeros(1, np.int64),
                              stamps=np.zeros(1), hb_ids=np.asarray([], np.int64),
                              hb_versions=np.zeros(0, np.int64), hb_stamps=np.zeros(0))[3]
        assert bool(flags & 4) == wide

    def test_heartbeat_only_and_empty_packets(self):
        for n_hb in (0, 3):
            self._both_ways(["x", "y", "z"], dict(
                ids=np.asarray([], np.int64), qrows=np.zeros((3, 0)), free=np.zeros(0),
                alive=np.zeros(0, bool), versions=np.zeros(0, np.int64), stamps=np.zeros(0),
                hb_ids=np.arange(n_hb), hb_versions=np.arange(n_hb, dtype=np.int64) * 7,
                hb_stamps=np.linspace(0.0, 3.0, n_hb)))

    def test_f16_midpoints_round_once_as_numpy(self):
        """ROADMAP C4: the payload's float64 → float16 cast is NumPy's,
        correctly rounded once."""
        vals = _f16_midpoints(4000)
        n = len(vals) // 3
        qrows = vals[: 3 * n].reshape(3, n)
        free = vals[:n][::-1].copy()
        kw = dict(ids=np.arange(n) % 60000, qrows=qrows, free=free, alive=np.ones(n, bool),
                  versions=np.arange(n, dtype=np.int64), stamps=np.zeros(n),
                  hb_ids=np.asarray([], np.int64), hb_versions=np.zeros(0, np.int64),
                  hb_stamps=np.zeros(0), quant="f16")
        names = [f"n{i}" for i in range(60000)]
        out = self._both_ways(names, kw)
        assert out["rows"].tolist() == qrows.astype(np.float16).astype(np.float64).tolist()
        assert out["free"].tolist() == free.astype(np.float16).astype(np.float64).tolist()
        # the smallest such input: 1 + 2^-11 + 2^-40 goes up, not to 1.0
        assert out["rows"][0, 0] == 1.0009765625

    def test_quant_fields_and_ack_size(self):
        assert PP.QUANT_FIELDS == RP.QUANT_FIELDS and PP.OWNER_FIELDS == RP.OWNER_FIELDS
        assert PP.ACK_WIRE_BYTES == RP.ACK_WIRE_BYTES == 16

    def test_bad_magic_and_qrows_shape_raise(self):
        with pytest.raises(ValueError, match="magic"):
            decode_packet(b"XX" + b"\x00" * 32)
        with pytest.raises(ValueError, match="qrows"):
            encode_packet(["a"], ids=np.asarray([0]), qrows=np.zeros((2, 1)), free=np.zeros(1),
                          alive=np.ones(1, bool), versions=np.zeros(1, np.int64),
                          stamps=np.zeros(1), hb_ids=np.asarray([], np.int64),
                          hb_versions=np.zeros(0, np.int64), hb_stamps=np.zeros(0))


def _decode_never_crashes(buf):
    try:
        out = decode_packet(bytes(buf))
    except PacketError:
        return False
    assert isinstance(out, dict) and "ids" in out
    return True


class TestPacketFuzz:
    """Byte-mutation fuzzing of ``decode_packet``: it succeeds or raises
    ``PacketError``, exactly when the reference's does."""

    @pytest.mark.parametrize("seed", range(12))
    def test_truncation_and_bitflips_raise(self, seed):
        rng = np.random.default_rng(seed)
        buf = _valid_buffer(seed, include_table=bool(seed % 2))
        for _ in range(8):
            cut = int(rng.integers(0, len(buf)))
            with pytest.raises(PacketError):
                decode_packet(buf[:cut])
            mutated = bytearray(buf)
            k = int(rng.integers(len(mutated)))
            mutated[k] ^= 1 << int(rng.integers(8))
            with pytest.raises(PacketError):
                decode_packet(bytes(mutated))

    @pytest.mark.parametrize("seed", range(12))
    def test_extension_and_garbage_agree_with_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        buf = _valid_buffer(seed)
        extended = buf + bytes(rng.integers(0, 256, size=int(rng.integers(1, 40)), dtype=np.uint8))
        garbage = bytes(rng.integers(0, 256, size=int(rng.integers(0, 120)), dtype=np.uint8))
        for b in (extended, garbage, buf[:2] + garbage):
            ok = _decode_never_crashes(b)
            try:
                RP.decode_packet(b)
                ref_ok = True
            except RP.PacketError:
                ref_ok = False
            assert ok == ref_ok

    def test_shuffled_sections_never_crash(self):
        rng = np.random.default_rng(3)
        buf = bytearray(_valid_buffer(3))
        for _ in range(16):
            mutated = bytearray(buf)
            a, b = rng.integers(2, len(mutated), size=2)
            mutated[int(a)], mutated[int(b)] = mutated[int(b)], mutated[int(a)]
            _decode_never_crashes(mutated)

    def test_valid_roundtrip_still_decodes(self):
        out = decode_packet(_valid_buffer(7))
        assert out["table"] is not None and isinstance(out["pair_seq"], int)


class TestReplayWindow:
    """``_PairState.accept_seq`` against the reference's on seeded
    sequences, and its fixed derivations."""

    @pytest.mark.parametrize("seed", range(4))
    def test_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        a, b = _PairState(), RP._PairState()
        for s in rng.integers(0, 200, size=400).tolist():
            assert a.accept_seq(s) == b.accept_seq(s)
            assert (a.recv_max, a.recv_window) == (b.recv_max, b.recv_window)

    def test_derivations(self):
        p = _PairState()
        for s in range(10):
            assert p.accept_seq(s) == (True, False)
        assert p.accept_seq(9) == (False, False)
        p = _PairState()
        p.accept_seq(0)
        p.accept_seq(5)
        assert p.accept_seq(3) == (True, True)
        assert p.accept_seq(3) == (False, False)
        p = _PairState()
        p.accept_seq(0)
        p.accept_seq(100)
        assert p.accept_seq(30) == (False, False)
        assert p.accept_seq(50) == (True, True)


class TestDeliveryEdgeCases:
    def test_next_due_empty_heap_raises(self):
        _, ex = _mesh(0)
        with pytest.raises(ValueError, match="no adverts in flight"):
            ex.next_due()
        assert ex.deliver_due(1e9) == 0

    @pytest.mark.parametrize("wire", ["delta", "full"])
    def test_receiver_departs_mid_flight(self, wire):
        peers, ex = _mesh(2, wire=wire, latency_s=10.0)
        ex.round(now=0.0)
        assert ex.in_flight > 0
        for k in range(1, len(peers)):
            ex.set_active(k, False)
        ex.deliver_due(100.0)
        assert ex.in_flight == 0
        assert not ex._pending
        for k in range(1, len(peers)):
            ex.set_active(k, True)
        ex.round(now=200.0)
        ex.deliver_due(300.0)

    def test_sender_departs_mid_flight(self):
        peers, ex = _mesh(3, wire="delta", latency_s=10.0)
        ex.round(now=0.0)
        ex.set_active(0, False)
        assert ex.deliver_due(100.0) >= 0
        assert not any(idx == 0 for (idx, _j) in ex._pairs)

    def test_all_peers_inactive_round_sends_nothing(self):
        peers, ex = _mesh(4, latency_s=5.0)
        for k in range(len(peers)):
            ex.set_active(k, False)
        ex.round(now=0.0)
        assert ex.in_flight == 0 and ex.deliver_due(1e9) == 0


def _converged(peers, value):
    return all(bool((p.view.queue == value).all()) for p in peers)


def _views(peers):
    return repr([[np.asarray(c).tolist() for c in (p.view.queue, p.view.work, p.view.load,
                                                    p.version, p.stamp, p.free)]
                 for p in peers])


def _twin_transport(tf):
    """The reference's TransportFaults equal to a port's one."""
    parts = tuple(RPW(start=w.start, end=w.end, groups=w.groups) for w in tf.partitions)
    kw = {f: getattr(tf, f) for f in tf.__dataclass_fields__ if f != "partitions"}
    return RTF(partitions=parts, **kw)


class TestUnreliableTransport:
    """Loss → retransmit → ack, duplicates, corruption, escalation and
    suspicion on the port, each run also equal to the reference's."""

    def _two_peer(self, transport, latency_s=1.0, mod=P, **kw):
        peers, ex = _mesh(11, n_sites=6, n_peers=2, mod=mod,
                          latency_s=latency_s, transport=transport, **kw)
        for p in peers:
            for n in p.home_names:
                p.authoritative[n].queue_length = 111.0
        return peers, ex

    def _both(self, transport, drive, latency_s=1.0, **kw):
        """``drive(peers, ex)`` on the port and on the reference, from the
        same state; returns the port's (peers, ex) after checking the two
        runs' stats and views are equal."""
        out = []
        for mod, t in ((P, transport), (R, _twin_transport(transport))):
            peers, ex = self._two_peer(t, latency_s, mod=mod, **kw)
            drive(peers, ex)
            out.append((peers, ex))
        (pp, pe), (rp, re) = out
        assert pe.stats.as_dict() == re.stats.as_dict()
        assert _views(pp) == _views(rp)
        return pp, pe

    @pytest.mark.parametrize("wire", ["delta", "full"])
    @pytest.mark.parametrize("latency", [0.0, 5.0])
    def test_zero_rate_transport_is_bit_identical(self, wire, latency):
        runs = []
        for transport in (None, TransportFaults(seed=99)):
            peers, ex = _mesh(20, wire=wire, latency_s=latency, transport=transport)
            rng = np.random.default_rng(5)
            for r in range(6):
                for p in peers:
                    for n in p.home_names:
                        p.authoritative[n].queue_length = float(rng.integers(0, 500))
                ex.deliver_due(60.0 * r)
                ex.round(now=60.0 * r)
            ex.deliver_due(1e9)
            runs.append((peers, ex))
        (pa, ea), (pb, eb) = runs
        assert _views(pa) == _views(pb)
        assert ea.stats.as_dict() == eb.stats.as_dict()
        assert eb.stats.dropped == 0 and eb.stats.duplicated == 0

    def test_partition_drop_retransmit_recovery(self):
        window = PartitionWindow(start=0.0, end=10.0, groups=(
            frozenset(["s0", "s2", "s4"]), frozenset(["s1", "s3", "s5"])))
        t = TransportFaults(seed=0, partitions=(window,), rto_jitter=0.0)

        def drive(peers, ex):
            ex.round(now=5.0)
            assert ex.stats.dropped > 0 and ex._pending
            ex.deliver_due(60.0)
        peers, ex = self._both(t, drive)
        assert ex.stats.retransmits > 0
        assert not ex._pending
        assert _converged(peers, 111.0)

    def test_escalation_after_max_retransmits(self):
        window = PartitionWindow(start=0.0, end=1e9, groups=(
            frozenset(["s0", "s2", "s4"]), frozenset(["s1", "s3", "s5"])))
        t = TransportFaults(seed=0, partitions=(window,), rto_s=2.0, max_retransmits=1,
                            rto_jitter=0.0)

        def drive(peers, ex):
            ex.round(now=0.0)
            ex.deliver_due(1000.0)
        peers, ex = self._both(t, drive)
        assert ex.stats.retransmits >= 1 and ex.stats.sync_escalations >= 1
        assert not ex._pending
        assert all(pair.sync_round is None for pair in ex._pairs.values())

    def test_duplicate_suppressed_but_still_acked(self):
        def drive(peers, ex):
            ex.round(now=0.0)
            ex.deliver_due(100.0)
        peers, ex = self._both(TransportFaults(seed=0, duplicate=1.0), drive)
        assert ex.stats.duplicated > 0 and ex.stats.dup_suppressed > 0
        assert not ex._pending
        assert _converged(peers, 111.0)

    def test_corrupted_packet_dropped_not_merged(self):
        t = TransportFaults(seed=0, corrupt=1.0, rto_s=2.0, max_retransmits=1, rto_jitter=0.0)
        peers, ex = self._two_peer(t)
        before = [p.view.queue.clone() for p in peers]
        ex.round(now=0.0)
        ex.deliver_due(1000.0)
        assert ex.stats.corrupted > 0 and ex.stats.sync_escalations >= 1
        for p, q in zip(peers, before):
            foreign = ~p.home_cols
            assert p.view.queue[foreign].tolist() == q[foreign].tolist()

    def test_reorder_jitter_reorders_and_merges(self):
        def drive(peers, ex):
            rng = np.random.default_rng(0)
            for r in range(12):
                for p in peers:
                    for n in p.home_names:
                        p.authoritative[n].queue_length = float(rng.integers(0, 500))
                ex.deliver_due(60.0 * r)
                ex.round(now=60.0 * r)
            ex.deliver_due(1e9)
        peers, ex = self._both(TransportFaults(seed=4, reorder_jitter_s=150.0), drive)
        assert ex.stats.reordered > 0 and ex.stats.dropped == 0
        for p in peers:
            for q in peers:
                for n in q.home_names:
                    assert p.view.queue[p._col[n]] == q.authoritative[n].queue_length

    def test_suspicion_rises_with_silence(self):
        t = TransportFaults(seed=0, loss=1e-9, phi_threshold=3.0)
        peers, ex = self._two_peer(t, latency_s=0.0)
        for r in range(8):
            ex.round(now=60.0 * r)
            ex.deliver_due(60.0 * r)
        assert ex.suspicion_phi(0, 1, 421.0) < 1.0
        assert ex.suspected_peers(0, 421.0) == set()
        assert ex.suspect_mask(0, 421.0) is None
        assert ex.suspicion_phi(0, 1, 2000.0) >= 3.0
        assert ex.suspected_peers(0, 2000.0) == {1}
        mask = ex.suspect_mask(0, 2000.0)
        names = list(peers[0].view.names)
        assert [bool(mask[names.index(n)]) for n in peers[1].home_names] == [True] * len(
            peers[1].home_names)
        assert not any(bool(mask[names.index(n)]) for n in peers[0].home_names)
        gap = ex.mean_delivery_gap(0)
        assert gap is not None and 50.0 <= gap <= 70.0
        rp, rex = self._two_peer(_twin_transport(t), latency_s=0.0, mod=R)
        for r in range(8):
            rex.round(now=60.0 * r)
            rex.deliver_due(60.0 * r)
        for now in (421.0, 900.0, 2000.0):
            assert ex.suspicion_phi(0, 1, now) == rex.suspicion_phi(0, 1, now)
        assert ex.suspicion_quiet_until() == rex.suspicion_quiet_until()
        assert np.asarray(mask).tolist() == rex.suspect_mask(0, 2000.0).tolist()

    def test_no_transport_means_no_suspicion(self):
        peers, ex = _mesh(12)
        ex.round(now=0.0)
        assert ex.suspected_peers(0, 1e9) == set()
        assert ex.suspicion_phi(0, 1, 1e9) == 0.0
        assert ex.mean_delivery_gap() is None

    @pytest.mark.parametrize("wire,quant", [("delta", "f32"), ("delta", "f16"), ("full", "f32")])
    def test_lossy_runs_replay_the_reference(self, wire, quant):
        """Same seed ⇒ the reference's drops, retransmits and final
        views, draw for draw (the transport's NumPy default_rng)."""
        t = TransportFaults(seed=7, loss=0.2, duplicate=0.1, reorder_jitter_s=10.0,
                            corrupt=0.02, burst_p=0.1, burst_r=0.5, burst_loss=0.7)
        out = []
        for mod, tf in ((P, t), (R, _twin_transport(t)), (P, t)):
            peers, ex = _mesh(13, mod=mod, latency_s=2.0, transport=tf, wire=wire, quant=quant)
            rng = np.random.default_rng(1)
            vals = _f16_midpoints(200, seed=2)
            seen = []
            for r in range(10):
                for p in peers:
                    for n in p.home_names:
                        p.authoritative[n].queue_length = float(rng.integers(0, 500))
                        p.authoritative[n].waiting_work = float(vals[int(rng.integers(len(vals)))])
                ex.deliver_due(60.0 * r)
                ex.round(now=60.0 * r)
                seen.append(_views(peers))
            ex.deliver_due(1e9)
            out.append((ex.stats.as_dict(), seen + [_views(peers)]))
        assert out[0] == out[1] == out[2]
        assert out[0][0]["dropped"] > 0
        assert (out[0][0]["retransmits"] > 0) == (wire == "delta")   # the full wire re-floods

    def test_reset_transport_clears_flight_state(self):
        peers, ex = _mesh(14, latency_s=5.0, transport=TransportFaults(seed=7, loss=0.3))
        ex.round(now=0.0)
        assert ex.in_flight > 0
        ex.reset_transport()
        assert ex.in_flight == 0 and not ex._pending
        assert ex.mean_delivery_gap() is None

    def test_stats_dict_carries_transport_counters(self):
        _, ex = _mesh(15, transport=TransportFaults(seed=0))
        d = ex.stats.as_dict()
        assert d == R.ExchangeStats().as_dict()
        for key in ("dropped", "duplicated", "corrupted", "dup_suppressed",
                    "reordered", "retransmits", "sync_escalations"):
            assert d[key] == 0
