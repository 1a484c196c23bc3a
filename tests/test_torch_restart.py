"""The port's survivable cache service (``repro_torch.daemon.journal``,
``server``, ``client``, ``supervisor``) under the JAX package's own
restart tests, run against the port's modules with their bounds
unchanged:

* **journal**: CRC-framed records round-trip; a torn log tail is
  truncated to the clean prefix; snapshots commit atomically and reset
  the log; replay is idempotent.
* **warm restart**: ``warm_state()`` / ``warm_admit()`` round-trip the
  kernel's residency manifest; a daemon rebuilt over the same journal
  re-admits its hot set and serves first-pass hits a cold one cannot.
* **client resilience**: a dead daemon is noticed by heartbeat or by a
  failed call (typed ``DaemonUnavailableError``, never a hung caller),
  degraded reads flow from the backing store, ``flush`` / ``close``
  return promptly, and reconnection replays pins.
* **supervision**: ``DaemonSupervisor`` respawns a crashed daemon on the
  same socket within its budget and settles ``down`` after it.

* **chaos drills**: a supervised daemon killed (or rolled gracefully)
  mid-trace on the port's cluster simulator: the trace completes, the
  client reconnects and the post-recovery windowed CHR lands within 5 %
  of the fault-free run's.

Every test runs under a hard SIGALRM guard.
"""
import os
import signal
import socket
import tempfile
import threading
import time

import pytest
import torch

from repro_torch.core import CacheConfig, MB, open_cache
from repro_torch.core.faults import (DaemonUnavailableError, SHARD_DOWN,
                                     SHARD_UP)
from repro_torch.daemon import (CacheDaemon, CacheJournal, DaemonSupervisor,
                                RemoteCacheClient)
from repro_torch.daemon.journal import LOG_NAME, SNAP_NAME
from repro_torch.daemon.wire import PROTO_VERSION, recv_msg, send_msg
from repro_torch.sim.cluster import ClusterSim
from repro_torch.sim.workloads import make_paper_suite
from repro_torch.storage import RemoteStore, make_dataset


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.restart

CFG = CacheConfig(min_share=4 * MB, rebalance_quantum=4 * MB,
                  window=40, reanalyze_every=20, node_cap=500)

HARD_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def hard_timeout():
    """Recovery tests must never hang tier-1."""

    def boom(signum, frame):  # pragma: no cover - only fires on deadlock
        raise TimeoutError(
            f"restart test exceeded the {HARD_TIMEOUT_S}s hard timeout "
            f"(hung reconnect / lost wakeup?)")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def mk_store(n_datasets=2):
    store = RemoteStore()
    for i in range(n_datasets):
        store.add(make_dataset(f"ds{i}", "dir_tree", n_dirs=2,
                               files_per_dir=6, small_file_size=256 * 1024))
    return store


def all_files(store):
    return [f for ds in store.datasets.values() for f in ds.files]


def wait_until(cond, deadline_s=15.0, tick=0.02, what="condition"):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(tick)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# journal: framing, torn tails, atomic snapshots
# ---------------------------------------------------------------------------

def test_journal_records_roundtrip(tmp_path):
    j = CacheJournal(str(tmp_path))
    records = [("pin", ("ds0",)), ("never_cache", ("tmp", "scratch")),
               ("verdict", "ds1", "SEQUENTIAL", True)]
    for r in records:
        j.append(r)
    j.close()
    j2 = CacheJournal(str(tmp_path))
    snap, replayed = j2.load()
    assert snap is None and replayed == records
    assert j2.stats.replayed_records == 3
    assert j2.stats.truncated_bytes == 0
    j2.close()


def test_journal_torn_tail_truncated_in_place(tmp_path):
    j = CacheJournal(str(tmp_path))
    j.append(("pin", ("a",)))
    j.append(("pin", ("b",)))
    j.close()
    log = tmp_path / LOG_NAME
    clean = log.stat().st_size
    # crash mid-append: a partial frame (and then some garbage) lands
    with open(log, "ab") as f:
        f.write(b"\x00\x00\x01\x00\xde\xad")
    j2 = CacheJournal(str(tmp_path))
    snap, replayed = j2.load()
    assert replayed == [("pin", ("a",)), ("pin", ("b",))]
    assert j2.stats.truncated_bytes == 6
    assert log.stat().st_size == clean       # tail gone from disk too
    # the next append lands on a frame boundary and replays cleanly
    j2.append(("pin", ("c",)))
    j2.close()
    j3 = CacheJournal(str(tmp_path))
    assert list(j3.iter_records()) == [("pin", ("a",)), ("pin", ("b",)),
                                       ("pin", ("c",))]
    j3.close()


def test_journal_corrupt_record_stops_replay(tmp_path):
    j = CacheJournal(str(tmp_path))
    j.append(("pin", ("a",)))
    j.append(("pin", ("b",)))
    j.close()
    log = tmp_path / LOG_NAME
    blob = bytearray(log.read_bytes())
    blob[-1] ^= 0xFF                         # flip a byte in the last frame
    log.write_bytes(bytes(blob))
    j2 = CacheJournal(str(tmp_path))
    _, replayed = j2.load()
    assert replayed == [("pin", ("a",))]     # clean prefix only
    assert j2.stats.truncated_bytes > 0
    j2.close()


def test_journal_snapshot_resets_log_and_commits_atomically(tmp_path):
    j = CacheJournal(str(tmp_path))
    j.append(("pin", ("old",)))
    j.write_snapshot({"pins": [("old",)], "resident": [("k", 4)]})
    j.append(("pin", ("new",)))
    j.close()
    # a stale tmp file from a crash mid-snapshot must be ignored
    (tmp_path / (SNAP_NAME + ".999.tmp")).write_bytes(b"garbage")
    j2 = CacheJournal(str(tmp_path))
    snap, replayed = j2.load()
    assert snap == {"pins": [("old",)], "resident": [("k", 4)]}
    assert replayed == [("pin", ("new",))]   # pre-snapshot records folded
    # replay is idempotent: loading twice changes nothing
    snap2, replayed2 = j2.load()
    assert snap2 == snap and replayed2 == replayed
    j2.close()


def test_journal_unreadable_snapshot_degrades_to_cold(tmp_path):
    j = CacheJournal(str(tmp_path))
    j.write_snapshot({"pins": []})
    j.close()
    (tmp_path / SNAP_NAME).write_bytes(b"IGTJ\x01not-a-frame")
    j2 = CacheJournal(str(tmp_path))
    snap, replayed = j2.load()
    assert snap is None and replayed == []
    j2.close()


# ---------------------------------------------------------------------------
# kernel warm restart: warm_state / warm_admit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 4])
def test_warm_state_round_trip(n_shards):
    """The residency manifest survives a kernel swap: a fresh engine
    fed ``warm_state()`` re-admits the hot set, pins, bans, and
    verdicts — first-pass reads hit without the store ever moving."""
    store = mk_store()
    files = [f.path for f in all_files(store)][:8]
    a = open_cache(store, 48 * MB, cfg=CFG, executor="sim",
                   n_shards=n_shards)
    for t in range(3):
        for i, fp in enumerate(files):
            a.read(fp, 0, 128 * 1024, float(t * len(files) + i))
    a.pin(("ds0",))
    a.never_cache(("ds1", "dir1"))
    state = a.engine.warm_state()
    assert state["resident"] and state["pins"] == [("ds0",)]
    resident_keys = {k for k, _s in state["resident"]}

    b = open_cache(store, 48 * MB, cfg=CFG, executor="sim",
                   n_shards=n_shards)
    restored = b.engine.warm_admit(state, now=100.0)
    assert restored["blocks"] > 0
    assert restored["pins"] == 1
    new_state = b.engine.warm_state()
    assert {k for k, _s in new_state["resident"]} >= resident_keys - {
        k for k in resident_keys if k.startswith("ds1/dir1")}
    assert new_state["pins"] == [("ds0",)]
    assert new_state["never_cache"] == [("ds1", "dir1")]
    # re-admission is visible to the read path: first pass hits
    r = b.read(files[0], 0, 128 * 1024, 101.0)
    assert all(blk.hit for blk in r.blocks)
    # idempotent: a second admit of the same state re-inserts nothing
    again = b.engine.warm_admit(state, now=102.0)
    assert again["blocks"] == 0
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# daemon warm restart: journal → restore → first-pass hits
# ---------------------------------------------------------------------------

def test_daemon_warm_restart_beats_cold(tmp_path):
    """A daemon rebuilt over its journal dir re-admits the hot set: the
    restarted daemon serves first-pass hits on the journaled keys,
    while a cold daemon (no journal) misses every one of them."""
    store = mk_store(1)
    files = [f.path for f in all_files(store)][:8]
    sock = str(tmp_path / "d.sock")
    jdir = str(tmp_path / "journal")

    def first_pass_hits(daemon):
        with open_cache(daemon.uri) as c:
            hits = total = 0
            for i, fp in enumerate(files):
                r = c.read(fp, 0, 128 * 1024, float(1000 + i))
                for blk in r.blocks:
                    hits += bool(blk.hit)
                    total += 1
            return hits, total

    with CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                     journal_dir=jdir) as d:
        with open_cache(d.uri) as c:
            c.pin(("ds0", "dir0"))
            for t in range(2):
                for i, fp in enumerate(files):
                    c.read(fp, 0, 128 * 1024, float(t * 10 + i))
        assert d.write_snapshot()
        assert d.journal.stats.snapshots >= 1

    # warm: same journal dir — restore re-admits the manifest
    with CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                     journal_dir=jdir) as warm:
        rs = warm.restore_stats
        assert rs["mode"] == "warm" and rs["blocks"] > 0
        assert rs["restore_s"] < 5.0
        w_hits, w_total = first_pass_hits(warm)
        st = warm.daemon_stats()
        assert st["restore"]["blocks"] == rs["blocks"]
        # sticky pin survived the restart (snapshot carried it)
        assert ("ds0", "dir0") in warm.client.engine.warm_state()["pins"]

    # cold: fresh journal dir — nothing to restore
    with CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                     journal_dir=str(tmp_path / "j2")) as cold:
        assert cold.restore_stats["mode"] == "cold"
        c_hits, _ = first_pass_hits(cold)

    assert w_hits == w_total, f"warm restart missed: {w_hits}/{w_total}"
    assert c_hits == 0
    # a third daemon over the same journal warm-starts from the warm
    # daemon's close() snapshot (clean-shutdown path)
    with CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                     journal_dir=jdir) as again:
        assert again.restore_stats["mode"] == "warm"


def test_sigterm_drain_sends_going_down_and_snapshots(tmp_path):
    """The graceful path: ``drain()`` (the SIGTERM handler's body)
    notifies live sessions out-of-band, writes a final snapshot, and
    closes.  The client sees the notice as a typed unavailability, not
    a mystery EOF."""
    store = mk_store(1)
    files = [f.path for f in all_files(store)][:4]
    jdir = str(tmp_path / "j")
    d = CacheDaemon(store, 32 * MB, cfg=CFG, uds=str(tmp_path / "d.sock"),
                    journal_dir=jdir).start()
    cli = RemoteCacheClient(d.uri, heartbeat=False, reconnect=False,
                            degraded=False)
    for i, fp in enumerate(files):
        cli.read(fp, 0, 64 * 1024, float(i))
    snaps_before = d.journal.stats.snapshots
    d.drain(timeout=5.0)
    assert d.journal.stats.snapshots >= snaps_before  # final snapshot
    # the queued going_down frame surfaces as the typed error
    with pytest.raises(DaemonUnavailableError):
        cli.read(files[0], 0, 64 * 1024, 99.0)
    assert cli.state == "down"
    cli.close()
    # and the journal it left behind warm-starts a successor
    with CacheDaemon(store, 32 * MB, cfg=CFG,
                     uds=str(tmp_path / "d.sock"), journal_dir=jdir) as d2:
        assert d2.restore_stats["mode"] == "warm"
        assert d2.restore_stats["blocks"] > 0


# ---------------------------------------------------------------------------
# client resilience: typed errors, no hangs, degraded reads, reconnect
# ---------------------------------------------------------------------------

def test_degraded_false_raises_typed_error_and_never_hangs():
    store = mk_store(1)
    f = all_files(store)[0]
    d = CacheDaemon(store, 16 * MB, cfg=CFG).start()
    cli = RemoteCacheClient(d.uri, heartbeat=False, reconnect=False,
                            degraded=False)
    assert cli.read(f.path, 0, 64 * 1024, 0.0).blocks
    d.crash()
    t0 = time.monotonic()
    with pytest.raises(DaemonUnavailableError) as ei:
        for i in range(10):                  # first call marks down,
            cli.read(f.path, 0, 64 * 1024, float(i))  # rest short-circuit
    assert time.monotonic() - t0 < 10.0
    assert isinstance(ei.value, ConnectionError)   # legacy handlers work
    assert cli.state == "down"
    # stats need the daemon: typed error, immediately
    with pytest.raises(DaemonUnavailableError):
        cli.hit_ratio()
    cli.close()
    d.close()


def test_degraded_reads_flow_from_backing_store():
    store = mk_store(1)
    files = all_files(store)[:4]
    d = CacheDaemon(store, 16 * MB, cfg=CFG).start()
    cli = RemoteCacheClient(d.uri, fetch_bytes=True, heartbeat=False,
                            reconnect=False, backing=store)
    direct = {f.path: cli.read(f.path, 0, f.size, 0.0).data.tobytes()
              for f in files}
    # geometry memoized while up: degraded outcomes stay exact
    for f in files:
        assert cli.meta.file_size(f.path) == f.size
    d.crash()
    for f in files:
        r = cli.read(f.path, 0, f.size, 1.0)
        assert r.blocks and not any(blk.hit for blk in r.blocks)
        assert r.data is not None and r.data.tobytes() == direct[f.path]
    cs = cli.client_stats.snapshot()
    assert cs["degraded_reads"] == len(files)
    assert cs["degraded_bytes"] == sum(f.size for f in files)
    # batch path degrades too
    outs = cli.read_batch([(f.path, 0, f.size) for f in files], 2.0)
    assert all(r.data is not None for r in outs)
    cli.close()
    d.close()


def test_heartbeat_marks_connection_dead_not_silent():
    """Satellite: the heartbeat thread must mark the connection down on
    failure (waking future callers with the typed error) instead of
    swallowing the exception and exiting."""
    store = mk_store(1)
    d = CacheDaemon(store, 16 * MB, cfg=CFG, lease_s=0.4).start()
    cli = RemoteCacheClient(d.uri, heartbeat=True, reconnect=False,
                            degraded=False)
    assert cli.state == "up"
    d.crash()
    # no reads issued: only the heartbeat can notice
    wait_until(lambda: cli.state == "down", deadline_s=10.0,
               what="heartbeat-driven down transition")
    with pytest.raises(DaemonUnavailableError):
        cli.heartbeat()
    cli.close()
    d.close()


def test_flush_and_close_short_circuit_on_dead_daemon():
    store = mk_store(1)
    d = CacheDaemon(store, 16 * MB, cfg=CFG).start()
    cli = RemoteCacheClient(d.uri, heartbeat=False, reconnect=False)
    assert cli.flush(timeout=5.0) in (True, False)   # live flush works
    d.crash()
    t0 = time.monotonic()
    assert cli.flush(timeout=30.0) is False          # no 30 s wait
    cli.close()                                      # no bye round-trip
    assert time.monotonic() - t0 < 5.0
    assert cli.state == "closed"
    d.close()


def test_rpc_deadline_wakes_caller_blocked_on_silent_daemon():
    """A daemon that accepts the session then goes mute (wedged, not
    crashed — no EOF ever comes) cannot hang a caller: the RPC deadline
    trips and surfaces the typed error."""
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    path = os.path.join(tempfile.mkdtemp(prefix="igt-mute-"), "s.sock")
    lst.bind(path)
    lst.listen(1)

    def mute_server():
        conn, _ = lst.accept()
        op, _, payload = recv_msg(conn)
        send_msg(conn, ("ok", {"proto": PROTO_VERSION, "session": 0,
                               "lease_s": 5.0, "block_size": 4 * MB,
                               "shm": None, "server_pid": 0}))
        # read the next request and never answer
        try:
            recv_msg(conn)
            time.sleep(30.0)
        except Exception:
            pass

    t = threading.Thread(target=mute_server, daemon=True)
    t.start()
    cli = RemoteCacheClient(f"cache://{path}", heartbeat=False,
                            reconnect=False, degraded=False,
                            rpc_timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(DaemonUnavailableError):
        cli.read(("ds0", "f"), 0, 1024, 0.0)
    assert time.monotonic() - t0 < 5.0
    assert cli.state == "down"
    cli.close()
    lst.close()


def test_client_reconnects_and_replays_pins(tmp_path):
    """Kill → supervisor respawn → client auto-reconnect: a fresh
    session on the same socket path, stale frees dropped, and the
    locally tracked pins replayed into the (journal-less) new daemon."""
    store = mk_store(1)
    files = [f.path for f in all_files(store)][:4]
    sock = str(tmp_path / "d.sock")

    def factory():
        return CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                           lease_s=1.0).start()

    sup = DaemonSupervisor(factory, restart_budget=3)
    cli = RemoteCacheClient(sup.uri, fetch_bytes=True, backing=store,
                            max_backoff_s=0.5)
    try:
        cli.pin(("ds0", "dir0"))
        for i, fp in enumerate(files):
            assert cli.read(fp, 0, 64 * 1024, float(i)).data is not None
        sup.kill_daemon()
        # degraded service while the daemon is away — zero errors
        for i, fp in enumerate(files):
            r = cli.read(fp, 0, 64 * 1024, float(10 + i))
            assert r.data is not None
        wait_until(lambda: sup.state == SHARD_UP and cli.state == "up",
                   what="respawn + reconnect")
        assert cli.reconnects == 1
        # pins replayed by the *client* (this daemon has no journal)
        assert ("ds0", "dir0") in \
            sup.daemon.client.engine.warm_state()["pins"]
        # the new session serves normally, and stats flow again
        r = cli.read(files[0], 0, 64 * 1024, 50.0)
        assert r.data is not None
        assert cli.daemon_stats()["sessions"] == 1
        assert cli.connection_stats()["reconnects"] == 1
    finally:
        cli.close()
        sup.close()


def test_supervisor_budget_exhaustion_stays_down_degraded(tmp_path):
    store = mk_store(1)
    f = all_files(store)[0]
    sock = str(tmp_path / "d.sock")

    def factory():
        return CacheDaemon(store, 16 * MB, cfg=CFG, uds=sock).start()

    sup = DaemonSupervisor(factory, restart_budget=1, restart_window_s=60.0)
    cli = RemoteCacheClient(sup.uri, fetch_bytes=True, backing=store,
                            max_backoff_s=0.2)
    try:
        assert cli.read(f.path, 0, 64 * 1024, 0.0).data is not None
        sup.kill_daemon()
        wait_until(lambda: sup.restarts == 1 and cli.state == "up",
                   what="first respawn")
        sup.kill_daemon()                     # budget (1) now exhausted
        wait_until(lambda: sup.state == SHARD_DOWN, what="budget exhaustion")
        assert any(e["kind"] == "budget_exhausted" for e in sup.events)
        # stable degraded state: reads still flow, nothing hangs
        for i in range(5):
            r = cli.read(f.path, 0, 64 * 1024, float(i))
            assert r.data is not None
        assert cli.client_stats.degraded_reads >= 5
        st = sup.supervisor_stats()
        assert st["state"] == SHARD_DOWN and st["restarts"] == 1
    finally:
        cli.close()
        sup.close()


# ---------------------------------------------------------------------------
# chaos drill: daemon_kill mid-trace on the cluster sim
# ---------------------------------------------------------------------------

def _sim_world():
    suite = make_paper_suite(scale=0.12, seed=0, job_filter=[2, 8])
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    return suite, store, cap


def _run_remote_sim(tmp_path, tag, *, strike=None, recover_by=None,
                    window_from=None, poll_s=0.05):
    """One ClusterSim pass in remote mode: supervised daemon on a UDS,
    the sim driving a ``RemoteCacheClient``.  ``strike=(t, kind)``
    schedules a daemon strike at virtual time ``t`` plus a probe at
    virtual time ``recover_by`` (default just after the strike) that
    *wall-blocks* until respawn + reconnect — virtual time cannot race
    past the recovery, and every read event the sim pumps before
    ``recover_by`` exercises the degraded path; ``window_from``
    snapshots kernel stats at that virtual time for windowed-CHR
    comparison.  ``poll_s`` is the supervisor's crash-detection cadence
    (a slower poll widens the degraded window the drill drives reads
    through)."""
    suite, store, cap = _sim_world()
    sock = str(tmp_path / f"{tag}.sock")
    jdir = str(tmp_path / f"{tag}-journal")

    def factory():
        return CacheDaemon(store, cap, cfg=CFG, uds=sock,
                           journal_dir=jdir, snapshot_every_s=0.1,
                           lease_s=2.0).start()

    sup = DaemonSupervisor(factory, restart_budget=3, poll_s=poll_s)
    cli = RemoteCacheClient(sup.uri, backing=store, max_backoff_s=0.25)
    snaps = {}
    try:
        chaos_events = []
        probes = []
        if strike is not None:
            strike_at, kind = strike
            chaos_events = [(strike_at, kind, 0)]

            def await_recovery(sim):
                # wall-clock pause inside virtual time: the drill's
                # post-recovery window must contain post-recovery reads
                wait_until(lambda: sup.restarts >= 1, what="daemon respawn")

                def client_ok():
                    try:
                        cli.heartbeat()     # forces down-detection too
                        return True
                    except ConnectionError:
                        return False

                wait_until(client_ok, what="client reconnect")

            probes.append((recover_by if recover_by is not None
                           else strike_at + 1.0, await_recovery))
        if window_from is not None:
            probes.append((window_from,
                           lambda sim: snaps.__setitem__(
                               "w", sim.client.stats.snapshot())))
        sim = ClusterSim(suite, cli, chaos_events=chaos_events,
                         chaos_daemon=sup)
        for t, fn in probes:
            sim.at(t, fn)
        res = sim.run()
        snaps["end"] = cli.stats.snapshot()
        return res, snaps, sup.supervisor_stats(), \
            cli.client_stats.snapshot(), cli.connection_stats()
    finally:
        cli.close()
        sup.close()


def _window_chr(snaps):
    s0, s1 = snaps["w"], snaps["end"]
    hits = s1["hits"] - s0["hits"]
    total = hits + s1["misses"] - s0["misses"]
    return hits / total if total else 0.0


def test_chaos_daemon_kill_drill(tmp_path):
    """Acceptance: kill the daemon mid-trace.  The run completes with
    zero hung or errored reads (SIGALRM guards hangs; an exception
    would abort the sim loop), the supervisor respawns within budget,
    the client reconnects, and post-recovery windowed CHR lands within
    5 % of the fault-free run."""
    base_res, _, base_sup, base_cstats, _ = _run_remote_sim(
        tmp_path, "base")
    assert base_res.jct, "baseline sim completed no jobs"
    assert base_sup["restarts"] == 0 and base_cstats["degraded_reads"] == 0
    kill_at = base_res.makespan / 3.0
    window_from = 2.0 * base_res.makespan / 3.0

    _, base_snaps, _, _, _ = _run_remote_sim(
        tmp_path, "basew", window_from=window_from)

    res, snaps, sup_stats, cstats, conn = _run_remote_sim(
        tmp_path, "chaos", strike=(kill_at, "daemon_kill"),
        recover_by=(kill_at + window_from) / 2.0,
        window_from=window_from, poll_s=0.3)

    assert set(res.jct) == set(base_res.jct)      # same jobs completed
    assert res.chaos_log and res.chaos_log[0]["kind"] == "daemon_kill"
    assert sup_stats["restarts"] == 1 and sup_stats["state"] == SHARD_UP
    assert any(e["kind"] == "respawn_done" for e in sup_stats["events"])
    assert conn["reconnects"] >= 1
    assert cstats["degraded_reads"] > 0           # reads flowed while down
    chr_base = _window_chr(base_snaps)
    chr_chaos = _window_chr(snaps)
    assert abs(chr_base - chr_chaos) <= 0.05, (
        f"post-recovery CHR diverged: base={chr_base:.4f} "
        f"chaos={chr_chaos:.4f}")


def test_chaos_daemon_graceful_restart_drill(tmp_path):
    """``daemon_restart``: the SIGTERM-shaped roll mid-trace — drain,
    final snapshot, immediate respawn.  The successor warm-starts and
    the trace completes with zero errors."""
    probe_res, _, _, _, _ = _run_remote_sim(tmp_path, "probe")
    res, _, sup_stats, _, conn = _run_remote_sim(
        tmp_path, "roll",
        strike=(probe_res.makespan / 2.0, "daemon_restart"))
    assert set(res.jct) == set(probe_res.jct)
    assert sup_stats["restarts"] == 1
    done = [e for e in sup_stats["events"] if e["kind"] == "respawn_done"]
    assert done and done[0]["restore"]["mode"] == "warm"



# ---------------------------------------------------------------------------
# opt-in soak: repeated kill/recover cycles (pytest -m restart_full)
# ---------------------------------------------------------------------------

@pytest.mark.restart_full
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_full_repeated_kill_recover_cycles(tmp_path, seed):
    import random
    store = mk_store(1)
    files = [f.path for f in all_files(store)]
    sock = str(tmp_path / "d.sock")
    jdir = str(tmp_path / "j")

    def factory():
        return CacheDaemon(store, 32 * MB, cfg=CFG, uds=sock,
                           journal_dir=jdir, snapshot_every_s=0.1,
                           lease_s=1.0).start()

    sup = DaemonSupervisor(factory, restart_budget=10, restart_window_s=600)
    cli = RemoteCacheClient(sup.uri, fetch_bytes=True, backing=store,
                            max_backoff_s=0.25)
    rng = random.Random(seed)
    try:
        for cycle in range(3):
            for i in range(30):
                fp = files[rng.randrange(len(files))]
                r = cli.read(fp, 0, 64 * 1024, float(cycle * 100 + i))
                assert r.data is not None and r.data.size == 64 * 1024
            time.sleep(0.25)                  # let a snapshot land
            if rng.random() < 0.5:
                sup.kill_daemon()
            else:
                sup.drain_restart()
            for i in range(10):               # degraded or fresh: no errors
                fp = files[rng.randrange(len(files))]
                assert cli.read(fp, 0, 64 * 1024,
                                float(cycle * 100 + 50 + i)).data is not None
            wait_until(lambda: sup.restarts == cycle + 1
                       and cli.state == "up",
                       what=f"recovery cycle {cycle}")
        assert sup.supervisor_stats()["restarts"] == 3
    finally:
        cli.close()
        sup.close()
