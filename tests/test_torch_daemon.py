"""The port's cache daemon (``repro_torch.daemon``) under the JAX package's
own daemon tests, run against the port's modules with their bounds
unchanged: the shared reply codec round-trips bitwise, ``open_cache(
"cache://...")`` gives the outcomes and bytes of a direct ``open_cache``
over the same store and trace, two clients racing one dataset keep
identity-hit accounting exact, and a client that dies mid-read (lease
expiry or EOF) leaks nothing, under the in-process and the process
driver.  The cluster-simulator chaos cases come with the port's
simulator.  Cross-package cases at the end hold a port client and daemon
against the reference pair.

Every test runs under a hard SIGALRM guard: a deadlocked serve thread
or a lost reply must fail the test, not hang the suite.
"""
import pickle
import random
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import CacheConfig, MB, block_key, open_cache, path_key
from repro_torch.core.igtcache import BlockResult, ReadOutcome
from repro_torch.core.wire import WireOutcome, encode_outcome
from repro_torch.daemon import CacheDaemon, RemoteCacheClient
from repro_torch.daemon.wire import PROTO_VERSION, recv_msg, send_msg
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


pytestmark = pytest.mark.daemon

CFG = CacheConfig(min_share=4 * MB, rebalance_quantum=4 * MB,
                  window=40, reanalyze_every=20, node_cap=500)

HARD_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def hard_timeout():
    """Socket/lease tests must never hang tier-1."""

    def boom(signum, frame):  # pragma: no cover - only fires on deadlock
        raise TimeoutError(
            f"daemon test exceeded the {HARD_TIMEOUT_S}s hard timeout "
            f"(stuck serve thread / lost reply?)")

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


def executor_identity(st):
    return st.completed + st.cancelled + st.deduped


def wait_until(cond, deadline_s=15.0, tick=0.02, what="condition"):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(tick)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# shared codec: seeded round-trip property test
# ---------------------------------------------------------------------------

def test_wire_codec_roundtrip_seeded():
    """encode → pickle → decode must reproduce the ``ReadOutcome``
    bitwise: every block (key, size, hit, prefetched_hit), the byte
    tallies, and the candidate list.  Re-encoding a ``WireOutcome`` is
    the identity (the daemon proxies driver outcomes for free)."""
    rng = random.Random(1234)
    for case in range(200):
        fp = (f"ds{rng.randrange(3)}", f"dir{rng.randrange(4)}",
              f"f{rng.randrange(50)}")
        first = rng.randrange(0, 100)
        n_blocks = rng.randrange(1, 12)
        blocks, prefetches = [], []
        for i in range(n_blocks):
            hit = rng.random() < 0.5
            pf = hit and rng.random() < 0.5
            blocks.append(BlockResult(path_key(block_key(fp, first + i)),
                                      rng.randrange(1, 4 * MB), hit, pf))
        for _ in range(rng.randrange(0, 4)):
            prefetches.append(((fp[0], fp[1], f"p{rng.randrange(9)}",
                                f"#{rng.randrange(8)}"),
                               rng.randrange(1, MB)))
        out = ReadOutcome(blocks, prefetches)
        enc = pickle.loads(pickle.dumps(encode_outcome(out, first)))
        wo = WireOutcome(enc, fp)
        assert [(b.key, b.size, b.hit, b.prefetched_hit)
                for b in wo.blocks] == \
               [(b.key, b.size, b.hit, b.prefetched_hit)
                for b in out.blocks], f"case {case}"
        assert wo.remote_bytes == out.remote_bytes
        assert wo.cached_bytes == out.cached_bytes
        assert wo.prefetches == out.prefetches
        # re-encode of an already-wire outcome: the identity, not a copy
        assert encode_outcome(wo, first) is enc


# ---------------------------------------------------------------------------
# client contract: cache:// equals a direct open_cache
# ---------------------------------------------------------------------------

def test_remote_client_matches_direct_open_cache():
    """The acceptance contract: a seeded mixed trace through
    ``open_cache("cache://...")`` produces per-block outcomes and
    payload bytes identical to a direct ``open_cache`` on the same
    store — the daemon adds transport, never semantics."""
    store = mk_store()
    direct = open_cache(store, 48 * MB, cfg=CFG, executor="sim",
                        fetch_bytes=True)
    files = all_files(store)
    rng = np.random.default_rng(11)
    with CacheDaemon(store, 48 * MB, cfg=CFG, executor="sim") as d, \
            open_cache(d.uri, fetch_bytes=True) as remote:
        t = 0.0
        for rep in range(4):
            picks = rng.integers(0, len(files), 24)
            reqs = []
            for j in picks:
                f = files[int(j)]
                off = int(rng.integers(0, 2)) * 128 * 1024
                reqs.append((f.path, off, f.size - off))
            got = remote.read_batch(reqs, t)
            want = direct.read_batch(reqs, t)
            for g, w in zip(got, want):
                assert [(b.key, b.size, b.hit, b.prefetched_hit)
                        for b in g.blocks] == \
                       [(b.key, b.size, b.hit, b.prefetched_hit)
                        for b in w.blocks]
                assert g.remote_bytes == w.remote_bytes
                assert g.cached_bytes == w.cached_bytes
                assert g.data is not None and w.data is not None
                assert g.data.tobytes() == w.data.tobytes()
            t += 0.5
        assert remote.stats.snapshot() == direct.stats.snapshot()
        assert remote.hit_ratio() == direct.hit_ratio()
    direct.close()


def test_uri_query_params_and_capacity_guard(tmp_path):
    store = mk_store(1)
    with CacheDaemon(store, 16 * MB, cfg=CFG,
                     uds=str(tmp_path / "d.sock")) as d:
        # query params ride the URI into the client constructor
        c = open_cache(d.uri + "?fetch_bytes=true&label=trainer0")
        assert c.fetch_bytes is True
        f = all_files(store)[0]
        r = c.read(f.path, 0, f.size, now=1.0)
        assert r.data is not None and r.data.size == f.size
        c.close()
        # the daemon owns capacity: passing one is a loud error
        with pytest.raises(ValueError, match="owned by the daemon"):
            open_cache(d.uri, 64 * MB)
    # non-cache stores still require capacity
    with pytest.raises(TypeError, match="capacity"):
        open_cache("sim://default")


# ---------------------------------------------------------------------------
# two clients, one cache
# ---------------------------------------------------------------------------

def test_second_client_reads_hit_warm_cache():
    store = mk_store(1)
    files = all_files(store)[:6]
    with CacheDaemon(store, 32 * MB, cfg=CFG) as d:
        with open_cache(d.uri, fetch_bytes=True) as a:
            for f in files:
                r = a.read(f.path, 0, f.size, now=1.0)
                assert r.data.size == f.size
        with open_cache(d.uri, fetch_bytes=True) as b:
            # remote StoreMeta: sizes answered daemon-side
            assert b.meta.file_size(files[0].path) == files[0].size
            assert b.meta.subtree_bytes(()) == \
                sum(f.size for f in all_files(store))
            total = hits = 0
            for f in files:
                r = b.read(f.path, 0, f.size, now=2.0)
                assert r.data.size == f.size
                total += len(r.blocks)
                hits += sum(1 for blk in r.blocks if blk.hit)
            # client A warmed the unified cache; B rides it
            assert hits == total


def test_two_clients_racing_same_dataset_identity_hits():
    """Concurrent sessions hammering the same files through separate
    serve threads: every served block must land in exactly one of
    hits/misses (identity-hit correctness under the kernel guard), and
    both clients must get the right bytes."""
    store = mk_store(1)
    files = all_files(store)[:8]
    with CacheDaemon(store, 64 * MB, cfg=CFG) as d:
        results = {}
        errors = []

        def hammer(name, seed):
            try:
                with open_cache(d.uri, fetch_bytes=True) as c:
                    rng = np.random.default_rng(seed)
                    blocks = 0
                    payload_ok = True
                    for rep in range(6):
                        reqs = [(files[int(j)].path, 0, files[int(j)].size)
                                for j in rng.integers(0, len(files), 8)]
                        for (fp, off, sz), r in zip(reqs,
                                                    c.read_batch(reqs)):
                            blocks += len(r.blocks)
                            if r.data.size != sz:
                                payload_ok = False
                    results[name] = (blocks, payload_ok)
            except BaseException as e:  # pragma: no cover - surfaced below
                errors.append(e)

        ts = [threading.Thread(target=hammer, args=(n, s))
              for n, s in (("a", 1), ("b", 2))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors
        total_blocks = sum(b for b, _ in results.values())
        assert all(ok for _, ok in results.values())
        st = d.client.stats
        assert st.hits + st.misses == total_blocks
        # one byte check against the store's own synthesis
        f = files[0]
        with open_cache(d.uri, fetch_bytes=True) as c:
            got = c.read(f.path, 0, f.size).data.tobytes()
        want = np.asarray(store.fetch_range(f.path, 0, f.size),
                          dtype=np.uint8).tobytes()
        assert got == want


# ---------------------------------------------------------------------------
# fault of the client: leases, reclamation, conservation
# ---------------------------------------------------------------------------

def _read_some(client, files, now=None):
    reqs = [(f.path, 0, f.size) for f in files]
    return client.read_batch(reqs, now, fetch=True)


def _assert_reclaimed_to_baseline(daemon, *, reaped=None, disconnects=None):
    wait_until(lambda: daemon.daemon_stats()["sessions"] == 0,
               what="session reclaim")
    st = daemon.daemon_stats()
    assert st["arena_free"] == st["arena_total"], st
    assert st["live_slots"] == 0
    if reaped is not None:
        assert st["reaped"] == reaped
    if disconnects is not None:
        assert st["disconnects"] >= disconnects
    # kernel pending-prefetch tables drain once the executor settles
    assert daemon.client.flush(timeout=15.0)
    wait_until(lambda: daemon.daemon_stats()["pending_prefetch"] == 0,
               what="pending-prefetch drain")
    ex = daemon.client.executor.stats
    assert ex.submitted == executor_identity(ex)


def test_client_kill_lease_reclaim_threaded():
    """Silent death under the in-process engine + ThreadedExecutor: the
    socket stays open (no EOF), so only the lease can notice.  After it
    expires the daemon's arena, candidate window, pending tables, and
    executor identity are all back to baseline."""
    store = mk_store()
    with CacheDaemon(store, 48 * MB, cfg=CFG, lease_s=0.3,
                     executor="threaded") as d:
        base = d.daemon_stats()
        assert base["arena_free"] == base["arena_total"]
        victim = RemoteCacheClient(d.uri, fetch_bytes=True, heartbeat=False)
        _read_some(victim, all_files(store)[:10])
        mid = d.daemon_stats()
        assert mid["live_slots"] > 0          # un-freed slots in flight
        assert mid["arena_free"] < mid["arena_total"]
        victim.kill()                          # goes silent mid-session
        _assert_reclaimed_to_baseline(d, reaped=1)
        # daemon still serves new sessions after the reclaim
        with open_cache(d.uri, fetch_bytes=True) as fresh:
            f = all_files(store)[0]
            assert fresh.read(f.path, 0, f.size).data.size == f.size


def test_client_kill_lease_reclaim_process_driver():
    """Same arc with the supervised multi-process driver behind the
    daemon: payload bytes cross worker arena → daemon arena → client,
    and the ProcessExecutor's conservation identity must survive the
    dead session."""
    store = mk_store()
    with CacheDaemon(store, 48 * MB, cfg=CFG, lease_s=0.3,
                     driver="process", n_procs=2, arena_bytes=8 * MB,
                     rpc_timeout_s=15.0) as d:
        victim = RemoteCacheClient(d.uri, fetch_bytes=True, heartbeat=False)
        outs = _read_some(victim, all_files(store)[:10])
        assert all(r.data is not None for r in outs)
        victim.kill()
        _assert_reclaimed_to_baseline(d, reaped=1)
        assert all(s == "up" for s in d.client.shard_states())


def test_disconnect_mid_read_batch_leaks_nothing():
    """The EOF path: a raw client sends a fetching ``read_batch`` and
    closes the socket without ever reading the reply.  The daemon must
    absorb the broken pipe, reclaim the session immediately, and keep
    serving others."""
    store = mk_store(1)
    files = all_files(store)[:6]
    with CacheDaemon(store, 32 * MB, cfg=CFG) as d:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(d.address.path)
        send_msg(sock, ("hello", (), {"proto": PROTO_VERSION, "shm": True}))
        status, info = recv_msg(sock)
        assert status == "ok"
        reqs = [(f.path, 0, f.size) for f in files]
        send_msg(sock, ("read_batch", (), (reqs, 1.0, True)))
        sock.close()                           # die before the reply
        wait_until(lambda: d.daemon_stats()["disconnects"] >= 1,
                   what="EOF reclaim")
        _assert_reclaimed_to_baseline(d, disconnects=1)
        with open_cache(d.uri, fetch_bytes=True) as c:
            r = c.read(files[0].path, 0, files[0].size)
            assert r.data.size == files[0].size


def test_graceful_close_releases_session_immediately():
    store = mk_store(1)
    with CacheDaemon(store, 16 * MB, cfg=CFG, lease_s=30.0) as d:
        c = open_cache(d.uri, fetch_bytes=True)
        _read_some(c, all_files(store)[:4])
        c.close()                              # bye: no lease wait
        wait_until(lambda: d.daemon_stats()["sessions"] == 0,
                   deadline_s=5.0, what="bye reclaim")
        st = d.daemon_stats()
        assert st["byes"] == 1 and st["reaped"] == 0
        assert st["arena_free"] == st["arena_total"]


def test_lease_expiry_races_reconnect_no_double_free():
    """The old session's lease expires *while the same
    client is already back on a new session*.  A client that loses its
    connection (here: forced down with the old socket held open by a
    dup'd fd, so no EOF ever reaches the daemon) reconnects and keeps
    reading; the abandoned session still owns arena slots until its
    lease runs out.  The reaper must reclaim exactly the old session's
    slots — never the new session's — and the arena must balance to
    baseline afterwards (a double-free or cross-session free would
    corrupt the allocator's accounting)."""
    store = mk_store(1)
    files = all_files(store)[:6]
    with CacheDaemon(store, 32 * MB, cfg=CFG, lease_s=0.6) as d:
        cli = RemoteCacheClient(d.uri, fetch_bytes=True, heartbeat=False,
                                max_backoff_s=0.1, backing=store)
        _read_some(cli, files)                 # old session holds slots
        assert d.daemon_stats()["live_slots"] > 0
        zombie = cli._sock.dup()               # keep the daemon's side open
        cli._mark_down("drill: connection lost")
        wait_until(lambda: cli.state == "up", what="reconnect")
        assert cli.reconnects == 1
        assert d.daemon_stats()["sessions"] == 2   # zombie + successor
        # the new session reads while the old lease runs down
        outs = _read_some(cli, files, now=10.0)
        assert all(r.data is not None for r in outs)
        wait_until(lambda: d.daemon_stats()["reaped"] == 1,
                   what="old-session lease reclaim")
        st = d.daemon_stats()
        assert st["sessions"] == 1             # successor untouched
        # reclaim took only the old session's slots; the new session
        # still serves, and its in-flight slots still account cleanly
        outs = _read_some(cli, files, now=20.0)
        assert all(r.data is not None for r in outs)
        zombie.close()
        cli.close()
        _assert_reclaimed_to_baseline(d, reaped=1)


# ---------------------------------------------------------------------------
# chaos harness: the client_kill strike
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# soak (opt-in): many clients, repeated kills
# ---------------------------------------------------------------------------

@pytest.mark.daemon_full
def test_daemon_full_multi_client_soak():
    """Four concurrent sessions, two of them killed mid-run, over a
    longer trace: the daemon ends with zero sessions, a full arena free
    list, drained pending tables, and the conservation identity."""
    store = mk_store(3)
    files = all_files(store)
    with CacheDaemon(store, 96 * MB, cfg=CFG, lease_s=0.4,
                     executor="threaded") as d:
        errors = []
        zombies = []      # keep killed clients alive: GC would close the
                          # zombie socket and turn the reap into an EOF

        def worker(seed, die):
            try:
                c = RemoteCacheClient(d.uri, fetch_bytes=True,
                                      heartbeat=not die)
                if die:
                    zombies.append(c)
                rng = np.random.default_rng(seed)
                for rep in range(30):
                    reqs = [(files[int(j)].path, 0, files[int(j)].size)
                            for j in rng.integers(0, len(files), 6)]
                    c.read_batch(reqs)
                    if die and rep == 15:
                        c.kill()
                        return
                c.close()
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(s, s % 2 == 0))
              for s in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors
        _assert_reclaimed_to_baseline(d, reaped=2)


# ---------------------------------------------------------------------------
# cross-package: a port session on a port daemon against the reference pair
# ---------------------------------------------------------------------------

def _daemon_pair_run(side):
    """The trace of ``test_remote_client_matches_direct_open_cache``
    through one package's ``CacheDaemon`` and ``cache://`` session."""
    if side == "jax":
        from repro.core import CacheConfig as Cfg, open_cache as opener
        from repro.daemon import CacheDaemon as Daemon
        from repro.storage import RemoteStore as Store, make_dataset as make
    else:
        Cfg, opener, Daemon, Store, make = (CacheConfig, open_cache,
                                            CacheDaemon, RemoteStore,
                                            make_dataset)
    store = Store()
    for i in range(2):
        store.add(make(f"ds{i}", "dir_tree", n_dirs=2, files_per_dir=6,
                       small_file_size=256 * 1024))
    cfg = Cfg(min_share=4 * MB, rebalance_quantum=4 * MB, window=40,
              reanalyze_every=20, node_cap=500)
    files = [f for ds in store.datasets.values() for f in ds.files]
    rng = np.random.default_rng(11)
    outs, data = [], []
    with Daemon(store, 48 * MB, cfg=cfg, executor="sim") as d, \
            opener(d.uri, fetch_bytes=True) as remote:
        t = 0.0
        for rep in range(4):
            reqs = []
            for j in rng.integers(0, len(files), 24):
                f = files[int(j)]
                off = int(rng.integers(0, 2)) * 128 * 1024
                reqs.append((f.path, off, f.size - off))
            for r in remote.read_batch(reqs, t):
                outs.append(([(b.key, b.size, b.hit, b.prefetched_hit)
                              for b in r.blocks], list(r.outcome.prefetches)))
                data.append(r.data.tobytes())
            t += 0.5
        stats = remote.stats.snapshot()
    return outs, data, stats


def test_remote_pair_matches_reference_pair():
    want = _daemon_pair_run("jax")
    got = _daemon_pair_run("torch")
    assert len(got[0]) == len(want[0]) == 96
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"divergence at read {k}"
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]["hits"] > 0


def test_cache_scheme_registry_roundtrip():
    """``cache://`` resolves through the stores' registry to a daemon
    address (the registry case of the reference's tests/test_stores.py)."""
    from repro_torch.daemon import DaemonAddress, format_cache_uri
    from repro_torch.storage import open_store
    from repro_torch.storage.api import registered_schemes

    assert "cache" in registered_schemes()
    uds = open_store("cache:///tmp/igt.sock")
    assert isinstance(uds, DaemonAddress)
    assert uds.is_cache_address
    assert uds.kind == "uds" and uds.path == "/tmp/igt.sock"
    assert uds.connect_args() == ("uds", "/tmp/igt.sock")
    tcp = open_store("cache://127.0.0.1:7171?label=trainer")
    assert tcp.kind == "tcp" and tcp.connect_args() == \
        ("tcp", ("127.0.0.1", 7171))
    assert tcp.params == {"label": "trainer"}
    assert uds.uri.startswith("cache://")
    assert open_store(format_cache_uri(uds)).connect_args() == \
        uds.connect_args()
    with pytest.raises(ValueError):
        open_store("cache://")            # no endpoint at all
