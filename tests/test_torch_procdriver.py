"""The port's multi-process shard driver (``repro_torch.core.procdriver``,
``core.wire``) under the JAX package's own driver tests, run against the
port's modules with their bounds unchanged: single-worker equivalence
against the in-process kernel, request order across shard splits, the
``ProcessExecutor`` contract (``submitted == completed + cancelled +
deduped`` at close, no leaked pending tables under transient or permanent
store failures), demand bytes through the shared-memory arena, the
rebalance-summary protocol, clean shutdown, and the ``spawn`` start
method.  Cross-package cases at the end hold the port against the
reference.

Every test runs under a hard SIGALRM guard: a deadlocked worker or a
lost reply must fail the test, not hang the suite.
"""
import gc
import signal

import numpy as np
import pytest
import torch

from repro_torch.core import (CacheConfig, GlobalRebalancer, IGTCache,
                              ProcessExecutor, ProcessShardedCache,
                              ShardedIGTCache, open_cache)
from repro_torch.core.procdriver import WireOutcome
from repro_torch.core.sharded import DemandSummary, ShardSummary
from repro_torch.core.types import MB
from repro_torch.storage import MemStore, RemoteStore, make_dataset
from repro_torch.storage.api import FaultyStore, store_spec


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CFG = CacheConfig(min_share=4 * MB, rebalance_quantum=4 * MB,
                  window=40, reanalyze_every=20, node_cap=500)

HARD_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def hard_timeout():
    """Multiprocessing tests must never hang tier-1: a deadlocked worker
    or a lost pipe reply raises here instead of stalling the job."""

    def boom(signum, frame):  # pragma: no cover - only fires on deadlock
        raise TimeoutError(
            f"procdriver test exceeded the {HARD_TIMEOUT_S}s hard timeout "
            f"(deadlocked worker / lost reply?)")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def mk_store(n_datasets=4):
    store = RemoteStore()
    for i in range(n_datasets):
        store.add(make_dataset(f"ds{i}", "dir_tree", n_dirs=4,
                               files_per_dir=8, small_file_size=512 * 1024))
    return store


def mk_flat_store():
    """Sequential-scan-friendly layout: long single-directory streams
    clear the observation window and emit readahead candidates."""
    store = RemoteStore()
    for name in ("flat0", "flat1"):
        store.add(make_dataset(name, "flat_files", n_files=120,
                               small_file_size=256 * 1024))
    return store


def all_files(store):
    return [f for ds in store.datasets.values() for f in ds.files]


def executor_identity(st):
    return st.completed + st.cancelled + st.deduped


# ---------------------------------------------------------------------------
# equivalence + ordering
# ---------------------------------------------------------------------------

def test_single_worker_matches_inprocess_kernel():
    """n_procs=1, inline prefetch: the worker-resident kernel must
    evolve exactly like the caller-driven in-process loop — same
    per-block outcomes, same merged stats, on a mixed seeded trace."""
    store = mk_store()
    mono = IGTCache(store, 64 * MB, cfg=CFG)
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=1,
                             prefetch="inline") as eng:
        files = all_files(store)
        rng = np.random.default_rng(7)
        t = 0.0
        for rep in range(3):
            picks = rng.integers(0, len(files), 40)
            reqs = []
            for j in picks:
                f = files[int(j)]
                off = int(rng.integers(0, 2)) * 256 * 1024
                reqs.append((f.path, off, f.size))
            outs = eng.read_batch(reqs, t)
            ref = mono.read_batch(reqs, t)
            for got, want in zip(outs, ref):
                assert [(b.key, b.size, b.hit, b.prefetched_hit)
                        for b in got.blocks] == \
                       [(b.key, b.size, b.hit, b.prefetched_hit)
                        for b in want.blocks]
                assert got.remote_bytes == want.remote_bytes
                assert got.cached_bytes == want.cached_bytes
            for o in ref:          # the worker completed inline already
                for p, s in o.prefetches:
                    mono.complete_prefetch(p, s, t)
            t += 0.5
        assert eng.stats.snapshot() == mono.stats.snapshot()
        assert eng.node_count() == mono.tree.node_count()


def test_read_batch_preserves_request_order_across_workers():
    store = mk_store(6)
    mono = IGTCache(store, 64 * MB, cfg=CFG)
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=4,
                             prefetch="inline") as eng:
        # interleave datasets so consecutive requests hit different shards
        files = []
        dss = list(store.datasets.values())
        for i in range(8):
            for ds in dss:
                files.append(ds.files[i])
        reqs = [(f.path, 0, f.size) for f in files]
        outs = eng.read_batch(reqs, 0.0)
        ref = mono.read_batch(reqs, 0.0)
        assert len(outs) == len(reqs)
        for got, want in zip(outs, ref):
            assert [b.key for b in got.blocks] == [b.key for b in want.blocks]


def test_routing_matches_inprocess_facade():
    """Same ShardRouting mixin → a path lands on the same shard index
    under either driver (placement cannot drift between them)."""
    store = mk_store(6)
    facade = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=4) as eng:
        for f in all_files(store):
            assert eng.shard_id(f.path) == facade.shard_id(f.path)
        f = store.datasets["ds0"].files[0]
        eng.read(f.path, 0, f.size, 0.0)
        gathered = eng._gather_stats()
        sid = eng.shard_id(f.path)
        for i, g in enumerate(gathered):
            assert g["stats"].accesses == (1 if i == sid else 0)


def test_wire_outcome_reconstructs_keys():
    enc = (3, [4, 5], 0b01, 0b00, [])
    out = WireOutcome(enc, ("ds", "a", "f.bin"))
    assert [b.key for b in out.blocks] == ["ds/a/f.bin/#3", "ds/a/f.bin/#4"]
    assert out.blocks[0].hit and not out.blocks[1].hit
    assert out.remote_bytes == 5 and out.cached_bytes == 4


# ---------------------------------------------------------------------------
# executor contract
# ---------------------------------------------------------------------------

def _drive_client(client, store, reps=1):
    t = 0.0
    for _ in range(reps):
        for ds in store.datasets.values():
            for f in ds.files:
                client.read(f.path, 0, f.size, t)
                t += 0.01
    return t


def test_process_executor_stats_conservation():
    store = mk_flat_store()
    client = open_cache(store, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2)
    assert isinstance(client.engine, ProcessShardedCache)
    assert isinstance(client.executor, ProcessExecutor)
    _drive_client(client, store, reps=2)
    assert client.flush(timeout=30.0)
    st = client.executor.stats
    engine = client.engine
    assert st.submitted > 0, "trace generated no prefetch candidates"
    pending = engine.pending_prefetch_count()
    client.close()
    assert executor_identity(st) == st.submitted, st.snapshot()
    assert pending == 0, "worker kernels leaked pending candidates"


def test_dedup_and_overflow_cancel_on_worker_kernel():
    store = mk_flat_store()
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=2) as eng:
        ex = ProcessExecutor(queue_depth=2, max_fetch_bytes=0)
        from repro_torch.core import CacheClient
        client = CacheClient(eng, backing=store, executor=ex)
        # generate real kernel candidates (sequential whole-file scans)
        cands = []
        t = 0.0
        for f in store.datasets["flat0"].files:
            out = eng.read(f.path, 0, f.size, t)
            cands.extend(out.prefetches)
            t += 0.01
            if len(cands) >= 12:
                break
        assert len(cands) >= 8, "workload failed to generate candidates"
        ex.submit(cands, t)      # depth-2 queue: most overflow-cancel
        ex.submit(cands, t)      # re-offer: queued ones dedup
        assert client.flush(timeout=30.0)
        st = ex.stats
        assert st.deduped > 0 or st.cancelled > 0
        ex.close()
        assert executor_identity(st) == st.submitted, st.snapshot()
        assert eng.pending_prefetch_count() == 0


def test_submit_after_close_raises_and_releases():
    store = mk_store()
    client = open_cache(store, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2)
    eng = client.engine
    out = eng.read(store.datasets["ds0"].files[0].path, 0, 512 * 1024, 0.0)
    ex = client.executor
    ex.close()
    cands = [((f"ds0", "x", f"f{i}", "#0"), 1024) for i in range(3)]
    before = ex.stats.cancelled
    with pytest.raises(RuntimeError):
        ex.submit(cands, 1.0)
    assert ex.stats.cancelled >= before + len(cands)
    assert executor_identity(ex.stats) == ex.stats.submitted
    eng.close()


def test_chr_parity_process_vs_threaded_executor():
    """ProcessExecutor(n_procs=1) must land within 2% CHR of the
    ThreadedExecutor on the seeded mixed trace (same kernel decisions,
    different prefetch transport)."""

    def run(kind):
        store = mk_store()
        if kind == "threaded":
            client = open_cache(store, 48 * MB, cfg=CFG,
                                executor="threaded", max_fetch_bytes=0)
        else:
            client = open_cache(store, 48 * MB, cfg=CFG, driver="process",
                                n_procs=1, max_fetch_bytes=0)
        files = all_files(store)
        rng = np.random.default_rng(3)
        for i in range(600):
            f = files[int(rng.integers(0, len(files)))]
            client.read(f.path, 0, f.size)
            if i % 50 == 49:
                client.flush(timeout=30.0)   # epoch-ish determinism
        client.flush(timeout=30.0)
        hr = client.hit_ratio()
        st = client.executor.stats
        client.close()
        assert executor_identity(st) == st.submitted, st.snapshot()
        return hr

    threaded, proc = run("threaded"), run("process")
    assert abs(threaded - proc) <= 0.02, (threaded, proc)


# ---------------------------------------------------------------------------
# failure semantics (worker-side store errors)
# ---------------------------------------------------------------------------

def test_transient_errors_retried_worker_side_no_leak():
    store = mk_flat_store()
    flaky = FaultyStore(store, fail_rate=0.3, seed=11,
                        sleep=lambda s: None)
    client = open_cache(flaky, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, max_fetch_bytes=512)
    _drive_client(client, store)
    assert client.flush(timeout=30.0)
    st = client.executor.stats
    engine = client.engine
    assert st.submitted > 0
    assert st.retries > 0, "30% transient rate produced no retries"
    pending = engine.pending_prefetch_count()
    client.close()
    assert executor_identity(st) == st.submitted, st.snapshot()
    assert pending == 0


def test_permanent_failures_cancel_candidates_no_leak():
    store = mk_flat_store()
    broken = FaultyStore(store, permanent_rate=1.0, seed=5,
                         sleep=lambda s: None)
    client = open_cache(broken, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, max_fetch_bytes=512)
    _drive_client(client, store)
    assert client.flush(timeout=30.0)
    st = client.executor.stats
    engine = client.engine
    assert st.submitted > 0
    assert st.fetch_errors > 0
    assert st.completed == 0, "every prefetch fetch should have failed"
    pending = engine.pending_prefetch_count()
    client.close()
    assert executor_identity(st) == st.submitted, st.snapshot()
    assert pending == 0


def test_demand_fetch_permanent_error_raises_in_reader():
    store = mk_store()
    broken = FaultyStore(store, permanent_rate=1.0, seed=5,
                         sleep=lambda s: None)
    client = open_cache(broken, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, fetch_bytes=True)
    f = store.datasets["ds0"].files[0]
    from repro_torch.storage.api import StoreError
    with pytest.raises(StoreError):
        client.read(f.path, 0, f.size, 1.0)
    # the worker and channel survive: metadata reads still serve
    out = client.read(f.path, 0, f.size, 2.0, fetch=False)
    assert out.blocks
    client.close()


# ---------------------------------------------------------------------------
# shared-memory arena byte path
# ---------------------------------------------------------------------------

def test_demand_bytes_cross_via_arena_and_match():
    store = mk_store()
    client = open_cache(store, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, fetch_bytes=True)
    f = store.datasets["ds0"].files[0]
    res = client.read(f.path, 0, f.size, 1.0)
    ref = store.fetch_range(f.path, 0, f.size)
    assert np.array_equal(res.data, ref)
    res2 = client.read(f.path, 0, f.size, 2.0)     # all hits now
    assert all(b.hit for b in res2.blocks)
    assert np.array_equal(res2.data, ref)
    assert client.engine.arena_spills() == 0, \
        "payload bytes fell back to pickling"
    client.close()


def test_arena_slots_recycle_under_pressure():
    """Reading far more bytes than the arena holds must keep working
    with zero spills once released views are collected — the refcounted
    free path feeds slots back to the worker allocators."""
    store = mk_store()
    client = open_cache(store, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, fetch_bytes=True,
                        arena_bytes=2 * MB)   # << total bytes read
    files = all_files(store)
    total = 0
    for i, f in enumerate(files[:24]):
        res = client.read(f.path, 0, f.size, float(i))
        assert len(res.data) == f.size
        total += f.size
        del res
        if i % 4 == 3:
            gc.collect()        # release views → frees piggyback
    assert total > 4 * MB
    assert client.engine.arena_spills() == 0
    client.close()


# ---------------------------------------------------------------------------
# cross-shard allocation over serialized summaries
# ---------------------------------------------------------------------------

def _skewed_pair(store, cfg):
    s0 = IGTCache(store, 32 * MB, cfg=cfg)
    s1 = IGTCache(store, 32 * MB, cfg=cfg)
    cmu = s0.cache.create_cmu(("ds0",), 128 * MB, now=0.0)
    from repro_torch.core import Pattern
    cmu.flat_pattern = Pattern.SKEWED
    for i in range(50):
        cmu.note_access(i * 0.01)
        cmu.buffer_window.on_evict(f"k{i}")
        cmu.buffer_window.probe(f"k{i}")
    return s0, s1


def test_plan_moves_matches_live_rebalancer():
    """The serialized planner is the same greedy rule the live
    cross-shard round applies (one skewed taker, one idle donor) —
    checked under both move-sizing policies: fixed ships exactly one
    quantum, adaptive sizes the move by the measured want."""
    import dataclasses
    store = mk_store()
    fixed_cfg = dataclasses.replace(CFG, quantum_policy="fixed")
    s0, s1 = _skewed_pair(store, fixed_cfg)
    reb = GlobalRebalancer(fixed_cfg)
    rows = [r for r, _ in reb.tracker.summarize(s0, 0, 1.0, mark=False)]
    rows += [r for r, _ in reb.tracker.summarize(s1, 1, 1.0, mark=False)]
    moves = reb.plan_moves(rows)
    assert moves, "skewed demand must pull capacity cross-shard"
    donor, taker, amt = moves[0]
    assert taker.key == ("ds0",) and taker.shard == 0
    assert donor.shard == 1
    assert amt == CFG.rebalance_quantum

    s0, s1 = _skewed_pair(store, CFG)        # adaptive (default policy)
    reb = GlobalRebalancer(CFG)
    rows = [r for r, _ in reb.tracker.summarize(s0, 0, 1.0, mark=False)]
    rows += [r for r, _ in reb.tracker.summarize(s1, 1, 1.0, mark=False)]
    moves = reb.plan_moves(rows)
    assert moves
    donor, taker, amt = moves[0]
    assert taker.key == ("ds0",) and taker.shard == 0
    assert donor.shard == 1
    # want-sized: 50 distinct ghost-hit blocks x block_size, capped by
    # the donor's headroom — strictly more than one fixed quantum
    assert amt > CFG.rebalance_quantum
    assert amt <= 50 * CFG.block_size


def test_process_driver_rebalance_conserves_capacity():
    store = mk_store(6)
    cap = 64 * MB
    with ProcessShardedCache(store, cap, cfg=CFG, n_procs=4,
                             prefetch="inline") as eng:
        assert sum(eng.shard_capacities()) == cap
        t = 0.0
        hot = store.datasets["ds0"].files[:3]
        for r in range(40):
            for f in hot:
                eng.read(f.path, 0, f.size, t)
                t += 0.05
            f = store.datasets["ds1"].files[r % 32]
            eng.read(f.path, 0, f.size, t)
            t += 0.05
        moved = 0
        for k in range(1, 20):
            moved += eng.rebalance_now(t + k * CFG.rebalance_period)
            caps = eng.shard_capacities()
            assert sum(caps) == cap, caps
        # per-shard quota invariant after the rounds
        for g in eng._gather_stats():
            assert g["capacity"] >= 0
        # the bounded wire summary really crossed the pipe: exact rows
        # plus the serialized demand sketches, O(KB) total
        summary = eng._rpc(0, "rebalance_summary", t + 999.0)
        assert isinstance(summary, ShardSummary)
        assert summary.rows
        assert all(isinstance(r, DemandSummary) for r in summary.rows)
        assert summary.payload_bytes() <= 64 * 1024
        # driver-side round stats got recorded (sketch merge path)
        assert eng.global_rebalancer.last_stats is not None
        assert eng.global_rebalancer.round_log


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_clean_shutdown_with_inflight_prefetches():
    store = mk_flat_store()
    slow = FaultyStore(store, jitter_s=0.002, seed=3)
    client = open_cache(slow, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, max_fetch_bytes=512)
    _drive_client(client, store)
    st = client.executor.stats
    procs = [ch.proc for ch in client.engine._channels]
    client.close()                 # no flush: candidates still in flight
    assert executor_identity(st) == st.submitted, st.snapshot()
    for p in procs:
        assert not p.is_alive(), "worker process leaked past close()"


def test_close_is_idempotent_and_context_manager():
    store = mk_store()
    eng = ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=2)
    eng.close()
    eng.close()
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=1) as eng2:
        f = store.datasets["ds0"].files[0]
        assert eng2.read(f.path, 0, f.size, 0.0).blocks
    with pytest.raises(RuntimeError):
        eng2.read(f.path, 0, f.size, 1.0)   # closed driver fails loudly


def test_worker_reports_renegotiated_capabilities():
    store = mk_store()
    with ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=2) as eng:
        assert len(eng.worker_info) == 2
        for info in eng.worker_info:
            assert info["capabilities"]["ranges"] is True
            assert info["pid"] > 0
        pids = {info["pid"] for info in eng.worker_info}
        assert len(pids) == 2, "shards must live in distinct processes"


def test_invalidate_meta_cache_reaches_worker_snapshots(tmp_path):
    """LocalFSStore mid-run refresh workflow under driver='process':
    the facade's invalidate_meta_cache must re-walk every worker's own
    store snapshot (a client-side refresh() can't reach them)."""
    root = tmp_path / "data"
    (root / "ds").mkdir(parents=True)
    (root / "ds" / "a.bin").write_bytes(b"x" * 4096)
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=64 * 1024)
    client = open_cache(f"file://{root}", 8 * MB, cfg=cfg,
                        driver="process", n_procs=2, fetch_bytes=True)
    got = client.read(("ds", "a.bin"), 0, 4096, 1.0)
    assert bytes(got.data) == b"x" * 4096
    (root / "ds" / "b.bin").write_bytes(b"y" * 2048)   # tree changed
    client.engine.invalidate_meta_cache()
    got = client.read(("ds", "b.bin"), 0, 2048, 2.0)
    assert bytes(got.data) == b"y" * 2048
    client.close()


def test_spawn_start_method_pickles_store():
    """`fork` is the Linux default (populated stores travel free), but
    the driver must also run under `spawn`/`forkserver` — the escape
    hatch when the embedding process is heavily threaded (fork-safety).
    Everything then crosses by pickle, including the fault wrapper."""
    store = mk_store(2)
    flaky = FaultyStore(store, fail_rate=0.0, seed=1)
    with ProcessShardedCache(flaky, 64 * MB, cfg=CFG, n_procs=1,
                             prefetch="inline",
                             start_method="spawn") as eng:
        f = store.datasets["ds0"].files[0]
        out = eng.read(f.path, 0, f.size, 0.0)
        assert out.blocks and not out.blocks[0].hit
        out2 = eng.read(f.path, 0, f.size, 1.0)
        assert all(b.hit for b in out2.blocks)


def test_store_spec_roundtrip():
    # object spec: a populated RemoteStore must travel as itself
    store = mk_store()
    kind, payload = store_spec(store)
    assert kind == "object" and payload is store
    # URI spec: strings re-open per process
    assert store_spec("sim://default") == ("uri", "sim://default")


def test_open_cache_driver_knobs_validated():
    store = mk_store()
    with pytest.raises(ValueError):
        open_cache(store, 64 * MB, cfg=CFG, driver="warp")
    with pytest.raises(ValueError):
        open_cache(store, 64 * MB, cfg=CFG, n_procs=2)  # thread driver
    with pytest.raises(TypeError):
        # ProcessExecutor needs the process driver
        open_cache(store, 64 * MB, cfg=CFG, executor="process")


def test_bad_executor_string_does_not_leak_workers():
    """Knob validation must run before workers spawn: a typo'd executor
    on driver='process' raises without leaving igt-shard processes (or
    an arena) behind."""
    import multiprocessing
    store = mk_store()
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(ValueError):
        open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                   executor="warp-drive")
    leaked = [p for p in multiprocessing.active_children()
              if p.pid not in before and p.name.startswith("igt-shard")]
    assert not leaked, f"leaked workers: {leaked}"


# ---------------------------------------------------------------------------
# fault-supervision regressions
# ---------------------------------------------------------------------------

def test_worker_death_during_executor_close_keeps_identity():
    """Regression for the _fail_channel stats race: a worker dying while
    ProcessExecutor.close() is draining must not double-count or drop
    the dead channel's queued candidates — both paths drain atomically
    through the channel and account under the registration lock, so the
    identity holds no matter who wins."""
    for seed in (1, 2):
        store = mk_flat_store()
        slow = FaultyStore(store, jitter_s=0.002, seed=seed)
        client = open_cache(slow, 64 * MB, cfg=CFG, driver="process",
                            n_procs=2, max_fetch_bytes=512)
        _drive_client(client, store)
        st = client.executor.stats
        assert st.submitted > 0
        # SIGKILL one worker and close immediately: the receiver thread's
        # death accounting races the executor's close-time drain
        client.engine._channels[seed % 2].proc.kill()
        client.close()
        assert executor_identity(st) == st.submitted, st.snapshot()


def test_driver_flush_returns_promptly_after_worker_death():
    """flush() on a driver whose worker died with queued background work
    must return promptly — the dead channel's queue is drained by the
    death accounting (supervision off: nothing refills it), so the call
    must not sleep out its full timeout waiting for progress that can
    never happen."""
    import time as _time
    store = mk_flat_store()
    slow = FaultyStore(store, jitter_s=0.002, seed=4)
    client = open_cache(slow, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, max_fetch_bytes=512, supervise=False)
    _drive_client(client, store)
    for ch in client.engine._channels:
        ch.proc.kill()
    t0 = _time.monotonic()
    client.engine.flush(timeout=30.0)
    elapsed = _time.monotonic() - t0
    assert elapsed < 10.0, (
        f"flush slept {elapsed:.1f}s against a dead channel")
    client.close()


def test_shard_channel_wait_idle_reports_closed_promptly():
    """A closed channel with outstanding work can only drain through the
    death sweep — wait_idle must report False immediately, not burn the
    caller's timeout."""
    import time as _time
    from repro_torch.core.procdriver import _ShardChannel
    ch = _ShardChannel(0, None, None)
    ch.outstanding = 3
    ch.closed = True
    t0 = _time.monotonic()
    assert ch.wait_idle(30.0) is False
    assert _time.monotonic() - t0 < 1.0


def test_client_shard_queue_wait_idle_reports_closed_promptly():
    """Same contract for the ThreadedExecutor's per-shard queue."""
    import time as _time
    from repro_torch.core.client import _ShardQueue
    q = _ShardQueue(depth=8)
    q.outstanding = 2
    q.closed = True
    t0 = _time.monotonic()
    assert q.wait_idle(30.0) is False
    assert _time.monotonic() - t0 < 1.0


def test_backing_override_reaches_workers():
    """An explicit `backing` store must be what the *workers* fetch
    demand bytes from — a permanently failing backing proves they do
    not silently fall back to the metadata store."""
    store = mk_store()
    broken = FaultyStore(store, permanent_rate=1.0, seed=1,
                         sleep=lambda s: None)
    client = open_cache(store, 64 * MB, cfg=CFG, driver="process",
                        n_procs=2, backing=broken, fetch_bytes=True)
    from repro_torch.storage.api import StoreError
    f = store.datasets["ds0"].files[0]
    with pytest.raises(StoreError):
        client.read(f.path, 0, f.size, 1.0)
    client.close()


# ---------------------------------------------------------------------------
# cross-package: the port's worker kernel against the reference's
# ---------------------------------------------------------------------------

def _tiered_worker_run(side, spill):
    """``ProcessShardedCache(n_procs=1, prefetch="inline")`` over a
    ``TieredStore`` of a ``RemoteStore``, driven with the trace of
    ``test_single_worker_matches_inprocess_kernel``: per-block outcomes,
    merged stats, node count."""
    if side == "jax":
        from repro.core import (CacheConfig as Cfg,
                                ProcessShardedCache as Driver)
        from repro.storage import (RemoteStore as Store, TieredStore as Tiers,
                                   make_dataset as make)
    else:
        from repro_torch.storage import TieredStore as Tiers
        Cfg, Driver, Store, make = (CacheConfig, ProcessShardedCache,
                                    RemoteStore, make_dataset)
    store = Store()
    for i in range(4):
        store.add(make(f"ds{i}", "dir_tree", n_dirs=4, files_per_dir=8,
                       small_file_size=512 * 1024))
    tiered = Tiers(store, ram_bytes=8 * MB, disk_bytes=16 * MB,
                   spill_dir=str(spill))
    cfg = Cfg(min_share=4 * MB, rebalance_quantum=4 * MB, window=40,
              reanalyze_every=20, node_cap=500)
    outs = []
    with Driver(tiered, 32 * MB, cfg=cfg, n_procs=1,
                prefetch="inline") as eng:
        files = [f for ds in store.datasets.values() for f in ds.files]
        rng = np.random.default_rng(7)
        t = 0.0
        for rep in range(3):
            reqs = []
            for j in rng.integers(0, len(files), 40):
                f = files[int(j)]
                off = int(rng.integers(0, 2)) * 256 * 1024
                reqs.append((f.path, off, f.size))
            for o in eng.read_batch(reqs, t):
                outs.append(([(b.key, b.size, b.hit, b.prefetched_hit)
                              for b in o.blocks], o.remote_bytes,
                             o.cached_bytes))
            t += 0.5
        stats = eng.stats.snapshot()
        nodes = eng.node_count()
    return outs, stats, nodes


def test_single_worker_over_tiers_matches_reference(tmp_path):
    want = _tiered_worker_run("jax", tmp_path / "jax")
    got = _tiered_worker_run("torch", tmp_path / "torch")
    assert len(got[0]) == len(want[0]) == 120
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"divergence at read {k}"
    assert got[1] == want[1]
    assert got[1]["hits"] > 0 and got[1]["evictions"] > 0
    assert got[2] == want[2]


def test_quickstart_torch_runs():
    """``examples/quickstart_torch.py``, every walkthrough, exits 0 in a
    process that imports neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import runpy, sys\n"
            "sys.argv = ['quickstart_torch.py']\n"
            "runpy.run_path('examples/quickstart_torch.py', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=150, env=env, cwd=str(root))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "BAD []" in out.stdout
    for line in ("session B hit 16/16 blocks with 0 demand fetches",
                 "32/32 blocks hit after the reconnect",
                 "(both passes verified)"):
        assert line in out.stdout, out.stdout


class _FreezeProbe:
    def snapshot(self):
        return {"frozen": gc.get_freeze_count(), "enabled": gc.isenabled()}


class _ProbeStore(MemStore):
    """A store whose capability snapshot (the worker's ``hello`` reply)
    reports the worker's collector state."""

    def capabilities(self):
        return _FreezeProbe()


def test_fork_worker_freezes_inherited_heap():
    """A forked worker inherits the parent's heap (in a trainer or a server,
    CUDA tensors among it) and must never free any of it: before it builds
    anything, every inherited object sits in the collector's permanent
    generation, which the parent's does not."""
    parent_frozen = gc.get_freeze_count()
    with ProcessShardedCache(_ProbeStore(block_size=MB), 64 * MB, cfg=CFG,
                             n_procs=2, start_method="fork") as eng:
        probes = [w["capabilities"] for w in eng.worker_info]
    assert gc.get_freeze_count() == parent_frozen
    for p in probes:
        assert p["enabled"] and p["frozen"] > 10_000, p
