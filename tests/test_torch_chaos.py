"""The JAX package's fault matrix (tests/test_chaos.py) on the port's process
driver, chaos harness and simulator, bounds unchanged:

  * worker SIGKILL mid ``read_batch`` → typed partial error, degraded
    direct-store reads with byte-exact results, supervised respawn;
  * kill with a prefetch batch in flight → executor conservation
    identity (``submitted == completed + cancelled + deduped``) survives
    the drain;
  * kill during a rebalance round → cluster capacity stays conserved
    with the dead shard's share frozen;
  * store hang hitting the retry deadline (client side) and the RPC
    deadline (worker side — hung worker killed and respawned, reader
    served from the store);
  * restart-budget exhaustion → permanent DOWN, reads keep flowing
    degraded;
  * SIGSTOP wedge → heartbeat stall detection kills and respawns;
  * chaos e2e: mixed-workload cluster sim loses a worker mid-trace —
    the run completes with zero hung or errored reads and the windowed
    post-recovery CHR lands within 5 % of the fault-free run.

Every test runs under a hard SIGALRM guard: "no hung calls" is asserted
by the alarm, not hoped for.  The fast subset is marked ``chaos`` (tier-1
default); the extended seeded sweep is ``chaos_full`` (opt-in).
"""
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import CacheConfig, open_cache
from repro_torch.core.client import CacheClient
from repro_torch.core.faults import (SHARD_DOWN, SHARD_UP,
                                     ShardUnavailableError)
from repro_torch.core.procdriver import ProcessExecutor, ProcessShardedCache
from repro_torch.core.types import MB
from repro_torch.sim import ChaosMonkey, ChaosSchedule, ClusterSim, plan_strikes
from repro_torch.sim.workloads import make_paper_suite
from repro_torch.storage import (MemStore, RemoteStore, RetryPolicy,
                                 make_dataset)
from repro_torch.storage.api import DeadlineError, FaultyStore


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.chaos

CFG = CacheConfig(min_share=4 * MB, rebalance_quantum=4 * MB,
                  window=40, reanalyze_every=20, node_cap=500)

HARD_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def hard_timeout():
    """Chaos tests must never hang tier-1: a lost reply, a stuck respawn
    or an unreleased SIGSTOP raises here instead of wedging the job."""

    def boom(signum, frame):  # pragma: no cover - only fires on deadlock
        raise TimeoutError(
            f"chaos test exceeded the {HARD_TIMEOUT_S}s hard timeout "
            f"(hung call / lost reply / stuck respawn?)")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def mk_byte_world(n_jobs=6, file_bytes=3 * MB + 12345, seed=0):
    """MemStore with real payloads under distinct top-level dirs.  Shard
    routing hashes the top-level component: with 2 shards, job0-3 land
    on one and job4-5 on the other, so batches genuinely span shards."""
    store = MemStore(block_size=1 * MB)
    rng = np.random.default_rng(seed)
    payloads = {}
    for j in range(n_jobs):
        p = (f"job{j}", "data")
        data = rng.integers(0, 256, size=file_bytes, dtype=np.uint8)
        store.add_file(p, data)
        payloads[p] = data
    return store, payloads


def wait_all_up(client, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(s == SHARD_UP for s in client.shard_states()):
            return True
        time.sleep(0.02)
    return False


def wait_event(client, kind, timeout=20.0):
    """Poll the fault log for an event kind.  Needed because the
    supervisor flips the shard to UP *before* appending the respawn
    event (the recovery stamp covers the control replay too), so
    wait_all_up can win the race against the log append."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [e for e in client.fault_stats()["events"]
               if e["kind"] == kind]
        if evs:
            return evs
        time.sleep(0.02)
    return []


def executor_identity(st):
    return st.completed + st.cancelled + st.deduped


def assert_identity(client):
    st = client.executor.stats
    assert st.submitted == executor_identity(st), (
        f"lost candidates: submitted={st.submitted} "
        f"completed={st.completed} cancelled={st.cancelled} "
        f"deduped={st.deduped}")


# ---------------------------------------------------------------------------
# kill mid read_batch: degraded bytes, typed partial error, respawn
# ---------------------------------------------------------------------------

def test_kill_mid_read_batch_serves_degraded_bytes_and_recovers():
    store, payloads = mk_byte_world()
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    arena_bytes=16 * MB, fetch_bytes=True,
                    rpc_timeout_s=10.0) as c:
        reqs = [((f"job{j}", "data"), 0, 2 * MB) for j in range(6)]
        c.read_batch(reqs)                         # warm both shards
        target = c.engine.shard_id(("job0", "data"))
        monkey = ChaosMonkey(c)
        monkey.kill(target)
        # the very next batch hits the dead shard: the client must still
        # hand back byte-exact results for every request
        outs = c.read_batch(reqs)
        for (p, off, sz), r in zip(reqs, outs):
            assert bytes(r.data) == bytes(payloads[p][off:off + sz])
        assert c.client_stats.degraded_reads > 0
        assert c.client_stats.degraded_bytes > 0
        # supervisor brings the shard back within budget
        assert wait_all_up(c), f"states: {c.shard_states()}"
        assert any(e["kind"] == "kill" for e in c.fault_stats()["events"])
        respawns = wait_event(c, "respawn")
        assert respawns, "no respawn event after recovery"
        assert respawns[0]["recovery_s"] > 0
        # post-recovery reads go through the (cold) kernel again
        r = c.read(("job0", "data"), 512, 1 * MB)
        assert bytes(r.data) == \
            bytes(payloads[("job0", "data")][512:512 + 1 * MB])
        assert_identity(c)


def test_kill_without_degraded_mode_raises_typed_partial_error():
    store, _ = mk_byte_world()
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    arena_bytes=16 * MB, fetch_bytes=True, degraded=False,
                    rpc_timeout_s=10.0) as c:
        reqs = [((f"job{j}", "data"), 0, 1 * MB) for j in range(6)]
        c.read_batch(reqs)
        target = c.engine.shard_id(("job0", "data"))
        ChaosMonkey(c).kill(target)
        with pytest.raises(ShardUnavailableError) as ei:
            c.read_batch(reqs)
        e = ei.value
        # the error carries the healthy shards' outcomes + the holes
        assert e.indices, "partial error names no failed positions"
        assert e.partial is not None and len(e.partial) == len(reqs)
        served = sum(1 for o in e.partial if o is not None)
        assert served + len(e.indices) == len(reqs)
        assert served > 0, "surviving shard's outcomes were dropped"
        wait_all_up(c)


# ---------------------------------------------------------------------------
# kill with in-flight prefetch batch: conservation identity survives
# ---------------------------------------------------------------------------

def test_kill_with_inflight_prefetch_batch_conserves_candidates():
    store = RemoteStore()
    for name in ("flat0", "flat1"):
        store.add(make_dataset(name, "flat_files", n_files=120,
                               small_file_size=256 * 1024))
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    rpc_timeout_s=10.0) as c:
        files = [f for ds in store.datasets.values() for f in ds.files]
        t = 0.0
        killed = False
        for i, f in enumerate(files):           # sequential scans →
            c.read(f.path, 0, f.size, t)        # readahead candidates
            t += 0.01
            if i == 80 and not killed:
                # strike while the coalesced prefetch pump has batches
                # in flight on both channels
                ChaosMonkey(c).kill(c.engine.shard_id(f.path))
                killed = True
        assert killed
        wait_all_up(c)
        c.flush(timeout=30.0)
        st = c.executor.stats
        assert st.submitted > 0, "trace produced no prefetch candidates"
    # close() drained everything; no candidate may be lost or double-done
    assert st.submitted == executor_identity(st), (
        f"submitted={st.submitted} completed={st.completed} "
        f"cancelled={st.cancelled} deduped={st.deduped}")


# ---------------------------------------------------------------------------
# kill during rebalance: capacity conservation with a frozen shard
# ---------------------------------------------------------------------------

def test_kill_during_rebalance_round_conserves_capacity():
    store, _ = mk_byte_world(n_jobs=6, file_bytes=2 * MB)
    cap = 64 * MB
    with open_cache(store, cap, cfg=CFG, driver="process", n_procs=2,
                    rpc_timeout_s=10.0) as c:
        d = c.engine
        assert sum(d.shard_capacities()) == cap
        # skew demand so the rebalancer has moves to plan
        t = 0.0
        for rep in range(3):
            for j in range(6):
                c.read((f"job{j}", "data"), 0, 2 * MB, t)
                t += 0.05
        ChaosMonkey(c).kill(0)
        moved = d.rebalance_now(t)              # dead shard mid-round
        caps = d.shard_capacities()
        assert sum(caps) == cap, (
            f"capacity leaked in a faulted rebalance: {caps} (moved "
            f"{moved} quanta)")
        wait_all_up(c)
        # post-recovery round still conserves
        d.rebalance_now(t + 100.0)
        assert sum(d.shard_capacities()) == cap


# ---------------------------------------------------------------------------
# store hang: client-side retry deadline, worker-side RPC deadline
# ---------------------------------------------------------------------------

def test_store_hang_hits_retry_deadline():
    """An endlessly-flaky, hanging store costs a *bounded* wait: the
    retry deadline converts the stall into DeadlineError instead of
    sleeping through the full backoff ladder."""
    inner = MemStore(block_size=1 * MB)
    inner.add_file(("a", "f"), np.zeros(1 * MB, dtype=np.uint8))
    flaky = FaultyStore(inner, fail_rate=1.0, hang_rate=1.0, hang_s=0.05,
                        seed=3)
    pol = RetryPolicy(max_attempts=100, backoff_s=0.01,
                      deadline_s=0.25)
    t0 = time.monotonic()
    with pytest.raises(DeadlineError):
        pol.call(flaky.fetch_range, ("a", "f#b0"), 0, 1024)
    assert time.monotonic() - t0 < 5.0, "deadline did not bound the wait"


def test_worker_store_hang_trips_rpc_deadline_and_degrades():
    """A worker whose backing store hangs past ``rpc_timeout_s`` is
    killed and respawned; the blocked reader is served from the store
    directly — bytes arrive, nothing hangs."""
    store, payloads = mk_byte_world(n_jobs=2)
    # the *workers* fetch through a hanging store; the client's degraded
    # path fetches from the pristine one (open_cache shares one backing,
    # so wire the two layers by hand)
    hang = FaultyStore(store, hang_rate=1.0, hang_s=30.0, seed=1)
    eng = ProcessShardedCache(store, 64 * MB, cfg=CFG, n_procs=2,
                              arena_bytes=16 * MB, backing=hang,
                              rpc_timeout_s=1.0)
    try:
        c = CacheClient(eng, backing=store, executor=ProcessExecutor(),
                        fetch_bytes=True)
        # the worker-side store is the hanging one: its fetch RPC must
        # blow the 1 s deadline, not wedge the reader for 30 s
        p = ("job0", "data")
        t0 = time.monotonic()
        r = c.read(p, 0, 1 * MB)
        elapsed = time.monotonic() - t0
        assert bytes(r.data) == bytes(payloads[p][:1 * MB])
        assert elapsed < 30.0, "reader waited out the full store hang"
        fs = c.fault_stats()
        assert any(e["kind"] == "kill" for e in fs["events"]), (
            "hung fetch did not trip the RPC deadline")
        assert (c.client_stats.fallback_fetches > 0
                or c.client_stats.degraded_reads > 0)
        wait_all_up(c)
        c.close()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# restart budget exhaustion: permanent DOWN, reads keep flowing
# ---------------------------------------------------------------------------

def test_budget_exhaustion_marks_shard_down_but_reads_flow():
    store, payloads = mk_byte_world()
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    arena_bytes=16 * MB, fetch_bytes=True,
                    restart_budget=2, restart_window_s=300.0,
                    rpc_timeout_s=10.0) as c:
        target = c.engine.shard_id(("job0", "data"))
        monkey = ChaosMonkey(c)

        def shard(c):
            return c.fault_stats()["shards"][target]

        for _ in range(3):                      # budget is 2: third kill
            wait_all_up(c, timeout=20.0)        # is the permanent one
            if c.shard_states()[target] == SHARD_DOWN:
                break
            gen0 = shard(c)["generation"]
            monkey.kill(target)
            # wait until this kill is *registered* (respawn bumps the
            # generation, or the budget marks the shard down) — a kill
            # fired before the previous death is even noticed would be a
            # no-op on an already-dead process
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                s = shard(c)
                if s["generation"] > gen0 or s["state"] == SHARD_DOWN:
                    break
                time.sleep(0.02)
        deadline = time.monotonic() + 20.0
        while (c.shard_states()[target] != SHARD_DOWN
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert c.shard_states()[target] == SHARD_DOWN
        assert any(e["kind"] == "down" for e in c.fault_stats()["events"])
        # capacity total is conserved with the shard permanently out
        assert sum(c.engine.shard_capacities()) == 64 * MB
        # every key still reads correctly — dead shard's keys degraded,
        # surviving shard's keys through its kernel
        reqs = [((f"job{j}", "data"), 0, 2 * MB) for j in range(6)]
        for rep in range(2):
            outs = c.read_batch(reqs)
            for (p, off, sz), r in zip(reqs, outs):
                assert bytes(r.data) == bytes(payloads[p][off:off + sz])
        assert c.client_stats.degraded_reads > 0


# ---------------------------------------------------------------------------
# SIGSTOP wedge: heartbeat stall detection
# ---------------------------------------------------------------------------

def test_suspended_worker_detected_by_heartbeat_and_respawned():
    store, payloads = mk_byte_world(n_jobs=2)
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    arena_bytes=16 * MB, fetch_bytes=True,
                    heartbeat_s=1.0, rpc_timeout_s=20.0) as c:
        monkey = ChaosMonkey(c)
        try:
            p = ("job0", "data")
            c.read(p, 0, 1 * MB)                # channel warm + beating
            target = c.engine.shard_id(p)
            monkey.suspend(target)
            # the wedged worker holds the pipe open — only the heartbeat
            # can notice.  The read blocks until the supervisor kills the
            # stalled worker, then degrades; it must NOT wait rpc_timeout.
            t0 = time.monotonic()
            r = c.read(p, 0, 1 * MB)
            elapsed = time.monotonic() - t0
            assert bytes(r.data) == bytes(payloads[p][:1 * MB])
            assert elapsed < 15.0
            assert any(e["kind"] == "kill" for e in
                       c.fault_stats()["events"])
            assert wait_all_up(c)
            r = c.read(p, 0, 1 * MB)            # respawned kernel serves
            assert bytes(r.data) == bytes(payloads[p][:1 * MB])
        finally:
            monkey.resume_all()


# ---------------------------------------------------------------------------
# chaos e2e: mixed cluster sim loses a worker mid-trace
# ---------------------------------------------------------------------------

def _sim_world():
    suite = make_paper_suite(scale=0.15, seed=0, job_filter=[2, 8, 9])
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    return suite, store, cap


def _run_sim(suite, store, cap, chaos_events=(), probes=()):
    client = open_cache(store, cap, cfg=CFG, driver="process", n_procs=2,
                        rpc_timeout_s=15.0)
    try:
        sim = ClusterSim(suite, client, chaos_events=list(chaos_events))
        snaps = {}
        for name, t in probes:
            sim.at(t, lambda s, name=name:
                   snaps.__setitem__(name, s.engine.stats.snapshot()))
        res = sim.run()
        snaps["end"] = client.stats.snapshot()
        return res, snaps, client.fault_stats(), \
            client.client_stats.snapshot()
    finally:
        client.close()


def _window_chr(snaps, start_key):
    s0, s1 = snaps[start_key], snaps["end"]
    hits = s1["hits"] - s0["hits"]
    total = hits + s1["misses"] - s0["misses"]
    return hits / total if total else 0.0


def test_chaos_e2e_cluster_sim_survives_worker_kill():
    """Acceptance: kill a shard worker mid-trace on the mixed cluster
    sim.  The run completes (SIGALRM guards against hangs) with zero
    errored reads, the shard respawns within budget, and windowed
    post-recovery CHR lands within 5 % of the fault-free run."""
    suite, store, cap = _sim_world()
    base_res, base_snaps, _, _ = _run_sim(suite, store, cap)
    assert base_res.jct, "baseline sim completed no jobs"
    kill_at = base_res.makespan / 3.0
    window_from = 2.0 * base_res.makespan / 3.0
    probes = [("w", window_from)]

    suite2, store2, cap2 = _sim_world()
    # re-probe the baseline at the same virtual time for the window
    base_res2, base_snaps2, _, _ = _run_sim(suite, store, cap,
                                            probes=probes)
    res, snaps, fault, cstats = _run_sim(
        suite2, store2, cap2,
        chaos_events=[(kill_at, "kill", 0)], probes=probes)

    # completed with the same job set, nothing hung or errored
    assert set(res.jct) == set(base_res2.jct)
    assert res.chaos_log and res.chaos_log[0]["kind"] == "kill"
    # the worker came back within the restart budget
    assert any(e["kind"] == "respawn" for e in fault["events"])
    assert all(s["state"] == SHARD_UP for s in fault["shards"].values())
    # degraded reads happened while the shard was out — and every one of
    # them returned an outcome instead of raising into the sim loop
    assert cstats["degraded_reads"] >= 0
    # post-recovery convergence: windowed CHR within 5 % of fault-free
    chr_base = _window_chr(base_snaps2, "w")
    chr_chaos = _window_chr(snaps, "w")
    assert abs(chr_base - chr_chaos) <= 0.05, (
        f"post-recovery CHR diverged: base={chr_base:.4f} "
        f"chaos={chr_chaos:.4f}")


# ---------------------------------------------------------------------------
# extended seeded matrix (opt-in: pytest -m chaos_full)
# ---------------------------------------------------------------------------

@pytest.mark.chaos_full
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_full_matrix_seeded_strikes(seed):
    """Randomized-but-reproducible sweep: a planned schedule of kills
    and suspends lands mid-trace; every read stays byte-exact, nothing
    hangs, and the executor identity holds at close."""
    store, payloads = mk_byte_world(n_jobs=6, file_bytes=2 * MB, seed=seed)
    n_steps = 40
    with open_cache(store, 64 * MB, cfg=CFG, driver="process", n_procs=2,
                    arena_bytes=16 * MB, fetch_bytes=True,
                    heartbeat_s=1.0, rpc_timeout_s=10.0,
                    restart_budget=10, restart_window_s=300.0) as c:
        monkey = ChaosMonkey(c)
        sched = ChaosSchedule(monkey, plan_strikes(
            n_steps, n_shards=2, seed=seed, n_strikes=3,
            kinds=("kill", "suspend")))
        rng = np.random.default_rng(seed)
        try:
            for i in range(n_steps):
                sched.on_step(i)
                picks = rng.integers(0, 6, 4)
                reqs = [((f"job{int(j)}", "data"), 0, 1 * MB)
                        for j in picks]
                outs = c.read_batch(reqs)
                for (p, off, sz), r in zip(reqs, outs):
                    assert bytes(r.data) == \
                        bytes(payloads[p][off:off + sz]), \
                        f"step {i}: wrong bytes for {p}"
        finally:
            sched.close()
        assert sched.fired, "schedule fired no strikes"
        wait_all_up(c, timeout=30.0)
        c.flush(timeout=30.0)
        assert_identity(c)
