"""The JAX package's sharded-engine invariants (tests/test_sharded.py) on the
port's ``core.sharded`` and simulator, bounds unchanged.

Routing: same path → same shard, always, across facade instances (the hash
is process-stable).  Batching: ``read_batch`` splits a batch by shard but
returns outcomes in the original request order.  Allocation: the
cross-shard GlobalRebalancer conserves total capacity and every shard's
``sum(quota) == capacity`` invariant — under both move-sizing policies
(``quantum_policy="fixed"`` and the sketch-fed adaptive planner).
End-to-end: the paper-suite cluster sim at n=4/8/16 stays within 2 pp CHR
of the unsharded engine (bitwise equivalence at ``n_shards=1`` is pinned in
test_torch_equivalence.py).
"""
import random

import pytest
import torch

from repro_torch.core import (CacheConfig, GlobalRebalancer, IGTCache, Pattern,
                              ShardedIGTCache, bundle_engine, make_engine,
                              shard_index)
from repro_torch.core.sharded import DemandSummary
from repro_torch.core.types import MB
from repro_torch.sim import ClusterSim, make_paper_suite
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


CFG = CacheConfig(min_share=8 * MB, rebalance_quantum=8 * MB,
                  rebalance_period=5.0, node_cap=300, window=20,
                  reanalyze_every=10)


def mk_store(n_datasets=6):
    store = RemoteStore()
    for i in range(n_datasets):
        store.add(make_dataset(f"ds{i}", "dir_tree", n_dirs=4,
                               files_per_dir=8, small_file_size=512 * 1024))
    return store


# ------------------------------------------------------------------ routing

def test_same_path_same_shard_always():
    store = mk_store()
    a = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    b = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    for ds in store.datasets.values():
        for f in ds.files:
            sid = a.shard_id(f.path)
            # stable across repeated calls, facade instances, and the free
            # function; block paths route with their file
            assert a.shard_id(f.path) == sid
            assert b.shard_id(f.path) == sid
            assert shard_index(f.path, 4) == sid
            assert a.shard_id(f.path + ("#0",)) == sid


def test_routing_hashes_once_per_dataset(monkeypatch):
    """Memoized routing: the CRC-32 runs once per
    top-level component, not once per access — every later access is a
    dict lookup on both drivers (ShardRouting mixin)."""
    import repro_torch.core.sharded as sh
    calls = []
    real = sh.zlib.crc32
    monkeypatch.setattr(sh.zlib, "crc32",
                        lambda data: calls.append(data) or real(data))
    store = mk_store()
    eng = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    t = 0.0
    for _ in range(3):
        for ds in store.datasets.values():
            for f in ds.files[:8]:
                eng.read(f.path, 0, f.size, t)
                t += 0.01
    assert len(calls) <= len(store.datasets), \
        f"CRC-32 ran {len(calls)}× for {len(store.datasets)} datasets"


def test_routing_only_uses_top_level_component():
    """A dataset never straddles shards: every stream (directory, file,
    block level) observes exactly its unsharded access sequence."""
    store = mk_store()
    eng = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    for ds in store.datasets.values():
        sids = {eng.shard_id(f.path) for f in ds.files}
        assert len(sids) == 1


def test_reads_land_on_routed_shard():
    store = mk_store()
    eng = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    f = store.datasets["ds0"].files[0]
    eng.read(f.path, 0, f.size, 0.0)
    sid = eng.shard_id(f.path)
    for i, shard in enumerate(eng.shards):
        expect = 1 if i == sid else 0
        assert shard.stats.accesses == expect


# ----------------------------------------------------------------- batching

def test_read_batch_preserves_request_order():
    store = mk_store()
    mono = IGTCache(store, 64 * MB, cfg=CFG)
    eng = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=4)
    # interleave datasets so consecutive requests hit different shards
    files = []
    dss = list(store.datasets.values())
    for i in range(8):
        for ds in dss:
            files.append(ds.files[i])
    reqs = [(f.path, 0, f.size) for f in files]
    t = 0.0
    for _ in range(3):
        outs = eng.read_batch(reqs, t)
        ref = mono.read_batch(reqs, t)
        assert len(outs) == len(reqs)
        for (fp, off, sz), out, r in zip(reqs, outs, ref):
            # outcome i describes request i: same block keys as unsharded
            assert [b.key for b in out.blocks] == [b.key for b in r.blocks]
        for o in outs:
            for p, s in o.prefetches:
                eng.complete_prefetch(p, s, t)
        for o in ref:
            for p, s in o.prefetches:
                mono.complete_prefetch(p, s, t)
        t += 0.5


# --------------------------------------------------------------- allocation

def _drive(eng, store, reps=40, t0=0.0, dt=0.05):
    """Skewed traffic on ds0, sequential scan on ds1 — promotes CMUs with
    opposite marginal benefit."""
    t = t0
    hot = store.datasets["ds0"].files[:3]
    for r in range(reps):
        for f in hot:                      # revisit a hot set (skew)
            out = eng.read(f.path, 0, f.size, t)
            t += dt
        f = store.datasets["ds1"].files[r % 32]
        eng.read(f.path, 0, f.size, t)     # one sequential step
        t += dt
    return t


def test_cross_shard_rebalance_conserves_capacity():
    store = mk_store()
    cap = 64 * MB
    eng = ShardedIGTCache(store, cap, cfg=CFG, n_shards=4)
    assert sum(eng.shard_capacities()) == cap
    t = _drive(eng, store)
    for k in range(1, 30):
        eng.tick(t + k * CFG.rebalance_period)
        assert sum(eng.shard_capacities()) == cap
        for s in eng.shards:
            assert s.cache.quota_invariant_ok()
            assert sum(c.quota for c in s.cache.cmus.values()) \
                == s.cache.capacity


def test_global_rebalancer_moves_toward_demand():
    """A skewed CMU with ghost-window demand pulls capacity from another
    shard's idle default pool."""
    store = mk_store()
    s0 = IGTCache(store, 32 * MB, cfg=CFG)
    s1 = IGTCache(store, 32 * MB, cfg=CFG)
    cmu = s0.cache.create_cmu(("ds0",), 128 * MB, now=0.0)
    cmu.flat_pattern = Pattern.SKEWED
    for i in range(50):                      # arrival rate + ghost hits
        cmu.note_access(i * 0.01)
        cmu.buffer_window.on_evict(f"k{i}")
        cmu.buffer_window.probe(f"k{i}")
    reb = GlobalRebalancer(CFG)
    before = (s0.cache.capacity, s1.cache.capacity)
    moves = reb.rebalance_shards([s0, s1], now=CFG.rebalance_period + 1.0)
    assert moves, "expected at least one cross-shard move"
    assert s0.cache.capacity > before[0]
    assert s1.cache.capacity < before[1]
    assert s0.cache.capacity + s1.cache.capacity == sum(before)
    for s in (s0, s1):
        assert sum(c.quota for c in s.cache.cmus.values()) \
            == s.cache.capacity


def test_global_estimate_survives_local_window_reset():
    """Shard-local rounds reset the per-round ghost counters on their own
    read-triggered phase; the global layer must still see a skewed CMU's
    demand (it measures cumulative-counter deltas over its own interval)."""
    store = mk_store()
    s0 = IGTCache(store, 32 * MB, cfg=CFG)
    s1 = IGTCache(store, 32 * MB, cfg=CFG)
    cmu = s0.cache.create_cmu(("ds0",), 128 * MB, now=0.0)
    cmu.flat_pattern = Pattern.SKEWED
    for i in range(50):
        cmu.note_access(i * 0.01)
        cmu.buffer_window.on_evict(f"k{i}")
        cmu.buffer_window.probe(f"k{i}")
    # a local round fired a moment ago and zeroed the per-round window
    cmu.buffer_window.reset_window()
    assert cmu.buffer_window.hit_frequency() == 0.0
    reb = GlobalRebalancer(CFG)
    moves = reb.rebalance_shards([s0, s1], now=CFG.rebalance_period + 1.0)
    assert moves, "reset phase must not hide cross-shard demand"
    # next interval starts at the marks: no new ghost traffic -> no demand
    moves2 = reb.rebalance_shards([s0, s1],
                                  now=2 * CFG.rebalance_period + 2.0)
    assert not moves2


def test_single_shard_never_globally_rebalances():
    store = mk_store()
    eng = ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=1)
    t = _drive(eng, store)
    eng.tick(t + CFG.rebalance_period + 1.0)
    assert eng.shard_capacities() == [64 * MB]


# ------------------------------------------------------------- constructors

def test_make_engine_dispatch():
    store = mk_store()
    assert isinstance(make_engine(store, 64 * MB, cfg=CFG), IGTCache)
    eng = make_engine(store, 64 * MB, cfg=CFG, n_shards=4)
    assert isinstance(eng, ShardedIGTCache)
    assert eng.n_shards == 4
    jfs = bundle_engine("juicefs", store, 64 * MB, cfg=CFG, n_shards=2)
    assert isinstance(jfs, ShardedIGTCache)
    assert jfs.options.name == "juicefs"
    with pytest.raises(ValueError):
        ShardedIGTCache(store, 64 * MB, cfg=CFG, n_shards=0)


# ------------------------------------------------------- end-to-end cluster

def _scaled_cfg(capacity, policy="adaptive"):
    share = max(16 * MB, capacity // 128)
    return CacheConfig(min_share=share, rebalance_quantum=share,
                       rebalance_period=10.0,
                       prefetch_budget_bytes=max(64 * MB, capacity // 8),
                       quantum_policy=policy)


@pytest.fixture(scope="module")
def paper_sim():
    """Scaled paper-suite runs shared by the convergence tests: one
    store/suite, results cached per shard count so the n=4/8/16 cases
    pay for one simulation each (plus one unsharded reference)."""
    suite = make_paper_suite(scale=0.15, seed=0,
                             job_filter=[2, 8, 9, 14, 16])
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    cache = {}

    def run(n_shards):
        if n_shards not in cache:
            if n_shards == 1:
                eng = IGTCache(store, cap, cfg=_scaled_cfg(cap))
            else:
                eng = ShardedIGTCache(store, cap, cfg=_scaled_cfg(cap),
                                      n_shards=n_shards)
            res = ClusterSim(suite, eng).run()
            if n_shards > 1:
                assert sum(eng.shard_capacities()) == cap
            cache[n_shards] = (eng, res)
        return cache[n_shards]

    return run


@pytest.mark.parametrize("n_shards", [4, 8, 16])
def test_sharded_cluster_sim_chr_converges(paper_sim, n_shards):
    """Paper-suite cluster sim (scaled): sharded CHR within 2 pp of the
    unsharded engine at n=4, *and* — the sketch-rebalance headline — at
    n=8 and n=16, where the fixed-quantum planner used to trail by
    11-16 pp.  One-sided: the global planner may legitimately beat the
    unsharded engine (it sizes demand across shards that the local
    rounds cannot see)."""
    _, mono = paper_sim(1)
    _, shard = paper_sim(n_shards)
    assert shard.hit_ratio >= mono.hit_ratio - 0.02, \
        f"CHR gap at n={n_shards}: unsharded={mono.hit_ratio:.4f} " \
        f"sharded={shard.hit_ratio:.4f}"


def test_rebalance_trace_bounded_summaries(paper_sim):
    """Every cross-shard round's wire payload stays O(KB)/shard — the
    point of shipping sketches instead of per-block counters — and the
    rounds are recorded in SimResult.rebalance_trace."""
    _, shard = paper_sim(8)
    trace = shard.rebalance_trace
    assert trace, "sharded run must record rebalance rounds"
    for row in trace:
        assert row["summary_bytes"] <= 4096 * 8
        assert row["policy"] == "adaptive"
    assert any(r["moves"] > 0 for r in trace)
    assert any(r["ghost_mass"] > 0 for r in trace)


# --------------------------------------------- adaptive planner (properties)

def _rand_rows(rng, n_shards, down=None):
    """Synthetic demand rows across shards, shapes the planner must keep
    capacity-safe: defaults with zero floors, workload CMUs with random
    quota/used/want/floor/benefit.  ``down`` excludes one shard's rows
    entirely (a dead worker contributes nothing: the frozen share)."""
    rows = []
    for sid in range(n_shards):
        if sid == down:
            continue
        dq = rng.randrange(0, 512 * MB, MB)
        rows.append(DemandSummary(
            shard=sid, key=("<default>",), benefit=0.0, wants_more=False,
            can_take=False, quota=dq, headroom=dq, want=0, floor=0,
            free=rng.randrange(0, dq + 1)))
        for i in range(rng.randrange(0, 3)):
            q = rng.randrange(0, 256 * MB, MB)
            rows.append(DemandSummary(
                shard=sid, key=(f"ds{sid}_{i}",),
                benefit=rng.random() * rng.choice([0.0, 1e-6, 1e-3, 1.0]),
                wants_more=rng.random() < 0.5, can_take=True, quota=q,
                headroom=q - 8 * MB,
                demand_limit=(rng.randrange(0, 512 * MB)
                              if rng.random() < 0.5 else None),
                want=rng.randrange(0, 256 * MB, MB),
                floor=rng.choice([0, 8 * MB, 64 * MB]),
                free=rng.randrange(0, q + 1)))
    return rows


@pytest.mark.parametrize("policy", ["adaptive", "fixed"])
def test_plan_moves_conserves_capacity_property(policy):
    """Randomized invariant sweep: whatever rows the planner sees, the
    planned moves conserve total quota, never drive a row negative, and
    never pull a workload donor below min_share."""
    cfg = CacheConfig(min_share=8 * MB, rebalance_quantum=8 * MB,
                      quantum_policy=policy)
    rng = random.Random(1234)
    for trial in range(200):
        n_shards = rng.choice([2, 3, 4, 8])
        down = rng.choice([None, rng.randrange(n_shards)])
        rows = _rand_rows(rng, n_shards, down=down)
        total = sum(r.quota for r in rows)
        reb = GlobalRebalancer(cfg)
        moves = reb.plan_moves(rows)
        assert sum(r.quota for r in rows) == total
        assert sum(a for _, _, a in moves) >= 0
        for d, t, amt in moves:
            assert amt > 0
            assert d.shard != t.shard
            if down is not None:
                assert down not in (d.shard, t.shard)
        for r in rows:
            assert r.quota >= 0
            if r.can_take and not any(r is d for d, _, _ in moves):
                continue    # untouched or taker: no donor floor to check
        for r in rows:
            if r.can_take and any(r is d for d, _, _ in moves):
                assert r.quota >= cfg.min_share or r.headroom <= 0


def test_adaptive_floor_topup_repairs_starvation():
    """A CMU born at quota 0 (defaults drained at creation time) is
    topped up to its floor even though benefit ordering alone would
    never select it — and the top-up retries each round, so it heals
    as soon as any donor has headroom."""
    cfg = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB)
    starving = DemandSummary(shard=0, key=("new",), benefit=0.0,
                             wants_more=False, can_take=True, quota=0,
                             headroom=-16 * MB, want=0, floor=16 * MB,
                             free=0)
    donor = DemandSummary(shard=1, key=("<default>",), benefit=0.0,
                          wants_more=False, can_take=False,
                          quota=128 * MB, headroom=128 * MB, want=0,
                          floor=0, free=128 * MB)
    reb = GlobalRebalancer(cfg)
    moves = reb.plan_moves([starving, donor])
    assert moves and starving.quota >= starving.floor
    assert donor.quota == 128 * MB - sum(a for _, _, a in moves)


def test_adaptive_want_sized_move_beats_one_quantum():
    """With a large measured want and a cold donor, one adaptive round
    moves (almost) the whole want — the fixed policy would need
    O(want/quantum) rounds."""
    cfg = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB)
    taker = DemandSummary(shard=0, key=("hot",), benefit=1.0,
                          wants_more=True, can_take=True, quota=64 * MB,
                          headroom=48 * MB, want=512 * MB, floor=16 * MB,
                          free=0)
    donor = DemandSummary(shard=1, key=("<default>",), benefit=0.0,
                          wants_more=False, can_take=False,
                          quota=1024 * MB, headroom=1024 * MB, want=0,
                          floor=0, free=1024 * MB)
    reb = GlobalRebalancer(cfg)
    moves = reb.plan_moves([taker, donor])
    assert sum(a for _, _, a in moves) == 512 * MB
    assert taker.want == 0


def test_adaptive_flow_cooldown_blocks_reversal():
    """A donor→taker flow must not reverse on the next round even if the
    benefit estimates momentarily flip (ping-pong damping for
    want-sized moves)."""
    cfg = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB)
    reb = GlobalRebalancer(cfg)

    def mk(b_a, b_b, qa, qb, want_a, want_b):
        a = DemandSummary(shard=0, key=("a",), benefit=b_a,
                          wants_more=True, can_take=True, quota=qa,
                          headroom=qa - 16 * MB, want=want_a,
                          floor=16 * MB, free=0)
        b = DemandSummary(shard=1, key=("b",), benefit=b_b,
                          wants_more=True, can_take=True, quota=qb,
                          headroom=qb - 16 * MB, want=want_b,
                          floor=16 * MB, free=0)
        return a, b
    a, b = mk(1.0, 1e-6, 64 * MB, 256 * MB, 128 * MB, 0)
    moves = reb.plan_moves([a, b])
    assert moves and all(d is b for d, _, _ in moves)
    # next round: estimates flip — the fresh b→a flow must not reverse
    a2, b2 = mk(1e-6, 1.0, a.quota, b.quota, 0, 128 * MB)
    moves2 = reb.plan_moves([a2, b2])
    assert not moves2
    # the round after, the cooldown has expired and the move is allowed
    a3, b3 = mk(1e-6, 1.0, a.quota, b.quota, 0, 128 * MB)
    assert reb.plan_moves([a3, b3])


# ---------------------------------------------------- tracker housekeeping

def test_ghost_mark_table_stays_bounded():
    """Long mixed trace with CMU churn: the tracker's ghost-mark and EMA
    tables track only live CMUs — entries for TTL-removed/evicted CMUs
    are pruned on each round, not accumulated forever."""
    store = mk_store()
    eng = IGTCache(store, 64 * MB, cfg=CFG)
    reb = GlobalRebalancer(CFG)
    tracker = reb.tracker
    for gen in range(12):
        cmu = eng.cache.create_cmu((f"ds{gen % 6}", f"g{gen}"), 32 * MB,
                                   now=float(gen))
        cmu.flat_pattern = Pattern.SKEWED
        for i in range(30):
            cmu.note_access(gen + i * 0.01)
            cmu.buffer_window.on_evict(f"k{gen}_{i}")
            cmu.buffer_window.probe(f"k{gen}_{i}")
        tracker.summarize(eng, 0, float(gen) + 0.5)
        live = len(eng.cache.cmus)          # includes the default
        assert len(tracker._ghost_mark) <= live
        assert len(tracker._ema) <= live
        if gen % 2:                          # churn: drop an old CMU
            eng.cache.remove_cmu((f"ds{gen % 6}", f"g{gen}"))
    # marks for the CMUs dropped since the last round disappear with the
    # next summarize (prune happens inside the round, not at removal)
    tracker.summarize(eng, 0, 99.0)
    assert len(tracker._ghost_mark) == len(eng.cache.cmus)
    assert len(tracker._ema) == len(eng.cache.cmus)
