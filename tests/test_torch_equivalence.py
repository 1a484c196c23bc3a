"""The JAX package's batched-vs-serial equivalence tests
(tests/test_equivalence.py) on the port's cache kernel, with the
simulator's trace helpers from ``repro_torch.sim.workloads``: the batched
``read()`` must reproduce the per-block reference path ``read_serial()``
decision for decision on seeded mixed workloads, and the vectorized
``classify_batch`` must agree with the scalar ``classify``.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core import (CacheConfig, IGTCache, Pattern, ShardedIGTCache,
                              bundle, open_cache)
from repro_torch.core.access_stream_tree import AccessStreamTree
from repro_torch.core.pattern import (classify, classify_batch,
                                      fit_adaptive_ttl, fit_adaptive_ttl_arr,
                                      fit_adaptive_ttl_batch)
from repro_torch.core.types import AccessRecord, MB
from repro_torch.storage import RemoteStore, make_dataset
from repro_torch.sim.workloads import (random_files, seq_blocks, seq_files,
                                       zipf_files)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# small window/cap so non-trivial thresholds, reanalysis, child pruning and
# the node cap all trigger inside a short trace
CFG = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB,
                  rebalance_period=5.0, prefetch_budget_bytes=64 * MB,
                  node_cap=250, window=40, reanalyze_every=20)


def mk_store():
    store = RemoteStore()
    store.add(make_dataset("seqset", "flat_files", n_files=250,
                           small_file_size=256 * 1024))
    store.add(make_dataset("randset", "dir_tree", n_dirs=20, files_per_dir=15,
                           small_file_size=256 * 1024))
    store.add(make_dataset("bigfiles", "big_files", n_files=10,
                           file_size=24 * MB))
    return store


def mixed_trace(store, seed=0):
    """Seeded mixed workload: sequential, random-epoch, skewed and
    multi-block extent reads, interleaved (generators from sim/workloads)."""
    rng = random.Random(seed)
    reqs = []
    for _, batch in seq_files(store.datasets["seqset"], 1, 8, 0.0):
        reqs.extend(batch)
    for _, batch in seq_blocks(store.datasets["bigfiles"], 1, 8, 0.0,
                               file_limit=6):
        reqs.extend(batch)
    for _, batch in random_files(store.datasets["randset"], 3, 8, 0.0,
                                 seed + 1):
        reqs.extend(batch)
    for _, batch in zipf_files(store.datasets["randset"], 1200, 1.3, 8, 0.0,
                               seed + 2):
        reqs.extend(batch)
    # whole-file multi-block extents (4+ blocks per read())
    for f in store.datasets["bigfiles"].files[:4]:
        reqs.append((f.path, 0, f.size))
    rng.shuffle(reqs)
    return reqs


def outcome_tuple(out):
    return ([(b.key, b.size, b.hit, b.prefetched_hit) for b in out.blocks],
            list(out.prefetches))


@pytest.mark.parametrize("seed", [0, 7])
def test_batched_read_matches_serial_reference(seed):
    store = mk_store()
    batched = IGTCache(store, 192 * MB, cfg=CFG)
    serial = IGTCache(store, 192 * MB, cfg=CFG)
    t = 0.0
    for k, (fp, off, sz) in enumerate(mixed_trace(store, seed)):
        ob = batched.read(fp, off, sz, t)
        os_ = serial.read_serial(fp, off, sz, t)
        assert outcome_tuple(ob) == outcome_tuple(os_), \
            f"divergence at access {k}: {fp} off={off}"
        for p, s in ob.prefetches:
            batched.complete_prefetch(p, s, t)
        for p, s in os_.prefetches:
            serial.complete_prefetch(p, s, t)
        t += 0.011
    assert batched.snapshot() == serial.snapshot()
    assert batched.tree.node_count() == serial.tree.node_count()


def test_batched_read_matches_serial_for_baseline_bundle():
    """The non-adaptive baselines ride the same hot path — pin one too."""
    store = mk_store()
    opts = bundle("juicefs")
    batched = IGTCache(store, 128 * MB, cfg=CFG, options=opts)
    serial = IGTCache(store, 128 * MB, cfg=CFG, options=bundle("juicefs"))
    t = 0.0
    for fp, off, sz in mixed_trace(store, 3)[:1500]:
        ob = batched.read(fp, off, sz, t)
        os_ = serial.read_serial(fp, off, sz, t)
        assert outcome_tuple(ob) == outcome_tuple(os_)
        for p, s in ob.prefetches:
            batched.complete_prefetch(p, s, t)
        for p, s in os_.prefetches:
            serial.complete_prefetch(p, s, t)
        t += 0.013
    assert batched.snapshot() == serial.snapshot()


def test_read_batch_matches_reads_between_tick_boundaries():
    """read_batch defers the tick to the end of the batch (that is the
    amortization), so it matches per-request read() exactly as long as no
    maintenance cadence boundary (TTL sweep / allocation round) falls inside
    a batch — pin that contract on a trace inside one cadence window."""
    store = mk_store()
    a = IGTCache(store, 192 * MB, cfg=CFG)
    b = IGTCache(store, 192 * MB, cfg=CFG)
    reqs = mixed_trace(store, 5)[:900]
    t = 0.0
    for i in range(0, len(reqs), 6):
        group = reqs[i:i + 6]
        outs_a = a.read_batch(group, t)
        outs_b = [b.read(fp, off, sz, t) for fp, off, sz in group]
        assert [outcome_tuple(o) for o in outs_a] == \
            [outcome_tuple(o) for o in outs_b]
        for o in outs_a:
            for p, s in o.prefetches:
                a.complete_prefetch(p, s, t)
        for o in outs_b:
            for p, s in o.prefetches:
                b.complete_prefetch(p, s, t)
        t += 0.01        # stays below the 5 s sweep/rebalance cadence
    assert a.snapshot() == b.snapshot()


@pytest.mark.parametrize("seed", [0, 7])
def test_sharded_n1_bitwise_identical_to_engine(seed):
    """ShardedIGTCache(n_shards=1) IS the engine: identical ReadOutcomes,
    stats and tree state on the seeded mixed traces (the facade forwards
    everything to one full-capacity shard and its global layer stays
    inert)."""
    store = mk_store()
    mono = IGTCache(store, 192 * MB, cfg=CFG)
    facade = ShardedIGTCache(store, 192 * MB, cfg=CFG, n_shards=1)
    t = 0.0
    for k, (fp, off, sz) in enumerate(mixed_trace(store, seed)):
        om = mono.read(fp, off, sz, t)
        of = facade.read(fp, off, sz, t)
        assert outcome_tuple(om) == outcome_tuple(of), \
            f"divergence at access {k}: {fp} off={off}"
        for p, s in om.prefetches:
            mono.complete_prefetch(p, s, t)
        for p, s in of.prefetches:
            facade.complete_prefetch(p, s, t)
        t += 0.011
    assert mono.snapshot() == facade.snapshot()
    assert mono.stats.snapshot() == facade.stats.snapshot()
    assert mono.tree.node_count() == facade.node_count()


def test_sharded_n1_read_batch_matches_engine():
    store = mk_store()
    mono = IGTCache(store, 192 * MB, cfg=CFG)
    facade = ShardedIGTCache(store, 192 * MB, cfg=CFG, n_shards=1)
    reqs = mixed_trace(store, 11)[:600]
    t = 0.0
    for i in range(0, len(reqs), 8):
        group = reqs[i:i + 8]
        outs_m = mono.read_batch(group, t)
        outs_f = facade.read_batch(group, t)
        assert [outcome_tuple(o) for o in outs_m] == \
            [outcome_tuple(o) for o in outs_f]
        for outs, eng in ((outs_m, mono), (outs_f, facade)):
            for o in outs:
                for p, s in o.prefetches:
                    eng.complete_prefetch(p, s, t)
        t += 0.01
    assert mono.snapshot() == facade.snapshot()


# ---------------------------------------------------------------------------
# client layer: CacheClient+SimExecutor vs the caller-driven loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_client_sim_executor_matches_caller_driven_loop(seed):
    """The caller layer is pure plumbing: a CacheClient with the inline
    SimExecutor over n_shards=1 must produce bitwise-identical
    ReadOutcomes, stats and tree state to the hand-rolled
    read-then-complete loop every consumer used to carry (the cluster
    sim's fetch/admit loop, the pipeline's inline mode, the examples)."""
    store = mk_store()
    loop = IGTCache(store, 192 * MB, cfg=CFG)
    client = open_cache(store, 192 * MB, cfg=CFG, n_shards=1,
                        executor="sim")
    t = 0.0
    for k, (fp, off, sz) in enumerate(mixed_trace(store, seed)):
        res = client.read(fp, off, sz, t)       # executor completes inline
        ol = loop.read(fp, off, sz, t)
        for p, s in ol.prefetches:              # the caller-driven contract
            loop.complete_prefetch(p, s, t)
        assert outcome_tuple(res.outcome) == outcome_tuple(ol), \
            f"divergence at access {k}: {fp} off={off}"
        t += 0.011
    assert client.engine.snapshot() == loop.snapshot()
    assert client.engine.stats.snapshot() == loop.stats.snapshot()
    assert client.engine.tree.node_count() == loop.tree.node_count()
    ex = client.executor.stats
    assert ex.completed == ex.submitted and ex.cancelled == 0


def test_client_read_batch_matches_caller_driven_loop():
    store = mk_store()
    loop = IGTCache(store, 192 * MB, cfg=CFG)
    client = open_cache(store, 192 * MB, cfg=CFG, n_shards=1,
                        executor="sim")
    reqs = mixed_trace(store, 11)[:600]
    t = 0.0
    for i in range(0, len(reqs), 8):
        group = reqs[i:i + 8]
        results = client.read_batch(group, t)
        outs_l = loop.read_batch(group, t)
        for o in outs_l:
            for p, s in o.prefetches:
                loop.complete_prefetch(p, s, t)
        assert [outcome_tuple(r.outcome) for r in results] == \
            [outcome_tuple(o) for o in outs_l]
        t += 0.01
    assert client.engine.snapshot() == loop.snapshot()


@pytest.mark.parametrize("seed", [0, 7])
def test_open_cache_uri_v2_store_matches_instance_client(seed):
    """``open_cache("sim://default", ...)`` — the
    URI front door resolving to the v2 ranged/batched store protocol —
    is bitwise-equivalent to the store-instance client on the
    seeded mixed traces: identical ReadOutcomes, stats, tree state, and
    identical fetched bytes."""
    ref_store = mk_store()
    ref = open_cache(ref_store, 192 * MB, cfg=CFG, n_shards=1,
                     executor="sim")
    uri = open_cache("sim://default", 192 * MB, cfg=CFG, n_shards=1,
                     executor="sim")
    # register the identical dataset layouts on the URI-created store
    uri.meta.add(make_dataset("seqset", "flat_files", n_files=250,
                              small_file_size=256 * 1024))
    uri.meta.add(make_dataset("randset", "dir_tree", n_dirs=20,
                              files_per_dir=15, small_file_size=256 * 1024))
    uri.meta.add(make_dataset("bigfiles", "big_files", n_files=10,
                              file_size=24 * MB))
    t = 0.0
    for k, (fp, off, sz) in enumerate(mixed_trace(ref_store, seed)):
        want = k % 97 == 0       # spot-check the byte path too
        ru = uri.read(fp, off, sz, t, fetch=want)
        rr = ref.read(fp, off, sz, t, fetch=want)
        assert outcome_tuple(ru.outcome) == outcome_tuple(rr.outcome), \
            f"divergence at access {k}: {fp} off={off}"
        if want and ru.blocks:
            assert np.array_equal(ru.data, rr.data), \
                f"byte divergence at access {k}: {fp} off={off}"
        t += 0.011
    assert uri.engine.snapshot() == ref.engine.snapshot()
    assert uri.engine.stats.snapshot() == ref.engine.stats.snapshot()
    assert uri.engine.tree.node_count() == ref.engine.tree.node_count()
    for c in (uri, ref):
        ex = c.executor.stats
        assert ex.completed == ex.submitted and ex.cancelled == 0


# ---------------------------------------------------------------------------
# vectorized analytics vs the scalar reference implementations
# ---------------------------------------------------------------------------

def _windows(seed, n_windows=200):
    """Randomized windows across all regimes the classifier distinguishes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        kind = rng.integers(0, 5)
        n = int(rng.integers(2, 101))
        c = int(rng.integers(2, 400))
        if kind == 0:       # sequential-ish
            start = int(rng.integers(0, 5))
            stride = int(rng.integers(1, 4))
            idx = start + stride * np.arange(n)
            c = max(c, int(idx.max()) + 1)
        elif kind == 1:     # permutation (random pattern)
            c = max(c, n)
            idx = rng.permutation(c)[:n]
        elif kind == 2:     # zipf-hot (skewed)
            idx = (rng.zipf(1.4, n) - 1) % c
        elif kind == 3:     # uniform with replacement
            idx = rng.integers(0, c, n)
        else:               # degenerate / tiny index space
            c = int(rng.integers(1, 4))
            idx = rng.integers(0, c, n)
        out.append((np.asarray(idx, dtype=np.int64), c))
    return out


def test_classify_batch_agrees_with_scalar_classify():
    cfg = CacheConfig(window=100)
    windows = _windows(0)
    got = classify_batch(windows, cfg)
    for (idx, c), res in zip(windows, got):
        records = [AccessRecord(index=int(i), total=c, time=float(k),
                                child_key=str(int(i)))
                   for k, i in enumerate(idx)]
        ref = classify(records, c, cfg)
        assert res.pattern is ref.pattern, \
            f"label mismatch: vec={res.pattern} scalar={ref.pattern} " \
            f"(n={len(idx)}, c={c})"
        if ref.d_critical:
            assert res.d_stat == pytest.approx(ref.d_stat, abs=1e-12)
            assert res.d_critical == pytest.approx(ref.d_critical, abs=1e-12)
        if ref.pattern is Pattern.SEQUENTIAL:
            assert res.stride == ref.stride


def test_classify_batch_rows_independent_of_batching():
    """A window must classify identically alone and inside a matrix batch."""
    cfg = CacheConfig(window=100)
    windows = _windows(1, n_windows=64)
    together = classify_batch(windows, cfg)
    alone = [classify_batch([w], cfg)[0] for w in windows]
    for a, b in zip(together, alone):
        assert a.pattern is b.pattern
        assert a.d_stat == b.d_stat
        assert a.d_critical == b.d_critical
        assert a.stride == b.stride
        assert a.seq_fraction == b.seq_fraction


def test_fit_adaptive_ttl_arr_matches_scalar():
    cfg = CacheConfig()
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 3, 10, 100):
        times = np.cumsum(rng.exponential(2.0, n))
        ref = fit_adaptive_ttl([float(t) for t in times], cfg)
        got = fit_adaptive_ttl_arr(times, cfg)
        if ref is None:
            assert got is None
        else:
            assert got == pytest.approx(ref, rel=1e-9)


def test_fit_adaptive_ttl_batch_matches_arr():
    """The one-matrix-pass TTL fit (all due-random nodes per classify pass)
    agrees with the per-window reference, including degenerate windows and
    out-of-order timestamps mid-batch."""
    cfg = CacheConfig()
    rng = np.random.default_rng(3)
    windows = []
    for n in (0, 1, 2, 3, 4, 10, 37, 100):
        windows.append(np.cumsum(rng.exponential(2.0, n)))
    shuffled = rng.exponential(2.0, 20)      # negative diffs get filtered
    windows.append(shuffled)
    got = fit_adaptive_ttl_batch(windows, cfg)
    assert len(got) == len(windows)
    for w, g in zip(windows, got):
        ref = fit_adaptive_ttl_arr(np.asarray(w, dtype=np.float64), cfg)
        if ref is None:
            assert g is None
        else:
            assert g == pytest.approx(ref, rel=1e-9)
    assert fit_adaptive_ttl_batch([], cfg) == []


def test_node_cap_leaf_lru_detaches_childless_first():
    cfg = CacheConfig(window=8, node_cap=60)
    t = AccessStreamTree(cfg)
    for i in range(2000):
        t.observe([(f"d{i % 30}", i % 30, 40), (f"f{i % 90}", i % 90, 90),
                   ("#0", 0, 4)], time=float(i))
        assert t.node_count() <= cfg.node_cap
    # interior nodes (the 30 live directories) must have survived: victims
    # are always taken from the childless leaf LRU first
    alive_dirs = sum(1 for n in t.iter_nodes() if n.children)
    assert alive_dirs > 0
    assert t.node_count() <= cfg.node_cap
