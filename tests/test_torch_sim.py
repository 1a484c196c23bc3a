"""The port's cluster simulator (``repro_torch.sim``) under the JAX package's
own simulator tests, bounds unchanged: link priorities and promotion,
determinism, cache-vs-no-cache and IGTCache-vs-JuiceFS ordering, every job
finishing.  Cross-package cases at the end hold the port's ``SimResult`` to
the reference's, field for field and bit for bit, on the same suite (the
igtcache, juicefs and nocache bundles, a two-shard engine, a ``tiered+``
backing, the allocation trace), and the paper suite's jobs and datasets and
the strike planner's plans to the reference's.
"""
import pytest
import torch

from repro_torch.core import CacheConfig, IGTCache, bundle
from repro_torch.core.types import MB
from repro_torch.sim import ClusterSim, SharedLink, make_paper_suite
from repro_torch.storage import RemoteStore


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def scaled_cfg(capacity):
    share = max(16 * MB, capacity // 128)
    return CacheConfig(min_share=share, rebalance_quantum=share,
                       rebalance_period=10.0,
                       prefetch_budget_bytes=max(64 * MB, capacity // 8))


def test_link_priority_and_latency():
    link = SharedLink(bandwidth_Bps=100.0, latency_s=1.0)
    got = []
    link.enqueue(100, "bg", demand=False, callback=None)
    link.enqueue(100, "demand", demand=True, callback=None)
    finish, t = link.pump(0.0)
    got.append(t.key)
    assert finish == pytest.approx(2.0)     # 1s busy + 1s latency
    finish2, t2 = link.pump(link.free_at)
    got.append(t2.key)
    assert got == ["demand", "bg"]


def test_link_promote():
    link = SharedLink(100.0, 0.0)
    link.enqueue(100, "a", demand=False, callback=("x", 1))
    assert link.promote("a")
    finish, t = link.pump(0.0)
    assert t.demand and t.key == "a"


def _run(bundle_name, suite, store, cap):
    eng = IGTCache(store, cap, cfg=scaled_cfg(cap),
                   options=bundle(bundle_name))
    return ClusterSim(suite, eng).run()


@pytest.fixture(scope="module")
def small_world():
    suite = make_paper_suite(scale=0.15, seed=0, job_filter=[2, 8, 9, 16])
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    return suite, store, cap


def test_sim_deterministic(small_world):
    suite, store, cap = small_world
    r1 = _run("igtcache", suite, store, cap)
    r2 = _run("igtcache", suite, store, cap)
    assert r1.jct == r2.jct
    assert r1.hit_ratio == r2.hit_ratio


def test_cache_beats_nocache(small_world):
    suite, store, cap = small_world
    with_cache = _run("juicefs", suite, store, cap)
    eng = IGTCache(store, 0, cfg=scaled_cfg(cap),
                   options=bundle("prefetch_none"))
    no_cache = ClusterSim(suite, eng).run()
    assert with_cache.avg_jct < no_cache.avg_jct
    assert with_cache.hit_ratio > 0.2


def test_igt_beats_juicefs_on_chr(small_world):
    suite, store, cap = small_world
    igt = _run("igtcache", suite, store, cap)
    jfs = _run("juicefs", suite, store, cap)
    assert igt.hit_ratio > jfs.hit_ratio


def test_all_jobs_finish(small_world):
    suite, store, cap = small_world
    res = _run("igtcache", suite, store, cap)
    assert set(res.jct) == {j.job_id for j in suite.jobs}
    assert all(v > 0 for v in res.jct.values())


# ---------------------------------------------------------------------------
# cross-package: the port's simulator against the reference's
# ---------------------------------------------------------------------------

def _packages(which):
    """(core, sim, storage) of the port or of the JAX package's reference
    (whose simulator and cache kernel import no JAX)."""
    import importlib
    root = "repro_torch" if which == "port" else "repro"
    return tuple(importlib.import_module(f"{root}.{m}")
                 for m in ("core", "sim", "storage"))


SIM_CASES = ("igtcache", "juicefs", "nocache", "two_shards", "tiered",
             "trace_alloc")


def _sim_result(which, case):
    """``small_world``'s suite through one package's ``ClusterSim``; the
    ``tiered`` case's backing is ``tiered+sim://`` in index mode holding a
    fifth of the cache's bytes on disk, under a client of the rest."""
    core, sim, storage = _packages(which)
    suite = sim.make_paper_suite(scale=0.15, seed=0, job_filter=[2, 8, 9, 16])
    cap = int(0.35 * suite.total_bytes())
    ram = int(cap * 0.8)
    store = (storage.open_store("tiered+sim://default?mode=index"
                                f"&disk_bytes={cap - ram}")
             if case == "tiered" else storage.RemoteStore())
    for ds in suite.datasets.values():
        store.add(ds)

    def cfg(c):
        share = max(16 * MB, c // 128)
        return core.CacheConfig(min_share=share, rebalance_quantum=share,
                                rebalance_period=10.0,
                                prefetch_budget_bytes=max(64 * MB, c // 8))
    if case == "nocache":
        eng = core.IGTCache(store, 0, cfg=cfg(cap),
                            options=core.bundle("prefetch_none"))
    elif case == "two_shards":
        eng = core.ShardedIGTCache(store, cap, cfg=cfg(cap), n_shards=2)
    elif case == "tiered":
        eng = core.bundle_client("igtcache", store, ram, cfg=cfg(ram))
    else:
        eng = core.IGTCache(store, cap, cfg=cfg(cap), options=core.bundle(
            "igtcache" if case == "trace_alloc" else case))
    return sim.ClusterSim(suite, eng,
                          trace_alloc=(case == "trace_alloc")).run()


@pytest.mark.parametrize("case", SIM_CASES)
def test_sim_result_matches_reference(case):
    """Every ``SimResult`` field, the kernel's stats included, equal to the
    reference's (floats bit for bit); each case does what it names."""
    import dataclasses
    got = dataclasses.asdict(_sim_result("port", case))
    want = dataclasses.asdict(_sim_result("ref", case))
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    assert len(got["jct"]) == 4 and got["link_bytes"] > 0
    if case == "nocache":
        assert got["hit_ratio"] == 0.0
    if case == "two_shards":
        assert got["rebalance_trace"]
    if case == "tiered":
        assert got["tier_stats"]["disk_hits"] > 0
    if case == "trace_alloc":
        assert len(got["alloc_trace"]) > 10


def test_paper_suite_matches_reference():
    """``make_paper_suite(1.0)``: the same 18 jobs, step for step, and the
    same datasets, file for file."""
    port = _packages("port")[1].make_paper_suite(1.0)
    ref = _packages("ref")[1].make_paper_suite(1.0)

    def jobs(s):
        return [(j.job_id, j.name, j.dataset, j.pattern, j.device,
                 j.submit_time, j.steps) for j in s.jobs]

    def datasets(s):
        return {k: (d.name, d.layout, [(f.path, f.size) for f in d.files],
                    d.dirs, d.total_bytes, d.n_items)
                for k, d in s.datasets.items()}
    assert len(port.jobs) == 18
    assert jobs(port) == jobs(ref)
    assert datasets(port) == datasets(ref)
    assert port.total_bytes() == ref.total_bytes()


@pytest.mark.parametrize("kw", [
    dict(n_steps=40, n_shards=2),
    dict(n_steps=200, n_shards=4, seed=3, n_strikes=6,
         kinds=("kill", "suspend"), resume_after=5),
    dict(n_steps=60, n_shards=2, seed=9, n_strikes=4,
         kinds=("kill", "client_kill", "daemon_kill", "daemon_restart"),
         n_clients=3, min_step=5),
], ids=["one_kill", "kill_suspend", "every_domain"])
def test_plan_strikes_matches_reference(kw):
    port = _packages("port")[1].plan_strikes(**kw)
    ref = _packages("ref")[1].plan_strikes(**kw)
    assert [(s.step, s.kind, s.sid) for s in port] == \
        [(s.step, s.kind, s.sid) for s in ref]
    assert len(port) >= kw.get("n_strikes", 1)
