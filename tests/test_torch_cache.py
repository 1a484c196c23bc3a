"""The port's copy of the cache engine (``repro_torch.core``, ``storage``,
``data.pipeline``) against the JAX package's, on the CPU.

Both engines are driven over one seeded mixed trace (sequential sweeps,
random epochs, zipf-skewed reads and multi-block extents) at the same
explicit timestamps, for every named policy bundle: each read's
``ReadOutcome`` (blocks with their hit flags, prefetch candidates) and the
final snapshot's hit ratio must be equal.  Then ``CachedTokenPipeline`` from
both packages, with inline prefetch (``background_prefetch=False``) and one
shared fake clock per run: identical batches and ``PipelineStats``.
"""
import itertools
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import BUNDLES as JAX_BUNDLES
from repro.core import CacheConfig as JaxCacheConfig
from repro.core import bundle_client as jax_bundle_client
from repro.core.types import MB
from repro.data import pipeline as jax_pipeline
from repro.storage import RemoteStore as JaxRemoteStore
from repro.storage import make_dataset as jax_make_dataset
from repro_torch.core import BUNDLES, CacheConfig, bundle_client
from repro_torch.data import pipeline as torch_pipeline
from repro_torch.storage import RemoteStore, make_dataset

SIDES = {
    "jax": (JaxRemoteStore, jax_make_dataset, JaxCacheConfig,
            jax_bundle_client),
    "torch": (RemoteStore, make_dataset, CacheConfig, bundle_client),
}
CFG = dict(min_share=8 * MB, rebalance_quantum=8 * MB, rebalance_period=5.0,
           prefetch_budget_bytes=32 * MB, window=40, reanalyze_every=20)
CAPACITY = 96 * MB


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _store(side):
    Store, make, _, _ = SIDES[side]
    store = Store()
    store.add(make("seqset", "flat_files", n_files=120,
                   small_file_size=256 * 1024))
    store.add(make("randset", "dir_tree", n_dirs=10, files_per_dir=12,
                   small_file_size=256 * 1024))
    store.add(make("bigfiles", "big_files", n_files=6, file_size=24 * MB))
    return store


def mixed_trace(store, seed=0):
    """(path, offset, size) reads: a sequential sweep, two random epochs, a
    zipf-skewed stream, and whole-file extents of big files, interleaved in
    seeded chunks of 8."""
    rng = np.random.default_rng(seed)
    seq = [f for f in store.datasets["seqset"].files]
    rnd = list(store.datasets["randset"].files)
    big = list(store.datasets["bigfiles"].files)
    streams = [[(f.path, 0, f.size) for f in seq]]
    for _ in range(2):
        streams.append([(rnd[i].path, 0, rnd[i].size)
                        for i in rng.permutation(len(rnd))])
    ranks = (rng.zipf(1.3, 400) - 1) % len(rnd)
    streams.append([(rnd[i].path, 0, rnd[i].size) for i in ranks])
    streams.append([(f.path, 0, f.size) for f in big[:4]]
                   + [(big[4].path, b * 4 * MB, 4 * MB) for b in range(6)])
    chunks = [s[i:i + 8] for s in streams for i in range(0, len(s), 8)]
    order = rng.permutation(len(chunks))
    return [r for i in order for r in chunks[i]]


def outcome_tuple(out):
    return ([(b.key, b.size, b.hit, b.prefetched_hit) for b in out.blocks],
            list(out.prefetches))


def _drive(side, name, trace):
    _, _, Cfg, make_client = SIDES[side]
    client = make_client(name, _store(side), CAPACITY, cfg=Cfg(**CFG),
                         executor="sim")
    outs = [outcome_tuple(client.read(fp, off, sz, 1000.0 + 0.01 * k).outcome)
            for k, (fp, off, sz) in enumerate(trace)]
    snap = client.snapshot()
    client.close()
    return outs, snap


def test_bundles_are_the_same():
    assert sorted(BUNDLES) == sorted(JAX_BUNDLES)
    for name, opts in BUNDLES.items():
        assert asdict(opts) == asdict(JAX_BUNDLES[name])


@pytest.mark.parametrize("name", sorted(JAX_BUNDLES))
def test_engine_copy_matches_reference(name):
    trace = mixed_trace(_store("jax"))
    assert len(trace) > 600
    want, want_snap = _drive("jax", name, trace)
    got, got_snap = _drive("torch", name, trace)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name}: divergence at read {k}: {trace[k]}"
    assert len(got) == len(want)
    assert got_snap["hit_ratio"] == want_snap["hit_ratio"]
    assert got_snap["hits"] == want_snap["hits"] > 0


def _fake_time():
    ticks = itertools.count()
    return SimpleNamespace(monotonic=lambda: 1000.0 + 1e-3 * next(ticks))


def _pipeline_run(side, module, steps=24):
    Store, make, Cfg, make_client = SIDES[side]
    store = Store()
    store.add(module.make_token_dataset("train_corpus", 8, 8 * MB))
    client = make_client("igtcache", store, 64 * MB,
                         cfg=Cfg(min_share=16 * MB, rebalance_quantum=16 * MB,
                                 rebalance_period=10.0), executor="sim")
    pipe = module.CachedTokenPipeline(store, client, "train_corpus",
                                      seq_len=128, batch=4, vocab=151936,
                                      background_prefetch=False)
    it = pipe.batches(epochs=1)
    batches = [next(it) for _ in range(steps)]
    pipe.close()
    snap = client.snapshot()
    client.close()
    return batches, asdict(pipe.stats), snap["hit_ratio"]


def test_pipeline_batches_and_stats_match_reference(monkeypatch):
    monkeypatch.setattr(jax_pipeline, "time", _fake_time())
    monkeypatch.setattr(torch_pipeline, "time", _fake_time())
    want = _pipeline_run("jax", jax_pipeline)
    got = _pipeline_run("torch", torch_pipeline)
    for bg, bw in zip(got[0], want[0]):
        assert sorted(bg) == sorted(bw) == ["labels", "tokens"]
        for k in bw:
            assert bg[k].dtype == bw[k].dtype
            np.testing.assert_array_equal(bg[k], bw[k])
    assert got[1] == want[1]
    assert got[1]["batches"] == 24 and got[1]["cache_hits"] > 0
    assert got[2] == want[2]


def test_port_opens_every_scheme_and_driver(tmp_path):
    """``tiered+``, ``mock-s3://`` and ``s3://`` open as stores,
    ``cache://`` as a daemon session, and ``driver="process"`` /
    ``executor="process"`` as engines, on the port as in the reference: no
    scheme is refused, and none falls through to ``unknown store scheme``."""
    from repro_torch.core import (ProcessExecutor, ProcessShardedCache,
                                  open_cache)
    from repro_torch.daemon import CacheDaemon, RemoteCacheClient
    from repro_torch.storage import S3Store, TieredStore, open_store
    from repro_torch.storage.api import registered_schemes
    assert {"s3", "mock-s3", "cache"} <= set(registered_schemes())
    tiered = open_store(
        f"tiered+mem://x?ram_mb=1&disk_mb=2&spill_dir={tmp_path}")
    assert isinstance(tiered, TieredStore)
    assert tiered.spill_dir == str(tmp_path)
    mock = open_store("mock-s3://t/bkt?dirs=1&files=2&file_kb=64")
    assert isinstance(mock, S3Store)
    direct = open_store(f"s3://{mock.host}:{mock.port}/bkt")
    path = ("bkt", "00", "000.bin")
    assert direct.file_size(path) == mock.file_size(path) == 64 * 1024
    store = _store("torch")
    c = open_cache(store, CAPACITY, driver="process", n_procs=2)
    try:
        assert isinstance(c.engine, ProcessShardedCache)
        assert isinstance(c.executor, ProcessExecutor)
    finally:
        c.close()
    c = open_cache(store, CAPACITY, driver="process", n_procs=1,
                   executor="process")
    c.close()
    with CacheDaemon(store, CAPACITY) as d:
        with open_cache(d.uri) as session:
            assert isinstance(session, RemoteCacheClient)
            fp = store.datasets["seqset"].files[0].path
            assert session.read(fp, 0, 4096).outcome.blocks
