"""The ``unified/qwen3-1.7b`` composition of ``chip_smoke.py`` at a reduced
width, on the CPU, in both packages: one process-driver cache client (two
shard workers) over a ``tiered+sim://`` store holding the launcher's token
corpus and the serving engine's knowledge set, shared by a
``CachedTokenPipeline`` (4 batches), a ``ServingEngine`` (8 requests, 4
retrievals each) and the pipeline again (4 batches).

The port's composition must draw the reference's batches element for
element, with equal ``PipelineStats``, and its retrieval reads must give the
reference's ``ReadOutcome``s read by read.  The cache decides nothing the
train step could change, so the batches go to no train step here (the card
path trains on them).  Both runs are deterministic: the ``sim`` executor
completes prefetches inline, and the pipeline and the engine read one fake
clock.
"""
import itertools
from dataclasses import asdict
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import CacheConfig as JaxCacheConfig
from repro.core import open_cache as jax_open_cache
from repro.data import pipeline as jax_pipeline
from repro.models.transformer import init_params as jax_init_params
from repro.serve import engine as jax_engine
from repro.storage import make_dataset as jax_make_dataset
from repro.storage import open_store as jax_open_store
from repro_torch.configs import reduced_config
from repro_torch.core import CacheConfig, ProcessShardedCache, open_cache
from repro_torch.core.types import MB
from repro_torch.data import pipeline as torch_pipeline
from repro_torch.interop import params_from_jax
from repro_torch.serve import engine as torch_engine
from repro_torch.storage import TieredStore, make_dataset, open_store

ARCH = "qwen3-1.7b"
SEQ, BATCH, STEPS = 64, 4, 4            # batches before and after serving
N_REQ, MAX_NEW = 8, 4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SIDES = {
    "jax": SimpleNamespace(open_store=jax_open_store, make=jax_make_dataset,
                           open_cache=jax_open_cache, Cfg=JaxCacheConfig,
                           pipeline=jax_pipeline, engine=jax_engine),
    "torch": SimpleNamespace(open_store=open_store, make=make_dataset,
                             open_cache=open_cache, Cfg=CacheConfig,
                             pipeline=torch_pipeline, engine=torch_engine),
}


def _fake_time():
    ticks = itertools.count()
    return SimpleNamespace(monotonic=lambda: 1000.0 + 1e-3 * next(ticks))


def _compose(side, spill, jcfg, jparams, tparams):
    s = SIDES[side]
    store = s.open_store(f"tiered+sim://default?ram_mb=4&disk_mb=64"
                         f"&spill_dir={spill}")
    store.add(s.pipeline.make_token_dataset("train_corpus", 8, 2 * MB))
    store.add(s.make("knowledge", "flat_files", n_files=120,
                     small_file_size=64 * 1024))
    client = s.open_cache(store, 12 * MB, driver="process", n_procs=2,
                          executor="sim",
                          cfg=s.Cfg(min_share=2 * MB,
                                    rebalance_quantum=2 * MB))
    reads, read = [], client.read

    def logged_read(*a, **kw):
        r = read(*a, **kw)
        reads.append(([(b.key, b.size, b.hit, b.prefetched_hit)
                       for b in r.outcome.blocks], list(r.outcome.prefetches)))
        return r
    client.read = logged_read
    try:
        pipe = s.pipeline.CachedTokenPipeline(
            store, client, "train_corpus", seq_len=SEQ, batch=BATCH,
            vocab=jcfg.vocab)
        it = pipe.batches(epochs=1000)
        batches = [next(it) for _ in range(STEPS)]
        if side == "jax":
            eng = jax_engine.ServingEngine(
                jparams, jcfg, batch=4, max_seq=32, cache_engine=client,
                knowledge_dataset="knowledge")
            Req = jax_engine.Request
        else:
            eng = torch_engine.ServingEngine(
                tparams, reduced_config(ARCH), batch=4, max_seq=32,
                cache_engine=client, knowledge_dataset="knowledge",
                device="cpu")
            Req = torch_engine.Request
        rng = np.random.default_rng(0)
        for rid in range(N_REQ):
            prompt = rng.integers(0, jcfg.vocab, rng.integers(3, 9))
            eng.submit(Req(rid, prompt, max_new=MAX_NEW))
        done = eng.run()
        batches += [next(it) for _ in range(STEPS)]
        pipe.close()
        snap = client.snapshot()
        is_process = type(client.engine).__name__ == "ProcessShardedCache"
    finally:
        client.close()
    return {"batches": batches, "stats": asdict(pipe.stats), "reads": reads,
            "retrieved": [r.retrieved for r in done],
            "tiers": snap["store"]["tiers"], "hit_ratio": snap["hit_ratio"],
            "tiered": type(store).__name__ == "TieredStore",
            "process": is_process}


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    jcfg = jax_reduced_config(ARCH)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for side in ("jax", "torch"):
            clock = _fake_time()
            mp.setattr(SIDES[side].pipeline, "time", clock)
            mp.setattr(SIDES[side].engine, "time", clock)
            out[side] = _compose(side, tmp_path_factory.mktemp(side), jcfg,
                                 jparams, tparams)
    return out


def test_composition_runs_on_tiers_and_two_workers(composed):
    t = composed["torch"]
    assert t["tiered"] and t["process"]
    assert composed["jax"]["tiered"] and composed["jax"]["process"]
    assert ProcessShardedCache.__module__ == "repro_torch.core.procdriver"
    assert TieredStore.__module__ == "repro_torch.storage.tiers"
    assert t["tiers"]["remote_bytes"] > 0


def test_pipeline_batches_and_stats_match_reference(composed):
    t, j = composed["torch"], composed["jax"]
    assert len(t["batches"]) == len(j["batches"]) == 2 * STEPS
    for bt, bj in zip(t["batches"], j["batches"]):
        assert sorted(bt) == sorted(bj) == ["labels", "tokens"]
        for k in bj:
            assert bt[k].dtype == bj[k].dtype
            assert bt[k].shape == (BATCH, SEQ)
            np.testing.assert_array_equal(bt[k], bj[k])
    assert t["stats"] == j["stats"]
    assert t["stats"]["batches"] == 2 * STEPS


def test_retrieval_reads_match_reference(composed):
    t, j = composed["torch"], composed["jax"]
    assert t["retrieved"] == j["retrieved"] == [4] * N_REQ
    assert len(t["reads"]) == len(j["reads"]) == 4 * N_REQ
    for k, (g, w) in enumerate(zip(t["reads"], j["reads"])):
        assert g == w, f"divergence at retrieval read {k}"
    assert t["hit_ratio"] == j["hit_ratio"]
    # every tier counter equal; the spill directories differ by construction
    tt, jt = dict(t["tiers"]), dict(j["tiers"])
    tt.pop("spill_dir"), jt.pop("spill_dir")
    assert tt == jt
