"""The port's ``ServingEngine`` against the JAX package's, on the CPU: the
same weights (reduced qwen3-1.7b, f32), seed and requests, each engine with
its own identically built retrieval cache (the JAX package's ``open_cache``
over a ``knowledge`` flat-files store, as in examples/serve_llm.py).

Greedy tokens must be equal.  So that an inequality means a real divergence
and not a near-tie, every step asserts that each row's top-1 / top-2 logit
margin exceeds the logits tolerance and that the two engines' logits agree
within it.  The tolerance, 1e-3, is the f32 weights' 1e-4 plus what a bf16
KV cache adds: a k/v value next to a bf16 rounding tie may be cached one ulp
(2^-8 relative) apart in the two frameworks, which moves later logits by up
to ~1e-3 at these widths.  ``max_seq`` is smaller than the number of steps, so
the shared scalar ``pos`` runs past it (clamped cache writes) while refilled
slots decode over the previous request's entries, as in the reference.
"""
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced_config
from repro.core import CacheConfig, open_cache
from repro.core.types import MB
from repro.models.transformer import init_params as jax_init_params
from repro.serve import engine as jax_engine_module
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.storage import RemoteStore, make_dataset
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.serve import engine as torch_engine_module
from repro_torch.serve.engine import Request, ServingEngine

ARCH = "qwen3-1.7b"
LOGITS_TOL = 1e-3          # f32 weights over a bf16 KV cache (see above)
N_REQ, BATCH, MAX_SEQ, MAX_NEW = 10, 4, 24, 6


def _cache():
    store = RemoteStore()
    store.add(make_dataset("knowledge", "flat_files", n_files=200,
                           small_file_size=64 * 1024))
    return open_cache(store, 16 * MB,
                      cfg=CacheConfig(min_share=2 * MB,
                                      rebalance_quantum=2 * MB))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, rng.integers(3, 9), dtype=np.int32)
            for _ in range(N_REQ)]


def _record(engine, to_np):
    """Wrap the engine's decode step to keep every step's logits."""
    seen, inner = [], engine._decode

    def step(params, state, toks):
        logits, state = inner(params, state, toks)
        seen.append(to_np(logits[:, -1]))
        return logits, state
    engine._decode = step
    return seen


def _fake_time():
    """A clock that advances 1 ms per reading: both engines' cache reads see
    the same times, far from the cache's 60 s TTL / rebalance periods,
    however slow the machine."""
    ticks = itertools.count()
    return SimpleNamespace(monotonic=lambda: 1000.0 + 1e-3 * next(ticks))


def serve_both():
    jcfg = jax_reduced_config(ARCH)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = _prompts(jcfg.vocab)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_module, "time", _fake_time())
        mp.setattr(torch_engine_module, "time", _fake_time())
        for name in ("jax", "torch"):
            out[name] = _serve(name, jcfg, jparams, tparams, prompts)
    return out


def _serve(name, jcfg, jparams, tparams, prompts):
    """One engine over its own cache; returns what the tests compare."""
    cache = _cache()
    if name == "jax":
        eng = JaxServingEngine(jparams, jcfg, batch=BATCH, max_seq=MAX_SEQ,
                               cache_engine=cache,
                               knowledge_dataset="knowledge", seed=5)
        logits = _record(eng, lambda x: np.asarray(x, np.float32))
        reqs = [JaxRequest(i, p, max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
    else:
        eng = ServingEngine(tparams, reduced_config(ARCH), batch=BATCH,
                            max_seq=MAX_SEQ, cache_engine=cache,
                            knowledge_dataset="knowledge", seed=5,
                            device="cpu")
        logits = _record(eng, lambda x: x.float().numpy())
        reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    snap = cache.snapshot()
    cache.close()
    return {"engine": eng, "done": done, "logits": logits,
            "hit_ratio": snap["hit_ratio"],
            "reads": snap["hits"] + snap["misses"]}


@pytest.fixture(scope="module")
def served():
    return serve_both()


def test_greedy_tokens_equal(served):
    j, t = served["jax"], served["torch"]
    assert [r.rid for r in t["done"]] == [r.rid for r in j["done"]]
    assert [r.output for r in t["done"]] == [r.output for r in j["done"]]
    assert len(t["done"]) == N_REQ
    assert all(len(r.output) == MAX_NEW for r in t["done"])


def test_every_step_is_decisive_and_within_tolerance(served):
    j, t = served["jax"]["logits"], served["torch"]["logits"]
    assert len(t) == len(j) > MAX_SEQ        # pos ran past max_seq
    for step, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a, b, atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(b, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert (margin > LOGITS_TOL).all(), (step, margin)


def test_retrieval_counts_and_hit_ratio_equal(served):
    j, t = served["jax"], served["torch"]
    assert ([r.retrieved for r in t["done"]]
            == [r.retrieved for r in j["done"]])
    assert sum(r.retrieved for r in t["done"]) == 4 * N_REQ
    assert t["reads"] == j["reads"] > 0
    assert t["hit_ratio"] == j["hit_ratio"]


def test_shared_pos_runs_like_the_reference(served):
    j, t = served["jax"]["engine"], served["torch"]["engine"]
    assert t.state["pos"] == int(j.state["pos"]) == t.steps > MAX_SEQ
    np.testing.assert_allclose(t.state["k"].float().numpy(),
                               np.asarray(j.state["k"], np.float32),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)

