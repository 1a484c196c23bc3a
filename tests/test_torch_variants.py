"""The JAX package's sharding-variant and chunked-CE tests
(tests/test_variants.py) on the port, bounds unchanged: every variant gives
a valid rules table, an unknown one raises, the chunked loss and its
gradient match the dense ones, and a chunked-loss train step runs through
the 1x1 CPU mesh.  (The variants' tables against the reference's, and the
specs they give: tests/test_torch_sharding.py.)
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_local_mesh, release_local_mesh
from repro_torch.launch.variants import apply_variant
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.models.transformer import (forward, init_params, lm_loss,
                                            lm_loss_chunked)
from repro_torch.sharding import DEFAULT_RULES
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

ALL_VARIANTS = ["fsdp_pod", "no_fsdp", "seq_shard", "expert_data",
                "vocab_data", "cache_seq_model", "pure_fsdp",
                "embed_replicated", "decode_weights_stationary",
                "ep_capacity", "ep_only"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _tokens(cfg, shape, seed=1):
    return torch.randint(0, cfg.vocab, shape,
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("v", ALL_VARIANTS)
def test_variants_produce_valid_rules(v):
    rules = apply_variant(dict(DEFAULT_RULES), "qwen3-1.7b", "train_4k", v)
    assert isinstance(rules, dict)
    assert set(DEFAULT_RULES) <= set(rules)


def test_unknown_variant_raises():
    with pytest.raises(KeyError):
        apply_variant(dict(DEFAULT_RULES), "x", "train_4k", "nope")


def test_chunked_ce_matches_dense():
    cfg = reduced_config("qwen3-1.7b")
    params = _params(cfg)
    tokens = _tokens(cfg, (2, 16))
    with torch.no_grad():
        logits, _ = forward(params, cfg, tokens, remat="none")
        dense = lm_loss(logits, tokens)
        x, _ = forward(params, cfg, tokens, remat="none", return_hidden=True)
        for chunk in (64, 100, 256):
            ck = lm_loss_chunked(x, params, cfg, tokens, vocab_chunk=chunk)
            assert float(torch.abs(dense - ck)) < 1e-3


def test_chunked_ce_grad_matches_dense():
    cfg = reduced_config("qwen3-1.7b")
    params = _params(cfg)
    tokens = _tokens(cfg, (2, 8))

    def dense_loss(p):
        lg, _ = forward(p, cfg, tokens, remat="none")
        return lm_loss(lg, tokens)

    def chunked(p):
        x, _ = forward(p, cfg, tokens, remat="none", return_hidden=True)
        return lm_loss_chunked(x, p, cfg, tokens, vocab_chunk=64)

    def grad(loss_fn):
        paths, leaves = zip(*tree_leaves(params))
        req = [t.detach().clone().requires_grad_(True) for t in leaves]
        loss = loss_fn(tree_unflatten(zip(paths, req)))
        return torch.autograd.grad(loss, req, allow_unused=True)

    g1, g2 = grad(dense_loss), grad(chunked)
    for a, b in zip(g1, g2):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=2e-2, rtol=2e-2)


def test_train_step_chunked_loss_runs():
    cfg = reduced_config("qwen3-1.7b")
    mesh = make_local_mesh("cpu")
    try:
        step = make_train_step(cfg, AdamWConfig(), mesh, None,
                               remat="none", loss_impl="chunked")
        params = _params(cfg)
        opt = init_state(params)
        tokens = _tokens(cfg, (2, 16))
        params, opt, m = step(params, opt, {"tokens": tokens,
                                            "labels": tokens})
        assert bool(torch.isfinite(m["loss"]))
    finally:
        release_local_mesh(mesh)
