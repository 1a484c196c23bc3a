"""The output head's product on a mesh with a "data" dimension
(``kernels._local.head_on_shards``): one rank's full-width train step
forms the head's weight gradient from its own batch rows, as the
reference's sharded step does, and never holds the logits or their
gradient at the global batch's rows.

One rank's step of qwen3-1.7b, mamba2-370m and granite-moe-3b-a800m at
depth 2, B 4 x S 1024, ``DEFAULT_RULES``, the 2 x 2 abstract mesh, with
the dense loss and with ``loss_impl="chunked"``, counted on ``meta``
DTensors as the dry-run counts a cell (``lower_step(...).compile()`` as
rank 0 of torch's fake process group), in a subprocess (a default
process group is process-wide), once for the module:

* no allocation has the global batch's rows at the rank's vocab width:
  (B, S, V / model) or (B·S, V / model), nor at the whole vocab (granite's
  49155 columns split over no mesh dimension), nor, under the chunked
  loss, at a chunk's width or a rank's block of it;
* the head's boundary (``"lm_head"``, each chunk's ``"lm_head_chunk"``)
  took the rank's (B / data, S, d) rows, the dense head its (d, V /
  model) columns, and each chunk's loss the rank's rows;
* the rank's all-gather bytes of the dense step are at most the
  unrepaired step's (torch 2.13, the same count) less the gathered
  logits' gradient (B, S, V / model) plus the head weight's own gather
  over "data" (d, V / model), which the reference's step makes in its
  place.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-1.7b", "mamba2-370m", "granite-moe-3b-a800m")
LOSSES = ("dense", "chunked")
B, S, DEPTH, DATA, MODEL = 4, 1024, 2, 2, 2
# the dense step's all-gather bytes a rank before the repair, counted the
# same way (torch 2.13): the logits' gradient gathered over "data"
UNREPAIRED_ALL_GATHER = {"qwen3-1.7b": 1_084_489_728,
                         "mamba2-370m": 628_416_768,
                         "granite-moe-3b-a800m": 1_044_907_008}

_COUNT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.kernels._local import shard_calls
from repro_torch.launch.dryrun import lower_step
from repro_torch.launch.mesh import AbstractMesh, fake_ranks
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
torch.set_num_threads(2)
spec = json.loads(sys.argv[1])
mesh = AbstractMesh((("data", spec["data"]), ("model", spec["model"])))
shape = ShapeSpec("head_train", spec["s"], spec["b"], "train")
out = {}
with fake_ranks():
    for arch in spec["archs"]:
        cfg = dataclasses.replace(get_config(arch), n_layers=spec["depth"])
        for loss in spec["losses"]:
            with shard_calls() as calls:
                t = lower_step(cfg, shape, mesh, DEFAULT_RULES,
                               loss_impl=loss).compile().trace
            out[f"{arch}/{loss}"] = {
                "d": cfg.d_model, "V": cfg.vocab,
                "shapes": sorted(t.shapes),
                "calls": sorted({(n, s) for n, s in calls
                                 if n.startswith("lm_")}),
                "all_gather": t.collectives.bytes_by_kind.get(
                    "all-gather", 0)}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    spec = {"archs": ARCHS, "losses": LOSSES, "b": B, "s": S,
            "depth": DEPTH, "data": DATA, "model": MODEL}
    proc = subprocess.run([sys.executable, "-c", _COUNT, json.dumps(spec)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _vocab_block(V: int) -> int:
    """A rank's columns of the head: the vocab splits over "model" where
    it divides."""
    return V // MODEL if V % MODEL == 0 else V


def _got(counts, arch, loss):
    got = counts[f"{arch}/{loss}"]
    shapes = {tuple(s) for s in got["shapes"]}
    calls = [(name, tuple(tuple(s) for s in shapes_))
             for name, shapes_ in got["calls"]]
    return got, shapes, calls


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_allocation_has_the_global_batchs_rows_at_vocab_width(
        counts, arch, loss):
    got, shapes, calls = _got(counts, arch, loss)
    widths = {got["V"], _vocab_block(got["V"])}
    widths |= {s[0][-1] for name, s in calls if name == "lm_loss_chunk"}
    blocks = {s[1][-1] for name, s in calls if name == "lm_head_chunk"}
    widths |= blocks
    global_rows = {(B, S, w) for w in widths} | {(B * S, w) for w in widths}
    # a chunk's weight gradient (d, w) gathered along its columns over
    # "model" comes out of the collective as (model d, w): qwen3's 2 d is
    # B S here
    gathered_grads = {(MODEL * got["d"], w) for w in blocks}
    held = (global_rows - gathered_grads) & shapes
    assert not held, sorted(held)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_head_takes_each_ranks_own_rows(counts, arch, loss):
    got, _, calls = _got(counts, arch, loss)
    d, Vl, rows = got["d"], _vocab_block(got["V"]), (B // DATA, S)
    names = {name for name, _ in calls}
    if loss == "dense":
        assert ("lm_head", ((*rows, d), (d, Vl))) in calls, calls
        assert ("lm_loss", ((*rows, Vl), rows)) in calls, calls
        assert "lm_head_chunk" not in names
    else:
        heads = [s for name, s in calls if name == "lm_head_chunk"]
        losses = [s for name, s in calls if name == "lm_loss_chunk"]
        assert heads and losses and "lm_head" not in names
        assert all(x == (*rows, d) and w[0] == d for x, w in heads), heads
        assert all(lg[:2] == rows and y == rows for lg, y in losses), losses


@pytest.mark.parametrize("arch", ARCHS)
def test_all_gather_falls_by_the_gathered_logits_gradient(counts, arch):
    got, _, _ = _got(counts, arch, "dense")
    Vl = _vocab_block(got["V"])
    dy_block, w_block = 2 * B * S * Vl, 2 * got["d"] * Vl      # bf16
    before = UNREPAIRED_ALL_GATHER[arch]
    assert got["all_gather"] <= before - dy_block + w_block
    assert got["all_gather"] < before
