"""The port's roofline modules (``repro_torch.roofline``) against the JAX
package's, on the CPU.

* ``model_flops`` and ``analytic_hbm_bytes`` equal the reference's exactly
  for every config × shape × mesh × remat.
* ``analyze`` / ``Roofline.row()``, ``report.enrich`` and ``report.table``
  equal the reference's on the same cost inputs, with both modules'
  constants patched to the same values; the port's fit test is at 80 GB
  (``fits_hbm_80g``), the reference's at 16 GiB (``fits_hbm_16g``).
* ``fill_repro.main`` writes the reference's ``EXPERIMENTS.md``.
* The traced FLOP count's grouped ``convolution_backward`` formula counts a
  depthwise conv's backward at twice its forward, where torch's counts it
  ``groups`` times too much.
* A step's collectives (``Compiled.collectives()``, one rank's step
  counted on ``meta`` DTensors) are none on one device, and on the
  production mesh do not depend on the global trace reused; the modules
  hold the H100's constants and no TPU one.
"""
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import repro.roofline.analysis as ref_analysis
import repro.roofline.report as ref_report
from repro.configs import CONFIGS as REF_CONFIGS, SHAPES as REF_SHAPES
from repro.roofline import fill_repro as ref_fill
from repro.roofline.analytic import analytic_hbm_bytes as ref_analytic

import repro_torch.roofline.analysis as analysis
import repro_torch.roofline.report as report
from repro_torch.configs import CONFIGS, SHAPES, reduced_config
from repro_torch.roofline import fill_repro
from repro_torch.roofline.analytic import analytic_hbm_bytes
from repro_torch.roofline.trace import conv_backward_flop
from repro_torch.sharding import DEFAULT_RULES

ROOT = Path(__file__).resolve().parent.parent
ROOFLINE = ROOT / "src" / "repro_torch" / "roofline"
# the reference's constants, set in both modules for the parity cases
REF_CONSTANTS = {"PEAK_FLOPS": ref_analysis.PEAK_FLOPS,
                 "HBM_BW": ref_analysis.HBM_BW,
                 "LINK_BW": ref_analysis.ICI_BW}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def same_constants(monkeypatch):
    for name, value in REF_CONSTANTS.items():
        monkeypatch.setattr(analysis, name, value)
    monkeypatch.setattr(report, "HBM_BW", ref_analysis.HBM_BW)


def test_constants_are_the_h100s_and_no_tpu_number_remains():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.HBM_BYTES,
            analysis.LINK_BW) == (989e12, 3.35e12, 80e9, 50e9)
    for f in sorted(ROOFLINE.glob("*.py")):
        text = f.read_text()
        for bad in ("v5e", "TPU", "197e12", "819e9", "ICI", "16 * 2**30"):
            assert bad not in text, (f.name, bad)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_model_flops_and_analytic_bytes_equal_the_reference(arch):
    cfg, ref_cfg = CONFIGS[arch], REF_CONFIGS[arch]
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        assert analysis.model_flops(cfg, shape) == \
            ref_analysis.model_flops(ref_cfg, ref_shape)
        for mesh in ("single", "multi"):
            for remat in ("full", "dots", "none"):
                assert analytic_hbm_bytes(cfg, shape, mesh, remat) == \
                    ref_analytic(ref_cfg, ref_shape, mesh, remat)


# (arch, shape, mesh, chips, flops, bytes, bytes per device, all-reduce
# result shape); 20e9 bytes a device lies between the two fit tests
CASES = [
    ("qwen3-1.7b", "train_4k", "single", 256, 6.8e13, 1.7e12, 13.0e9,
     (16, 4096, 2048)),
    ("qwen3-moe-30b-a3b", "prefill_32k", "multi", 512, 2.1e12, 9.1e11,
     1.0e9, None),
    ("llama3-405b", "decode_32k", "single", 256, 7.7e9, 5.3e10, 1.2e11,
     (8, 1, 16384)),
    ("zamba2-1.2b", "long_500k", "multi", 512, 3.3e8, 4.2e9, 0.0, None),
]


def _inputs(case):
    arch, shape, mesh, chips, flops, nbytes, per_dev, ar = case
    cost = {"flops": flops, "bytes accessed": nbytes}
    mem = {"bytes_per_device": per_dev}
    hlo, coll = "", None
    if ar is not None:
        hlo = (f"  %ar.1 = bf16[{','.join(map(str, ar))}]{{2,1,0}} "
               "all-reduce(bf16[16,4096,2048]{2,1,0} %x), replica_groups={}")
        coll = analysis.CollectiveStats()
        coll.add("all-reduce", 2 * 2 * torch.Size(ar).numel())
    return (arch, shape, mesh, chips, cost, mem, hlo, coll)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_analyze_row_equals_the_reference(case, same_constants):
    arch, shape, mesh, chips, cost, mem, hlo, coll = _inputs(case)
    got = analysis.analyze(arch, SHAPES[shape], mesh, chips, cost, coll,
                           CONFIGS[arch], mem).row()
    want = ref_analysis.analyze(arch, REF_SHAPES[shape], mesh, chips, cost,
                                hlo, REF_CONFIGS[arch], mem).row()
    fits = got.pop("fits_hbm_80g")
    ref_fits = want.pop("fits_hbm_16g")
    assert got == want
    per_dev = mem["bytes_per_device"]
    assert fits == (per_dev <= 80e9 if per_dev else None)
    if per_dev and not 16 * 2**30 < per_dev <= 80e9:
        assert fits == ref_fits


def test_report_enrich_and_table_equal_the_reference(same_constants):
    rows, ref_rows = [], []
    for case in CASES:
        arch, shape, mesh, chips, cost, mem, hlo, coll = _inputs(case)
        extra = {"status": "ok", "variant": "baseline", "remat": "full"}
        rows.append({**analysis.analyze(
            arch, SHAPES[shape], mesh, chips, cost, coll, CONFIGS[arch],
            mem).row(), **extra})
        ref_rows.append({**ref_analysis.analyze(
            arch, REF_SHAPES[shape], mesh, chips, cost, hlo,
            REF_CONFIGS[arch], mem).row(), **extra})
    skipped = {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "single",
               "status": "skipped"}
    failed = {"arch": "mamba2-370m", "shape": "train_4k", "mesh": "single",
              "status": "error", "error": "RuntimeError: x" * 20}
    rows[0]["variant"] = ref_rows[0]["variant"] = "pure_fsdp"
    rows += [dict(skipped), dict(failed)]
    ref_rows += [dict(skipped), dict(failed)]
    got = [report.enrich(dict(r)) for r in rows]
    want = [ref_report.enrich(dict(r)) for r in ref_rows]
    for g, w in zip(got, want):
        if "fits_hbm_80g" in g:
            g = dict(g)
            w = dict(w)
            g.pop("fits_hbm_80g")
            w.pop("fits_hbm_16g")
        assert g == w
    for mesh in ("single", "multi"):
        table = report.table([r for r in got if r.get("mesh") == mesh], mesh)
        ref_table = ref_report.table(
            [r for r in want if r.get("mesh") == mesh], mesh)
        assert "fits 80G" in table.splitlines()[0]
        lines = table.splitlines()
        ref_lines = ref_table.replace("fits 16G", "fits 80G").splitlines()
        assert len(lines) == len(ref_lines) > 2
        for line, ref_line in zip(lines, ref_lines):
            # the last cell is each package's fit test
            if line.count("|") > 2 and not line.startswith("|---"):
                line, ref_line = line.rsplit("|", 2)[0], \
                    ref_line.rsplit("|", 2)[0]
            assert line == ref_line


def test_fill_repro_writes_the_reference_experiments_md(tmp_path,
                                                        monkeypatch):
    src = Path(ref_fill.__file__).read_text()
    fills = sorted(set(re.findall(r"FILL_[A-Z0-9_]+", src)))
    keys = sorted(set(re.findall(r"[vd]\('([^']+)'\)", src)))
    assert len(fills) == 12 and keys
    bench = ["# a comment line", "no comma here"] + [
        f"{k},{i + 0.5},note={i}x {i}" for i, k in enumerate(keys)]
    text = "# EXPERIMENTS\n" + "\n".join(f"- {f}: here" for f in fills)
    out = {}
    for name, mod in (("ref", ref_fill), ("port", fill_repro)):
        d = tmp_path / name
        d.mkdir()
        (d / "bench_output.txt").write_text("\n".join(bench) + "\n")
        (d / "EXPERIMENTS.md").write_text(text)
        monkeypatch.chdir(d)
        mod.main()
        out[name] = (d / "EXPERIMENTS.md").read_text()
    assert out["port"] == out["ref"]
    assert "FILL_" not in out["port"]


@pytest.mark.parametrize("groups", [1, 640])
def test_grouped_conv_backward_is_counted_at_twice_its_forward(groups):
    """A depthwise causal conv's shape (Mamba2's, C = 640): the corrected
    formula counts the backward at twice the forward; torch's own formula
    ignores ``groups`` and counts ``groups`` times the forward."""
    C, K = 640, 4
    x = torch.randn(2, C, 259, requires_grad=True)
    w = torch.randn(C, C // groups, K, requires_grad=True)
    counts = {}
    for name, mapping in (("torch", {}), ("corrected", {
            torch.ops.aten.convolution_backward: conv_backward_flop})):
        fc = FlopCounterMode(display=False, custom_mapping=mapping)
        with fc:
            y = F.conv1d(x, w, groups=groups)
            y.sum().backward()
        by_op = fc.get_flop_counts()["Global"]
        counts[name] = (by_op[torch.ops.aten.convolution],
                        by_op[torch.ops.aten.convolution_backward])
    fwd = 2 * 2 * C * 256 * (C // groups) * K
    assert counts["corrected"] == (fwd, 2 * fwd)
    if groups == 1:
        assert counts["torch"] == counts["corrected"]
    else:
        # its grad_input term runs over the 259 input steps, not 256
        assert counts["torch"][0] == fwd
        assert counts["torch"][1] == pytest.approx(groups * fwd, rel=0.02)


def test_reduced_config_traces_without_collectives_on_one_device():
    """A 1 x 1 mesh moves nothing; on the production mesh one rank's train
    step all-gathers its FSDP params, reduce-scatters their gradients and
    all-reduces partial products: ``compile()`` there runs the step as a
    rank, and a second count of it (``Lowered.count``) agrees."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.train_step import lower_train_step
    cfg = reduced_config("qwen3-1.7b")
    shape = ShapeSpec("t", 64, 32, "train")
    one = lower_train_step(cfg, shape, abstract_mesh(local=True),
                           DEFAULT_RULES).compile()
    assert one.collectives().counts == {}
    low = lower_train_step(cfg, shape, abstract_mesh(), DEFAULT_RULES)
    pod = low.compile()
    counts = pod.collectives().counts
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(counts)
    assert all(n > 0 for n in counts.values())
    assert pod.collectives() == low.count().collectives
    assert "all-reduce" in pod.as_text()
