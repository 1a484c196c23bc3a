"""Generate the §Dry-run / §Roofline tables from dryrun_results.json (no
retrace — analytic terms computed from configs); counterpart of
``repro.roofline.report``, over the H100's constants (``analysis``).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [results.json]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from ..configs import SHAPES, get_config
from .analysis import HBM_BW
from .analytic import analytic_hbm_bytes


def enrich(row: dict) -> dict:
    if row.get("status") != "ok":
        return row
    cfg = get_config(row["arch"])
    shape = SHAPES[row["shape"]]
    ana = analytic_hbm_bytes(cfg, shape, row["mesh"],
                             row.get("remat", "full"))
    row["analytic_gbytes"] = round(ana / 1e9, 2)
    row["memory_ms_analytic"] = round(ana / HBM_BW * 1e3, 3)
    terms = {"compute": row["compute_ms"],
             "memory": row["memory_ms_analytic"],
             "collective": row["collective_ms"]}
    row["dominant_adj"] = max(terms, key=terms.get)
    peak = max(terms.values())
    row["roofline_fraction_adj"] = (round(row["compute_ms"] / peak, 3)
                                    if peak > 0 else 0.0)
    # achieved fraction: the unavoidable bound (compute or HBM streaming,
    # whichever is larger — the hardware roofline for this cell) over the
    # achieved step bound.  1.0 = the sharding adds no collective overhead
    # beyond the roofline; this is the §Perf score.
    bound = max(row["compute_ms"], row["memory_ms_analytic"])
    row["achieved_fraction"] = round(bound / peak, 3) if peak > 0 else 0.0
    row["step_ms_adj"] = round(peak, 3)
    return row


def table(rows, mesh: str) -> str:
    hdr = ("| arch | shape | chips | compute ms | memory ms (HLO / analytic) "
           "| collective ms | dominant | useful | roofline-frac | achieved | "
           "bytes/dev GB | fits 80G |")
    sep = "|" + "---|" * 12
    out = [hdr, sep]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(rows, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        if r.get("mesh", mesh) != mesh and r.get("status") == "ok":
            continue
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"skipped (full attention, DESIGN.md) | — | — | — | — "
                       f"| — |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | ERROR: "
                       f"{r.get('error','')[:60]} | | | | | | | | |")
            continue
        name = r["arch"]
        if r.get("variant", "baseline") != "baseline":
            name += f" **[{r['variant']}]**"
        out.append(
            f"| {name} | {r['shape']} | {r['chips']} "
            f"| {r['compute_ms']} "
            f"| {r['memory_ms']} / {r.get('memory_ms_analytic','-')} "
            f"| {r['collective_ms']} "
            f"| {r.get('dominant_adj', r['dominant'])} "
            f"| {r['useful_ratio']} "
            f"| {r.get('roofline_fraction_adj', r['roofline_fraction'])} "
            f"| {r.get('achieved_fraction','-')} "
            f"| {r.get('bytes_per_device_gb','-')} "
            f"| {r.get('fits_hbm_80g','-')} |")
    return "\n".join(out)


def main() -> None:
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json")
    rows = [enrich(dict(r)) for r in json.loads(path.read_text())]
    for mesh in ("single", "multi"):
        sub = [r for r in rows if r.get("mesh", "single") == mesh]
        if not sub:
            continue
        print(f"\n### Roofline — {mesh} mesh "
              f"({'2×16×16' if mesh == 'multi' else '16×16'})\n")
        print(table(sub, mesh))
    path.with_suffix(".enriched.json").write_text(
        json.dumps(rows, indent=1, default=str))


if __name__ == "__main__":
    main()
