"""Patch EXPERIMENTS.md §Repro FILL_ placeholders from bench_output.txt
(counterpart of ``repro.roofline.fill_repro``)."""
from __future__ import annotations

import re
import sys
from pathlib import Path


def parse(path: Path) -> dict:
    vals = {}
    for line in path.read_text().splitlines():
        if line.startswith("#") or "," not in line:
            continue
        parts = line.split(",", 2)
        if len(parts) >= 2:
            vals[parts[0]] = (parts[1], parts[2] if len(parts) > 2 else "")
    return vals


def main() -> None:
    bench = parse(Path("bench_output.txt"))
    exp_path = Path("EXPERIMENTS.md")
    exp = exp_path.read_text()

    def v(key, default="n/a"):
        return bench.get(key, (default, ""))[0]

    def d(key):
        return bench.get(key, ("", ""))[1]

    fills = {
        "FILL_FIG8_JFS_NC": f"{v('fig8.juicefs_vs_nocache_jct_reduction_pct')} %",
        "FILL_FIG8_JCT": f"{v('fig8.jct_reduction_vs_juicefs_pct')} %",
        "FILL_FIG8_CHR": f"{v('fig8.chr_gain_vs_juicefs_pct')} %",
        "FILL_FIG9_JCT": f"−{v('fig9.jct_reduction_vs_second_best_pct')} % "
                         f"(CHR +{v('fig9.chr_gain_vs_second_best_pct')} %)",
        "FILL_FIG9_HIER": f"−{v('fig9.hierarchical.jct_reduction_pct')} %",
        "FILL_FIG10": f"−{v('fig10.jct_reduction_vs_second_best_pct')} % "
                      f"(CHR +{v('fig10.chr_gain_vs_second_best_pct')} %)",
        "FILL_FIG11": f"{v('fig11.adaptive.evict_start_s')} s "
                      f"(vs {v('fig11.fixed600.evict_start_s')} s fixed)",
        "FILL_FIG12": f"−{v('fig12.jct_reduction_vs_second_best_pct')} % "
                      f"(CHR +{v('fig12.chr_gain_vs_second_best_pct')} %)",
        "FILL_FIG14": f"α=0.01: {v('fig14.alpha_0.01.random_acc')} rand / "
                      f"{d('fig14.alpha_0.01.random_acc').split('=')[-1]} skew",
        "FILL_FIG15": f"w=10: skew {d('fig15.window_10.random_acc').split('=')[-1]}; "
                      f"w=100: {d('fig15.window_100.random_acc').split('=')[-1]}",
        "FILL_FIG16": f"35 %: {v('fig16.cache_35pct.igtcache_chr')} vs "
                      f"{d('fig16.cache_35pct.igtcache_chr').split('=')[-1]}",
        "FILL_FIG17": f"{v('fig17.nodecap_10000.us_per_access')} µs @10k "
                      f"({d('fig17.nodecap_10000.us_per_access').split(' ')[0]})",
    }
    for k, val in fills.items():
        exp = exp.replace(k, val)
    exp_path.write_text(exp)
    print("patched", len(fills), "placeholders")


if __name__ == "__main__":
    main()
