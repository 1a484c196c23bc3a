"""Two dry-run sweeps side by side (``python -m repro_torch.launch.dryrun
--all --mesh both --out ...`` of two checkouts): for each cell ``ok`` in
both, the second's per-device FLOPs, bytes accessed, temp and bytes per
device over the first's, and its dominant roofline term beside the
first's; then each sweep's count of cells by dominant term, the cells
whose term changed, and the cells whose ``fits_hbm_80g`` changed (temp
before and after, and the second's temp at its two counted depths where
it has them).  Reads JSON only: no torch, no device.

    python examples/dryrun_diff_torch.py OLD.json NEW.json
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path


def _ok(path: Path) -> dict:
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in json.loads(path.read_text()) if r.get("status") == "ok"}


def _ratio(new: float, old: float) -> str:
    return f"{new / old:.3f}" if old else "-"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    args = ap.parse_args(argv)
    old, new = _ok(args.old), _ok(args.new)
    keys = [k for k in new if k in old]
    print("| Cell | FLOPs | bytes | temp | bytes / device | dominant |")
    print("|---|---|---|---|---|---|")
    for k in keys:
        o, n = old[k], new[k]
        temp = (n["memory"]["temp_size_in_bytes"],
                o["memory"]["temp_size_in_bytes"])
        print(f"| {' '.join(k)} | {_ratio(n['hlo_gflops'], o['hlo_gflops'])}"
              f" | {_ratio(n['hlo_gbytes'], o['hlo_gbytes'])}"
              f" | {_ratio(*temp)}"
              f" | {_ratio(n['memory']['bytes_per_device'], o['memory']['bytes_per_device'])}"
              f" | {o['dominant']} -> {n['dominant']} |")
    for name, rows in (("old", old), ("new", new)):
        print(f"{name}: {len(rows)} ok, dominant "
              f"{dict(Counter(r['dominant'] for r in rows.values()))}, "
              f"fits_hbm_80g {sum(bool(r['fits_hbm_80g']) for r in rows.values())}")
    moved = [k for k in keys if old[k]["dominant"] != new[k]["dominant"]]
    print(f"changed dominant term: {len(moved)}")
    for k in moved:
        print(f"  {' '.join(k)}: {old[k]['dominant']} -> {new[k]['dominant']}")
    flipped = [k for k in keys
               if old[k]["fits_hbm_80g"] != new[k]["fits_hbm_80g"]]
    print(f"changed fits_hbm_80g: {len(flipped)}")
    for k in flipped:
        o, n = old[k]["memory"], new[k]["memory"]
        print(f"  {' '.join(k)}: {old[k]['fits_hbm_80g']} -> "
              f"{new[k]['fits_hbm_80g']}, bytes / device "
              f"{o['bytes_per_device'] / 1e9:.2f} -> "
              f"{n['bytes_per_device'] / 1e9:.2f} GB, temp "
              f"{o['temp_size_in_bytes'] / 1e9:.3f} -> "
              f"{n['temp_size_in_bytes'] / 1e9:.3f} GB, by depth "
              f"{[round(t / 1e9, 3) for t in n.get('temp_by_depth', [])]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
