"""The paper's headline scenario on the PyTorch port: 18 heterogeneous AI
jobs, one unified cache, discrete-event cluster simulation — IGTCache vs
vanilla JuiceFS vs no cache.  The counterpart of ``examples/mixed_cluster.py``
on the port's own simulator and cache kernel (``repro_torch.sim``,
``repro_torch.core``), printing the same lines; the simulator runs on the
host and, seeded alike, gives the reference's numbers.

    PYTHONPATH=src python examples/mixed_cluster_torch.py [--scale 0.5]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import CacheConfig, bundle_client  # noqa: E402
from repro_torch.core.types import MB  # noqa: E402
from repro_torch.sim import ClusterSim, make_paper_suite  # noqa: E402
from repro_torch.storage import RemoteStore  # noqa: E402

BUNDLES = ("igtcache", "juicefs", "nocache")


def build(scale: float, seed: int):
    """The paper suite at ``scale`` in a ``RemoteStore``, the cache's bytes
    (35 % of the data) and its config (shares proportional to it)."""
    suite = make_paper_suite(scale=scale, seed=seed)
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    share = max(16 * MB, cap // 128)
    cfg = CacheConfig(min_share=share, rebalance_quantum=share,
                      rebalance_period=10.0,
                      prefetch_budget_bytes=max(64 * MB, cap // 8))
    return suite, store, cap, cfg


def simulate(suite, store, cap, cfg, name: str):
    """One bundle through ``ClusterSim``: (SimResult, wall seconds)."""
    t0 = time.perf_counter()
    # one constructor path for every consumer: the sim swaps the
    # client's prefetch transport onto its simulated link internally
    client = bundle_client("prefetch_none" if name == "nocache" else name,
                           store, 0 if name == "nocache" else cap, cfg=cfg)
    res = ClusterSim(suite, client).run()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    suite, store, cap, cfg = build(args.scale, args.seed)
    print(f"{len(suite.jobs)} jobs, data {suite.total_bytes() >> 20} MB, "
          f"cache {cap >> 20} MB (35%)\n")
    results = {}
    for name in BUNDLES:
        res, _ = simulate(suite, store, cap, cfg, name)
        results[name] = res
        print(f"{name:10s} avg JCT {res.avg_jct:8.1f}s   "
              f"CHR {res.hit_ratio:.3f}   makespan {res.makespan:7.0f}s")
    ig, ju, nc = (results[k] for k in BUNDLES)
    print(f"\nIGTCache vs JuiceFS : JCT −{(1-ig.avg_jct/ju.avg_jct)*100:.1f}%  "
          f"CHR +{(ig.hit_ratio/ju.hit_ratio-1)*100:.1f}%")
    print(f"JuiceFS  vs no-cache: JCT −{(1-ju.avg_jct/nc.avg_jct)*100:.1f}%  "
          f"(paper: 55.0%)")


if __name__ == "__main__":
    main()
