"""Quickstart for the PyTorch port's cache engine (``repro_torch``): the
counterpart of ``examples/quickstart.py``, on the port's own copies of the
engine, the stores, the process driver and the cache daemon.

Part 1: three workloads (a sequential scan, random training epochs, zipf-hot
RAG queries) hit one unified cache opened with ``open_cache``; the engine
classifies each stream from its access gaps and picks prefetch and eviction
per stream, with no hints.

The walkthroughs, each of which checks what it claims and returns its
numbers:

* ``file``: the same ``open_cache`` pointed at a real directory
  (``file:///dir`` resolves to a ``LocalFSStore``), bytes checked against
  the files on disk.
* ``daemon``: the directory served by a ``CacheDaemon`` whose engine runs in
  two shard worker processes (``driver="process"``), and two independent
  ``open_cache("cache://<sock>")`` sessions sharing it: the second session
  hits every block the first one read, with no demand fetch.
* ``tiered``: a ``tiered+mock-s3://`` stack, a RAM and disk hierarchy over
  an in-process HTTP server speaking ranged GETs: every payload equals
  ``mock_object_bytes``, and pass 2 is served from the tiers
  (``disk_hits`` > 0) with ``remote_bytes`` frozen at the pass-1 total.
* ``survivable``: the daemon journaled under a ``DaemonSupervisor``; killed
  mid-stream, reads keep flowing from the backing store, the supervisor
  respawns it on the same socket, the journal warm-restores it, and the
  client reconnects and hits again.

    PYTHONPATH=src python examples/quickstart_torch.py            # all
    PYTHONPATH=src python examples/quickstart_torch.py daemon tiered

Nothing here needs a GPU.  Temporary files go under ``TMPDIR``; a daemon's
unix socket gets a directory of its own there (socket paths are limited to
108 bytes).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import os
import random
import tempfile
import time

import numpy as np

from repro_torch.core import CacheConfig, open_cache
from repro_torch.core.types import MB
from repro_torch.storage import RemoteStore, make_dataset

UDS_MAX = 107                     # sun_path holds 108 bytes with its NUL


def socket_path(tag: str) -> str:
    """A unix socket path in a fresh temporary directory; raises if the
    temporary directory's path is too long for one."""
    sock = os.path.join(tempfile.mkdtemp(prefix="igt-"), f"{tag}.sock")
    if len(sock.encode()) > UDS_MAX:
        raise OSError(f"socket path {sock!r} is {len(sock.encode())} bytes, "
                      f"over the {UDS_MAX} a unix socket takes: set TMPDIR "
                      "to a shorter directory")
    return sock


def write_files(root: str, sub: str, n_dirs: int, n_files: int, size: int,
                seed: int) -> list:
    """Random files ``root/sub/<dd>/<iii>.bin``; returns their paths
    relative to ``root`` as tuples."""
    rng = np.random.default_rng(seed)
    files = []
    for d in range(n_dirs):
        os.makedirs(os.path.join(root, sub, f"{d:02d}"))
        for i in range(n_files):
            data = rng.integers(0, 256, size, dtype=np.uint8)
            with open(os.path.join(root, sub, f"{d:02d}", f"{i:03d}.bin"),
                      "wb") as f:
                f.write(data.tobytes())
            files.append((sub, f"{d:02d}", f"{i:03d}.bin"))
    return files


def main() -> dict:
    store = RemoteStore()
    store.add(make_dataset("scan_set", "flat_files", n_files=600,
                           small_file_size=256 * 1024))
    store.add(make_dataset("train_set", "dir_tree", n_dirs=30,
                           files_per_dir=20, small_file_size=256 * 1024))
    store.add(make_dataset("rag_set", "flat_files", n_files=400,
                           small_file_size=256 * 1024))
    cfg = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB,
                      rebalance_period=5.0)
    client = open_cache(store, 256 * MB, cfg=cfg, executor="sim")

    t = 0.0
    rng = random.Random(0)
    nrng = np.random.default_rng(0)
    scan = store.datasets["scan_set"].files
    train = store.datasets["train_set"].files
    rag = store.datasets["rag_set"].files
    rag_perm = nrng.permutation(len(rag))
    train_order = list(range(len(train)))
    si = 0
    first_bytes = None
    for epoch in range(3):
        rng.shuffle(train_order)
        for j in train_order:
            f = scan[si % len(scan)]
            si += 1
            client.read(f.path, 0, f.size, t)
            t += 0.01
            f = train[j]
            client.read(f.path, 0, f.size, t)
            t += 0.01
            f = rag[int(rag_perm[(nrng.zipf(1.3) - 1) % len(rag)])]
            res = client.read(f.path, 0, f.size, t, fetch=True)
            t += 0.01
            if first_bytes is None:
                first_bytes = len(res.data)

    print("\nDetected streams (pattern -> policy chosen by the cache):")
    patterns = {}
    for path, cmu in sorted(client.iter_workload_cmus()):
        tot = cmu.hits + cmu.misses
        pats = {s.pattern.value: type(s.policy).__name__
                for s in cmu.substreams.values()}
        patterns["/".join(path)] = cmu.effective_pattern().value
        print(f"  {'/'.join(path):22s} "
              f"pattern={cmu.effective_pattern().value:10s} "
              f"quota={cmu.quota >> 20:4d}MB "
              f"hit_ratio={cmu.hits / max(1, tot):.2f} policies={pats}")
    s = client.snapshot()
    client.close()
    print(f"\nOverall: CHR={s['hit_ratio']:.3f}  "
          f"prefetch_hits={s['prefetch_hits']}  tree_nodes={s['nodes']}")
    print(f"Executor: {s['executor']}  (first fetched passage: "
          f"{first_bytes} bytes)")
    return {"hit_ratio": s["hit_ratio"], "patterns": patterns}


def file_store_walkthrough() -> dict:
    """Cache a real directory tree through ``file://``."""
    print("\n--- file:// walkthrough ------------------------------------")
    root = tempfile.mkdtemp(prefix="igt-quickstart-")
    files = write_files(root, "corpus", 3, 4, 192 * 1024, seed=0)
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=64 * 1024)
    client = open_cache(f"file://{root}", 16 * MB, cfg=cfg,
                        executor="threaded", fetch_bytes=True)
    caps = client.store_capabilities()
    print(f"store: LocalFSStore over {root}; capabilities: "
          f"ranges={caps.ranges} batching={caps.batching} "
          f"concurrency={caps.concurrency}")
    for rel in files:                       # pass 1: demand misses
        res = client.read(rel, 0, client.meta.file_size(rel))
        with open(os.path.join(root, *rel), "rb") as f:
            assert bytes(res.data) == f.read(), "client bytes != disk bytes"
    hits = total = 0
    for rel in files:                       # pass 2: served from cache
        res = client.read(rel, 0, client.meta.file_size(rel))
        total += len(res.blocks)
        hits += sum(1 for b in res.blocks if b.hit)
    res = client.read(files[0], 100_000, 5_000)     # a partial extent
    assert len(res.data) == 5_000
    client.flush(timeout=10.0)
    snap = client.snapshot()
    client.close()
    assert hits == total, (hits, total)
    print(f"pass 1 verified against the files; pass 2 hit {hits}/{total} "
          f"blocks; executor: {snap['executor']}")
    return {"hits": hits, "blocks": total}


def daemon_walkthrough() -> dict:
    """One daemon over two shard worker processes, two sessions."""
    print("\n--- cache:// daemon walkthrough (process driver) -----------")
    from repro_torch.daemon import CacheDaemon

    root = tempfile.mkdtemp(prefix="igt-daemon-")
    files = write_files(root, "shared", 2, 4, 128 * 1024, seed=1)
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=64 * 1024)
    sock = socket_path("daemon")
    with CacheDaemon(f"file://{root}", 16 * MB, cfg=cfg, uds=sock,
                     driver="process", n_procs=2) as d:
        engine = d.client.engine
        print(f"daemon up at {d.uri}: workers "
              f"{[w['pid'] for w in engine.worker_info]}")
        with open_cache(d.uri, fetch_bytes=True) as a:   # a cold session
            for rel in files:
                res = a.read(rel, 0, a.meta.file_size(rel))
                with open(os.path.join(root, *rel), "rb") as f:
                    assert bytes(res.data) == f.read(), "daemon bytes != disk"
        demand = d.client.executor.stats.demand_fetches
        with open_cache(d.uri, fetch_bytes=True) as b:   # a second session
            hits = total = 0
            for rel in files:
                res = b.read(rel, 0, b.meta.file_size(rel))
                total += len(res.blocks)
                hits += sum(1 for blk in res.blocks if blk.hit)
        new_demand = d.client.executor.stats.demand_fetches - demand
        st = d.daemon_stats()
        spills = engine.arena_spills()
        faults = engine.fault_stats()
    assert hits == total > 0 and new_demand == 0, (hits, total, new_demand)
    assert spills == 0 and not faults["events"], (spills, faults)
    print(f"session A verified {len(files)} files against disk; session B "
          f"hit {hits}/{total} blocks with {new_demand} demand fetches")
    print(f"daemon: sessions_served={st['byes']} "
          f"served_reads={st['served_reads']} "
          f"arena_free={st['arena_free']}/{st['arena_total']}; "
          f"worker arena spills={spills}")
    return {"hits": hits, "blocks": total, "demand_fetches": new_demand,
            "served_reads": st["served_reads"], "worker_arena_spills": spills,
            "socket_bytes": len(sock.encode())}


def tiered_s3_walkthrough() -> dict:
    """A RAM and disk tier over a mock S3 bucket."""
    print("\n--- tiered+mock-s3:// walkthrough --------------------------")
    from repro_torch.storage.s3 import mock_object_bytes

    spill = tempfile.mkdtemp(prefix="igt-spill-")
    # 2 dirs x 3 objects of 128 KB; ram_bytes=256 KB holds 4 of the 12
    # blocks, so the rest spill
    uri = (f"tiered+mock-s3://quickstart/corpus?dirs=2&files=3&file_kb=128"
           f"&block_size=65536&ram_bytes=262144&disk_mb=8&spill_dir={spill}")
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=64 * 1024)
    client = open_cache(uri, 2 * MB, cfg=cfg, executor="threaded",
                        fetch_bytes=True)
    files = [("corpus", f"{d:02d}", f"{i:03d}.bin")
             for d in range(2) for i in range(3)]
    remote = []
    for _ in range(2):                      # pass 1 remote, pass 2 tiers
        for rel in files:
            res = client.read(rel, 0, client.meta.file_size(rel))
            want = bytes(mock_object_bytes("corpus", "/".join(rel[1:]),
                                           0, 128 * 1024))
            assert bytes(res.data) == want, "client bytes != bucket bytes"
        client.flush(timeout=10.0)
        remote.append(client.snapshot()["store"]["tiers"]["remote_bytes"])
    tiers = client.snapshot()["store"]["tiers"]
    client.close()
    assert tiers["disk_hits"] > 0, tiers
    assert remote[0] == remote[1] == len(files) * 128 * 1024, remote
    print(f"pass 1 fetched {len(files)} objects over ranged GETs; pass 2 "
          f"from the tiers: ram_hits={tiers['ram_hits']} "
          f"disk_hits={tiers['disk_hits']} spills={tiers['spills']} "
          f"remote_bytes={tiers['remote_bytes']} (both passes verified)")
    return {k: tiers[k] for k in ("ram_hits", "disk_hits", "spills",
                                  "remote_bytes")}


def survivable_daemon_walkthrough() -> dict:
    """Kill the daemon, keep reading, come back warm."""
    print("\n--- survivable daemon walkthrough --------------------------")
    from repro_torch.daemon import CacheDaemon, DaemonSupervisor

    root = tempfile.mkdtemp(prefix="igt-survive-")
    data = os.path.join(root, "data")
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(data, "set"))
    for i in range(16):
        blob = rng.integers(0, 256, 128 * 1024, dtype=np.uint8)
        with open(os.path.join(data, "set", f"{i:03d}.bin"), "wb") as f:
            f.write(blob.tobytes())
    files = [("set", f"{i:03d}.bin") for i in range(16)]
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=64 * 1024)
    sock = socket_path("survive")
    jdir = os.path.join(root, "journal")

    # the supervisor's respawn recipe: same socket, same journal
    def factory():
        return CacheDaemon(f"file://{data}", 16 * MB, cfg=cfg, uds=sock,
                           journal_dir=jdir, snapshot_every_s=0.2).start()

    sup = DaemonSupervisor(factory, restart_budget=3)
    # backing= gives the client a byte path while the daemon is away; it
    # must share the daemon's block geometry
    client = open_cache(sup.uri, fetch_bytes=True,
                        backing=f"file://{data}?block_size=65536")
    try:
        for i in rng.permutation(len(files)):
            client.read(files[i], 0, client.meta.file_size(files[i]))
        sup.daemon.write_snapshot()
        sup.kill_daemon()
        for i in rng.permutation(len(files)):
            res = client.read(files[i], 0, client.meta.file_size(files[i]))
            with open(os.path.join(data, *files[i]), "rb") as f:
                assert bytes(res.data) == f.read(), "degraded bytes != disk"
        degraded = client.client_stats.degraded_reads
        deadline = time.monotonic() + 10.0
        while client.state != "up" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert client.state == "up", "client did not reconnect"
        ev = next(e for e in reversed(sup.supervisor_stats()["events"])
                  if e["kind"] == "respawn_done")
        hits = total = 0
        for i in rng.permutation(len(files)):
            res = client.read(files[i], 0, client.meta.file_size(files[i]))
            total += len(res.blocks)
            hits += sum(1 for blk in res.blocks if blk.hit)
    finally:
        client.close()
        sup.close()
    assert degraded == len(files) and ev["restore"]["mode"] == "warm"
    assert hits == total, (hits, total)
    print(f"daemon killed: {degraded} reads served degraded (bytes "
          f"verified); respawned in {ev['recovery_s'] * 1e3:.1f} ms, "
          f"restore mode={ev['restore']['mode']}; {hits}/{total} blocks hit "
          "after the reconnect")
    return {"degraded_reads": degraded, "restore": ev["restore"]["mode"],
            "hits": hits, "blocks": total}


WALKTHROUGHS = {"main": main, "file": file_store_walkthrough,
                "daemon": daemon_walkthrough, "tiered": tiered_s3_walkthrough,
                "survivable": survivable_daemon_walkthrough}


if __name__ == "__main__":
    names = sys.argv[1:] or list(WALKTHROUGHS)
    unknown = set(names) - set(WALKTHROUGHS)
    if unknown:
        raise SystemExit(f"unknown walkthroughs {sorted(unknown)}; choose "
                         f"from {sorted(WALKTHROUGHS)}")
    for name in names:
        WALKTHROUGHS[name]()
