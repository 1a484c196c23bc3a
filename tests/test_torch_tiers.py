"""The port's tiered storage and object-store scheme (``repro_torch.storage.
tiers``, ``storage.s3``) under the JAX package's own tier tests, run
against the port's modules with their bounds unchanged: RAM / disk
placement, spills and promotion, checksummed spill files, warm re-index,
the ``tiered+`` URI knobs, the mock S3 server, and a tiered client that
is decision-identical to a flat one.  The cluster-simulator case comes
with the port's simulator.  Cross-package cases at the end hold the port
against the reference on one seeded trace.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import CacheConfig, open_cache
from repro_torch.core.types import MB, Pattern
from repro_torch.storage import (FaultyStore, MemStore, MockS3Server,
                                 RetryPolicy, S3Store, StoreError,
                                 TieredStore, TransientStoreError, open_store)
from repro_torch.storage.api import resolve_store_spec, store_spec
from repro_torch.storage.s3 import mock_object_bytes
from repro_torch.storage.tiers import DiskTier


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


BS = 64 * 1024          # block size for every store in this file

pytestmark = pytest.mark.tier


def _mem_world(n_files=6, blocks_per_file=3, seed=0):
    mem = MemStore(block_size=BS)
    rng = np.random.default_rng(seed)
    data = {}
    for i in range(n_files):
        b = rng.integers(0, 256, BS * blocks_per_file,
                         dtype=np.uint8).tobytes()
        mem.add_file(("ds", f"f{i:02d}"), b)
        data[i] = b
    return mem, data


def _tiered(mem, tmp_path, *, ram_blocks=4, disk_blocks=64, **kw):
    return TieredStore(mem, ram_bytes=ram_blocks * BS,
                       disk_bytes=disk_blocks * BS,
                       spill_dir=str(tmp_path / "spill"), **kw)


class _CountingInner:
    """v2 wrapper counting inner fetches (tier-hit tests prove the inner
    store was *not* consulted)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.lock = threading.Lock()

    def capabilities(self):
        return self.inner.capabilities()

    def fetch_range(self, path, offset, length):
        with self.lock:
            self.calls += 1
        return self.inner.fetch_range(path, offset, length)

    def fetch_many(self, requests):
        with self.lock:
            self.calls += len(requests)
        return self.inner.fetch_many(requests)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---------------------------------------------------------------------------
# bytes mode: fills, slices, spills, promotes
# ---------------------------------------------------------------------------

def test_whole_block_fill_and_partial_slice(tmp_path):
    mem, data = _mem_world()
    ts = _tiered(mem, tmp_path)
    # full-block miss → fetched from inner, admitted
    got = ts.fetch_range(("ds", "f00", "#1"), 0, BS)
    assert bytes(got) == data[0][BS:2 * BS]
    assert ts.tier_stats()["ram_blocks"] == 1
    # partial read of the resident block → served by slicing RAM
    counting = _CountingInner(mem)
    ts2 = TieredStore(counting, ram_bytes=4 * BS, disk_bytes=16 * BS,
                      spill_dir=str(tmp_path / "s2"))
    assert bytes(ts2.fetch_range(("ds", "f00", "#1"), 0, BS)) == \
        data[0][BS:2 * BS]
    before = counting.calls
    part = ts2.fetch_range(("ds", "f00", "#1"), 100, 300)
    assert bytes(part) == data[0][BS + 100:BS + 400]
    assert counting.calls == before          # no inner fetch: RAM slice
    assert ts2.tier_stats()["ram_hits"] == 1
    # partial miss (block not resident) passes through uncached
    part2 = ts2.fetch_range(("ds", "f01", "#0"), 10, 50)
    assert bytes(part2) == data[1][10:60]
    snap = ts2.tier_stats()
    assert snap["pass_through"] >= 1
    assert snap["ram_blocks"] == 1           # nothing new admitted


def test_fetch_many_serves_resident_and_batches_misses(tmp_path):
    mem, data = _mem_world()
    counting = _CountingInner(mem)
    ts = TieredStore(counting, ram_bytes=8 * BS, disk_bytes=16 * BS,
                     spill_dir=str(tmp_path / "spill"))
    reqs = [(("ds", "f00", "#0"), 0, BS), (("ds", "f01", "#0"), 0, BS)]
    out = ts.fetch_many(reqs)
    assert bytes(out[0]) == data[0][:BS] and bytes(out[1]) == data[1][:BS]
    before = counting.calls
    out2 = ts.fetch_many(reqs + [(("ds", "f02", "#0"), 0, BS)])
    assert counting.calls == before + 1      # only the new block fetched
    assert bytes(out2[2]) == data[2][:BS]
    assert ts.tier_stats()["ram_hits"] == 2


def test_ram_spills_to_disk_and_promotes_exact_bytes(tmp_path):
    mem, data = _mem_world(n_files=8, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=2)
    for i in range(8):
        ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
    snap = ts.tier_stats()
    assert snap["ram_blocks"] == 2
    assert snap["spills"] == 6 and snap["disk_blocks"] == 6
    assert os.listdir(ts.spill_dir)          # real files on disk
    # disk hit: exact bytes, no inner fetch, promoted back to RAM
    counting = ts.inner  # noqa: F841
    got = ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    snap = ts.tier_stats()
    assert snap["disk_hits"] == 1 and snap["promotes"] == 1
    # partial slice of a disk-resident block also returns exact bytes
    got2 = ts.fetch_range(("ds", "f01", "#0"), 1000, 123)
    assert bytes(got2) == data[1][1000:1123]


def test_kernel_eviction_spills_payload(tmp_path):
    """The engine's evict hook moves a RAM-resident payload to disk."""
    mem, data = _mem_world(n_files=4, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=8)
    for i in range(4):
        ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
    assert ts.tier_stats()["ram_blocks"] == 4
    ts.note_evicted("ds/f00/#0", BS)
    snap = ts.tier_stats()
    assert snap["ram_blocks"] == 3 and snap["disk_blocks"] == 1
    got = ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    assert ts.tier_stats()["disk_hits"] == 1


# ---------------------------------------------------------------------------
# pattern-aware placement
# ---------------------------------------------------------------------------

def test_sequential_writes_through_to_disk_not_ram(tmp_path):
    mem, data = _mem_world()
    ts = _tiered(mem, tmp_path)
    ts.note_pattern("ds", Pattern.SEQUENTIAL.value, False)
    got = ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    snap = ts.tier_stats()
    assert snap["ram_blocks"] == 0           # streamed: never RAM-resident
    assert snap["disk_blocks"] == 1          # but disk-eligible
    # a re-scan hits disk and *streams* (no promote for sequential)
    got2 = ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got2) == data[0][:BS]
    snap = ts.tier_stats()
    assert snap["disk_hits"] == 1 and snap["promotes"] == 0
    assert snap["ram_blocks"] == 0


def test_skewed_blocks_pin_in_ram_under_pressure(tmp_path):
    mem = MemStore(block_size=BS)
    rng = np.random.default_rng(0)
    for top in ("hot", "cold"):
        for i in range(4):
            mem.add_file((top, f"f{i}"),
                         rng.integers(0, 256, BS, dtype=np.uint8).tobytes())
    ts = TieredStore(mem, ram_bytes=4 * BS, disk_bytes=32 * BS,
                     spill_dir=str(tmp_path / "spill"))
    ts.note_pattern("hot", Pattern.SKEWED.value, True)
    for i in range(2):
        ts.fetch_range(("hot", f"f{i}", "#0"), 0, BS)
    # pressure from non-sticky traffic: sticky blocks must survive
    for i in range(4):
        ts.fetch_range(("cold", f"f{i}", "#0"), 0, BS)
    resident = set(ts._ram)
    assert {"hot/f0/#0", "hot/f1/#0"} <= resident
    assert ts.tier_stats()["ram_evictions"] >= 2  # cold blocks churned


def test_target_hit_rate_gates_random_admission(tmp_path):
    mem, data = _mem_world(n_files=8, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=2, target_hit_rate=0.5,
                 hit_window=16)
    ts.note_pattern("ds", Pattern.RANDOM.value, False)
    # fill RAM, then drive the windowed hit rate above target
    ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    ts.fetch_range(("ds", "f01", "#0"), 0, BS)
    for _ in range(20):
        ts.fetch_range(("ds", "f00", "#0"), 0, BS)
        ts.fetch_range(("ds", "f01", "#0"), 0, BS)
    assert ts._recent_rate is not None and ts._recent_rate >= 0.5
    before = dict(ts.tier_stats())
    ts.fetch_range(("ds", "f02", "#0"), 0, BS)   # would evict a RAM block
    snap = ts.tier_stats()
    assert snap["admission_skips"] == before["admission_skips"] + 1
    assert set(ts._ram) == {"ds/f00/#0", "ds/f01/#0"}  # no churn
    # SEQUENTIAL placement is structural: never gated
    ts.note_pattern("seq", Pattern.SEQUENTIAL.value, False)
    assert not ts._admission_gated("sequential")


# ---------------------------------------------------------------------------
# durability edges
# ---------------------------------------------------------------------------

def test_warm_restart_reindexes_spill_dir(tmp_path):
    mem, data = _mem_world(n_files=6, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=2)
    for i in range(6):
        ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
    spilled = ts.tier_stats()["disk_blocks"]
    assert spilled == 4
    # "restart": a fresh store over the same spill dir re-adopts the files
    counting = _CountingInner(mem)
    ts2 = TieredStore(counting, ram_bytes=2 * BS, disk_bytes=64 * BS,
                      spill_dir=ts.spill_dir)
    snap = ts2.tier_stats()
    assert snap["restored"] == spilled and snap["disk_blocks"] == spilled
    got = ts2.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    assert counting.calls == 0               # served from the warm spill dir
    assert ts2.tier_stats()["disk_hits"] == 1


def test_corrupt_spill_file_degrades_to_clean_miss(tmp_path):
    mem, data = _mem_world(n_files=4, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=1)
    for i in range(4):
        ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
    # truncate f00's spill file and bit-flip f01's payload
    trunc = os.path.join(ts.spill_dir, ts.disk._fname("ds/f00/#0"))
    with open(trunc, "r+b") as f:
        f.truncate(os.path.getsize(trunc) // 2)
    flip = os.path.join(ts.spill_dir, ts.disk._fname("ds/f01/#0"))
    raw = bytearray(open(flip, "rb").read())
    raw[-1] ^= 0xFF
    with open(flip, "wb") as f:
        f.write(raw)
    # the truncated block reads back exact inner bytes — never corrupt
    got = ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    assert ts.tier_stats()["checksum_failures"] == 1
    assert not os.path.exists(trunc)         # bad file dropped on detection
    # ditto the bit-flipped one
    got = ts.fetch_range(("ds", "f01", "#0"), 0, BS)
    assert bytes(got) == data[1][:BS]
    snap = ts.tier_stats()
    assert snap["checksum_failures"] == 2
    # every other read still round-trips
    for i in range(4):
        got = ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
        assert bytes(got) == data[i][:BS]


def test_corrupt_files_dropped_at_reindex(tmp_path):
    mem, _ = _mem_world(n_files=3, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=1)
    for i in range(3):
        ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
    bad = os.path.join(ts.spill_dir, "junk.blk")
    with open(bad, "wb") as f:
        f.write(b"not a spill header at all")
    ts2 = TieredStore(mem, ram_bytes=BS, disk_bytes=64 * BS,
                      spill_dir=ts.spill_dir)
    assert not os.path.exists(bad)           # unparseable file deleted
    assert ts2.tier_stats()["restored"] == 2


def test_spill_dir_full_falls_back_to_ram_only(tmp_path, monkeypatch):
    mem, data = _mem_world(n_files=16, blocks_per_file=1)
    ts = _tiered(mem, tmp_path, ram_blocks=2)

    def fail_replace(src, dst):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(os, "replace", fail_replace)
    for i in range(12):
        got = ts.fetch_range(("ds", f"f{i:02d}", "#0"), 0, BS)
        assert bytes(got) == data[i][:BS]    # reads keep working
    snap = ts.tier_stats()
    assert snap["spill_errors"] >= 8
    assert snap["disk_disabled"] is True     # stopped hammering the disk
    assert snap["disk_blocks"] == 0
    monkeypatch.undo()
    # RAM tier still serves
    got = ts.fetch_range(("ds", "f11", "#0"), 0, BS)
    assert bytes(got) == data[11][:BS]
    assert ts.tier_stats()["ram_hits"] >= 1


def test_disk_tier_capacity_evicts_lru(tmp_path):
    stats_dir = str(tmp_path / "d")
    tier = DiskTier(3 * BS, stats_dir, payload=True)
    blob = np.zeros(BS, dtype=np.uint8)
    for i in range(5):
        assert tier.put(f"k{i}", BS, blob)
    assert len(tier.index) == 3 and tier.used == 3 * BS
    assert tier.stats.disk_evictions == 2
    assert "k0" not in tier and "k4" in tier


# ---------------------------------------------------------------------------
# URI composition + worker respawn specs
# ---------------------------------------------------------------------------

def test_tiered_uri_and_query_knobs(tmp_path):
    st = open_store(f"tiered+mem://?ram_mb=1&disk_mb=4&block_size={BS}"
                    f"&target_hit_rate=0.7&mode=bytes"
                    f"&spill_dir={tmp_path / 'sp'}")
    assert isinstance(st, TieredStore)
    assert st.ram_bytes == 1 * MB and st.disk_bytes == 4 * MB
    assert st.target_hit_rate == 0.7
    assert st.inner.block_size == BS
    assert st.uri.startswith("tiered+mem://")
    # RAM-only configuration: disk tier absent, no spill dir required
    ram_only = open_store(f"tiered+mem://?ram_mb=1&disk_mb=0"
                          f"&block_size={BS}")
    assert ram_only.disk_bytes == 0 and ram_only.spill_dir is None


def test_wrapper_spec_round_trip_keeps_fault_injection(tmp_path):
    """The registry double-wrap fix: ``store_spec`` on a ``faulty+`` (or
    ``tiered+``) wrapper must return the *composed* URI, so a respawned
    worker reconstructs the whole stack — previously the wrapper
    delegated ``uri`` from the inner store and the fault injector was
    silently dropped on respawn."""
    root = tmp_path / "data"
    root.mkdir()
    (root / "a.bin").write_bytes(b"\x01" * 4096)
    uri = f"faulty+file://{root}?fail_rate=0.25&seed=7&block_size={BS}"
    st = open_store(uri)
    assert isinstance(st, FaultyStore)
    kind, payload = store_spec(st)
    assert (kind, payload) == ("uri", uri)
    clone = resolve_store_spec((kind, payload))
    assert isinstance(clone, FaultyStore)
    assert clone.fail_rate == 0.25 and clone._rng is not None
    # tiered+ wrapper: same contract
    turi = (f"tiered+file://{root}?ram_mb=1&disk_mb=2&block_size={BS}"
            f"&spill_dir={tmp_path / 'sp'}")
    tst = open_store(turi)
    assert store_spec(tst) == ("uri", turi)
    tclone = resolve_store_spec(store_spec(tst))
    assert isinstance(tclone, TieredStore) and tclone.ram_bytes == 1 * MB
    # a tiered store over a non-reopenable inner travels as the object
    mem_tiered = open_store(f"tiered+mem://?ram_mb=1&block_size={BS}")
    assert store_spec(mem_tiered)[0] == "object"


def test_faulty_tiered_composition(tmp_path):
    mem, data = _mem_world(n_files=2, blocks_per_file=1)
    # tiered over faulty: a tier hit masks the injector entirely
    faulty = FaultyStore(mem, fail_rate=0.0)
    ts = TieredStore(faulty, ram_bytes=4 * BS, disk_bytes=8 * BS,
                     spill_dir=str(tmp_path / "sp"))
    assert bytes(ts.fetch_range(("ds", "f00", "#0"), 0, BS)) == data[0][:BS]
    faulty.fail_rate = 1.0                   # store goes dark
    got = ts.fetch_range(("ds", "f00", "#0"), 0, BS)   # tier hit: no fault
    assert bytes(got) == data[0][:BS]
    with pytest.raises(TransientStoreError):
        ts.fetch_range(("ds", "f01", "#0"), 0, BS)     # tier miss: surfaces


def test_mock_s3_spec_reopens_identical_server():
    uri = f"mock-s3://spec/bkt?dirs=1&files=2&file_kb=16&block_size={BS}"
    a = open_store(uri)
    clone = resolve_store_spec(store_spec(a))
    assert isinstance(clone, S3Store)
    p = ("bkt", "00", "001.bin")
    assert clone.file_size(p) == 16 * 1024
    assert np.array_equal(clone.fetch_range(p, 5, 100),
                          a.fetch_range(p, 5, 100))


# ---------------------------------------------------------------------------
# the object-store scheme
# ---------------------------------------------------------------------------

def test_mock_s3_metadata_and_ranged_bytes():
    st = open_store(f"mock-s3://t/b1?dirs=2&files=3&file_kb=8"
                    f"&block_size=4096")
    assert st.listing(("b1",)) == ["00", "01"]
    assert st.listing(("b1", "01")) == ["000.bin", "001.bin", "002.bin"]
    p = ("b1", "01", "002.bin")
    assert st.file_size(p) == 8192
    got = st.fetch_range(p, 123, 456)
    assert np.array_equal(got, mock_object_bytes("b1", "01/002.bin",
                                                 123, 456))
    # block-relative addressing resolves through block_size
    blk = st.fetch_range(p + ("#1",), 10, 20)
    assert np.array_equal(blk, mock_object_bytes("b1", "01/002.bin",
                                                 4096 + 10, 20))
    # batched fetch preserves request order over one connection
    outs = st.fetch_many([(p, 0, 10), (p, 100, 10), (p + ("#1",), 0, 10)])
    assert np.array_equal(outs[1], mock_object_bytes("b1", "01/002.bin",
                                                     100, 10))
    caps = st.capabilities()
    assert caps.ranges and caps.batching


def test_s3_explicit_server_and_errors():
    srv = MockS3Server()
    try:
        srv.add_object("bkt", "dir/obj.bin", data=bytes(range(256)) * 16)
        st = open_store(srv.uri("bkt") + "?block_size=1024")
        p = ("bkt", "dir", "obj.bin")
        assert st.file_size(p) == 4096
        got = st.fetch_range(p, 250, 20)
        assert bytes(got) == (bytes(range(256)) * 16)[250:270]
        with pytest.raises(StoreError):
            st.fetch_range(("bkt", "dir", "missing.bin"), 0, 10)
        with pytest.raises(StoreError):
            st.fetch_range(p, 4000, 500)     # past EOF: permanent
    finally:
        srv.close()
    # server gone: transport error surfaces as transient (retryable).
    # Drop the keep-alive socket first — an already-established handler
    # thread would otherwise keep serving it after shutdown.
    st._drop_conn()
    with pytest.raises(TransientStoreError):
        st.fetch_range(p, 0, 16)


def test_mock_s3_round_trips_under_retry_and_breaker():
    """Acceptance: mock-s3 returns exact ranged bytes under fault
    injection, through the client's RetryPolicy/CircuitBreaker."""
    uri = (f"faulty+mock-s3://rt/b2?dirs=1&files=4&file_kb=32"
           f"&fail_rate=0.35&seed=3&block_size=8192")
    st = open_store(uri)
    assert isinstance(st, FaultyStore)
    retry = RetryPolicy(max_attempts=8, backoff_s=0.0,
                        sleep=lambda s: None)
    for i in range(4):
        p = ("b2", "00", f"{i:03d}.bin")
        got = retry.call(st.fetch_range, p, 1000, 2000)
        assert np.array_equal(
            got, mock_object_bytes("b2", f"00/{i:03d}.bin", 1000, 2000))
    assert st.injected_transient > 0


def test_open_cache_over_mock_s3_end_to_end():
    cfg = CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                      block_size=16 * 1024)
    client = open_cache("mock-s3://e2e/corpus?dirs=2&files=3&file_kb=32"
                        "&block_size=16384", 4 * MB, cfg=cfg,
                        executor="sim", fetch_bytes=True)
    files = [("corpus", f"{d:02d}", f"{i:03d}.bin")
             for d in range(2) for i in range(3)]
    t = 0.0
    for rel in files:
        res = client.read(rel, 0, client.meta.file_size(rel), t)
        t += 0.1
        assert bytes(res.data) == bytes(
            mock_object_bytes("corpus", "/".join(rel[1:]), 0, 32 * 1024))
    client.close()


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def _cfg():
    return CacheConfig(min_share=1 * MB, rebalance_quantum=1 * MB,
                       block_size=BS)


def test_client_spills_and_serves_from_disk_tier(tmp_path):
    mem, data = _mem_world(n_files=12, blocks_per_file=3, seed=1)
    ts = _tiered(mem, tmp_path, ram_blocks=16, disk_blocks=128)
    client = open_cache(ts, 1 * MB, cfg=_cfg(), executor="sim",
                        fetch_bytes=True)
    files = [("ds", f"f{i:02d}") for i in range(12)]
    t = 0.0
    for _ in range(2):
        for i, rel in enumerate(files):
            res = client.read(rel, 0, client.meta.file_size(rel), t)
            t += 0.1
            assert bytes(res.data) == data[i]
    snap = client.snapshot()
    tiers = snap["store"]["tiers"]
    assert tiers["disk_hits"] + tiers["ram_hits"] > 0
    assert tiers["spills"] > 0               # kernel evictions spilled
    client.close()


def test_tiered_client_is_equivalent_to_flat(tmp_path):
    """RAM-only acceptance: wrapping the store in tiers never changes
    kernel outcomes — hits/misses/evictions/bytes are bitwise equal."""
    mem, _ = _mem_world(n_files=10, blocks_per_file=3, seed=2)

    def trace(store):
        client = open_cache(store, 1 * MB, cfg=_cfg(), executor="sim")
        t = 0.0
        for _ in range(3):
            for i in range(10):
                client.read(("ds", f"f{i:02d}"), 0,
                            client.meta.file_size(("ds", f"f{i:02d}")), t)
                t += 0.1
        s = client.snapshot()
        client.close()
        return {k: s[k] for k in ("hits", "misses", "evictions",
                                  "prefetch_hits", "bytes_from_remote",
                                  "bytes_from_cache")}

    flat = trace(mem)
    tiered = trace(_tiered(mem, tmp_path, ram_blocks=8, disk_blocks=64))
    assert flat == tiered


def test_engine_pushes_placement_hints(tmp_path):
    mem = MemStore(block_size=BS)
    rng = np.random.default_rng(3)
    for i in range(40):
        mem.add_file(("scan", f"f{i:03d}"),
                     rng.integers(0, 256, BS, dtype=np.uint8).tobytes())
    ts = _tiered(mem, tmp_path, ram_blocks=8, disk_blocks=64)
    client = open_cache(ts, 2 * MB, cfg=_cfg(), executor="sim")
    t = 0.0
    for _ in range(4):                       # sequential scan epochs
        for i in range(40):
            client.read(("scan", f"f{i:03d}"), 0, BS, t)
            t += 0.5
    pats = ts.tier_stats()["patterns"]
    assert pats.get("scan", ("", False))[0] == "sequential"
    client.close()


def test_index_mode_needs_no_spill_dir():
    mem, _ = _mem_world(n_files=2, blocks_per_file=1)
    ts = TieredStore(mem, mode="index", disk_bytes=4 * BS)
    assert ts.spill_dir is None
    assert ts.sim_read("ds/f00/#0", BS) is False    # miss → admitted
    assert ts.sim_read("ds/f00/#0", BS) is True     # now disk-resident
    # non-sequential hit promotes: entry leaves the index
    assert ts.sim_read("ds/f00/#0", BS) is False


def test_tiered_store_pickles(tmp_path):
    import pickle
    mem, data = _mem_world(n_files=2, blocks_per_file=1)
    ts = _tiered(mem, tmp_path)
    ts.fetch_range(("ds", "f00", "#0"), 0, BS)
    clone = pickle.loads(pickle.dumps(ts))
    got = clone.fetch_range(("ds", "f00", "#0"), 0, BS)
    assert bytes(got) == data[0][:BS]
    assert clone.tier_stats()["ram_hits"] >= 1


# ---------------------------------------------------------------------------
# cross-package: the port against the reference on one seeded trace
# ---------------------------------------------------------------------------

PARITY_URI = ("tiered+mock-s3://parity/pbkt?dirs=3&files=4&file_kb=192"
              "&block_size=65536&ram_bytes=393216&disk_mb=1"
              "&spill_dir={spill}")
PARITY_FILES = [("pbkt", f"{d:02d}", f"{i:03d}.bin")
                for d in range(3) for i in range(4)]


def _parity_trace(seed=3):
    """(path, offset, size) reads: two sequential passes over every object,
    a zipf-skewed stream of whole objects, and partial ranges that start
    and end inside blocks."""
    rng = np.random.default_rng(seed)
    size = 192 * 1024
    trace = [(p, 0, size) for _ in range(2) for p in PARITY_FILES]
    for r in (rng.zipf(1.3, 120) - 1) % len(PARITY_FILES):
        trace.append((PARITY_FILES[int(r)], 0, size))
    for _ in range(40):
        p = PARITY_FILES[int(rng.integers(0, len(PARITY_FILES)))]
        off = int(rng.integers(0, size - 1))
        trace.append((p, off, int(rng.integers(1, size - off + 1))))
    return trace


def _parity_run(side, spill):
    if side == "jax":
        from repro.core import CacheConfig as Cfg, open_cache as opener
        from repro.storage import open_store as store_opener
    else:
        Cfg, opener, store_opener = CacheConfig, open_cache, open_store
    store = store_opener(PARITY_URI.format(spill=spill))
    cfg = Cfg(min_share=256 * 1024, rebalance_quantum=256 * 1024,
              block_size=BS, window=16, reanalyze_every=8)
    client = opener(store, 1 * MB, cfg=cfg, fetch_bytes=True)
    outs, data = [], []
    for k, (p, off, sz) in enumerate(_parity_trace()):
        r = client.read(p, off, sz, 100.0 + 0.01 * k)
        outs.append(([(b.key, b.size, b.hit, b.prefetched_hit)
                      for b in r.outcome.blocks], list(r.outcome.prefetches)))
        data.append(bytes(r.data))
    snap = client.snapshot()
    client.close()
    return outs, data, snap["store"]["tiers"], snap["hit_ratio"]


def test_tiered_uri_matches_reference(tmp_path):
    """One ``tiered+mock-s3://`` URI opened by each package, one seeded
    trace: equal ``ReadOutcome``s read by read, equal payload bytes (and
    each equal to ``mock_object_bytes``), equal ``TierStats``."""
    want = _parity_run("jax", tmp_path / "jax")
    got = _parity_run("torch", tmp_path / "torch")
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"divergence at read {k}"
    assert len(got[0]) == len(want[0]) == len(_parity_trace())
    for (p, off, sz), g, w in zip(_parity_trace(), got[1], want[1]):
        assert g == w == bytes(mock_object_bytes(p[0], "/".join(p[1:]),
                                                 off, sz))
    # every counter equal; the spill directories differ by construction
    assert got[2].pop("spill_dir") == str(tmp_path / "torch")
    assert want[2].pop("spill_dir") == str(tmp_path / "jax")
    assert got[2] == want[2]
    assert got[2]["spills"] > 0 and got[2]["disk_hits"] > 0
    assert got[2]["ram_hits"] > 0
    assert got[3] == want[3]


def test_mock_object_bytes_match_reference():
    from repro.storage.s3 import mock_object_bytes as jax_bytes
    rng = np.random.default_rng(5)
    for key in ("a.bin", "00/000.bin", "deep/er/x"):
        for off, n in ((0, 1), (0, 4096), (7, 1000), (65535, 3)):
            g = mock_object_bytes("bkt", key, off, n)
            w = jax_bytes("bkt", key, off, n)
            assert g.dtype == w.dtype and bytes(g) == bytes(w)
        off = int(rng.integers(0, 1 << 20))
        assert bytes(mock_object_bytes("b2", key, off, 333)) == \
            bytes(jax_bytes("b2", key, off, 333))


# ---------------------------------------------------------------------------
# URI registry (the registry cases of the reference's tests/test_stores.py)
# ---------------------------------------------------------------------------

def test_open_store_registry_schemes():
    from repro_torch.storage import MemStore, RemoteStore
    from repro_torch.storage.api import registered_schemes
    assert {"sim", "file", "mem", "s3", "mock-s3"} <= set(
        registered_schemes())
    sim = open_store("sim://default?latency_s=0.2")
    assert isinstance(sim, RemoteStore)
    assert sim.transfer.latency_s == pytest.approx(0.2)
    mem = open_store("mem://?block_size=65536")
    assert isinstance(mem, MemStore) and mem.block_size == 65536
    with pytest.raises(ValueError):
        open_store("warp://nope")
    with pytest.raises(ValueError):
        open_store("no-scheme-at-all")


def test_s3_mock_s3_and_tiered_registry_schemes(tmp_path):
    """``s3://host:port/bucket``, ``mock-s3://name/bucket`` and the
    ``tiered+`` wrapper resolve through the registry; ``tiered+`` takes its
    own knobs and hands the rest to the inner scheme."""
    mock = open_store("mock-s3://reg/rbkt?dirs=1&files=1&file_kb=8")
    assert isinstance(mock, S3Store) and mock.bucket == "rbkt"
    again = open_store("mock-s3://reg/rbkt?dirs=1&files=1&file_kb=8")
    assert (again.host, again.port) == (mock.host, mock.port)
    s3 = open_store(f"s3://{mock.host}:{mock.port}/rbkt?block_size=4096")
    assert isinstance(s3, S3Store) and s3.block_size == 4096
    assert s3.file_size(("rbkt", "00", "000.bin")) == 8 * 1024
    with pytest.raises(ValueError):
        open_store("s3://127.0.0.1:1/")          # no bucket
    tiered = open_store(f"tiered+mock-s3://reg/rbkt?dirs=1&files=1&file_kb=8"
                        f"&block_size=4096&ram_mb=1&disk_mb=2"
                        f"&spill_dir={tmp_path}")
    assert isinstance(tiered, TieredStore) and isinstance(tiered.inner,
                                                          S3Store)
    assert tiered.inner.block_size == 4096
    assert tiered.ram_bytes == MB and tiered.disk_bytes == 2 * MB
    assert bytes(tiered.fetch_range(("rbkt", "00", "000.bin"), 0, 8)) == \
        bytes(mock_object_bytes("rbkt", "00/000.bin", 0, 8))
