"""The Table-3 workload suite (18 jobs, 10 datasets), scaled ~10×.

Each job is a materialized sequence of *steps*; a step is
``(compute_seconds, [(file_path, offset, size), ...])`` — read the batch,
then compute.  Patterns per Table 3: sequential (test/analytics/
preprocessing/checkpoint-load), random (training epochs), skewed (LakeBench
table queries, Wiki RAG), and the mixed LLaVa finetune.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import MB, PathT
from ..storage.datasets import DatasetSpec, make_dataset

Request = Tuple[PathT, int, int]          # (file_path, offset, size)
Step = Tuple[float, List[Request]]        # (compute_s, batch of reads)

BLOCK = 4 * MB


@dataclass
class Job:
    job_id: int
    name: str
    dataset: str
    pattern: str                      # sequential | random | skewed | mixed
    steps: List[Step]
    device: str = "V"                 # A/V/C — informational (Table 3)
    submit_time: float = 0.0

    @property
    def n_accesses(self) -> int:
        return sum(len(reqs) for _, reqs in self.steps)


# --------------------------------------------------------------------------
# datasets (Table 1 layouts, scaled ~10×; sizes in bytes)
# --------------------------------------------------------------------------

def make_datasets(scale: float = 1.0) -> Dict[str, DatasetSpec]:
    s = scale

    def n(x: float) -> int:
        return max(2, int(x * s))

    # Sizes keep the paper's *proportions* (total ≈ 430 GB, cache 150 GB,
    # ImageNet+Places ≈ 60 % of the data, hot/query sets a small fraction of
    # the cache) scaled to ≈10 GB total so a full 18-job day runs in seconds.
    return {
        "audiomnist": make_dataset("audiomnist", "flat_files",
                                   n_files=n(2000), small_file_size=64 * 1024),
        "fashionproduct": make_dataset("fashionproduct", "flat_files",
                                       n_files=n(3000), small_file_size=64 * 1024),
        "airquality": make_dataset("airquality", "big_files",
                                   n_files=4, file_size=int(48 * MB * s)),
        "icoads": make_dataset("icoads", "dir_tree", n_dirs=n(120),
                               files_per_dir=10, small_file_size=512 * 1024),
        "bookcorpus": make_dataset("bookcorpus", "big_files",
                                   n_files=8, file_size=int(96 * MB * s)),
        "imagenet": make_dataset("imagenet", "dir_tree", n_dirs=n(310),
                                 files_per_dir=26, small_file_size=512 * 1024),
        "mitplaces": make_dataset("mitplaces", "dir_tree", n_dirs=n(190),
                                  files_per_dir=30, small_file_size=512 * 1024),
        "lakebench": make_dataset("lakebench", "flat_files",
                                  n_files=n(800), small_file_size=512 * 1024),
        "wiki": make_dataset("wiki", "big_files",
                             n_files=8, file_size=int(64 * MB * s)),
        "llava_text": make_dataset("llava_text", "big_files",
                                   n_files=2, file_size=int(64 * MB * s)),
        "llava_images": make_dataset("llava_images", "flat_files",
                                     n_files=n(1200), small_file_size=256 * 1024),
    }


# --------------------------------------------------------------------------
# access-sequence generators
# --------------------------------------------------------------------------

def seq_files(ds: DatasetSpec, passes: int, batch: int, compute: float) -> List[Step]:
    steps: List[Step] = []
    for _ in range(passes):
        reqs = [(f.path, 0, f.size) for f in ds.files]
        for i in range(0, len(reqs), batch):
            steps.append((compute, reqs[i:i + batch]))
    return steps


def coalesce_extents(reqs: Sequence[Request]) -> List[Request]:
    """Merge adjacent same-file contiguous block requests into one extent.

    A run ``(f, 0, B), (f, B, B), (f, 2B, B)`` becomes ``(f, 0, 3B)`` — the
    multi-block extent form the engine's batched ``read()`` was built for
    (one resolve/route/chain replay serves all blocks).  The engine
    decomposes the extent back into the identical block sequence, so cache
    decisions and per-block outcomes are unchanged; only the number of
    engine calls drops.
    """
    out: List[Request] = []
    for path, off, size in reqs:
        if out:
            lpath, loff, lsize = out[-1]
            if lpath == path and loff + lsize == off:
                out[-1] = (lpath, loff, lsize + size)
                continue
        out.append((path, off, size))
    return out


def seq_blocks(ds: DatasetSpec, passes: int, batch: int, compute: float,
               file_limit: Optional[int] = None) -> List[Step]:
    """Sequential block scan; each step's contiguous per-block runs are
    coalesced into multi-block extent reads (``batch`` counts blocks, so
    the bytes-per-step and the block stream are unchanged)."""
    steps: List[Step] = []
    files = ds.files[:file_limit] if file_limit else ds.files
    for _ in range(passes):
        reqs: List[Request] = []
        for f in files:
            nb = max(1, -(-f.size // BLOCK))
            for b in range(nb):
                reqs.append((f.path, b * BLOCK, min(BLOCK, f.size - b * BLOCK)))
        for i in range(0, len(reqs), batch):
            steps.append((compute, coalesce_extents(reqs[i:i + batch])))
    return steps


def random_files(ds: DatasetSpec, epochs: int, batch: int, compute: float,
                 seed: int) -> List[Step]:
    rng = random.Random(seed)
    steps: List[Step] = []
    idx = list(range(len(ds.files)))
    for _ in range(epochs):
        rng.shuffle(idx)
        for i in range(0, len(idx), batch):
            reqs = [(ds.files[j].path, 0, ds.files[j].size)
                    for j in idx[i:i + batch]]
            steps.append((compute, reqs))
    return steps


def random_records(ds: DatasetSpec, n_steps: int, records_per_step: int,
                   record_size: int, compute: float, seed: int) -> List[Step]:
    """Random record reads inside big files (fine-tuning over a corpus)."""
    rng = random.Random(seed)
    steps: List[Step] = []
    for _ in range(n_steps):
        reqs: List[Request] = []
        for _ in range(records_per_step):
            f = ds.files[rng.randrange(len(ds.files))]
            off = rng.randrange(max(1, f.size - record_size))
            reqs.append((f.path, off, record_size))
        steps.append((compute, reqs))
    return steps


def zipf_files(ds: DatasetSpec, n_queries: int, a: float, batch: int,
               compute: float, seed: int,
               drift_every: int = 1200) -> List[Step]:
    """Zipf-hot file queries; the hot set DRIFTS (rotating rank→item map
    every ``drift_every`` queries) — real query popularity is
    non-stationary, which is what separates recency-aware eviction from
    static pinning."""
    rng = np.random.default_rng(seed)
    n = len(ds.files)
    perm = rng.permutation(n)
    steps: List[Step] = []
    reqs: List[Request] = []
    for q in range(n_queries):
        if drift_every and q and q % drift_every == 0:
            perm = rng.permutation(n)
        r = (rng.zipf(a) - 1) % n
        f = ds.files[int(perm[r])]
        reqs.append((f.path, 0, f.size))
        if len(reqs) == batch:
            steps.append((compute, reqs))
            reqs = []
    if reqs:
        steps.append((compute, reqs))
    return steps


def zipf_blocks(ds: DatasetSpec, n_queries: int, a: float, batch: int,
                compute: float, seed: int,
                drift_every: int = 1500) -> List[Step]:
    rng = np.random.default_rng(seed)
    blocks: List[Request] = []
    for f in ds.files:
        nb = max(1, -(-f.size // BLOCK))
        for b in range(nb):
            blocks.append((f.path, b * BLOCK, min(BLOCK, f.size - b * BLOCK)))
    n = len(blocks)
    perm = rng.permutation(n)
    steps: List[Step] = []
    reqs = []
    for q in range(n_queries):
        if drift_every and q and q % drift_every == 0:
            perm = rng.permutation(n)
        r = (rng.zipf(a) - 1) % n
        reqs.append(blocks[int(perm[r])])
        if len(reqs) == batch:
            steps.append((compute, reqs))
            reqs = []
    if reqs:
        steps.append((compute, reqs))
    return steps


def location_scan(ds: DatasetSpec, file_indices: Sequence[int],
                  compute: float) -> List[Step]:
    """ICOADS marine analysis (Fig. 7): one location file per date dir,
    traversing dirs in order — the hierarchical-prefetch showcase."""
    steps: List[Step] = []
    root = ds.root()
    for loc in file_indices:
        for d in ds.dirs[root]:
            fname = ds.dirs[root + (d,)][loc]
            fpath = root + (d, fname)
            size = next(f.size for f in ds.files if f.path == fpath)
            steps.append((compute, [(fpath, 0, size)]))
    return steps


def mixed_llava(text: DatasetSpec, images: DatasetSpec, epochs: int,
                batch: int, compute: float, seed: int) -> List[Step]:
    """LLaVa finetune: sequential text shards + random image batches."""
    rng = random.Random(seed)
    steps: List[Step] = []
    text_blocks: List[Request] = []
    for f in text.files:
        nb = max(1, -(-f.size // BLOCK))
        for b in range(nb):
            text_blocks.append((f.path, b * BLOCK, min(BLOCK, f.size - b * BLOCK)))
    ti = 0
    idx = list(range(len(images.files)))
    for _ in range(epochs):
        rng.shuffle(idx)
        for i in range(0, len(idx), batch):
            reqs = [(images.files[j].path, 0, images.files[j].size)
                    for j in idx[i:i + batch]]
            reqs.append(text_blocks[ti % len(text_blocks)])
            ti += 1
            steps.append((compute, reqs))
    return steps


# --------------------------------------------------------------------------
# the 18-job suite (Table 3)
# --------------------------------------------------------------------------

@dataclass
class WorkloadSuite:
    datasets: Dict[str, DatasetSpec]
    jobs: List[Job]

    def total_bytes(self) -> int:
        return sum(d.total_bytes for d in self.datasets.values())


def make_paper_suite(scale: float = 1.0, seed: int = 0,
                     poisson_beta: float = 60.0,
                     job_filter: Optional[Sequence[int]] = None) -> WorkloadSuite:
    ds = make_datasets(scale)
    J = []

    def add(jid, name, dsname, pattern, steps, device):
        J.append(Job(jid, name, dsname, pattern, steps, device))

    add(1, "vgg16_train_audiomnist", "audiomnist", "sequential",
        seq_files(ds["audiomnist"], 2, 32, 0.25), "V")
    add(2, "vgg16_test_fashion", "fashionproduct", "sequential",
        seq_files(ds["fashionproduct"], 3, 32, 0.12), "V")
    add(3, "airquality_analysis", "airquality", "sequential",
        seq_blocks(ds["airquality"], 1, 4, 0.05), "C")
    add(4, "marine_analysis_icoads", "icoads", "sequential",
        location_scan(ds["icoads"], [3, 7], 0.08), "C")
    add(5, "preprocess_icoads", "icoads", "sequential",
        seq_files(ds["icoads"], 2, 8, 0.06), "C")
    add(6, "opt125m_ckpt_load", "bookcorpus", "sequential",
        seq_blocks(ds["bookcorpus"], 1, 8, 0.01, file_limit=4), "A")
    add(7, "opt125m_finetune", "bookcorpus", "random",
        random_records(ds["bookcorpus"], 2500, 8, 64 * 1024, 0.18, seed + 7), "A")
    add(8, "resnet50_test_imagenet", "imagenet", "sequential",
        seq_files(ds["imagenet"], 2, 32, 0.10), "V")
    add(9, "resnet50_train_imagenet", "imagenet", "random",
        random_files(ds["imagenet"], 5, 32, 0.22, seed + 9), "V")
    add(10, "alexnet_train_imagenet", "imagenet", "random",
        random_files(ds["imagenet"], 5, 32, 0.15, seed + 10), "V")
    add(11, "alexnet_test_mitplaces", "mitplaces", "sequential",
        seq_files(ds["mitplaces"], 2, 32, 0.10), "V")
    add(12, "resnet50_train_mitplaces", "mitplaces", "random",
        random_files(ds["mitplaces"], 5, 32, 0.22, seed + 12), "V")
    add(13, "alexnet_train_mitplaces", "mitplaces", "random",
        random_files(ds["mitplaces"], 5, 32, 0.15, seed + 13), "V")
    add(14, "lakebench_join", "lakebench", "skewed",
        zipf_files(ds["lakebench"], 3000, 1.2, 4, 0.06, seed + 14), "C")
    add(15, "lakebench_union", "lakebench", "skewed",
        zipf_files(ds["lakebench"], 2500, 1.1, 4, 0.06, seed + 15), "C")
    add(16, "rag_large_wiki", "wiki", "skewed",
        zipf_blocks(ds["wiki"], 6000, 1.2, 2, 0.08, seed + 16), "V")
    add(17, "rag_small_wiki", "wiki", "skewed",
        zipf_blocks(ds["wiki"], 2500, 1.4, 2, 0.08, seed + 17), "V")
    add(18, "llava_finetune", "llava_images", "mixed",
        mixed_llava(ds["llava_text"], ds["llava_images"], 3, 32, 0.25,
                    seed + 18), "A")

    if job_filter is not None:
        keep = set(job_filter)
        J = [j for j in J if j.job_id in keep]

    # Poisson arrivals (§5.1): expected inter-arrival beta seconds.
    rng = random.Random(seed + 100)
    t = 0.0
    for j in J:
        j.submit_time = t
        t += rng.expovariate(1.0 / poisson_beta)
    return WorkloadSuite(datasets=ds, jobs=J)
