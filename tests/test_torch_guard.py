"""Import guard and no-fallback checks for the PyTorch port.

``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of the
JAX package ``repro``, and the port's entry points refuse to run on the CPU
unless asked to.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_modules_exist():
    mods = _port_modules()
    for name in ("repro_torch.interop", "repro_torch.kernels._build",
                 "repro_torch.kernels.rmsnorm.kernel",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.ssd.kernel",
                 "repro_torch.kernels.ssd.ops", "repro_torch.kernels.ssd.ref",
                 "repro_torch.models.ssm", "repro_torch.models.transformer",
                 "repro_torch.serve.engine", "repro_torch.configs",
                 "repro_torch.train.optimizer",
                 "repro_torch.train.train_step",
                 "repro_torch.train.checkpoint", "repro_torch.train.fault",
                 "repro_torch.data.pipeline", "repro_torch.launch.train",
                 *(f"repro_torch.core.{m}" for m in (
                     "types", "ks", "pattern", "access_stream_tree", "meta",
                     "prefetch", "eviction", "allocation", "sketch", "cache",
                     "igtcache", "sharded", "faults", "client", "baselines",
                     "wire", "procdriver")),
                 *(f"repro_torch.storage.{m}" for m in (
                     "api", "datasets", "object_store", "local_fs", "tiers",
                     "s3")),
                 "repro_torch.daemon",
                 *(f"repro_torch.daemon.{m}" for m in (
                     "wire", "uri", "journal", "server", "client",
                     "supervisor")),
                 "repro_torch.sim",
                 *(f"repro_torch.sim.{m}" for m in (
                     "link", "workloads", "cluster", "chaos")),
                 "repro_torch.sharding", "repro_torch.sharding.rules",
                 "repro_torch.sharding.context", "repro_torch.launch.mesh",
                 "repro_torch.launch.variants", "repro_torch.launch.dryrun",
                 "repro_torch.roofline",
                 *(f"repro_torch.roofline.{m}" for m in (
                     "analysis", "analytic", "report", "fill_repro",
                     "trace"))):
        assert name in mods


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_process_driver_worker_loads_no_jax_and_no_repro():
    """A shard worker of the port's process driver (forked, the default
    start method, by a parent that imported only the port) reports its own
    ``sys.modules`` through the ``hello`` command's capability snapshot."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "from repro_torch.core import open_cache\n"
        "from repro_torch.core.types import MB\n"
        "from repro_torch.storage import MemStore\n"
        "class Caps:\n"
        "    def snapshot(self):\n"
        "        import os\n"
        "        return {'pid': os.getpid(), 'bad': sorted(\n"
        "            m for m in sys.modules if m == 'jax' or\n"
        "            m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "            m.startswith('repro.'))}\n"
        "class Store(MemStore):\n"
        "    def capabilities(self):\n"
        "        return Caps()\n"
        "c = open_cache(Store(block_size=MB), 64 * MB, driver='process',\n"
        "               n_procs=2)\n"
        "info = [w['capabilities'] for w in c.engine.worker_info]\n"
        "c.close()\n"
        "import os\n"
        "assert all(i['pid'] != os.getpid() for i in info), info\n"
        "print('WORKERS', len(info), 'BAD', [i['bad'] for i in info])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "WORKERS 2 BAD [[], []]" in out.stdout, out.stdout


def test_static_scan_finds_no_jax_or_repro_import():
    assert all(FORBIDDEN.search(line) for line in (
        "import jax", "from jax import numpy", "import repro.core",
        "from repro.models import x", "from repro import core"))
    assert not any(FORBIDDEN.search(line) for line in (
        "import repro_torch", "from repro_torch.models import x",
        "import jaxtyping_free"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert hits == []


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """Default device is CUDA; without one they raise, never run on the
    CPU."""
    from repro_torch import resolve_device
    from repro_torch.configs import reduced_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen3-1.7b")
    params = {"embed": torch.zeros(cfg.vocab, cfg.d_model)}
    for call in (lambda: ServingEngine(params, cfg),
                 lambda: make_prefill(cfg), lambda: make_serve_step(cfg),
                 lambda: launch_train.main(["--reduced", "--steps", "1"]),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_engine_refuses_params_on_another_device():
    from repro_torch.configs import reduced_config
    from repro_torch.serve.engine import ServingEngine
    cfg = reduced_config("qwen3-1.7b")
    params = {"embed": torch.zeros(cfg.vocab, cfg.d_model, device="meta")}
    with pytest.raises(ValueError):
        ServingEngine(params, cfg, device="cpu")


def test_every_module_of_the_reference_has_a_counterpart():
    """A ``comm`` of the two packages' file lists: every module of the JAX
    package has the port's module of the same name."""
    ref = ROOT / "src" / "repro"
    missing = [str(f.relative_to(ref)) for f in sorted(ref.rglob("*.py"))
               if not (PORT / f.relative_to(ref)).exists()]
    assert missing == []
