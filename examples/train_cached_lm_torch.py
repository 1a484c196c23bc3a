"""End-to-end driver (PyTorch port): train an LM for a few hundred steps with
every input byte served through the port's IGTCache (delegates to the port's
launcher, ``repro_torch.launch.train``).

    PYTHONPATH=src python examples/train_cached_lm_torch.py --device cpu

On the H100 drop ``--device cpu`` (the default device is ``cuda``, where every
RMSNorm and flash-attention forward and backward is a hand-written kernel).
Use ``--arch`` for another dense architecture; ``--cache-bundle juicefs``
swaps the cache policy bundle under the SAME training code.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "200",
                "--batch", "4", "--seq", "256"] + argv
    elif "--reduced" not in argv:
        argv = ["--reduced"] + argv
    raise SystemExit(main(argv))
