"""Federated LM training: the cloud model is one of the assigned
architectures (reduced config); client updates flow through DeviceFlow with
top-k + error-feedback compression — the LM-scale SimDC loop (the
reference's ``examples/lm_federation.py``).

Run on the card (the default) or on the CPU::

    python -m repro_torch.examples.lm_federation [--arch llama3_2_3b]
        [--device cpu]
"""
import sys

from repro_torch.launch.train import main


def argv(args: list) -> list:
    """The reference example's flags, with ``--arch`` and ``--device``
    taken from ``args``."""
    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    return ["--mode", "federated", "--arch", opt("--arch", "llama3_2_3b"),
            "--rounds", "5", "--clients-per-round", "8",
            "--traffic", "curve", "--sigma", "1.0",
            "--compress", "--compress-fraction", "0.05",
            "--device", opt("--device", "cuda")]


if __name__ == "__main__":
    sys.exit(main(argv(sys.argv[1:])))
