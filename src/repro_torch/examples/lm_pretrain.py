"""Cloud-side LM pretraining driver (smoke scale): a small llama-family model
trained for a few hundred steps with checkpoint/restart — the datacenter end
of the device-cloud platform (the reference's ``examples/lm_pretrain.py``).

Run on the card (the default) or on the CPU::

    python -m repro_torch.examples.lm_pretrain [--steps 200] [--device cpu]
        [--checkpoint-dir DIR]
"""
import sys

from repro_torch.launch.train import main


def argv(args: list) -> list:
    """The reference example's flags, with ``--steps``, ``--device`` and
    ``--checkpoint-dir`` taken from ``args``."""
    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    return ["--mode", "cloud", "--arch", "llama3_2_3b", "--smoke",
            "--steps", opt("--steps", "200"), "--checkpoint-every", "50",
            "--checkpoint-dir", opt("--checkpoint-dir",
                                    "artifacts/ckpt_example"),
            "--log-every", "10", "--device", opt("--device", "cuda")]


if __name__ == "__main__":
    sys.exit(main(argv(sys.argv[1:])))
