"""Device-cloud serving under a traffic curve: DeviceFlow replays request
arrivals against a batched prefill+decode server (the reference's
``examples/serve_traffic.py``), through the port's ``launch.serve``.

Run on the card (the default) or on the CPU::

    python -m repro_torch.examples.serve_traffic [--device cpu]
"""
import sys

from repro_torch.launch.serve import main


def argv(args: list) -> list:
    """The reference example's four flags, with ``--device`` taken from
    ``args``."""
    device = args[args.index("--device") + 1] if "--device" in args else "cuda"
    return ["--arch", "llama3_2_3b", "--requests", "32", "--batch-size", "4",
            "--sigma", "1.0", "--device", device]


if __name__ == "__main__":
    sys.exit(main(argv(sys.argv[1:])))
