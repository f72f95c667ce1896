"""``python -m superviseddescent_tpu_torch.probes [--device cpu] [--seed N]``:
run every probe at the scripts' shapes and print one line per variant."""

import argparse
import subprocess

import torch

from superviseddescent_tpu_torch.probes import run_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the plain twins, untimed")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.device != "cpu" and torch.cuda.is_available():
        print(torch.cuda.get_device_name(0), flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    run_all(device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
