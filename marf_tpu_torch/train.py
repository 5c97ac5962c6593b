"""Training entry point of the port (the reference CLI, same flags as the
repository's train.py):

    python -m marf_tpu_torch.train --group=<GROUP> --model=planar --yaml=planar \
        --name=<NAME> --seed=3 --barf_c2f=[0,0.4] --dataset=synthetic

Runs on CUDA device 0; `--cpu` runs on the CPU instead.
"""

import os
import sys

from marf_tpu_torch.utils.console import log


def main(argv=None):
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.utils.config import parse_arguments, save_options_file, set_opt

    log.process(os.getpid())
    log.title("[marf_tpu_torch.train] (PyTorch/CUDA planar bundle-adjusting NeRF)")
    opt = set_opt(opt_cmd=parse_arguments(sys.argv[1:] if argv is None else argv))
    save_options_file(opt)
    if opt.model != "planar":
        raise ValueError(f"unknown model {opt.model!r} (available: planar)")
    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    return m


if __name__ == "__main__":
    main()
