"""Training CLI of the port (counterpart of ``tools/train.py``):

    python -m isfusion_tpu_torch.tools.train CONFIG --work-dir DIR
        [--resume-from CKPT] [--cfg-options k=v ...] [--seed S]
        [--deterministic] [--device cuda|cpu] [--launcher none|pytorch]

Builds the config's detector with weights drawn from ``--seed``, its
``data.train`` dataset, and runs ``apis/train.py:train_model`` on the card
(``--device cpu`` to run on the CPU). ``--launcher pytorch`` (the
reference's flag) trains data-parallel on the ranks ``torchrun`` starts,
one card each (``cuda:LOCAL_RANK``), over the backend of the config's
``dist_params`` (default nccl):

    torchrun --nproc_per_node 2 -m isfusion_tpu_torch.tools.train CONFIG \
        --launcher pytorch [--device cpu --cfg-options \
        dist_params.backend=gloo]
"""
from __future__ import annotations

import argparse
import ast
import logging
import os


def parse_cfg_options(pairs) -> dict:
    """``k=v`` strings -> {dotted key: literal value (else the string)}."""
    opts = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opts[k] = v
    return opts


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a 3D detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value overrides with dotted keys")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--launcher", choices=["none", "pytorch"],
                   default="none", help="pytorch: one rank per process "
                   "started by torchrun")
    return p.parse_args(argv)


def launch(cfg, launcher: str, device):
    """The device to run on: ``device`` with ``--launcher none``, else
    this rank's after joining the process group (backend from
    ``cfg.dist_params``)."""
    if launcher == "none":
        return device
    from ..parallel.mesh import init_distributed
    backend = dict(cfg.get("dist_params", {}) or {}).get("backend", "nccl")
    return init_distributed(backend, device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    from ..apis import init_model, set_random_seed, train_model
    from ..config import Config
    from ..datasets import build_dataset

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    cfg.seed = args.seed
    set_random_seed(args.seed, deterministic=args.deterministic)
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    device = launch(cfg, args.launcher, args.device)
    try:
        model = init_model(cfg, device=device)
        train_model(model, build_dataset(cfg.data["train"]), cfg,
                    work_dir=work_dir, resume_from=args.resume_from,
                    device=device)
    finally:
        if args.launcher == "pytorch":
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
