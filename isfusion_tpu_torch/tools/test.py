"""Evaluation CLI of the port (counterpart of ``tools/test.py``):

    python -m isfusion_tpu_torch.tools.test CONFIG WORK_DIR --eval bbox
        [--format-only] [--out METRICS.json] [--jsonfile-prefix DIR]
        [--cfg-options k=v ...] [--device cuda|cpu] [--launcher none|pytorch]

Loads the latest checkpoint of WORK_DIR (or the checkpoint file given),
predicts the config's ``data.test`` split (else ``data.val``) on the card
and prints the nuScenes metrics as JSON. With ``--launcher pytorch``
(under ``torchrun``, as ``tools/train.py``) every rank predicts its rows
of each global batch and rank 0 evaluates, prints and writes.
"""
from __future__ import annotations

import argparse
import json

from .train import launch, parse_cfg_options


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a 3D detector")
    p.add_argument("config")
    p.add_argument("checkpoint", help="checkpoint file or work dir")
    p.add_argument("--eval", nargs="*", default=["bbox"])
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--out", default=None, help="metrics json output path")
    p.add_argument("--jsonfile-prefix", default="results")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value overrides with dotted keys")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--launcher", choices=["none", "pytorch"],
                   default="none")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    device = launch(cfg, args.launcher, args.device)
    try:
        return _test(args, cfg, device)
    finally:
        if args.launcher == "pytorch":
            import torch.distributed as dist
            dist.destroy_process_group()


def _test(args, cfg, device) -> dict:
    from ..apis import init_model, single_device_test
    from ..datasets import build_dataloader, build_dataset
    from ..parallel.mesh import world

    rank, size = world()
    model = init_model(cfg, args.checkpoint, device=device)
    dataset = build_dataset(cfg.data["test" if "test" in cfg.data
                                     else "val"])
    loader = build_dataloader(
        dataset,
        samples_per_gpu=int(cfg.data.get("samples_per_gpu", 1)) * size,
        workers_per_gpu=int(cfg.data.get("workers_per_gpu", 0)),
        shuffle=False)
    results = single_device_test(model, loader, device=device)
    if rank != 0:
        return {}
    if args.format_only:
        path, _ = dataset.format_results(results, args.jsonfile_prefix)
        print(f"wrote {path}")
        return {}
    metrics = dataset.evaluate(results, jsonfile_prefix=args.jsonfile_prefix,
                               device=device)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
