"""Evaluation CLI of the port (counterpart of ``tools/test.py``):

    python -m isfusion_tpu_torch.tools.test CONFIG WORK_DIR --eval bbox
        [--format-only] [--out METRICS.json] [--jsonfile-prefix DIR]
        [--cfg-options k=v ...] [--device cuda|cpu]

Loads the latest checkpoint of WORK_DIR (or the checkpoint file given),
predicts the config's ``data.test`` split (else ``data.val``) on the card
and prints the nuScenes metrics as JSON.
"""
from __future__ import annotations

import argparse
import json

from .train import parse_cfg_options


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
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..apis import init_model, single_device_test
    from ..config import Config
    from ..datasets import build_dataloader, build_dataset

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    model = init_model(cfg, args.checkpoint, device=args.device)
    dataset = build_dataset(cfg.data["test" if "test" in cfg.data
                                     else "val"])
    loader = build_dataloader(
        dataset, samples_per_gpu=int(cfg.data.get("samples_per_gpu", 1)),
        workers_per_gpu=int(cfg.data.get("workers_per_gpu", 0)),
        shuffle=False)
    results = single_device_test(model, loader, device=args.device)
    if args.format_only:
        path, _ = dataset.format_results(results, args.jsonfile_prefix)
        print(f"wrote {path}")
        return {}
    metrics = dataset.evaluate(results, jsonfile_prefix=args.jsonfile_prefix)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
