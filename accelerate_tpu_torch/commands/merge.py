"""``merge-weights``: a checkpoint's model as a standalone safetensors export.

Counterpart of :mod:`accelerate_tpu.commands.merge`. A checkpoint written
by ``save_state`` already holds the whole model in one file
(``model/model.safetensors``); this reads it and writes it out again
through :func:`~accelerate_tpu_torch.checkpointing.save_model`, split into
shards of at most ``--max_shard_size`` with an index when it is larger.
Every tensor keeps its name, dtype and bytes.

Example::

    python -m accelerate_tpu_torch.commands.cli merge-weights runs/x/checkpoints/checkpoint_3 out --max_shard_size 2GB
"""

from __future__ import annotations

import argparse


def merge_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("merge-weights", help="Merge a sharded checkpoint into safetensors")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch merge-weights")
    parser.add_argument("checkpoint_dir", help="directory produced by Accelerator.save_state")
    parser.add_argument("output_dir")
    parser.add_argument("--max_shard_size", default="10GB")
    if subparsers is not None:
        parser.set_defaults(func=merge_command)
    return parser


def merge_command(args) -> int:
    from pathlib import Path
    from types import SimpleNamespace

    from ..checkpointing import MODEL_FILE, MODEL_NAME, save_model
    from ..utils import safetensors_io

    model_path = Path(args.checkpoint_dir) / MODEL_NAME
    if not model_path.exists():
        raise FileNotFoundError(f"no model checkpoint at {model_path}")
    state = safetensors_io.load_file(str(model_path / MODEL_FILE))
    # save_model reads a model's state_dict() and nothing else
    save_model(SimpleNamespace(state_dict=lambda: state), args.output_dir, max_shard_size=args.max_shard_size)
    print(f"Merged weights written to {args.output_dir}")
    return 0


def main():
    raise SystemExit(merge_command(merge_parser().parse_args()))


if __name__ == "__main__":
    main()
