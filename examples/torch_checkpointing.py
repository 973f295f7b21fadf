"""Save and resume a BERT fine-tune mid-epoch on accelerate_tpu_torch: the
counterpart of examples/by_feature/checkpointing.py on
examples/torch_nlp_example.py's loop, on one CUDA card.

    python examples/torch_checkpointing.py                 # BERT-base on the card
    python examples/torch_checkpointing.py --tiny --cpu    # tiny config on the CPU

It trains part of an epoch, saves the whole state with ``save_state``
(automatic naming under ``--project_dir``, a temporary directory by
default), keeps training, then ``load_state()`` auto-resumes from the
newest checkpoint: the parameters, the optimizer and scheduler, the step,
the RNGs and the loader's position. The interrupted epoch then resumes
through the loader, which skips the batches it had delivered before the
save, and its losses are those of the steps trained after the save.
"""

from __future__ import annotations

import argparse
import importlib.util
import tempfile
from pathlib import Path

import torch

from accelerate_tpu_torch import Accelerator, BertConfig, ProjectConfiguration, bert_classification_loss
from accelerate_tpu_torch import create_bert_model
from accelerate_tpu_torch.data_loader import prepare_data_loader


def _nlp_example():
    """examples/torch_nlp_example.py beside this file, as a module."""
    spec = importlib.util.spec_from_file_location("torch_nlp_example", Path(__file__).with_name("torch_nlp_example.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--save_after", type=int, default=None, help="steps before the save (default: half an epoch)")
    parser.add_argument("--keep_training", type=int, default=3, help="steps taken after the save, then rolled back")
    parser.add_argument("--project_dir", default=None, help="where checkpoints go (default: a temporary directory)")
    parser.add_argument("--tiny", action="store_true", help="tiny config for CI")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)

    with tempfile.TemporaryDirectory() as scratch:
        project = ProjectConfiguration(project_dir=args.project_dir or scratch, automatic_checkpoint_naming=True)
        accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu, project_config=project)
        example = _nlp_example()
        config = BertConfig.tiny(num_labels=2) if args.tiny else BertConfig.base()
        dataset = example.SyntheticMRPC(n=512 if args.tiny else 3668, seq_len=args.seq_len,
                                        vocab_size=config.vocab_size)
        model = create_bert_model(config, seq_len=args.seq_len, device=accelerator.device)
        optimizer = torch.optim.AdamW(model.module.parameters(), lr=1e-3 if args.tiny else 2e-5, weight_decay=0.01)
        total_steps = len(dataset) // args.batch_size
        schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: max(0.0, 1.0 - s / total_steps))
        loader = prepare_data_loader(dataset, batch_size=args.batch_size, shuffle=True, seed=42)
        model, optimizer, loader, schedule = accelerator.prepare(model, optimizer, loader, schedule)
        step = accelerator.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
        n_batches = len(loader)
        save_after = args.save_after if args.save_after is not None else n_batches // 2

        # part of an epoch, then the checkpoint
        it = iter(loader)
        for _ in range(save_after):
            step(next(it))
        saved = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        out = accelerator.save_state()
        accelerator.print(f"saved step {accelerator.step} ({save_after} of {n_batches} batches) to {out}")

        # keep training, remembering what the steps after the save gave
        after_save = [float(step(next(it))) for _ in range(args.keep_training)]
        del it  # as if the run had died here

        # roll back to the newest committed checkpoint and resume the epoch
        accelerator.load_state()
        restored = all(torch.equal(v.detach().cpu(), saved[k]) for k, v in model.state_dict().items())
        assert restored, "load_state must restore every parameter"
        resumed = [float(step(batch)) for batch in loader]  # the loader skips the delivered batches
        assert len(resumed) == n_batches - save_after
        assert resumed[: len(after_save)] == after_save, "the resumed steps repeat the steps after the save"
        accelerator.print(
            f"restored step {save_after}; resumed the epoch with {len(resumed)} batches, "
            f"loss {resumed[-1]:.4f} at step {accelerator.step}"
        )
    return resumed


if __name__ == "__main__":
    main()
