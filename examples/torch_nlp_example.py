"""BERT-base sequence-classification fine-tune on accelerate_tpu_torch: the
JAX package's canonical example (examples/nlp_example.py) line for line
on the PyTorch port, on one CUDA card.

    python examples/torch_nlp_example.py                 # BERT-base on the card
    python examples/torch_nlp_example.py --tiny --cpu    # tiny config on the CPU

The data is a synthetic MRPC-shaped set made from a numpy seed (nothing is
downloaded): token ids and a label correlated with a planted token, so
accuracy means something. The loop is the reference's shape:
Accelerator() -> prepare() -> train loop -> eval loop with
gather_for_metrics. AdamW with a linear decay stands in for optax's
``adamw(linear_schedule(...))``. Trackers (``log_with``) and
checkpointing are not ported yet (ROADMAP.md Queue 1 items 3 and 9).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, BertConfig, bert_classification_loss, create_bert_model
from accelerate_tpu_torch.data_loader import prepare_data_loader


class SyntheticMRPC:
    """MRPC-shaped synthetic data: pairs encoded as token ids, binary label
    correlated with a learnable signal token so accuracy is meaningful."""

    def __init__(self, n=3668, seq_len=128, vocab_size=30522, seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(5, vocab_size, size=(n, seq_len)).astype(np.int32)
        self.labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
        # plant a signal: label-1 rows get token 4 early in the sequence
        self.ids[self.labels == 1, 3] = 4
        self.mask = np.ones((n, seq_len), np.bool_)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i], "labels": self.labels[i]}


def evaluate(accelerator, eval_step, loader):
    """One pass over ``loader``: ``(correct, total)``, the padded rows of a
    short last batch dropped by ``gather_for_metrics``."""
    correct = total = 0
    for batch in loader:
        logits = eval_step(batch["input_ids"], batch["attention_mask"])
        preds = accelerator.gather_for_metrics(logits.argmax(-1))
        labels = accelerator.gather_for_metrics(batch["labels"])
        correct += int((preds == labels).sum())
        total += len(labels)
    return correct, total


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=None, help="default: 2e-5 (base), 1e-3 (tiny)")
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--tiny", action="store_true", help="tiny config for CI")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)

    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)

    if args.lr is None:
        args.lr = 1e-3 if args.tiny else 2e-5
    config = BertConfig.tiny(num_labels=2) if args.tiny else BertConfig.base()
    dataset = SyntheticMRPC(n=512 if args.tiny else 3668, seq_len=args.seq_len, vocab_size=config.vocab_size)
    model = create_bert_model(config, seq_len=args.seq_len, device=accelerator.device)
    optimizer = torch.optim.AdamW(model.module.parameters(), lr=args.lr, weight_decay=0.01)
    total_steps = args.num_epochs * (len(dataset) // args.batch_size)
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: max(0.0, 1.0 - s / total_steps))

    loader = prepare_data_loader(
        dataset,
        batch_size=max(1, args.batch_size // accelerator.num_data_shards),
        shuffle=True,
        seed=42,
    )
    model, optimizer, loader, schedule = accelerator.prepare(model, optimizer, loader, schedule)

    loss_fn = lambda p, b: bert_classification_loss(p, b, model.apply_fn)  # noqa: E731
    step = accelerator.build_train_step(loss_fn)
    eval_step = accelerator.build_eval_step(lambda p, ids, mask: model.apply_fn(p, ids, mask))

    for epoch in range(args.num_epochs):
        t0, n_samples = time.perf_counter(), 0
        for batch in loader:
            loss = step(batch)
            n_samples += batch["input_ids"].shape[0]
        loss = float(loss)  # waits for the card
        dt = time.perf_counter() - t0
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} {n_samples / dt:.1f} samples/s")

        # eval pass with padded-tail truncation
        correct, total = evaluate(accelerator, eval_step, loader)
        accelerator.print(f"epoch {epoch}: accuracy={correct / total:.3f} ({total} samples)")
    return correct / total


if __name__ == "__main__":
    main()
