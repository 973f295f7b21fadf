"""ResNet image classification on accelerate_tpu_torch: the JAX package's
CV example (examples/cv_example.py) line for line on the PyTorch port, on
one CUDA card.

    python examples/torch_cv_example.py                 # ResNet-50, 37 classes, 224 px, bf16
    python examples/torch_cv_example.py --tiny --cpu    # tiny config at 32 px on the CPU

The data is a synthetic pets-shaped set made from a numpy seed (nothing is
downloaded): each of 37 classes has its own colour bias under noise, so
accuracy means something. The loop is the reference's shape:
Accelerator() -> prepare() -> one-cycle schedule -> has_state train step
(BatchNorm statistics) -> eval on the running statistics with
gather_for_metrics. SGD with momentum 0.9 stands in for ``optax.sgd``;
:func:`onecycle_schedule` gives ``optax.cosine_onecycle_schedule``'s
values. Trackers are not ported yet (ROADMAP.md Queue 1 item 9), so the
numbers the reference logs are printed.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, ResNetConfig, create_resnet_model, resnet_classification_loss
from accelerate_tpu_torch.data_loader import prepare_data_loader


class SyntheticPets:
    """Pets-shaped synthetic data: each class gets a characteristic colour
    bias plus noise, so accuracy is a meaningful signal."""

    def __init__(self, n=1024, image_size=224, num_classes=37, seed=0):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
        means = rng.normal(0.0, 1.0, size=(num_classes, 3)).astype(np.float32)
        noise = rng.normal(0.0, 0.5, size=(n, image_size, image_size, 3)).astype(np.float32)
        self.images = noise + means[self.labels][:, None, None, :]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"images": self.images[i], "labels": self.labels[i]}


def onecycle_schedule(total_steps: int, peak_value: float, pct_start: float = 0.25, div_factor: float = 25.0,
                      final_div_factor: float = 1e4):
    """``step -> lr`` with the values of ``optax.cosine_onecycle_schedule``:
    cosine from ``peak / div_factor`` up to ``peak`` over the first
    ``int(pct_start * total)`` steps, then cosine down to ``peak /
    (div_factor * final_div_factor)`` at ``total``, flat after."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [peak_value / div_factor, peak_value, peak_value / (div_factor * final_div_factor)]

    def schedule(step: int) -> float:
        if step >= bounds[-1]:
            return values[-1]
        i = 0 if step < bounds[1] else 1
        pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
        return values[i + 1] + (values[i] - values[i + 1]) / 2 * (math.cos(math.pi * pct) + 1)

    return schedule


def evaluate(accelerator, eval_step, loader):
    """One pass over ``loader`` on the running statistics: ``(correct,
    total)``, the padded rows of a short last batch dropped by
    ``gather_for_metrics``."""
    correct = total = 0
    for batch in loader:
        logits = eval_step(batch["images"])
        preds = accelerator.gather_for_metrics(logits.argmax(-1))
        labels = accelerator.gather_for_metrics(batch["labels"])
        correct += int((preds == labels).sum())
        total += len(labels)
    return correct, total


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=None, help="default: 3e-2 (one-cycle peak)")
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--tiny", action="store_true", help="tiny config for CI")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--checkpoint_dir", default=None)
    args = parser.parse_args(argv)

    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)

    if args.tiny:
        args.image_size = min(args.image_size, 32)
    config = ResNetConfig.tiny() if args.tiny else ResNetConfig.resnet50(num_classes=37)
    dataset = SyntheticPets(n=256 if args.tiny else 1024, image_size=args.image_size, num_classes=config.num_classes)
    loader = prepare_data_loader(
        dataset,
        batch_size=max(1, args.batch_size // accelerator.num_data_shards),
        shuffle=True,
        seed=42,
        drop_last=True,
    )

    model = create_resnet_model(config, image_size=args.image_size, device=accelerator.device)
    total_steps = max(1, args.num_epochs * len(loader))
    peak_lr = args.lr if args.lr is not None else (1e-1 if args.tiny else 3e-2)
    optimizer = torch.optim.SGD(model.module.parameters(), lr=peak_lr, momentum=0.9)
    schedule = onecycle_schedule(total_steps, peak_lr, pct_start=0.25)

    model, optimizer, loader, schedule = accelerator.prepare(model, optimizer, loader, schedule)
    loss_fn = lambda p, s, b: resnet_classification_loss(p, s, b, model.apply_fn)  # noqa: E731
    step = accelerator.build_train_step(loss_fn, has_state=True)
    eval_step = accelerator.build_eval_step(lambda p, s, x: model.apply_fn(p, x, s, train=False))

    for epoch in range(args.num_epochs):
        t0, n_samples = time.perf_counter(), 0
        for batch in loader:
            loss = step(batch)
            n_samples += batch["images"].shape[0]
        loss = float(loss)  # waits for the card
        dt = time.perf_counter() - t0
        accelerator.print(f"epoch {epoch}: loss={loss:.4f} {n_samples / dt:.1f} samples/s")

        # eval with the running BatchNorm statistics and padded-tail truncation
        correct, total = evaluate(accelerator, eval_step, loader)
        accelerator.print(f"epoch {epoch}: accuracy={correct / total:.3f} ({total} samples)")

    if args.checkpoint_dir:
        accelerator.save_state(args.checkpoint_dir)
    accelerator.end_training()
    return correct / total


if __name__ == "__main__":
    main()
