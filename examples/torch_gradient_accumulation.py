"""Gradient accumulation with the imperative API on accelerate_tpu_torch:
the counterpart of examples/by_feature/gradient_accumulation.py, on one
CUDA card.

    python examples/torch_gradient_accumulation.py          # on the card
    python examples/torch_gradient_accumulation.py --cpu    # on the CPU

``accumulate()`` buffers the gradients of 4 microbatches and
``optimizer.step()`` applies their mean on the boundary (and at the end of
each pass over the loader). ``build_train_step`` does the same in one
call a microbatch, shown second: both fit y = 2x + 3 from the same
weights and the same batches, and end on the same parameters bit for bit.
"""

from __future__ import annotations

import argparse

import torch

from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin
from accelerate_tpu_torch.test_utils import RegressionDataset, RegressionModel


def make_task(accelerator: Accelerator, batch_size: int = 8, length: int = 256, lr: float = 0.1):
    """model, optimizer, loader and loss for y = 2x + 3 regression."""
    model = RegressionModel()
    optimizer = torch.optim.SGD(model.module.parameters(), lr=lr)
    model, optimizer = accelerator.prepare(model, optimizer)
    loader = accelerator.prepare_data_loader(
        RegressionDataset(length=length, seed=0), batch_size=batch_size, shuffle=True, seed=42
    )

    def loss_fn(params, batch):
        pred = model.apply_fn(params, batch["x"])
        return ((pred - batch["y"]) ** 2).mean()

    return model, optimizer, loader, loss_fn


def final_weights(model) -> tuple[float, float]:
    return model.module.a.item(), model.module.b.item()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)

    accelerator = Accelerator(gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=4), cpu=args.cpu)
    model, optimizer, loader, loss_fn = make_task(accelerator)
    for _ in range(args.epochs):
        for batch in loader:
            with accelerator.accumulate(model):
                accelerator.backward(loss_fn, batch)
                optimizer.step()
                optimizer.zero_grad()
    imperative = final_weights(model)
    accelerator.print(f"imperative path: a={imperative[0]:.3f} (want 2), b={imperative[1]:.3f} (want 3)")
    assert abs(imperative[0] - 2) < 0.3 and abs(imperative[1] - 3) < 0.3

    # the fused path: the same accumulation, one call a microbatch
    accelerator.free_memory()
    accelerator = Accelerator(gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=4), cpu=args.cpu)
    model, optimizer, loader, loss_fn = make_task(accelerator)
    step = accelerator.build_train_step(loss_fn)
    for _ in range(args.epochs):
        for batch in loader:
            step(batch)
    fused = final_weights(model)
    accelerator.print(f"fused path:      a={fused[0]:.3f} (want 2), b={fused[1]:.3f} (want 3)")
    assert fused == imperative, "the two paths apply the same arithmetic"
    return imperative, fused


if __name__ == "__main__":
    main()
