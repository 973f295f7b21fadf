"""Model factory for the port's process-fleet tests: a Llama whose weights
come from a safetensors file the test wrote once (the JAX package's weights
carried across by ``models/convert.py``), so every worker process holds
the same weights without importing jax. Reached by the workers through
``ProcConfig.worker_env``'s ``PYTHONPATH``; not a test module.

``delay_s`` sleeps before every forward: a tiny model on the CPU decodes a
token in a millisecond or two, and a test that must act on a request while
it is still decoding (cancel it, kill its worker after a snapshot) needs
the stream to last."""

import time

from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model
from accelerate_tpu_torch.utils.safetensors_io import load_file


def llama_from_file(path: str, config: dict, device=None, delay_s: float = 0.0):
    model = create_llama_model(LlamaConfig(**config), device=device)
    model.load_state_dict(load_file(path))
    if delay_s:
        model.module.register_forward_pre_hook(lambda module, args: time.sleep(delay_s))
    return model
