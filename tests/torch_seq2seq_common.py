"""Shared set-up of the encoder-decoder parity tests (test_torch_t5.py,
test_torch_whisper.py, test_torch_seq2seq.py): the JAX package's tiny T5
and Whisper, the port's twins on the same weights (carried by
``t5_params_from_jax`` / ``whisper_params_from_jax``, the norms' scales
and every bias moved off their init so they bite), and seeded inputs made
with numpy. Everything runs on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.models import whisper as jwhisper
import accelerate_tpu_torch.models as pm

SRC, DEC, FRAMES = 10, 7, 16
VOCAB = 256
MELS = 8


def jax_config(family: str, **kw):
    return jt5.T5Config.tiny(**kw) if family == "t5" else jwhisper.WhisperConfig.tiny(**kw)


def port_config(family: str, jcfg):
    cls = pm.T5Config if family == "t5" else pm.WhisperConfig
    return cls(**dataclasses.asdict(jcfg))


@functools.cache
def jax_params(family: str, tied: bool = True):
    """The JAX tiny model's params as numpy, every norm scale and bias moved
    off its init by seeded noise."""
    cfg = jax_config(family, **({} if tied else {"tie_word_embeddings": False}))
    if family == "t5":
        model = jt5.create_t5_model(cfg, seed=1, seq_len=8)
    else:
        model = jwhisper.create_whisper_model(cfg, seed=1, n_frames=FRAMES)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if str(getattr(path[-1], "key", path[-1])) in ("scale", "bias"):
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, model.params)


def jax_model(family: str, tied: bool = True, dtype=None, **kw):
    cfg = jax_config(family, **({} if tied else {"tie_word_embeddings": False}), **kw)
    if family == "t5":
        model = jt5.create_t5_model(cfg, seed=1, seq_len=8)
    else:
        model = jwhisper.create_whisper_model(cfg, seed=1, n_frames=FRAMES)
    model.params = jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), jax_params(family, tied))
    return model


def port_model(family: str, tied: bool = True, dtype=None, **kw):
    import torch

    cfg = port_config(family, jax_config(family, **({} if tied else {"tie_word_embeddings": False}), **kw))
    create = pm.create_t5_model if family == "t5" else pm.create_whisper_model
    convert = pm.t5_params_from_jax if family == "t5" else pm.whisper_params_from_jax
    model = create(cfg, device="cpu", dtype=dtype or torch.float32)
    params = jax_params(family, tied)
    if dtype is not None and dtype != torch.float32:  # the JAX side's rounded values, widened for the loader
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    model.load_state_dict(convert(params, cfg))
    return model


def source(family: str, b: int = 2, seed: int = 0, frames: int = FRAMES) -> np.ndarray:
    """Token ids ``[b, SRC]`` (T5) or log-mel-like features ``[b, frames,
    MELS]`` (Whisper)."""
    rng = np.random.default_rng(seed)
    if family == "t5":
        return rng.integers(2, VOCAB, size=(b, SRC)).astype(np.int32)
    return rng.standard_normal((b, frames, MELS)).astype(np.float32)


def padding_mask(b: int = 2, lengths=(SRC, 6)) -> np.ndarray:
    mask = np.zeros((b, SRC), bool)
    for r, n in enumerate(lengths[:b]):
        mask[r, :n] = True
    return mask


def decoder_ids(b: int = 2, s: int = DEC, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, VOCAB, size=(b, s)).astype(np.int32)
