"""BERT for sequence classification: the JAX package's flagship model.

Counterpart of :mod:`accelerate_tpu.models.bert` (the encoder, the [CLS]
pooler and the classifier of the MRPC fine-tune), as an ``nn.Module``
wrapped in :class:`~..modeling.Model`. It keeps the JAX module's numerics:

* every LayerNorm computes in f32 from whatever dtype comes in and casts
  back (flax ``nn.LayerNorm(dtype=jnp.float32)``);
* the attention (:func:`~..ops.attention.dot_product_attention`) masks
  padded keys with the softmax dtype's minimum, so a fully padded row gets
  uniform weights, not NaN; the softmax runs in the policy's
  ``softmax_dtype``;
* GELU is exact (erf);
* the pooler computes in the stream dtype, the classifier in f32 on the
  weights it is given (under bf16 compute, the bf16 copy made f32);
* parameters are named so that ``AutocastKwargs.keep_fp32_patterns``
  keeps f32 exactly what the JAX package keeps f32: the scale and bias of
  every LayerNorm, all named ``...norm...``.

Dropout draws from a ``torch.Generator`` (``rngs={"dropout": generator}``):
each layer draws from a generator seeded from it, so ``remat``
(``torch.utils.checkpoint`` a layer) recomputes the same masks.
``jax.random`` and ``torch.Generator`` never agree, so dropout matches the
JAX package by its properties, not its values. ``BERT_SHARDING_RULES``
waits for the mesh (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..utils.environment import resolve_device


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    remat: bool = False

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        """bert-base-uncased: vocab 30522, hidden 768, 12 layers, 12 heads,
        intermediate 3072, 512 positions, 2 token types."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """4-layer test-size config."""
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


def _dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale the kept
    values by ``1 / (1 - rate)``; nothing without a generator."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 from any input dtype, cast back."""
    w, b = norm.weight.float(), norm.bias.float()
    return F.layer_norm(x.float(), norm.normalized_shape, w, b, norm.eps).to(x.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.query, self.key, self.value, self.out = (nn.Linear(h, h) for _ in range(4))

    def forward(self, hidden, attention_mask, rng: Optional[torch.Generator] = None):
        cfg = self.config
        b, s, _ = hidden.shape
        head_dim = cfg.hidden_size // cfg.num_attention_heads

        def split(x):
            return x.view(b, s, cfg.num_attention_heads, head_dim)

        out = dot_product_attention(
            split(self.query(hidden)),
            split(self.key(hidden)),
            split(self.value(hidden)),
            mask=attention_mask[:, None, None, :].bool(),
            dropout_rate=0.0 if rng is None else cfg.attention_probs_dropout_prob,
            dropout_rng=rng,
        )
        out = self.out(out.reshape(b, s, cfg.hidden_size))
        return _dropout(out, cfg.hidden_dropout_prob, rng)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.attention = BertSelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.ffn = nn.ModuleDict({
            "intermediate": nn.Linear(cfg.hidden_size, cfg.intermediate_size),
            "output": nn.Linear(cfg.intermediate_size, cfg.hidden_size),
        })
        self.ffn_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden, attention_mask, seed: Optional[int] = None):
        """``seed`` seeds this layer's dropout generator (None: no dropout)."""
        rng = None if seed is None else torch.Generator(device=hidden.device).manual_seed(seed)
        hidden = _layer_norm(self.attention_norm, hidden + self.attention(hidden, attention_mask, rng))
        ffn = F.gelu(self.ffn["intermediate"](hidden), approximate="none")
        ffn = _dropout(self.ffn["output"](ffn), self.config.hidden_dropout_prob, rng)
        return _layer_norm(self.ffn_norm, hidden + ffn)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, cfg.hidden_size),
            "position_embeddings": nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size),
            "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, cfg.hidden_size),
            "norm": nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps),
        })
        self.layers = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, attention_mask, token_type_ids=None, rng: Optional[torch.Generator] = None):
        emb = self.embeddings
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        hidden = (
            emb["word_embeddings"](input_ids)
            + emb["position_embeddings"](positions)
            + emb["token_type_embeddings"](token_type_ids)
        )
        hidden = _layer_norm(emb["norm"], hidden)
        seeds = [None] * len(self.layers)
        if rng is not None:  # one draw for every layer: a checkpointed layer reseeds the same
            seeds = torch.randint(0, 2**62, (len(self.layers),), generator=rng, device=rng.device).tolist()
        for layer, seed in zip(self.layers, seeds):
            if self.config.remat and torch.is_grad_enabled():
                hidden = checkpoint(layer, hidden, attention_mask, seed, use_reentrant=False)
            else:
                hidden = layer(hidden, attention_mask, seed)
        return hidden


class BertForSequenceClassification(nn.Module):
    """Encoder + [CLS] pooler + classifier (the MRPC fine-tune head)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.encoder = BertEncoder(cfg)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, attention_mask, token_type_ids=None, deterministic: bool = True, rngs=None):
        """Logits ``[B, num_labels]`` in f32. ``deterministic=False`` turns
        dropout on and needs ``rngs={"dropout": torch.Generator}`` on the
        inputs' device."""
        if not deterministic and rngs is None:
            raise ValueError("deterministic=False (dropout on) requires rngs={'dropout': generator}")
        rng = None if deterministic else rngs["dropout"]
        hidden = self.encoder(input_ids, attention_mask, token_type_ids, rng)
        pooled = _dropout(torch.tanh(self.pooler(hidden[:, 0])), self.config.hidden_dropout_prob, rng)
        w, b = self.classifier.weight, self.classifier.bias
        return F.linear(pooled.float(), w.float(), b.float())


def create_bert_model(
    config: Optional[BertConfig] = None,
    seed: int = 0,
    seq_len: int = 128,
    batch_size: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """BERT for classification with seeded random weights on ``device``
    (``cuda`` unless ``"cpu"`` is asked for): linear and embedding weights
    draw ``N(0, 1/fan_in)`` from a ``torch.Generator`` seeded with
    ``seed``, biases start at zero, LayerNorm scales at one. ``seq_len`` and
    ``batch_size`` are the JAX signature's (its init traces a dummy batch);
    here they shape nothing."""
    config = config or BertConfig.base()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = BertForSequenceClassification(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)
            p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()
    return Model(module, config, name="bert")


def bert_classification_loss(params: dict, batch: dict, apply_fn, rng: Optional[torch.Generator] = None):
    """Cross entropy of the classification head (f32 logits and loss), the
    mean over rows, or over the rows ``batch["loss_mask"]`` keeps. With
    ``rng`` (the train step's per-step generator) the model trains with
    dropout; without it the model runs deterministically."""
    logits = apply_fn(
        params,
        batch["input_ids"],
        batch["attention_mask"],
        batch.get("token_type_ids"),
        deterministic=rng is None,
        rngs=None if rng is None else {"dropout": rng},
    )
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, batch["labels"].long()[:, None], dim=-1)[:, 0]
    if "loss_mask" in batch:
        mask = batch["loss_mask"].float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
