"""The port's weight-only quantization (accelerate_tpu_torch.utils.quantization,
ops.qmatmul, ops.qdense, models.llama.quantize_llama_model) against the JAX
package's on the same numpy inputs, f32 on the CPU: equal codes, scales
within one f32 ulp, the fused int4 product's plain version against the
Pallas kernel in interpret mode, QuantDense against the flax module, and a
tiny quantized Llama whose weights are carried across."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import accelerate_tpu.utils.quantization as jq
from accelerate_tpu.modeling import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.ops.pallas_qmatmul import int4_matmul as jax_int4_matmul
from accelerate_tpu.ops.qdense import QuantDense as JaxQuantDense
from accelerate_tpu_torch import (
    LlamaConfig,
    QuantDense,
    QuantizationConfig,
    create_llama_model,
    llama_params_from_jax,
    load_and_quantize_model,
)
from accelerate_tpu_torch.modeling import Model
from accelerate_tpu_torch.ops import qmatmul
from accelerate_tpu_torch.utils import quantization as tq

torch.set_num_threads(2)

NEEDS_CARD = "needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)"


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _configs(method, group_size):
    kw = dict(method=method, group_size=group_size, bits=8 if method in ("int8", "w8a8") else 4)
    return jq.QuantizationConfig(**kw), QuantizationConfig(**kw)


def _assert_same_qtensor(got, want):
    """Codes equal, scales within one f32 ulp."""
    assert got.data.dtype == {np.dtype("int8"): torch.int8, np.dtype("uint8"): torch.uint8}[np.asarray(want.data).dtype]
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    ws = np.asarray(want.scale)
    assert got.scale.dtype == torch.float32 and got.scale.shape == ws.shape
    assert np.all(np.abs(got.scale.numpy() - ws) <= np.spacing(ws))


QUANT_CASES = [
    ("int8", None, (128, 64)), ("int8", 32, (128, 64)), ("w8a8", None, (128, 64)),
    ("int4", None, (128, 64)), ("int4", 32, (128, 64)), ("int4", 64, (256, 128)),
    ("nf4", None, (128, 64)), ("nf4", 16, (128, 64)),
    ("int4", 16, (4, 64, 32)), ("int8", 16, (2, 3, 32, 16)), ("nf4", 16, (64,)), ("int8", None, (64,)),
]


@pytest.mark.parametrize("method,group_size,shape", QUANT_CASES)
def test_quantize_matches_jax(method, group_size, shape):
    jcfg, cfg = _configs(method, group_size)
    w = _w(shape, seed=len(shape))
    w.flat[:3] = [0.0, w.max() / 2, -w.max() / 2]  # a zero and values near rounding ties
    want = jq.quantize(jnp.asarray(w), jcfg)
    got = tq.quantize(torch.tensor(w), cfg)
    _assert_same_qtensor(got, want)
    assert got.shape == tuple(w.shape) and got.method == method and got.nbytes == want.nbytes
    back = tq.dequantize(got)
    assert back.shape == tuple(w.shape) and back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), np.asarray(jq.dequantize(want)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.dequantize(torch.bfloat16).float().numpy(),
                               np.asarray(want.dequantize(jnp.bfloat16).astype(jnp.float32)), atol=1e-6, rtol=0)


def test_quantize_all_zero_group_and_pack_roundtrip():
    w = _w((64, 8), seed=5)
    w[:32] = 0.0  # a whole group of zeros: scale clamps at 1e-12
    _, cfg = _configs("int4", 32)
    qt = tq.quantize(torch.tensor(w), cfg)
    _assert_same_qtensor(qt, jq.quantize(jnp.asarray(w), _configs("int4", 32)[0]))
    assert torch.all(tq.dequantize(qt)[:32] == 0)
    codes = torch.randint(0, 16, (3, 8, 5))
    assert torch.equal(tq._unpack4(tq._pack4(codes)), codes)
    packed = tq._pack4(codes)
    assert torch.equal(packed[:, 0] & 0x0F, codes[:, 0].to(torch.uint8))  # row 2r in the low nibble
    assert torch.equal(packed[:, 0] >> 4, codes[:, 1].to(torch.uint8))
    with pytest.raises(ValueError, match="even"):
        tq._pack4(torch.zeros(3, 5, dtype=torch.int8))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(bits=3), "bits must be 8 or 4"),
        (dict(method="int2"), "method must be"),
        (dict(method="int8", bits=4), "requires bits=8"),
        (dict(method="w8a8", bits=4), "requires bits=8"),
        (dict(method="w8a8", group_size=32), "group_size=None"),
    ],
)
def test_quantization_config_rejects_what_jax_rejects(kw, match):
    with pytest.raises(ValueError):
        jq.QuantizationConfig(**kw)
    with pytest.raises(ValueError, match=match):
        QuantizationConfig(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(bits=4), dict(method="int4"), dict(method="nf4", bits=8), dict(method="w8a8")])
def test_quantization_config_defaults_match_jax(kw):
    assert dataclasses.asdict(QuantizationConfig(**kw)) == dataclasses.asdict(jq.QuantizationConfig(**kw))


def test_quantize_rejects_indivisible_group():
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize(torch.zeros(100, 8), QuantizationConfig(method="int4", group_size=32))


def test_quantize_params_selects_skips_and_counts_bytes_as_jax():
    tree = {
        "embed_tokens": {"embedding": _w((100, 64))},
        "layer_0": {"mlp": {"kernel": _w((64, 128), 1)}, "norm": {"scale": np.ones(64, np.float32)}},
        "tiny": _w((4, 4), 2),
        "ids": np.arange(8192, dtype=np.int32).reshape(64, 128),
    }
    jcfg, cfg = _configs("int4", 32)
    want = jq.quantize_params(jax.tree.map(jnp.asarray, tree), jcfg)
    got = tq.quantize_params(jax.tree.map(torch.tensor, tree), cfg)
    assert isinstance(got["layer_0"]["mlp"]["kernel"], tq.QTensor)
    _assert_same_qtensor(got["layer_0"]["mlp"]["kernel"], want["layer_0"]["mlp"]["kernel"])
    for path in (("embed_tokens", "embedding"), ("layer_0", "norm", "scale"), ("tiny",), ("ids",)):
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        assert isinstance(g, torch.Tensor) and not isinstance(w, jq.QTensor)
    assert tq.quantized_bytes(got) == jq.quantized_bytes(want)
    back = tq.dequantize_params(got)
    assert back["layer_0"]["mlp"]["kernel"].shape == (64, 128) and back["tiny"] is got["tiny"]


@pytest.mark.parametrize("method,group_size", [("int8", None), ("int8", 32), ("nf4", 32), ("int4", 64)])
def test_quantized_matmul_matches_jax(method, group_size):
    jcfg, cfg = _configs(method, group_size)
    w, x = _w((128, 64)), _w((8, 128), seed=2, scale=1.0)
    want = jq.quantized_matmul(jnp.asarray(x), jq.quantize(jnp.asarray(w), jcfg))
    got = tq.quantized_matmul(torch.tensor(x), tq.quantize(torch.tensor(w), cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---- K5: the fused int4 dequantize + matmul ---------------------------------

INT4_CASES = [(1, 128, 256, 64), (4, 256, 384, 128), (3, 256, 128, 64), (9, 256, 128, 128), (8, 512, 128, 256)]


def _int4_inputs(b, infeat, out, g, seed=11):
    w = _w((infeat, out), seed=seed)
    x = _w((b, infeat), seed=seed + 1, scale=1.0)
    qt = jq.quantize(jnp.asarray(w), jq.QuantizationConfig(bits=4, method="int4", group_size=g))
    return x, qt


@pytest.mark.parametrize("b,infeat,out,g", INT4_CASES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2), ("float16", 1e-2)])
def test_int4_matmul_plain_matches_pallas_interpret(b, infeat, out, g, dtype, tol):
    """The port's plain version against the Pallas kernel in interpret mode:
    within ``tol`` of max |ref| (in bf16/fp16 both round their result to the
    type; with f32 x only the summation order differs)."""
    x, qt = _int4_inputs(b, infeat, out, g)
    want = jax_int4_matmul(jnp.asarray(x).astype(dtype), qt.data, qt.scale, group_size=g, interpret=True)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    packed, scale = torch.tensor(np.asarray(qt.data)), torch.tensor(np.asarray(qt.scale))
    got = qmatmul.int4_matmul(tx, packed, scale, group_size=g)  # CPU tensors: the plain version
    assert got.dtype == tx.dtype and got.shape == (b, out)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    # and the product is what dequantize-then-matmul gives, to the rounding of x to bf16
    ref = x @ np.asarray(jq.dequantize(qt, jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_int4_matmul_rejects_bad_shapes_as_jax():
    w = _w((128, 256), seed=13)
    x = torch.ones(1, 128, dtype=torch.bfloat16)
    for g, out, match in ((32, 256, "multiple of 64"), (64, 192, "divide by 128")):
        qt = jq.quantize(jnp.asarray(w[:, :out]), jq.QuantizationConfig(bits=4, method="int4", group_size=g))
        with pytest.raises(ValueError):
            jax_int4_matmul(jnp.ones((1, 128), jnp.bfloat16), qt.data, qt.scale, group_size=g, interpret=True)
        with pytest.raises(ValueError, match=match):
            qmatmul.int4_matmul(x, torch.tensor(np.asarray(qt.data)), torch.tensor(np.asarray(qt.scale)), group_size=g)
    qt = jq.quantize(jnp.asarray(w), jq.QuantizationConfig(bits=4, method="int4", group_size=64))
    packed, scale = torch.tensor(np.asarray(qt.data)), torch.tensor(np.asarray(qt.scale))
    with pytest.raises(ValueError, match="inconsistent"):
        qmatmul.int4_matmul(x, packed, scale, group_size=128)
    with pytest.raises(ValueError, match="inconsistent"):
        qmatmul.int4_matmul(torch.ones(1, 256), packed, scale, group_size=64)
    with pytest.raises(ValueError, match="scale shape"):
        qmatmul.int4_matmul(x, packed, scale[:1], group_size=64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qmatmul.int4_matmul(x.to("meta"), packed.to("meta"), scale.to("meta"), group_size=64)


@pytest.mark.parametrize(
    "m,n_groups,out",
    [(8, 16, 2048), (8, 16, 256), (8, 16, 5632), (8, 44, 2048), (1, 2, 128), (64, 16, 5632), (256, 44, 2048),
     (256, 16, 5632), (17, 3, 384)],
)
def test_int4_split_plan_covers_every_group(m, n_groups, out):
    """The launch plan is a function of the shapes alone; its splits are
    whole groups, none empty, and together they cover the contraction. M
    up to 16 takes the decode kernel (16 or 32 columns, 1-4 warps a block, no
    more warps than a split has groups), larger M the prefill kernel."""
    plan = qmatmul._split_plan(m, n_groups, out)
    assert plan == qmatmul._split_plan(m, n_groups, out)
    assert (plan.splits - 1) * plan.groups_per_split < n_groups <= plan.splits * plan.groups_per_split
    if m <= qmatmul.DECODE_ROWS:
        assert plan.m_tiles == 1 and plan.columns in (16, 32) and out % plan.columns == 0
        assert 1 <= plan.warps <= min(4, plan.groups_per_split)
        assert plan.grid(m, out) == (out // plan.columns, plan.splits)
    else:
        assert plan.m_tiles in (2, 4) and (plan.m_tiles == 4 or m <= 16 * plan.m_tiles)
        assert plan.columns == qmatmul.N_TILE and plan.warps == 4 and 1 <= plan.splits <= 8
        assert plan.grid(m, out) == (out // 128, plan.splits, -(-m // (16 * plan.m_tiles)))


TINYLLAMA_PROJECTIONS = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]  # q/o, k/v, gate/up, down


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("infeat,out", TINYLLAMA_PROJECTIONS)
def test_int4_decode_plan_fills_the_card(infeat, out, m):
    """At decode batches every TinyLlama projection (int4, groups of 128)
    runs at least one block for each of the H100's 132 SMs."""
    plan = qmatmul._split_plan(m, infeat // 128, out)
    blocks = int(np.prod(plan.grid(m, out)))
    assert blocks >= 132, (plan, blocks)


@pytest.mark.parametrize("infeat,out", TINYLLAMA_PROJECTIONS)
def test_int4_decode_plan_is_one_for_every_decode_batch(infeat, out):
    """The decode plan depends on the weight's shape alone: every M from 1
    to 16 launches the same grid, so a row sums in the same order whatever
    else is in the batch."""
    plans = {qmatmul._split_plan(m, infeat // 128, out) for m in range(1, 17)}
    assert len(plans) == 1


def test_int4_supported_mirrors_the_reference_gate():
    x = torch.zeros(2, 128)
    assert not qmatmul.int4_supported(x, "int4", 64, 2, 256)  # a CPU tensor never takes the kernel
    meta = x.to("meta")
    for method, g, feats in (("nf4", 64, 256), ("int4", None, 256), ("int4", 32, 256), ("int4", 64, 192)):
        assert not qmatmul.int4_supported(meta, method, g, 2, feats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2), (torch.float16, 2e-3)])
def test_cuda_int4_kernel_matches_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    for b, infeat, out, g in INT4_CASES + [(100, 512, 384, 128)]:
        x, qt = _int4_inputs(b, infeat, out, g)
        args = (torch.tensor(x).cuda().to(dtype), torch.tensor(np.asarray(qt.data)).cuda(),
                torch.tensor(np.asarray(qt.scale)).cuda())
        before = qmatmul.launches
        got = qmatmul.int4_matmul(*args, group_size=g)
        torch.cuda.synchronize()
        assert qmatmul.launches == before + 1
        want = qmatmul.int4_matmul_plain(*args, group_size=g).float()
        assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,infeat,out", [(8, 2048, 256), (8, 5632, 2048), (64, 2048, 256)])
def test_cuda_int4_kernel_joins_splits_bit_exactly(b, infeat, out):
    """Shapes whose plan has several splits (the decode kernel at M 8, the
    prefill kernel at M 64): the kernel's one launch joins them, agrees with
    the plain version, and two calls on the same inputs are bit-equal (the
    splits are summed in split order, whichever block finishes last)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    assert qmatmul._split_plan(b, infeat // 128, out).splits > 1
    x, qt = _int4_inputs(b, infeat, out, 128)
    args = (torch.tensor(x).cuda().to(torch.bfloat16), torch.tensor(np.asarray(qt.data)).cuda(),
            torch.tensor(np.asarray(qt.scale)).cuda())
    before = qmatmul.launches
    got = qmatmul.int4_matmul(*args, group_size=128)
    again = qmatmul.int4_matmul(*args, group_size=128)
    torch.cuda.synchronize()
    assert qmatmul.launches == before + 2
    assert torch.equal(got, again)
    want = qmatmul.int4_matmul_plain(*args, group_size=128).float()
    assert (got.float() - want).abs().max().item() <= 1e-2 * want.abs().max().item()


# ---- QuantDense -------------------------------------------------------------

DENSE_CASES = [("int8", None), ("int8", 16), ("w8a8", None), ("int4", None), ("int4", 64), ("nf4", 16)]


@pytest.mark.parametrize("method,group_size", DENSE_CASES)
def test_qdense_matches_flax_module(method, group_size):
    jcfg, _ = _configs(method, group_size)
    w, x = _w((128, 256), seed=7), _w((2, 3, 128), seed=8, scale=1.0)
    qt = jq.quantize(jnp.asarray(w), jcfg)
    want = JaxQuantDense(256, method=method, group_size=group_size, dtype=jnp.float32).apply(
        {"params": {"qdata": qt.data, "qscale": qt.scale}}, jnp.asarray(x)
    )
    layer = QuantDense(128, 256, method=method, group_size=group_size)
    assert layer.qdata.shape == tuple(qt.data.shape) and layer.qscale.shape == tuple(qt.scale.shape)
    assert not any(p.requires_grad for p in layer.parameters())
    assert torch.all(layer.qdata == 0) and torch.all(layer.qscale == 1)  # the reference's fresh init
    layer.load_state_dict({"qdata": torch.tensor(np.asarray(qt.data)), "qscale": torch.tensor(np.asarray(qt.scale))})
    got = layer(torch.tensor(x))
    assert got.shape == (2, 3, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_qdense_bias_dtype_and_bad_arguments():
    layer = QuantDense(64, 32, method="int8", use_bias=True, dtype=torch.float32)
    with torch.no_grad():
        layer.bias.fill_(0.5)
    out = layer(torch.ones(2, 64, dtype=torch.bfloat16))
    assert out.dtype == torch.float32 and torch.all(out == 0.5)  # zero codes: the bias alone
    for kw, match in ((dict(method="fp4"), "method must be"), (dict(method="int4", group_size=48), "not divisible"),
                      (dict(method="w8a8", group_size=32), "per-channel"), (dict(method="nf4", group_size=1), "even")):
        with pytest.raises(ValueError, match=match):
            QuantDense(64, 32, **kw)
    with pytest.raises(ValueError, match="in_features"):
        layer(torch.ones(2, 32))


# ---- the slice: a quantized tiny Llama ---------------------------------------

LLAMA_CASES = [("int4", 64), ("int8", None), ("nf4", 16), ("w8a8", None)]


def _quantized_pair(method, group_size, **tiny_kw):
    """A JAX tiny llama quantized by the JAX package, the port's llama
    carrying its codes, and the float pair they came from."""
    jcfg_q, cfg_q = _configs(method, group_size)
    jmodel = jax_create_llama_model(JaxLlamaConfig.tiny(hidden_size=128, intermediate_size=256, **tiny_kw), seed=1, seq_len=16)
    jqmodel = jq.load_and_quantize_model(jmodel, jcfg_q)
    qcfg = LlamaConfig(**dataclasses.asdict(jqmodel.config))
    qmodel = create_llama_model(qcfg, device="cpu")
    qmodel.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jqmodel.params), qcfg))
    fcfg = LlamaConfig(**dataclasses.asdict(jmodel.config))
    fmodel = create_llama_model(fcfg, device="cpu")
    fmodel.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), fcfg))
    return jqmodel, qmodel, fmodel, cfg_q


# w8a8 rounds its activations to int8 in every projection, so a last-bit
# difference in an activation that sits on a rounding tie flips a code and
# moves logits by a few hundredths: it is held to 1e-4 in the scanned layout
# only (QuantDense's own w8a8 test holds the arithmetic)
@pytest.mark.parametrize(
    "method,group_size,scan_layers",
    [(*case, True) for case in LLAMA_CASES] + [(*case, False) for case in LLAMA_CASES if case[0] != "w8a8"],
)
def test_quantized_llama_logits_match_jax(method, group_size, scan_layers):
    jqmodel, qmodel, fmodel, cfg_q = _quantized_pair(method, group_size, scan_layers=scan_layers)
    assert qmodel.config.quant_method == method
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 12)).astype(np.int32)
    want = np.asarray(jqmodel.apply_fn(jqmodel.params, ids))
    got = qmodel(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the port's own load_and_quantize_model on the same float weights: the same state dict
    own = load_and_quantize_model(fmodel, cfg_q)
    assert own.config.quant_method == method and own.config.quant_group_size == group_size
    carried, made = qmodel.state_dict(), own.state_dict()
    assert carried.keys() == made.keys()
    for key, t in carried.items():
        assert made[key].dtype == t.dtype, key
        if t.is_floating_point():
            assert torch.all((made[key] - t).abs() <= torch.from_numpy(np.spacing(np.abs(t.numpy())))), key
        else:
            assert torch.equal(made[key], t), key
    proj = own.module.layers[0].mlp.down_proj
    assert isinstance(proj, QuantDense) and proj.qdata.dtype == (torch.int8 if method in ("int8", "w8a8") else torch.uint8)
    # the float weight is [out, in] and quantized through a transposed view: the codes must not keep its strides
    assert proj.qdata.is_contiguous() and proj.qscale.is_contiguous()
    assert own.module.embed_tokens.weight.data_ptr() == fmodel.module.embed_tokens.weight.data_ptr()  # shared
    assert tq.quantized_bytes(own.params) == jq.quantized_bytes(jqmodel.params)
    with pytest.raises(ValueError, match="already quantized"):
        load_and_quantize_model(own, cfg_q)


def test_fresh_quantized_llama_has_the_reference_init():
    model = create_llama_model(LlamaConfig.tiny(quant_method="int4", quant_group_size=32), device="cpu", dtype=torch.bfloat16)
    proj = model.module.layers[1].attn.k_proj
    assert proj.qdata.dtype == torch.uint8 and proj.qdata.shape == (2, 16, 32) and torch.all(proj.qdata == 0)
    assert proj.qscale.dtype == torch.float32 and torch.all(proj.qscale == 1)
    assert model.dtype == torch.bfloat16 and model.module.lm_head.weight.dtype == torch.float32
    assert torch.isfinite(model(torch.zeros(1, 4, dtype=torch.int32))).all()


def test_quantized_llama_bf16_stream_equals_a_float_model_of_the_decoded_weights():
    """bf16 stream through QuantDense (the dequantize path on the CPU)
    against a float llama whose projections hold the decoded weights."""
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256)
    fmodel = create_llama_model(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    qmodel = load_and_quantize_model(fmodel, QuantizationConfig(method="int4", group_size=64))
    assert qmodel.dtype == torch.bfloat16 and qmodel.module.layers[0].attn.q_proj.qscale.dtype == torch.float32
    decoded = dict(fmodel.state_dict())
    for name, mod in qmodel.module.named_modules():
        if isinstance(mod, QuantDense):
            w = tq.grouped_dequantize(mod.qdata, mod.qscale, "int4").reshape(mod.in_features, mod.features)
            decoded[f"{name}.weight"] = w.T.to(torch.bfloat16)
    ref = create_llama_model(cfg, seed=4, device="cpu", dtype=torch.bfloat16)
    ref.load_state_dict(decoded)
    ids = torch.tensor(np.random.default_rng(1).integers(0, 256, size=(2, 10)).astype(np.int32))
    want, got = ref(ids), qmodel(ids)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 2e-2  # bf16 sums in another order


class _Mlp(nn.Module):
    """``tanh(x @ w1) @ w2`` with [in, out] weights, as the JAX apply_fn below."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1, self.w2 = nn.Parameter(torch.tensor(w1)), nn.Parameter(torch.tensor(w2))
        self.embed_tokens = nn.Embedding(2, 2)  # Model reads its stream dtype here

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


@pytest.mark.parametrize("method,group_size", [("int8", None), ("nf4", 32)])
def test_load_and_quantize_fallback_wraps_any_other_model(method, group_size):
    """A model that is no llama: the tree is quantized and every call
    dequantizes it, as the JAX package's wrapped apply_fn does."""
    jcfg, cfg = _configs(method, group_size)
    jcfg.compute_dtype = cfg.compute_dtype = "float32"
    w1, w2, x = _w((64, 128), 1), _w((128, 64), 2), _w((4, 64), 3, scale=1.0)
    jmodel = JaxModel(lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"], {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)})
    jqmodel = jq.load_and_quantize_model(jmodel, jcfg)
    want = np.asarray(jqmodel.apply_fn(jqmodel.params, jnp.asarray(x)))
    qmodel = load_and_quantize_model(Model(_Mlp(w1, w2), config=None), cfg)
    assert isinstance(qmodel.params["w1"], tq.QTensor) and isinstance(qmodel.params["embed_tokens.weight"], torch.Tensor)
    _assert_same_qtensor(qmodel.params["w2"], jqmodel.params["w2"])
    np.testing.assert_allclose(qmodel(torch.tensor(x)).detach().numpy(), want, atol=1e-5, rtol=1e-5)
    assert qmodel.device.type == "cpu" and qmodel.dtype == torch.float32
    assert all(p.device.type == "meta" for p in qmodel.module.parameters())  # the float copy is gone
