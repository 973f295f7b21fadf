"""Package rules of accelerate_tpu_torch: it imports nothing of jax or of
the JAX package, its entry points run on CUDA unless the CPU is asked for,
and its kernel wrapper takes the plain version only for CPU tensors."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import accelerate_tpu_torch
from accelerate_tpu_torch import (
    Accelerator,
    LlamaConfig,
    QuantizationConfig,
    ServingEngine,
    create_llama_model,
    load_and_quantize_model,
)
from accelerate_tpu_torch.kernels import build, reference
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops import qmatmul
from accelerate_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)

PKG = pathlib.Path(accelerate_tpu_torch.__file__).parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _module_names():
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(REPO).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_every_module_loads_no_jax():
    modules = sorted(_module_names())
    code = (
        "import importlib, sys\n"
        f"for m in {[*modules, 'chip_smoke']!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("serving", "accelerator", "ops.flash_attention", "state", "optimizer", "scheduler", "generation",
                 "utils.quantization", "ops.qmatmul", "ops.qdense", "kernels.contracts", "kernels.reference",
                 "kernels.launch", "kernels.fixtures", "analysis", "analysis.rules", "analysis.report",
                 "analysis.costmodel", "analysis.perfmodel", "analysis.kernelmodel", "analysis.kernel_rules",
                 "analysis.selfcheck", "analysis.changed", "commands.kernelcheck", "data_loader",
                 "utils.operations", "models.bert", "models.convert"):
        assert f"accelerate_tpu_torch.{name}" in modules


def test_no_source_imports_jax():
    """Neither the package, nor the script that drives it on the card
    (chip_smoke.py), nor its example imports jax or the JAX package."""
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py", REPO / "examples" / "torch_nlp_example.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    model = create_llama_model(LlamaConfig.tiny(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_llama_model(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, paged_block_size=4)
    # a quantized model is no exception: without a card and without device="cpu" nothing runs
    qmodel = load_and_quantize_model(model, QuantizationConfig(method="int4", group_size=32))
    assert qmodel.device.type == "cpu"  # it lives where the float model lived
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(qmodel, paged_block_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_llama_model(LlamaConfig.tiny(quant_method="int4", quant_group_size=32))


def test_data_path_and_example_refuse_to_run_without_cuda(monkeypatch):
    """Without a card, neither ``Accelerator().prepare(loader)``, nor a loader
    made outside an Accelerator, nor the BERT example runs unless the CPU is
    asked for; asked, they run there."""
    import importlib.util

    from accelerate_tpu_torch import prepare_data_loader
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    rows = [{"x": torch.full((2,), float(i))} for i in range(5)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Accelerator().prepare(rows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_data_loader(rows, batch_size=2)
    spec = importlib.util.spec_from_file_location("torch_nlp_example", REPO / "examples" / "torch_nlp_example.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--tiny"])
    loader = Accelerator(cpu=True).prepare(rows)
    assert [b["x"].device.type for b in loader] == ["cpu"] * 5
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def test_quantized_model_cannot_be_prepared_for_training():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    model = create_llama_model(LlamaConfig.tiny(), device="cpu")
    qmodel = load_and_quantize_model(model, QuantizationConfig(method="int8"))
    with pytest.raises(NotImplementedError, match="quantized"):
        Accelerator(cpu=True).prepare_model(qmodel)
    assert not any(p.requires_grad for p in qmodel.module.parameters())


def test_new_kernel_wrappers_take_plain_versions_on_cpu_only():
    """K5-K7 on CPU tensors compute their plain versions and launch
    nothing; the kernel libraries are never asked for."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 128, generator=gen)
    packed = torch.randint(0, 256, (2, 32, 128), generator=gen, dtype=torch.uint8)
    scale = torch.rand(2, 1, 128, generator=gen)
    before = (qmatmul.launches, reference.launches_matmul_softmax, reference.launches_accumulate)
    got = qmatmul.int4_matmul(x, packed, scale, group_size=64)
    torch.testing.assert_close(got, qmatmul.int4_matmul_plain(x, packed, scale, group_size=64), rtol=0, atol=0)
    w = torch.randn(128, 40, generator=gen)
    soft = reference.block_matmul_softmax(torch.randn(8, 128, generator=gen), w)
    assert soft.shape == (8, 40)
    acc = torch.zeros(8, 40)
    assert reference.block_accumulate(acc, soft) is acc and torch.equal(acc, soft)
    assert (qmatmul.launches, reference.launches_matmul_softmax, reference.launches_accumulate) == before
    for name in ("int4_matmul", "reference_kernels", "kernel_fixtures"):
        assert name in build.SIGNATURES and (build.CSRC / f"{name}.cu").exists()


def test_kernel_wrapper_takes_plain_version_on_cpu_only():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 64, generator=gen)
    kp, vp = torch.randn(2, 5, 4, 2, 64, generator=gen).unbind(0)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    cur = torch.tensor([7, 2], dtype=torch.int32)
    before = pa.launches
    got = pa.paged_decode_attention(q, kp, vp, table, cur)
    assert pa.launches == before
    torch.testing.assert_close(got, pa.paged_decode_attention_plain(q, kp, vp, table, cur), rtol=0, atol=0)
    # any other device is refused, never computed on the plain path
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_decode_attention(*(t.to("meta") for t in (q, kp, vp, table, cur)))
    assert pa.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_attention")


def test_flash_path_is_not_quietly_replaced():
    """On the CPU an explicit use_flash=True computes the kernels' plain
    version (what the einsum path gives, within f32 rounding) and launches
    nothing; a tensor on any other device is refused, never computed, and
    touches no counter either."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 70, 4, 64, generator=gen)
    k, v = torch.randn(2, 2, 70, 2, 64, generator=gen).unbind(0)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    got = dot_product_attention(q, k, v, causal=True, use_flash=True)
    want = dot_product_attention(q, k, v, causal=True, use_flash=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        dot_product_attention(*(t.to("meta") for t in (q, k, v)), causal=True, use_flash=True)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before


@pytest.mark.parametrize(
    "knob", [{"qk_norm": True}, {"sandwich_norm": True}, {"attn_logit_softcap": 50.0},
             {"layer_types": ("full_attention",) * 2}, {"qkv_bias": True}]
)
def test_unported_llama_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_llama_model(LlamaConfig.tiny(**knob), device="cpu")


def test_chip_smoke_refuses_without_the_card_or_the_package(tmp_path):
    """chip_smoke.py fails, and prints no result, off the GPU and in a
    directory holding nothing else of the repository."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {**os.environ, "PYTHONPATH": ""}
    runs = [(lone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((REPO / "chip_smoke.py", REPO))
    for script, cwd in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
