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
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model
from accelerate_tpu_torch.kernels import build
from accelerate_tpu_torch.ops import paged_attention as pa
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
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "accelerate_tpu_torch.serving" in modules


def test_no_source_imports_jax():
    for path in PKG.rglob("*.py"):
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
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(NotImplementedError, match="K1"):
        dot_product_attention(q, q, q, causal=True, use_flash=True)


@pytest.mark.parametrize(
    "knob", [{"qk_norm": True}, {"sandwich_norm": True}, {"attn_logit_softcap": 50.0},
             {"layer_types": ("full_attention",) * 2}, {"quant_method": "int8"}]
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
