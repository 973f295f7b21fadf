"""Package rules of accelerate_tpu_torch: it imports nothing of jax or of
the JAX package, its entry points run on CUDA unless the CPU is asked for,
and its kernel wrapper takes the plain version only for CPU tensors."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
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
                 "utils.operations", "models.bert", "models.convert", "checkpointing", "ft", "ft.manifest",
                 "ft.manager", "ft.topology", "ft.preemption", "ft.crashpoints", "utils.retry",
                 "utils.safetensors_io", "test_utils.fault_injection", "models.resnet", "utils.memory",
                 "test_utils.training", "test_utils.testing", "ops.fp8", "logging", "utils.imports", "tracking",
                 "telemetry", "telemetry.eventlog", "telemetry.step", "telemetry.mfu", "telemetry.nonfinite",
                 "ops.moe", "models.mixtral", "models.qwen3_moe", "models.gpt2", "models.gptneox",
                 "serving_fleet", "scheduling", "telemetry.serving_metrics", "telemetry.summarize", "telemetry.trace",
                 "telemetry.flightrec", "telemetry.critpath", "utils.dataclasses", "serving_transport",
                 "serving_proc", "telemetry.httpd", "commands.serve", "commands.fleet", "commands.trace",
                 "commands.telemetry", "commands.cli", "models.t5", "models.whisper", "ops.kv_cache",
                 "models.vit", "models.clip", "models.unet", "models.vae", "diffusion", "models.hub", "aot",
                 "aot.bucketing", "aot.cache", "aot.program_cache", "commands.compile_cache", "launchers",
                 "utils.environment", "utils.versions", "utils.console", "utils.tqdm", "commands.launch",
                 "commands.config", "commands.menu", "commands.env", "commands.test", "commands.estimate",
                 "commands.checkpoints", "commands.merge", "commands.migrate", "commands.tpu",
                 "test_utils.scripts.test_script"):
        assert f"accelerate_tpu_torch.{name}" in modules


def test_hub_importer_loads_no_jax_and_no_safetensors():
    """The HF importer reads checkpoints with the port's own safetensors
    reader: importing it loads neither jax, nor the JAX package (whose
    ``models/hub.py`` imports jax only lazily), nor the ``safetensors``
    package, which the machine with the card does not have."""
    forbidden = (*FORBIDDEN, "safetensors")
    code = (
        "import sys\n"
        "import accelerate_tpu_torch.models.hub\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {forbidden!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax():
    """Neither the package, nor the script that drives it on the card
    (chip_smoke.py), nor its example imports jax or the JAX package."""
    examples = [REPO / "examples" / name for name in ("torch_nlp_example.py", "torch_checkpointing.py",
                                                      "torch_cv_example.py", "torch_gradient_accumulation.py")]
    scripts = [REPO / "scripts" / name for name in ("torch_handoff_rate.py", "torch_proc_boot.py",
                                                    "torch_sampled_resume.py", "torch_ddim_floor.py",
                                                    "torch_first_build.py")]
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py", *scripts, *examples]
    checked = {p.relative_to(PKG).as_posix() for p in sources if PKG in p.parents}
    assert {"ops/fp8.py", "logging.py", "tracking.py", "utils/imports.py", "telemetry/__init__.py",
            "telemetry/eventlog.py", "telemetry/step.py", "telemetry/mfu.py", "telemetry/nonfinite.py",
            "serving_fleet.py", "scheduling.py", "analysis/costmodel.py", "telemetry/serving_metrics.py",
            "telemetry/summarize.py", "telemetry/trace.py", "telemetry/flightrec.py", "telemetry/critpath.py",
            "utils/dataclasses.py", "test_utils/fault_injection.py", "serving.py", "serving_transport.py",
            "serving_proc.py", "telemetry/httpd.py", "commands/serve.py", "commands/fleet.py", "commands/trace.py",
            "commands/telemetry.py", "commands/cli.py", "models/t5.py", "models/whisper.py", "ops/kv_cache.py",
            "generation.py", "models/convert.py", "models/vit.py", "models/clip.py", "models/unet.py",
            "models/vae.py", "diffusion.py", "models/hub.py", "aot/__init__.py", "aot/bucketing.py",
            "aot/cache.py", "aot/program_cache.py", "commands/compile_cache.py", "launchers.py",
            "utils/environment.py", "utils/versions.py", "utils/console.py", "utils/tqdm.py", "commands/launch.py",
            "commands/config.py", "commands/menu.py", "commands/env.py", "commands/test.py", "commands/estimate.py",
            "commands/checkpoints.py", "commands/merge.py", "commands/migrate.py", "commands/tpu.py",
            "test_utils/scripts/test_script.py"} <= checked
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


# refusals the JAX package makes too (ROADMAP.md: "as the reference does"), and the tracker base class's
# contract; every other NotImplementedError in the port names the Queue 1 item that clears it
REFERENCE_REFUSALS = (
    ("accelerator.py", "L2 global norm"),
    ("ops/kv_cache.py", "softcap"),
    ("ops/paged_kv.py", "bias_fn (T5-style relative bias)"),
    ("serving.py", "softcap"),
    ("serving.py", "speculative"),
    ("serving.py", "preemption does not compose with speculative"),
    ("models/llama.py", "rope_scaling type"),
    ("models/llama.py", "FP8Dense (delayed scaling) has no bias"),
    ("tracking.py", ""),
)


def _message(node) -> str:
    """The string constants of a raise's arguments, f-strings included."""
    return "".join(n.value for n in ast.walk(node) if isinstance(n, ast.Constant) and isinstance(n.value, str))


def test_every_refusal_names_its_queue_1_item():
    unnamed = []
    for path in PKG.rglob("*.py"):
        rel = path.relative_to(PKG).as_posix()
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", None) == "NotImplementedError"):
                continue
            msg = _message(node.exc)
            if "Queue 1 item" in msg or any(rel == f and s in msg for f, s in REFERENCE_REFUSALS):
                continue
            unnamed.append(f"{rel}:{node.lineno}: {msg[:80]!r}")
    assert not unnamed, unnamed


def test_entry_points_refuse_to_run_without_cuda(monkeypatch, tmp_path):
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    model = create_llama_model(LlamaConfig.tiny(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Accelerator(project_dir=str(tmp_path))  # a checkpointing run is no exception
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
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
    for name, argv in (("torch_nlp_example", ["--tiny"]), ("torch_checkpointing", ["--tiny"]),
                       ("torch_cv_example", ["--tiny"]), ("torch_gradient_accumulation", [])):
        spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(argv)
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
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
    "knob", [{"attention_impl": "ring"}, {"attention_impl": "all_to_all"}, {"attn_logit_softcap": 50.0},
             {"sliding_window": 4}, {"layer_types": ("sliding_attention", "full_attention"), "scan_layers": False,
                                     "sliding_window": 4}]
)
def test_unported_llama_knobs_raise(knob):
    """What of the Llama knobs is still queued raises, naming ROADMAP.md:
    context-parallel attention when the model is built. A band, on every
    layer or on the sliding layers of mixed kinds, is served since
    windowed block expiry was ported: the paged engine's greedy tokens
    equal ``generate``'s. A softcap is served by the dense engine layout,
    its greedy tokens equal ``generate``'s, and the paged engine refuses
    it, as the JAX package's does."""
    from accelerate_tpu_torch import ServingEngine, generate

    prompt = np.arange(1, 10, dtype=np.int32)
    if "sliding_window" in knob or "attn_logit_softcap" in knob:
        model = create_llama_model(LlamaConfig.tiny(**knob), device="cpu")
        layout = {} if "attn_logit_softcap" in knob else {"paged_block_size": 4}
        engine = ServingEngine(model, num_slots=1, prompt_buckets=(4,), device="cpu", **layout)
        got = engine.generate_many([prompt], max_new_tokens=6)[0]
        np.testing.assert_array_equal(got, generate(model, prompt[None], max_new_tokens=6)[0].numpy())
        if "attn_logit_softcap" in knob:
            with pytest.raises(NotImplementedError, match="softcapping.*dense engine layout"):
                ServingEngine(model, num_slots=1, prompt_buckets=(4,), paged_block_size=4, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model = create_llama_model(LlamaConfig.tiny(**knob), device="cpu")
        ServingEngine(model, num_slots=1, prompt_buckets=(4,), paged_block_size=4, device="cpu")


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


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_cuda_imperative_loop_equals_build_train_step():
    """On the card, examples/torch_gradient_accumulation.py's two paths end
    on the same parameters bit for bit (at TinyLlama's shape with the flash
    kernels: chip_smoke.py's imperative phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the imperative and fused paths run on the GPU (chip_smoke.py's imperative)")
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    imperative, fused = _example("torch_gradient_accumulation").main(["--epochs", "4"])
    assert imperative == fused


@pytest.mark.cuda
def test_cuda_f32_convolutions_are_full_precision():
    """mixed_precision="no" on the card convolves in real f32 under torch's
    default flags (cuDNN's TF32 on): a ResNet at ResNet-50's first widths,
    built on the CPU and moved by prepare, gives logits within 1e-4 of the
    same model in f64 on the CPU, relative to their RMS (chip_smoke.py's
    resnet_consistency bound; TF32 is about 1e-3 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's TF32 convolutions exist only on the GPU")
    import copy

    from accelerate_tpu_torch import Accelerator, ResNetConfig, create_resnet_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    assert torch.backends.cudnn.allow_tf32  # torch's default: what a user gets
    model = create_resnet_model(ResNetConfig(stage_sizes=(2, 2), num_classes=37), seed=5, device="cpu")
    reference = copy.deepcopy(model.module).double()
    images = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    acc = Accelerator(mixed_precision="no")
    model = acc.prepare(model)
    got = acc.build_eval_step(lambda p, st, x: model.apply_fn(p, x, st, train=False))(images.cuda()).cpu().double()
    with torch.no_grad():
        want = reference(images.double())
    assert float((got - want).abs().max() / want.pow(2).mean().sqrt()) <= 1e-4
    assert torch.backends.cudnn.allow_tf32  # restored after the step


@pytest.mark.cuda
def test_cuda_cv_example_trains_with_batchnorm_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ResNet and its batches live on the GPU (chip_smoke.py's resnet_train)")
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    assert 0.0 <= _example("torch_cv_example").main(["--tiny"]) <= 1.0
