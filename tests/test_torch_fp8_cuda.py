"""The card's twins of test_torch_fp8.py and test_torch_telemetry.py:
``torch._scaled_mm`` held to its plain version, and the step timeline's
fence waiting for the card. They need a CUDA card and skip without one;
this file imports no JAX, so it runs on the machine with the card:
``python -m pytest tests/test_torch_fp8_cuda.py -m cuda``."""

import pytest
import torch

from accelerate_tpu_torch import telemetry as tel
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.utils.quantization import fp8_quantize


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 2048, 256), (40, 72, 24)])
def test_scaled_mm_matches_its_plain_version_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._scaled_mm is the cuBLASLt fp8 GEMM (chip_smoke.py's fp8_matmul)")
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, k, device="cuda", generator=gen, dtype=torch.bfloat16)
    w = torch.randn(n, k, device="cuda", generator=gen, dtype=torch.bfloat16)
    x8, sx = fp8_quantize(x)
    w8, sw = fp8_quantize(w)
    before = fp8.launches
    got = fp8.fp8_mm(x8, w8.t(), sx * sw, torch.float32)
    assert fp8.launches == before + 1
    want = fp8.fp8_mm_plain(x8, w8.t(), sx * sw, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.square().mean().sqrt().item())
    codes, _ = fp8_quantize(x.cpu())
    assert torch.equal(codes.view(torch.uint8), x8.cpu().view(torch.uint8))


@pytest.mark.cuda
def test_the_fence_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fence is torch.cuda.synchronize (chip_smoke.py's telemetry phase)")
    st = tel.StepTelemetry(warmup_steps=0)
    a = torch.randn(4096, 4096, device="cuda")
    step = st.wrap(lambda: a @ a)
    for _ in range(3):
        step()
    assert all(r["execute_ms"] > 0 for r in st.records)
