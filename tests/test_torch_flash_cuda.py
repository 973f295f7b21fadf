"""The card's twin of test_torch_flash_attention.py at Stable Diffusion's
head dim: K1-K3 at D 40 (run at the built width 64, the columns past 40
read as zero and never stored) against their plain versions, at the UNet's
64 x 64 self-attention (Sq = Sk = 4,096) and its cross-attention over 77
text states (a key length no key tile divides). They need a CUDA card and
skip without one; this file imports no JAX, so it runs on the machine with
the card: ``python -m pytest tests/test_torch_flash_cuda.py -m cuda``."""

import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as fa

# per element |got - want| <= t (|want| + RMS(want)) + floor: chip_smoke.py's FLASH_TOL and GRAD_FLOOR
TOL = {
    torch.float32: {"out": 2e-5, "dq": 2e-5, "dk": 2e-4, "dv": 2e-4},
    torch.bfloat16: {"out": 2e-2, "dq": 5e-2, "dk": 2e-2, "dv": 3e-2},
    torch.float16: {"out": 5e-3, "dq": 1e-2, "dk": 5e-3, "dv": 5e-3},
}
GRAD_FLOOR = 2e-5


def _within(got, want, t, floor=0.0) -> bool:
    got, want = got.float(), want.float()
    limit = t * (want.abs() + want.pow(2).mean().sqrt()) + floor
    return bool(((got - want).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("sk", [4096, 77], ids=["self", "cross"])
def test_k1_k3_at_head_dim_40_match_their_plain_versions(dtype, sk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1-K3 are CUDA kernels with no interpret mode (chip_smoke.py's flash_d40)")
    b, sq, h, d = 2, 4096, 8, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    scale = d**-0.5
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_fwd_kernel(q, k, v, False, scale, None)
    delta = fa._delta(out, do)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, False, scale, None)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, False, scale, None)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, False, scale, None)
    want_dq = fa.flash_attention_plain_dq(q, k, v, do, lse, delta, False, scale, None)
    want_dk, want_dv = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, False, scale, None)
    tol, floor = TOL[dtype], GRAD_FLOOR * do.float().pow(2).mean().sqrt().item()
    assert out.shape == (b, sq, h, d) and dk.shape == (b, sk, h, d)
    assert _within(out, want_out, tol["out"])
    assert (lse - want_lse).abs().max().item() <= 1e-5
    assert _within(dq, want_dq, tol["dq"], floor)
    assert _within(dk, want_dk, tol["dk"], floor) and _within(dv, want_dv, tol["dv"], floor)
