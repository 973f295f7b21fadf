"""Shared harness of the port's process-fleet tests (test_torch_proc*.py,
test_torch_serve.py): the JAX package's tiny Llama carried to a
safetensors file the workers load (``torch_proc_factory``), the
supervisor's config for CPU workers, bounded pump loops, and the JAX
``ServingEngine``'s run of the same prompts as the reference. Not a test
module.

Every wait here has its own deadline and every supervisor is shut down in
a ``finally`` by its test: there is no per-test timeout in the suite."""

import dataclasses
import os
import time

import jax
import numpy as np

import accelerate_tpu.models as jm
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import LlamaConfig, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.serving_proc import FleetRequestError, ProcConfig, ProcessSupervisor
from accelerate_tpu_torch.utils.safetensors_io import save_file

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# the workers find the factory through PYTHONPATH; one torch thread each,
# as the suite runs several files at once
WORKER_ENV = {"PYTHONPATH": REPO + os.pathsep + TESTS, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
FACTORY = "torch_proc_factory:llama_from_file"
ENGINE = {"num_slots": 2, "prompt_buckets": [8], "max_len": 64, "tick_block": 2}
PAGED = dict(ENGINE, paged_block_size=4)
LP_ATOL = 1e-5  # f32 on the CPU: the port's logprobs against the JAX engine's


def make_weights(root):
    """The JAX package's tiny Llama (f32) and the path of its weights as
    the port's state dict; ``(jmodel, path, config dict)``."""
    jcfg = jm.LlamaConfig.tiny()
    jmodel = jm.create_llama_model(jcfg, seed=2, seq_len=16)
    config = dataclasses.asdict(jcfg)
    cfg = LlamaConfig(**config)
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    path = os.path.join(str(root), "tiny_llama.safetensors")
    save_file({k: v.contiguous() for k, v in model.module.state_dict().items()}, path)
    return jmodel, path, config


def proc_config(run_dir, weights, workers=2, engine=None, delay_s=0.0, **kw) -> ProcConfig:
    _, path, config = weights
    kw.setdefault("poll_interval_s", 0.01)
    kw.setdefault("heartbeat_timeout_s", 15.0)
    kw.setdefault("spawn_timeout_s", 90.0)
    return ProcConfig(
        workers=workers, device="cpu", run_dir=str(run_dir), model_spec=FACTORY,
        model_kwargs={"path": path, "config": config, "delay_s": delay_s}, engine=engine or PAGED,
        worker_env=WORKER_ENV, **kw,
    )


def boot(cfg) -> ProcessSupervisor:
    sup = ProcessSupervisor(cfg)
    try:
        sup.start(wait=True)
        assert all(h["health"] == "healthy" for h in sup.health().values()), sup.health()
    except BaseException:
        sup.shutdown()
        raise
    return sup


def pump_until(sup, cond, timeout_s=60.0, msg=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.pump()
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"pump_until timed out after {timeout_s} s: {msg or cond}")


def drive_all(sup, fids, timeout_s=60.0):
    """Pump every request to a terminal state; ``(outs, lost)``:
    ``{fid: (tokens, logprobs)}`` and ``{fid: reason}``."""
    outs, lost = {}, {}

    def done():
        for f in fids:
            if f in outs or f in lost:
                continue
            try:
                r = sup.poll(f)
            except FleetRequestError as e:
                lost[f] = str(e)
                continue
            if r is not None:
                outs[f] = (np.asarray(r), sup.logprobs(f))
        return len(outs) + len(lost) == len(fids)

    pump_until(sup, done, timeout_s, "requests to finish")
    return outs, lost


def prompts(n, seed=0, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, size=int(rng.integers(lo, hi))).astype(np.int32) for _ in range(n)]


def jax_reference(jmodel, *cases, engine=ENGINE):
    """The JAX dense engine's greedy tokens and logprobs for each case
    ``(prompts, new tokens)``, all served by one engine (one compile): a
    list of ``[(tokens, logprobs), ...]``, one a case."""
    eng = JaxServingEngine(jmodel, **{k: v for k, v in engine.items() if k != "paged_block_size"})
    uids = [[eng.submit(p, new) for p in ps] for ps, new in cases]
    eng.run()
    out = [[(np.asarray(eng.poll(u)), np.asarray(eng.logprobs(u))) for u in case] for case in uids]
    jax.clear_caches()
    return out


def assert_matches(outs, fids, ref, exact=False):
    """Each fleet request's tokens equal the reference's; logprobs within
    LP_ATOL (bit-equal with ``exact``)."""
    for f, (want, want_lps) in zip(fids, ref):
        got, got_lps = outs[f]
        np.testing.assert_array_equal(got, want)
        if exact:
            np.testing.assert_array_equal(got_lps, want_lps)
        else:
            np.testing.assert_allclose(got_lps, want_lps, atol=LP_ATOL, rtol=0)
