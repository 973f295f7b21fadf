"""The port's compile management (accelerate_tpu_torch/aot) against the JAX
package's (accelerate_tpu/aot) on the same inputs: the shape bucketer fed
the same size streams (buckets, choices, refinements and stats equal),
pad_batch_tree and next_pow2, resolve_cache_dir, the store's entries and
their rejection, the program cache's counters through memory and disk hits,
poison, wrap_jit and export/import, the loader's and the serving engine's
auto-bucketing (batches equal, tokens exact and f32 logprobs within 1e-5),
the ragged-stream watchdog, CompileKwargs and ACCELERATE_COMPILE_CACHE_DIR,
and the compile-cache command. The port's own warm start is shown on the
CPU: a cold and a warm subprocess over one store, a kernel library's
round trip through the store, and the fleets' shared stores."""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.aot as jaot
import accelerate_tpu_torch.aot as paot
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import Accelerator, CompileKwargs, LlamaConfig, ServingEngine, create_llama_model
from accelerate_tpu_torch import TelemetryKwargs, llama_params_from_jax
from accelerate_tpu_torch.commands import cli
from accelerate_tpu_torch.kernels import build
from accelerate_tpu_torch.telemetry.eventlog import EventLog, read_events
from accelerate_tpu_torch.test_utils.training import RegressionDataset, RegressionModel, linear_loss_fn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LP_ATOL = 1e-5  # f32 logprobs of the port's engine against the JAX engine's


def _jfn(x, w):
    return jnp.tanh(x @ w).sum()


def _fn(x, w):
    return torch.tanh(x @ w).sum()


def _javals(rows=8, dtype=jnp.float32):
    return jax.ShapeDtypeStruct((rows, 16), dtype), jax.ShapeDtypeStruct((16, 16), dtype)


def _specs(rows=8, dtype=torch.float32):
    return torch.empty(rows, 16, dtype=dtype), torch.empty(16, 16, dtype=dtype)


def _counts(pc) -> tuple:
    return pc.misses, pc.hits, pc.deserialized, pc.rejected


# --------------------------------------------------------------------- #
# ShapeBucketer, pad_batch_tree, next_pow2
# --------------------------------------------------------------------- #


def _stream_minimal(mod):
    b = mod.ShapeBucketer((8, 32, 128))
    return [b.bucket(n) for n in (3, 8, 9, 100)], b


def _stream_grow(mod):
    b = mod.ShapeBucketer((8,))
    out = [b.bucket(20), b.buckets]
    out += [b.bucket(n) for n in (1, 7, 20, 31, 32)]
    out.append(b.refine())
    return out, b


def _stream_multiple(mod):
    b = mod.ShapeBucketer((6,), multiple_of=4)
    capped = mod.ShapeBucketer((8,), max_size=24, multiple_of=4)
    out = [b.buckets, b.bucket(9), capped.bucket(17)]
    try:
        capped.bucket(25)
    except ValueError as e:
        out.append(str(e))
    return out, capped


def _stream_refine(mod):
    b = mod.ShapeBucketer((64,), refine_every=10_000)
    out = [b.bucket(17) for _ in range(50)]
    out += [b.refine(), b.bucket(17), b.bucket(18)]
    return out, b


def _stream_random(mod):
    """300 sizes with the default refinement cadence and a capacity bound:
    the online refinement runs four times."""
    rng = np.random.default_rng(3)
    b = mod.ShapeBucketer((8, 16), max_size=256)
    out = [b.bucket(int(n)) for n in np.concatenate([rng.integers(1, 40, 200), rng.integers(1, 257, 100)])]
    return out, b


@pytest.mark.parametrize("stream", [_stream_minimal, _stream_grow, _stream_multiple, _stream_refine, _stream_random],
                         ids=["minimal", "grow", "multiple", "refine", "random"])
def test_bucketer_follows_the_jax_bucketer(stream):
    jout, jb = stream(jaot)
    pout, pb = stream(paot)
    assert pout == jout
    assert pb.buckets == jb.buckets and pb.stats() == jb.stats() and pb.histogram == jb.histogram
    assert all(pb.lookup(n) == jb.lookup(n) for n in range(1, 300))


def test_next_pow2_round_up_and_pad_batch_tree_follow_jax():
    assert [paot.next_pow2(n) for n in range(1, 70)] == [jaot.next_pow2(n) for n in range(1, 70)]
    assert [paot.round_up_to(n, 6) for n in range(1, 30)] == [jaot.round_up_to(n, 6) for n in range(1, 30)]
    batch = {"x": np.arange(12).reshape(3, 4), "y": np.arange(3), "scalar": 7, "odd": np.arange(5),
             "nest": [np.arange(6).reshape(3, 2), (np.ones((3, 1), np.float32),)]}
    for target in (2, 3, 4, 8, 11):
        want = jaot.pad_batch_tree(batch, target)
        got = paot.pad_batch_tree(batch, target)
        flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(got)
        assert len(flat_w) == len(flat_g)
        for w, g in zip(flat_w, flat_g):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        # torch leaves pad to the same rows and stay torch tensors
        want = jaot.pad_batch_tree({"x": np.arange(12).reshape(3, 4), "y": np.arange(3), "scalar": 7}, target)
        tgot = paot.pad_batch_tree({"x": torch.arange(12).reshape(3, 4), "y": torch.arange(3), "scalar": 7}, target)
        assert isinstance(tgot["x"], torch.Tensor) and tgot["scalar"] == 7
        np.testing.assert_array_equal(tgot["x"].numpy(), want["x"])
        np.testing.assert_array_equal(tgot["y"].numpy(), want["y"])


@pytest.mark.parametrize("env", [None, "ENV"])
@pytest.mark.parametrize("explicit,project", [(None, None), (None, "/p"), ("/explicit", None), ("/explicit", "/p")])
def test_resolve_cache_dir_follows_jax(monkeypatch, tmp_path, env, explicit, project):
    if env is None:
        monkeypatch.delenv("ACCELERATE_COMPILE_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("ACCELERATE_COMPILE_CACHE_DIR", str(tmp_path))
    for dir_name in ("compile_cache", "cc"):
        assert paot.resolve_cache_dir(explicit, project, dir_name) == jaot.resolve_cache_dir(explicit, project,
                                                                                             dir_name)


# --------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------- #


def test_store_put_get_header_poison_and_stale(tmp_path):
    for mod, d in ((jaot, tmp_path / "jax"), (paot, tmp_path / "port")):
        store = mod.ExecutableStore(str(d))
        store.put("k" * 64, b"payload-bytes", name="demo")
        assert store.get("k" * 64) == b"payload-bytes"
        header = store.read_header("k" * 64)
        assert header["name"] == "demo" and header["size"] == len(b"payload-bytes")
        assert store.get("absent" * 8) is None and store.keys() == ["k" * 64]
    store = paot.ExecutableStore(str(tmp_path / "port"))
    assert store.read_header("k" * 64)["backend"] == paot.backend_descriptor() == {
        "platform": "cpu", "torch": torch.__version__}
    path = store._entry_path("k" * 64)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-4] + b"XXXX")
    with pytest.raises(paot.CorruptEntryError) as ei:
        store.get("k" * 64)
    assert ei.value.key == "k" * 64
    # a header written for another torch: stale before its crc is even looked at
    store.put("s" * 64, b"payload-bytes", name="demo")
    path = store._entry_path("s" * 64)
    with open(path, "rb") as f:
        magic, header, payload = f.readline(), json.loads(f.readline()), f.read()
    header["backend"]["torch"] = "0.0.1-somethingelse"
    with open(path, "wb") as f:
        f.write(magic + json.dumps(header).encode() + b"\n" + payload)
    with pytest.raises(paot.StaleEntryError, match="somethingelse"):
        store.get("s" * 64)
    with open(path, "wb") as f:
        f.write(b"NOPE\n{}\n")
    with pytest.raises(paot.CorruptEntryError, match="bad magic"):
        store.read_header("s" * 64)
    assert [e.get("error", "") != "" for e in store.entries()] == [False, True]
    assert store.clear() == 2 and store.keys() == []


def test_content_key_changes_with_shape_dtype_and_salt(tmp_path):
    """Each of shape, dtype and salt lands on its own key (four entries),
    and the same inputs land on the same key again, as in the JAX store."""
    jpc, pc = jaot.ProgramCache(store=jaot.ExecutableStore(str(tmp_path / "jax"))), paot.ProgramCache(
        store=paot.ExecutableStore(str(tmp_path / "port")))
    for rows, salt in ((8, ()), (16, ()), (8, ("v2",))):
        jpc.compile(_jfn, *_javals(rows), name="t", key_salt=salt)
        pc.compile(_fn, *_specs(rows), name="t", key_salt=salt)
    jpc.compile(_jfn, *_javals(8, jnp.bfloat16), name="t")
    pc.compile(_fn, *_specs(8, torch.bfloat16), name="t")
    pc.compile(_fn, *_specs(8), name="t")
    jpc.compile(_jfn, *_javals(8), name="t")
    assert len(pc.store.keys()) == len(jpc.store.keys()) == 4
    assert _counts(pc) == _counts(jpc) == (4, 1, 0, 0)
    again = paot.ProgramCache(store=paot.ExecutableStore(str(tmp_path / "port")))
    again.compile(_fn, *_specs(16), name="t")
    assert (again.misses, again.deserialized) == (0, 1)


# --------------------------------------------------------------------- #
# ProgramCache
# --------------------------------------------------------------------- #


def test_program_cache_memory_then_disk_hit_follows_jax(tmp_path):
    counts = {}
    for mod, fn, avals, d in ((jaot, _jfn, _javals, "jax"), (paot, _fn, _specs, "port")):
        pc = mod.ProgramCache(store=mod.ExecutableStore(str(tmp_path / d)))
        pc.compile(fn, *avals(), name="t")
        pc.compile(fn, *avals(), name="t")
        fresh = mod.ProgramCache(store=mod.ExecutableStore(str(tmp_path / d)))
        compiled = fresh.compile(fn, *avals(), name="t")
        counts[d] = (_counts(pc), _counts(fresh))
    assert counts["port"] == counts["jax"] == ((1, 1, 0, 0), (0, 1, 1, 0))
    # the port's warm program is the caller's own callable
    x, w = np.full((8, 16), 0.01, np.float32), np.full((16, 16), 0.02, np.float32)
    assert compiled is _fn and float(compiled(torch.from_numpy(x), torch.from_numpy(w))) == pytest.approx(
        float(np.tanh(x @ w).sum()), rel=1e-6)


def test_program_cache_rejects_and_heals_poison(tmp_path):
    log_path = str(tmp_path / "run.jsonl")
    pc = paot.ProgramCache(store=paot.ExecutableStore(str(tmp_path / "s")))
    pc.compile(_fn, *_specs(), name="t")
    path = pc.store._entry_path(pc.store.keys()[0])
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2] + b"\xff" * 16 + blob[len(blob) // 2:])
    log = EventLog(log_path, rank=0)
    healed = paot.ProgramCache(store=paot.ExecutableStore(str(tmp_path / "s")), log=log)
    healed.compile(_fn, *_specs(), name="t")
    log.close()
    assert (healed.rejected, healed.misses) == (1, 1)
    third = paot.ProgramCache(store=paot.ExecutableStore(str(tmp_path / "s")))
    third.compile(_fn, *_specs(), name="t")
    assert third.deserialized == 1  # the heal stored a sound entry
    names = [e["name"] for e in read_events(log_path)]
    assert names.count("compile_cache_reject") == 1 and "compile_cache_miss" in names


def test_wrap_jit_cache_size_and_export_import_follow_jax(tmp_path):
    got = {}
    for mod, fn, wrap, arr, d in ((jaot, _jfn, jax.jit, np.ones, "jax"), (paot, _fn, lambda f: f, torch.ones, "port")):
        pc = mod.ProgramCache(store=mod.ExecutableStore(str(tmp_path / d / "src")))
        w = pc.wrap_jit(wrap(fn), name="w")
        x, wgt = arr((8, 16)), arr((16, 16))
        sizes = [(float(w(x, wgt)), w._cache_size(), pc.misses)]
        sizes.append((float(w(x, wgt)), w._cache_size(), pc.misses))
        w(arr((4, 16)), wgt)
        sizes.append((None, w._cache_size(), pc.misses))
        assert w._program_cache is pc and w.__wrapped__ is not None
        archive = str(tmp_path / d / "bundle.tar.gz")
        exported = pc.aot_export(archive)
        dst = mod.ProgramCache(store=mod.ExecutableStore(str(tmp_path / d / "dst")))
        loaded = dst.aot_load(archive)
        dst.compile(fn, *(_javals() if mod is jaot else _specs()), name="w")
        got[d] = (sizes, exported, loaded, dst.misses, dst.deserialized)
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == [(128.0, 1, 1), (128.0, 1, 1)]  # tanh(16) is 1 in f32
    with pytest.raises(ValueError, match="persistent store"):
        paot.ProgramCache().aot_export(str(tmp_path / "none.tar.gz"))


def test_a_kernel_library_rides_the_store(tmp_path, monkeypatch):
    """The library half of an entry, on the CPU: a program whose first call
    loads a kernel library (``build.load``, its loading stubbed: no nvcc
    here) records it; the store keeps the library's bytes once under its
    ``lib<name>-<hash>.so`` name; a process with an empty build directory
    installs the same bytes there instead of building; a poisoned library
    entry is rejected, deleted and stored anew by the rebuild."""
    library = b"\x7fELF-not-really" * 64
    builds = []

    def load(name):  # what _load does with its library, without nvcc: build it unless it is there
        path = build.library_path(name)
        if not path.exists():
            builds.append(name)
            path.write_bytes(library)

    monkeypatch.setattr(build, "_load", load)
    cold_dir, warm_dir, store_dir = tmp_path / "cold", tmp_path / "warm", str(tmp_path / "store")
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_BUILD_DIR", str(cold_dir))
    lib = build.library_path("paged_attention")

    def program(x):
        build.load("paged_attention")
        return x * 2

    cold = paot.ProgramCache(store=paot.ExecutableStore(store_dir))
    step = cold.wrap_jit(program, name="tick")
    step(torch.ones(3))
    step(torch.ones(3))
    kinds = sorted(e["kind"] for e in cold.store.entries())
    assert cold.misses == 1 and kinds == ["library", "program"] and builds == ["paged_attention"]
    cold.wrap_jit(program, name="tick")(torch.ones(5))  # a second program: the library is stored once
    assert sorted(e["kind"] for e in cold.store.entries()) == ["library", "program", "program"]

    monkeypatch.setenv("ACCELERATE_TPU_TORCH_BUILD_DIR", str(warm_dir))
    warm = paot.ProgramCache(store=paot.ExecutableStore(store_dir))
    warm.wrap_jit(program, name="tick")(torch.ones(3))
    installed = warm_dir / lib.name
    assert (warm.misses, warm.deserialized) == (0, 1) and installed.read_bytes() == library
    assert builds == ["paged_attention"]  # the warm process built nothing

    lib_key = next(e["key"] for e in warm.store.entries() if e["kind"] == "library")
    path = warm.store._entry_path(lib_key)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-8] + b"poisoned")
    installed.unlink()
    healed = paot.ProgramCache(store=paot.ExecutableStore(store_dir))
    healed.wrap_jit(program, name="tick")(torch.ones(3))
    assert (healed.rejected, healed.misses, healed.deserialized) == (1, 1, 0)
    # the poisoned bytes never reached the build directory: the library was built again, and stored anew
    assert builds == ["paged_attention"] * 2 and installed.read_bytes() == library
    assert paot.ExecutableStore(store_dir).get(lib_key) == library


def test_recording_sees_loads_on_other_threads(monkeypatch):
    """A program's backward runs on autograd's device thread on the card:
    a scope records the libraries loaded on any thread while it is open,
    nests, and records nothing once closed."""
    import threading

    monkeypatch.setattr(build, "_load", lambda name: None)
    with build.recording() as outer:
        with build.recording() as inner:
            t = threading.Thread(target=build.load, args=("flash_bwd_sm90",))
            t.start()
            t.join()
        build.load("paged_attention")
    build.load("int4_matmul")
    assert inner == {"flash_bwd_sm90"} and outer == {"flash_bwd_sm90", "paged_attention"}
    assert build._RECORDING == {}

    # sixteen threads open and close scopes and load at once, switching every microsecond: every scope sees its
    # own loads, and every scope is gone at the end
    got, old = [], sys.getswitchinterval()

    def worker(i):
        for _ in range(200):
            with build.recording() as names:
                build.load(f"lib{i}")
            got.append(f"lib{i}" in names)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 3200 and all(got) and build._RECORDING == {}


def test_configure_persistent_cache_points_the_kernel_library_directory(tmp_path, monkeypatch):
    from accelerate_tpu_torch.utils import environment

    monkeypatch.delenv("ACCELERATE_TPU_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setattr(environment, "_build_dir_override", None)
    assert paot.configure_persistent_cache(str(tmp_path)) is True
    assert build.kernel_build_dir() == tmp_path / "cuda" and (tmp_path / "cuda").is_dir()
    assert paot.configure_persistent_cache(str(tmp_path / "other")) is False  # the first choice stands
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_BUILD_DIR", str(tmp_path / "env"))
    assert build.kernel_build_dir() == tmp_path / "env"  # the environment wins


_CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from accelerate_tpu_torch import Accelerator, CompileKwargs, LlamaConfig, ServingEngine, create_llama_model
from accelerate_tpu_torch import causal_lm_loss
from accelerate_tpu_torch.aot import ExecutableStore, ProgramCache
from accelerate_tpu_torch.kernels import build

torch.manual_seed(0)
model = create_llama_model(LlamaConfig.tiny(), device="cpu")
pc = ProgramCache(store=ExecutableStore({store!r} + "/executables"))
eng = ServingEngine(model, device="cpu", num_slots=2, prompt_buckets=(4,), paged_block_size=4, tick_block=2,
                    program_cache=pc, auto_bucketing=True)
outs = eng.generate_many([np.arange(1, 1 + n, dtype=np.int32) for n in (3, 6, 11)], max_new_tokens=3)
acc = Accelerator(cpu=True, kwargs_handlers=[CompileKwargs(cache_dir={store!r}, persistent_xla_cache=False)])
tmodel = acc.prepare_model(create_llama_model(LlamaConfig.tiny(), device="cpu"))
acc.prepare_optimizer(torch.optim.SGD(tmodel.module.parameters(), lr=0.1))
step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, tmodel.apply_fn))
ids = torch.from_numpy(np.random.default_rng(0).integers(1, 200, (2, 16)).astype(np.int64))
losses = [float(step({{"input_ids": ids}})) for _ in range(2)]
tpc = acc.program_cache
print(json.dumps({{"serve": [pc.misses, pc.deserialized], "train": [tpc.misses, tpc.deserialized],
                  "tokens": [o.tolist() for o in outs], "losses": losses, "buckets": list(eng.bucketer.buckets),
                  "nvcc": build.nvcc_builds}}))
"""


def test_cold_then_warm_process_on_one_store(tmp_path):
    """A cold process serves (auto-bucketing, paged) and trains (under
    CompileKwargs) into an empty store; a second process on the same store
    compiles nothing, installs every program the first compiled, and gives
    the same tokens and bit-equal losses."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("ACCELERATE_COMPILE_CACHE_DIR", None)

    def run():
        out = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO, store=str(tmp_path / "cc"))],
                             capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold, warm = run(), run()
    assert cold["serve"] == [4, 0]  # the prefills at buckets 4, 8 and 16, the decode tick
    assert cold["train"] == [1, 0] and cold["buckets"] == [4, 8, 16]
    assert warm["serve"] == [0, cold["serve"][0]] and warm["train"] == [0, 1]
    assert warm["tokens"] == cold["tokens"] and warm["losses"] == cold["losses"]
    assert cold["nvcc"] == warm["nvcc"] == 0


# --------------------------------------------------------------------- #
# auto-bucketing: the loader, the engine, the watchdog
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_loader_auto_bucketing_batches_equal_jax(iterable):
    from accelerate_tpu.data_loader import DataLoaderShard as JaxShard
    from accelerate_tpu.data_loader import IterableDataLoaderShard as JaxIterable
    from accelerate_tpu_torch.data_loader import DataLoaderShard, IterableDataLoaderShard

    rows = [{"x": np.full((4,), i, np.float32), "y": np.int32(i)} for i in range(30 if iterable else 21)]

    class Stream:
        def __iter__(self):
            return iter(rows)

    data, bs = (Stream(), 7) if iterable else (rows, 8)  # a tail of 2 and of 5 rows
    jcls, pcls = (JaxIterable, IterableDataLoaderShard) if iterable else (JaxShard, DataLoaderShard)
    jl = jcls(data, batch_size=bs, even_batches=False, auto_bucketing=True, device_placement=False)
    pl = pcls(data, batch_size=bs, even_batches=False, auto_bucketing=True, device_placement=False)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == -(-len(rows) // bs)
    for j, p in zip(jb, pb):
        for k in ("x", "y"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
    assert pl.remainder == jl.remainder == len(rows) % bs
    assert pl.bucketer.buckets == jl.bucketer.buckets == (bs,)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlamaConfig.tiny()
    jmodel = jax_create_llama_model(jcfg, seed=2, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.mark.parametrize("paged", [None, 4], ids=["dense", "paged"])
def test_engine_auto_bucketing_token_exact_against_jax(models, paged):
    """Lengths 3, 5, 6, 9 and 2 from the seed bucket (4,): both engines
    mint the buckets (4, 8, 16) and run one prefill program a bucket, and
    the port's tokens equal the JAX engine's (logprobs within 1e-5)."""
    jmodel, model = models
    prompts = [np.arange(1, 1 + n, dtype=np.int32) for n in (3, 5, 6, 9, 2)]
    kw = dict(num_slots=2, prompt_buckets=(4,), auto_bucketing=True, paged_block_size=paged)
    jeng = JaxServingEngine(jmodel, **kw)
    peng = ServingEngine(model, device="cpu", **kw)
    juids = [jeng.submit(p, 4) for p in prompts]
    puids = [peng.submit(p, 4) for p in prompts]
    jeng.run()
    peng.run()
    for ju, pu in zip(juids, puids):
        np.testing.assert_array_equal(peng.poll(pu), jeng.poll(ju))
        np.testing.assert_allclose(peng.logprobs(pu), jeng.logprobs(ju), atol=LP_ATOL, rtol=0)
    assert peng.bucketer.buckets == jeng.bucketer.buckets == (4, 8, 16)
    assert peng.bucketer.stats() == jeng.bucketer.stats()
    assert peng._programs["prefill"]._cache_size() == len(jeng._prefill.compiled_buckets()) == 3


def test_ragged_stream_under_bucketing_leaves_the_watchdog_silent():
    from accelerate_tpu.telemetry import StepTelemetry as JaxStepTelemetry
    from accelerate_tpu_torch.telemetry import StepTelemetry

    rng = np.random.default_rng(0)
    sizes = [5, 13] + [int(rng.integers(1, 17)) for _ in range(50)]
    got = {}
    for name, mod, tel, wrap, arr in (("jax", jaot, JaxStepTelemetry, jax.jit, np.ones),
                                      ("port", paot, StepTelemetry, lambda f: f, torch.ones)):
        bucketer = mod.ShapeBucketer((8, 16))
        pc = mod.ProgramCache()
        dispatch = pc.wrap_jit(wrap(lambda b: (b["x"] * 2).sum()), name="ragged")
        telem = tel(warmup_steps=2)
        step = telem.wrap(dispatch)
        for n in sizes:  # the first two cover both buckets during the warmup
            batch = {"x": arr((n, 4), dtype=np.float32) if arr is np.ones else torch.ones(n, 4)}
            step(mod.pad_batch_tree(batch, bucketer.bucket(n)))
        got[name] = (bucketer.buckets, pc.misses, dispatch._cache_size(), telem.recompiles)
    assert got["port"] == got["jax"] == ((8, 16), 2, 2, 0)
    # a shape past the warm buckets is still caught: the watchdog probes the program cache
    telem = StepTelemetry(warmup_steps=1)
    pc = paot.ProgramCache()
    step = telem.wrap(pc.wrap_jit(lambda x: x.sum(), name="drift"))
    step(torch.ones(8, 4))
    step(torch.ones(8, 4))
    step(torch.ones(5, 4))
    assert telem.recompiles == 1 and pc.misses == 2


# --------------------------------------------------------------------- #
# CompileKwargs / the Accelerator
# --------------------------------------------------------------------- #


def _trainer(cache_dir):
    acc = Accelerator(cpu=True, kwargs_handlers=[CompileKwargs(cache_dir=cache_dir, persistent_xla_cache=False)])
    model = acc.prepare_model(RegressionModel())
    acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=0.1))
    data = RegressionDataset(length=16)
    batch = {"x": torch.from_numpy(data.x), "y": torch.from_numpy(data.y)}
    return acc, acc.build_train_step(linear_loss_fn), batch


def _reset_port_state():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def test_compile_kwargs_activates_the_program_cache(tmp_path):
    import accelerate_tpu as jat

    jacc = jat.Accelerator(kwargs_handlers=[jat.CompileKwargs(cache_dir=str(tmp_path / "jax"),
                                                              persistent_xla_cache=False)])
    _reset_port_state()
    acc, step, batch = _trainer(str(tmp_path / "port"))
    assert acc.program_cache.store.path == str(tmp_path / "port" / "executables")
    assert os.path.relpath(jacc.program_cache.store.path, str(tmp_path / "jax")) == "executables"
    losses = [float(step(batch)) for _ in range(3)]
    assert acc.program_cache.misses == 1 and step._cache_size() == 1
    assert len(acc.program_cache.store.keys()) == 1
    eval_step = acc.build_eval_step(lambda p, x: x * p["a"])
    eval_step(torch.ones(4))
    assert acc.program_cache.misses == 2
    # a restart: a fresh Accelerator and cache over the same directory compile nothing, same losses
    _reset_port_state()
    acc2, step2, batch2 = _trainer(str(tmp_path / "port"))
    assert [float(step2(batch2)) for _ in range(3)] == losses
    assert (acc2.program_cache.misses, acc2.program_cache.deserialized) == (0, 1)
    _reset_port_state()
    assert Accelerator(cpu=True, kwargs_handlers=[CompileKwargs(aot_train_step=False)]).program_cache.store is None
    with pytest.raises(ValueError, match="min_compile_time_secs"):
        CompileKwargs(min_compile_time_secs=-1)


def test_env_var_activates_the_program_cache(tmp_path, monkeypatch):
    import accelerate_tpu as jat

    monkeypatch.delenv("ACCELERATE_COMPILE_CACHE_DIR", raising=False)
    assert Accelerator(cpu=True).program_cache is None and jat.Accelerator().program_cache is None
    _reset_port_state()
    monkeypatch.setenv("ACCELERATE_COMPILE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))  # keep the checkout's own
    log_path = tmp_path / "resume.jsonl"
    acc = Accelerator(cpu=True, kwargs_handlers=[TelemetryKwargs(output_path=str(log_path))])
    want = os.path.join(str(tmp_path), "executables")
    assert acc.program_cache.store.path == want == jat.Accelerator().program_cache.store.path
    assert acc.telemetry.log is acc.program_cache.log  # compile_cache_* events join the run's log
    model = acc.prepare_model(RegressionModel())
    acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=0.1))
    acc.save_state(str(tmp_path / "ckpt"))
    acc.load_state(str(tmp_path / "ckpt"))
    acc.telemetry.close()
    events = [e for e in read_events(str(log_path)) if e["name"] == "compile_cache_warmstart"]
    assert len(events) == 1 and events[0]["store_dir"] == want


# --------------------------------------------------------------------- #
# the compile-cache command
# --------------------------------------------------------------------- #


def _cli(*argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ei:
        cli.main(list(argv))
    return ei.value.code, out.getvalue()


def test_compile_cache_command_selfcheck_warm_stats_clear(tmp_path):
    rc, out = _cli("compile-cache", "--selfcheck")
    assert rc == 0 and "poisoned entry rejected + healed: OK" in out
    fn_file = tmp_path / "stepfn.py"
    fn_file.write_text("import torch\n\ndef step(x, w):\n    return torch.tanh(x @ w).sum()\n")
    d = str(tmp_path / "cache")
    warm = ("compile-cache", "warm", f"{fn_file}::step", "--arg", "f32[8,16]", "--arg", "f32[16,16]", "--dir", d,
            "--device", "cpu")
    rc, out = _cli(*warm)
    assert rc == 0 and "compiled + stored" in out, out
    rc, out = _cli(*warm)
    assert "deserialized (already warm)" in out
    rc, out = _cli("compile-cache", "stats", "--dir", d, "--format", "json")
    report = json.loads(out)
    assert report["entries"] == 1 and report["programs"][0]["name"] == "step"
    rc, out = _cli("compile-cache", "stats", "--dir", d)
    assert rc == 0 and "1 entrie(s)" in out and "program" in out
    rc, out = _cli("compile-cache", "clear", "--dir", d)
    assert "would remove 1" in out
    rc, out = _cli("compile-cache", "clear", "--dir", d, "--yes")
    assert "removed 1" in out
    rc, out = _cli("compile-cache", "stats", "--dir", d, "--format", "json")
    assert json.loads(out)["entries"] == 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        _cli("compile-cache", "warm", f"{fn_file}::step", "--arg", "f32[8,16]", "--dir", d, "--mesh", "data=4",
             "--device", "cpu")
    rc, out = _cli("compile-cache")
    assert rc == 2 and "usage" in out


# --------------------------------------------------------------------- #
# the fleets' shared stores
# --------------------------------------------------------------------- #


def test_process_fleet_warm_starts_from_its_store(tmp_path):
    """``ProcConfig(store_dir=...)`` on the CPU: a first one-worker fleet
    fills the store, a second fleet's fresh worker process compiles nothing
    (hello and status), installs every program and serves."""
    from torch_proc_harness import boot, drive_all, make_weights, proc_config, pump_until

    (tmp_path / "weights").mkdir()
    weights = make_weights(tmp_path / "weights")
    store = str(tmp_path / "store")
    sup = boot(proc_config(tmp_path / "a", weights, workers=1, store_dir=store))
    first = sup.worker_stats()["w0"]["hello"]
    sup.shutdown()
    assert first["compiles"] > 0 and first["deserialized"] == 0 and first["nvcc_builds"] == 0
    sup = boot(proc_config(tmp_path / "b", weights, workers=1, store_dir=store))
    try:
        hello = sup.worker_stats()["w0"]["hello"]
        assert (hello["compiles"], hello["deserialized"]) == (0, first["compiles"])
        fid = sup.submit([1, 2, 3, 4], max_new_tokens=4)
        outs, lost = drive_all(sup, [fid])
        assert not lost and len(outs) == 1
        pump_until(sup, lambda: sup.health()["w0"]["compiles"] == 0 and sup.health()["w0"]["deserialized"] > 0,
                   30, "the warm worker's status")
    finally:
        sup.shutdown()


def test_package_surface_matches_jax():
    assert paot.__all__ == jaot.__all__
    assert isinstance(paot.ProgramCache.from_env(), paot.ProgramCache)
    assert types.FunctionType is type(paot.default_program_cache)
