"""The port's data loader (accelerate_tpu_torch.data_loader) against the JAX
package's on the same datasets: every yielded batch element for element,
and the end flag and ``remainder`` after each, across drop_last x
even_batches x split_batches, the seeded shuffle over epochs, skipping,
a resume from a state dict, the iterable loader, dispatch mode and a
``torch.utils.data.DataLoader`` as input. Then the loader driving the
train step's sync boundaries beside the JAX Accelerator's. The JAX loader
runs without an Accelerator (one data shard) and without placement, so
its batches are numpy; the port's land on the CPU."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import data_loader as jdl
from accelerate_tpu.models import BertConfig as JaxBertConfig
from accelerate_tpu.models import bert_classification_loss as jax_bert_loss
from accelerate_tpu.models import create_bert_model as jax_create_bert_model
from accelerate_tpu.utils.dataclasses import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu_torch import Accelerator, BertConfig, bert_classification_loss, bert_params_from_jax
from accelerate_tpu_torch import create_bert_model
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


class Rows:
    """A map-style dataset: row i is ``{"x": float32[3], "y": int32}``."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.y = np.arange(n, dtype=np.int32)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


class Stream:
    """An iterable dataset over the same rows (no ``__getitem__``)."""

    def __init__(self, n, seed=0):
        self.rows = Rows(n, seed)

    def __iter__(self):
        return (self.rows[i] for i in range(len(self.rows)))


def _np(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in batch.items()}


def _passes(loader, n_passes=1, stop_after=None):
    """Each yielded batch (as numpy) with the loader's and GradientState's
    end flag and remainder read right after the yield."""
    seen = []
    for _ in range(n_passes):
        for i, batch in enumerate(loader):
            gs = loader.gradient_state
            seen.append((_np(batch), loader.end_of_dataloader, loader.remainder, gs.end_of_dataloader, gs.remainder))
            if stop_after is not None and i + 1 == stop_after:
                break
    return seen


def _assert_same_passes(got, want):
    assert len(got) == len(want) and len(want) > 0
    for (gb, *gflags), (wb, *wflags) in zip(got, want):
        assert gb.keys() == wb.keys()
        for k in wb:
            assert gb[k].dtype == wb[k].dtype, k
            np.testing.assert_array_equal(gb[k], wb[k])
        assert gflags == wflags


def _both(data, **kwargs):
    """The JAX loader and the port's over ``data`` with the same settings."""
    jax_loader = jdl.prepare_data_loader(data, put_on_device=False, **kwargs)
    port_loader = tdl.prepare_data_loader(data, device="cpu", **kwargs)
    return jax_loader, port_loader


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("even_batches", [True, False])
@pytest.mark.parametrize("split_batches", [False, True])
def test_map_loader_matches_jax(drop_last, even_batches, split_batches):
    jax_loader, port_loader = _both(Rows(10), batch_size=4, drop_last=drop_last, even_batches=even_batches,
                                    split_batches=split_batches)
    want = _passes(jax_loader)
    _assert_same_passes(_passes(port_loader), want)
    assert len(port_loader) == len(jax_loader) == len(want)
    # the tail: 10 = 2 x 4 + 2 rows; even_batches wraps round to 4 and says 2 are real
    if not drop_last:
        assert want[-1][0]["y"].shape[0] == (4 if even_batches else 2)
        assert want[-1][1:] == ((True, 2, True, 2) if even_batches else (True, -1, True, -1))
    assert [flags[0] for _, *flags in want] == [False] * (len(want) - 1) + [True]


def test_seeded_shuffle_over_three_epochs_matches_jax():
    jax_loader, port_loader = _both(Rows(11), batch_size=4, shuffle=True, seed=7)
    want = _passes(jax_loader, n_passes=3)
    got = _passes(port_loader, n_passes=3)
    _assert_same_passes(got, want)
    orders = [np.concatenate([b["y"] for b, *_ in got[i * 3 : i * 3 + 3]])[:11] for i in range(3)]
    assert not np.array_equal(orders[0], orders[1]) and sorted(orders[2].tolist()) == list(range(11))
    assert port_loader.iteration == jax_loader.iteration == 3


def test_skip_first_batches_and_a_mid_epoch_resume_match_jax():
    jax_loader, port_loader = _both(Rows(14), batch_size=3, shuffle=True, seed=1)
    _assert_same_passes(_passes(tdl.skip_first_batches(port_loader, 2)),
                        _passes(jdl.skip_first_batches(jax_loader, 2)))
    # the skipping pass was full (epoch 0 -> 1); one more (-> 2), then stop after 2 batches of epoch 2
    # and resume in a new loader
    for loader in (jax_loader, port_loader):
        _passes(loader)
        _passes(loader, stop_after=2)
    state = port_loader.state_dict()
    assert state == jax_loader.state_dict()
    assert state["iteration"] == 2 and state["batches_yielded"] == 2 and state["sampler_epoch"] == 2
    resumed = []
    for loader, fresh in zip((jax_loader, port_loader), _both(Rows(14), batch_size=3, shuffle=True, seed=1)):
        fresh.load_state_dict(loader.state_dict())
        resumed.append(_passes(fresh))
    _assert_same_passes(resumed[1], resumed[0])
    assert len(resumed[1]) == 5 - 2
    with pytest.raises(TypeError, match="skip_first_batches expects"):
        tdl.skip_first_batches(Rows(3), 1)


@pytest.mark.parametrize("even_batches,drop_last,skip", [(True, False, 0), (False, False, 0), (True, True, 0),
                                                          (True, False, 1), (False, False, 2)])
def test_iterable_loader_matches_jax(even_batches, drop_last, skip):
    jax_loader, port_loader = _both(Stream(11), batch_size=4, even_batches=even_batches, drop_last=drop_last)
    jdl.skip_first_batches(jax_loader, skip)
    tdl.skip_first_batches(port_loader, skip)
    assert isinstance(port_loader, tdl.IterableDataLoaderShard)
    _assert_same_passes(_passes(port_loader), _passes(jax_loader))


def test_iterable_resume_past_the_tail_yields_nothing_like_jax():
    jax_loader, port_loader = _both(Stream(11), batch_size=4)
    jdl.skip_first_batches(jax_loader, 3)
    tdl.skip_first_batches(port_loader, 3)
    assert _passes(port_loader) == _passes(jax_loader) == []


@pytest.mark.parametrize("data", [Rows(10), Stream(10)], ids=["map", "iterable"])
def test_dispatch_mode_matches_jax(data):
    jax_loader = jdl.prepare_data_loader(data, put_on_device=False, batch_size=4,
                                         data_loader_config=JaxDataLoaderConfiguration(dispatch_batches=True))
    port_loader = tdl.prepare_data_loader(data, device="cpu", batch_size=4,
                                          data_loader_config=DataLoaderConfiguration(dispatch_batches=True))
    assert isinstance(port_loader, tdl.DataLoaderDispatcher)
    _assert_same_passes(_passes(port_loader), _passes(jax_loader))
    assert port_loader.state_dict() == jax_loader.state_dict()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("custom_collate", [False, True])
def test_torch_dataloader_as_input_matches_jax(shuffle, drop_last, custom_collate):
    def collate(samples):  # the user's collate: their own stacking, torch tensors out
        return {"x": torch.stack([torch.from_numpy(s["x"]) * 2 for s in samples]),
                "y": torch.tensor([int(s["y"]) for s in samples], dtype=torch.int32)}

    kwargs = {"collate_fn": collate} if custom_collate else {}
    source = torch.utils.data.DataLoader(Rows(10), batch_size=4, shuffle=shuffle, drop_last=drop_last, **kwargs)
    jax_loader, port_loader = _both(source, seed=3)
    _assert_same_passes(_passes(port_loader), _passes(jax_loader))
    assert port_loader.total_batch_size == 4 and port_loader.drop_last == drop_last


def test_a_prepared_loader_is_returned_as_it_is_and_batches_follow_the_accelerator():
    acc = Accelerator(cpu=True)
    loader = acc.prepare(Rows(6))
    assert isinstance(loader, tdl.DataLoaderShard) and acc.prepare(loader) is loader
    assert acc.prepare_data_loader(loader) is loader and acc._dataloaders == [loader]
    assert all(b["x"].device.type == "cpu" for b in loader)
    host = acc.prepare_data_loader(Rows(6), device_placement=False, batch_size=2)
    assert host.device_placement is False and host.device is None
    # auto-bucketing: the ragged tail (without even_batches) is wrap-padded to the steady batch's bucket
    bucketed = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(auto_bucketing=True,
                                                                               even_batches=False))
    loader = bucketed.prepare_data_loader(Rows(10), batch_size=4)
    assert [len(b["y"]) for b in loader] == [4, 4, 4] and loader.remainder == 2 and loader.bucketer.buckets == (4,)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tdl.prepare_data_loader(Rows(6), device="cpu", num_processes=2)


def test_the_loader_needs_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdl.prepare_data_loader(Rows(4), batch_size=2)
    assert tdl.prepare_data_loader(Rows(4), batch_size=2, put_on_device=False).device is None


def _bert_rows(n, seq=8, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    return [{"input_ids": ids[i], "attention_mask": np.ones(seq, bool), "labels": labels[i]} for i in range(n)]


@functools.cache
def _tiny_bert_cfg():
    return JaxBertConfig.tiny(num_hidden_layers=1, vocab_size=64, hidden_size=32, num_attention_heads=2,
                              intermediate_size=64, max_position_embeddings=16)


def test_sync_with_dataloader_forces_a_sync_on_the_last_batch_like_jax():
    """Accumulation of 3 over 10 batches: syncs after batches 3, 6, 9 and,
    forced by the loader's end, 10, in both packages. The JAX step runs on
    the suite's 8-device mesh: 1 row a shard is the port's batch of 8."""
    rows = _bert_rows(80)
    jacc = JaxAccelerator(gradient_accumulation_steps=3)
    jmodel = jacc.prepare_model(jax_create_bert_model(_tiny_bert_cfg(), seed=0, seq_len=8))
    jacc.prepare_optimizer(optax.sgd(1e-3))
    jloader = jacc.prepare_data_loader(rows, batch_size=1)
    jstep = jacc.build_train_step(lambda p, b: jax_bert_loss(p, b, jmodel.apply_fn))
    want = []
    for batch in jloader:
        jstep(batch)
        want.append(jacc.sync_gradients)

    acc = Accelerator(cpu=True, gradient_accumulation_steps=3)
    model = create_bert_model(BertConfig(**vars(_tiny_bert_cfg())), device="cpu")
    model.load_state_dict(bert_params_from_jax(jax.tree.map(np.asarray, jmodel.params), model.config))
    opt = torch.optim.SGD(model.module.parameters(), lr=1e-3)
    model, _, loader = acc.prepare(model, opt, tdl.prepare_data_loader(rows, batch_size=8))
    step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    got = []
    for batch in loader:
        step(batch)
        got.append(acc.sync_gradients)
    assert got == want == [False, False, True] * 3 + [True]
    assert not acc.gradient_state.in_dataloader  # the pass is over: the loader left the registry


@pytest.mark.cuda
def test_cuda_batches_arrive_on_the_card_from_pinned_memory(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: batches are placed on the GPU (chip_smoke.py's bert_finetune runs it there)")
    pinned = []
    pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t, *a: pinned.append(1) or pin(t, *a))
    acc = Accelerator()
    loader = acc.prepare_data_loader(Rows(10), batch_size=4, shuffle=True, seed=2)
    host = tdl.prepare_data_loader(Rows(10), device="cpu", batch_size=4, shuffle=True, seed=2)
    for got, want in zip(loader, host):
        assert got["x"].device.type == "cuda" and got["y"].dtype == torch.int32
        torch.testing.assert_close(got["x"].cpu(), want["x"], rtol=0, atol=0)
    assert len(pinned) == 2 * 3  # every leaf of every batch copied from pinned memory


@pytest.mark.cuda
def test_cuda_loader_drives_the_sync_pattern_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: batches are placed on the GPU (chip_smoke.py's bert_finetune runs it there)")
    acc = Accelerator(gradient_accumulation_steps=3)
    model = create_bert_model(BertConfig(**vars(_tiny_bert_cfg())))
    opt = torch.optim.SGD(model.module.parameters(), lr=1e-3)
    model, _, loader = acc.prepare(model, opt, tdl.prepare_data_loader(_bert_rows(80), batch_size=8))
    step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    syncs = []
    for batch in loader:
        assert batch["input_ids"].is_cuda
        step(batch)
        syncs.append(acc.sync_gradients)
    assert syncs == [False, False, True] * 3 + [True]


def test_accelerator_surface_for_one_process(capsys):
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(even_batches=False), split_batches=True)
    assert (acc.num_processes, acc.process_index, acc.local_process_index, acc.num_data_shards) == (1, 0, 0, 1)
    assert acc.is_main_process and acc.is_local_main_process and acc.split_batches
    acc.print("from the main process")
    acc.wait_for_everyone()
    assert capsys.readouterr().out == "from the main process\n"
    loader = acc.prepare_data_loader(Rows(10), batch_size=4)
    assert loader.even_batches is False and loader.split_batches is True
    batches = list(loader)
    assert [len(b["y"]) for b in batches] == [4, 4, 2] and loader.remainder == -1
    x = torch.arange(6.0)
    assert torch.equal(acc.gather(x), x) and torch.equal(acc.reduce(x, "sum", 0.5), x * 0.5)
    assert torch.equal(acc.pad_across_processes(x), x)
    assert acc.gather_for_metrics(["a", "b"]) == ["a", "b"]  # objects: gather_object
    assert tdl.skip_first_batches(loader, 1) is acc.skip_first_batches(loader, 1)
    # trackers are ported: log_with is taken (no tracker is active before init_trackers: a blank one comes
    # back); a kwargs handler the port lacks still raises, naming its Queue 1 item
    assert Accelerator(cpu=True, log_with="jsonl").get_tracker("jsonl").name == ""
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Accelerator(cpu=True, kwargs_handlers=[object()])


def test_rng_synchronisation_with_one_process_touches_only_the_generator():
    from accelerate_tpu_torch.utils.random import synchronize_rng_state, synchronize_rng_states

    gen = torch.Generator().manual_seed(5)
    want = torch.Generator().manual_seed(5)
    np_state = np.random.get_state()[1].copy()
    synchronize_rng_states(["generator", "numpy", "python", "torch"], gen)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=want))
    np.testing.assert_array_equal(np.random.get_state()[1], np_state)
    with pytest.raises(ValueError):
        synchronize_rng_state("jax")
    loader = tdl.DataLoaderShard(Rows(5), batch_size=2, rng_types=["generator"], generator=gen, device_placement=False)
    assert [len(b["y"]) for b in loader] == [2, 2, 2]
