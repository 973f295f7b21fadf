"""The port's framed transport (serving_transport.py) against the JAX
package's: frames byte-equal for the same object and blob and each side
decoding the other's; the failure semantics (partial reads, an oversized
length refused before the body, corrupt frames, peer death mid-frame, a
structured worker error); the failover-snapshot codec (meta field for
field equal to the JAX package's on equivalent engines, round trips
bit-equal in f32 and bf16, subsets of a bundle)."""

import dataclasses
import json
import os
import socket
import struct
import threading
import time
import zlib

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
import accelerate_tpu.serving_transport as jt
import accelerate_tpu_torch.serving_transport as pt
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.serving_proc import ProcConfig, ProcessSupervisor, subset_snapshots

torch.set_num_threads(2)

_HEADER = struct.Struct(">2sBBIII")
ENGINE = dict(num_slots=2, prompt_buckets=(8,), max_len=64, tick_block=2)
PROMPTS = [np.asarray([3, 17, 5, 9, 11], np.int32), np.asarray([8, 2, 2, 40, 7, 7, 1], np.int32),
           np.asarray([100, 101, 3], np.int32)]


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _wire(mod, obj, blob=b""):
    """The bytes ``mod.send_msg`` writes for ``obj`` and ``blob``."""
    a, b = _pair()
    try:
        n = mod.send_msg(a, obj, blob)
        a.close()
        out = b""
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                break
            out += chunk
        assert len(out) == n
        return out
    finally:
        b.close()


FRAME_CASES = {
    "status": ({"op": "status", "ack": [1, 2], "shadow_kv": True}, b""),
    "blob": ({"op": "import_snaps", "uids": [3], "allow_kv": False}, bytes(range(256)) * 17),
    "floats": ({"done": {"4": {"tokens": [1, 2, 3], "lps": [-0.5, -1.25e-07, -3.0]}}, "x": None}, b"\x00\xff"),
    "unicode": ({"err": {"kind": "bad_op", "detail": "unknown op 'π'"}}, b""),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_byte_equal_to_jax_and_cross_decode(case):
    obj, blob = FRAME_CASES[case]
    wire = _wire(pt, obj, blob)
    assert wire == _wire(jt, obj, blob)
    for sender, receiver in ((pt, jt), (jt, pt)):
        a, b = _pair()
        try:
            sender.send_msg(a, obj, blob)
            got, rblob = receiver.recv_msg(b)
            assert got == obj and rblob == blob
        finally:
            a.close()
            b.close()
    assert (pt.MAGIC, pt.VERSION, pt.MAX_FRAME_BYTES) == (jt.MAGIC, jt.VERSION, jt.MAX_FRAME_BYTES)


def test_recv_exact_loops_over_partial_reads():
    """TCP segmentation is invisible: the peer dribbles one frame a few
    bytes at a time."""
    a, b = _pair()
    payload = json.dumps({"op": "x"}, separators=(",", ":")).encode()
    blob = np.random.default_rng(0).integers(0, 256, size=503, dtype=np.uint8).tobytes()
    crc = zlib.crc32(blob, zlib.crc32(payload))
    wire = _HEADER.pack(pt.MAGIC, pt.VERSION, 0, len(payload), len(blob), crc) + payload + blob

    def dribble():
        for i in range(0, len(wire), 7):
            a.sendall(wire[i : i + 7])
            time.sleep(0.0005)
        a.close()

    t = threading.Thread(target=dribble)
    t.start()
    try:
        obj, rblob = pt.recv_msg(b)
        assert obj == {"op": "x"} and rblob == blob
    finally:
        t.join(timeout=10)
        b.close()


def test_oversized_frame_refused_before_body():
    a, b = _pair()
    try:
        a.sendall(_HEADER.pack(pt.MAGIC, pt.VERSION, 0, 1 << 30, 1 << 30, 0))
        with pytest.raises(pt.FrameError, match="exceeds"):
            pt.recv_msg(b, max_frame=1 << 20)
        with pytest.raises(pt.FrameError, match="exceeds"):
            pt.send_msg(a, {"op": "big"}, b"x" * 32, max_frame=16)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda h, p: (b"XX" + h[2:], p), "magic"),
        (lambda h, p: (h[:2] + bytes([pt.VERSION + 1]) + h[3:], p), "version"),
        (lambda h, p: (h, p[:-1] + bytes([p[-1] ^ 0xFF])), "crc32"),
    ],
    ids=["magic", "version", "crc32"],
)
def test_corrupt_frame_structured_error(mutate, match):
    a, b = _pair()
    try:
        payload = json.dumps({"op": "x"}, separators=(",", ":")).encode()
        header = _HEADER.pack(pt.MAGIC, pt.VERSION, 0, len(payload), 0, zlib.crc32(b"", zlib.crc32(payload)))
        header, payload = mutate(header, payload)
        a.sendall(header + payload)
        with pytest.raises(pt.FrameError, match=match):
            pt.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_undecodable_json_is_frame_error():
    a, b = _pair()
    try:
        payload = b"\xff\xfe not json"
        a.sendall(_HEADER.pack(pt.MAGIC, pt.VERSION, 0, len(payload), 0, zlib.crc32(payload)) + payload)
        with pytest.raises(pt.FrameError, match="undecodable"):
            pt.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_peer_death_mid_frame_raises_peer_closed():
    """The header promises 64 payload bytes, the peer dies after 10."""
    a, b = _pair()
    try:
        a.sendall(_HEADER.pack(pt.MAGIC, pt.VERSION, 0, 64, 0, 0) + b"x" * 10)
        a.close()
        with pytest.raises(pt.PeerClosedError) as ei:
            pt.recv_msg(b)
        assert ei.value.got == 10 and ei.value.want == 64
    finally:
        b.close()


def test_recv_exact_zero_and_eof_semantics():
    a, b = _pair()
    try:
        assert pt.recv_exact(b, 0) == b""
        a.close()
        with pytest.raises(pt.PeerClosedError):
            pt.recv_exact(b, 1)
    finally:
        b.close()


def test_worker_error_reply_raises_structured():
    a, b = _pair()

    def server():
        obj, _ = pt.recv_msg(b)
        pt.send_msg(b, {"err": {"kind": "bad_uid", "detail": f"no uid {obj['uid']}"}})

    t = threading.Thread(target=server)
    t.start()
    try:
        with pytest.raises(pt.WorkerError, match="no uid 7") as ei:
            pt.request(a, {"op": "result", "uid": 7}, timeout=5.0)
        assert ei.value.kind == "bad_uid" and ei.value.detail["detail"] == "no uid 7"
    finally:
        t.join(timeout=10)
        a.close()
        b.close()


# --------------------------------------------------------------------- #
# failover-snapshot codec
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def engines():
    """The JAX package's dense engine and the port's on the same weights
    (f32), each with the same three requests submitted and two ticks run:
    two decoding, one queued."""
    jcfg = jm.LlamaConfig.tiny()
    jmodel = jm.create_llama_model(jcfg, seed=2, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    jeng = JaxServingEngine(jmodel, **ENGINE)
    peng = ServingEngine(model, device="cpu", **ENGINE)
    for eng in (jeng, peng):
        for p in PROMPTS:
            eng.submit(p, 12)
        eng.step()
        eng.step()
    return jeng, peng, model


def test_snapshot_meta_matches_jax_field_for_field(engines):
    jeng, peng, _ = engines
    jsnaps, psnaps = jeng.export_inflight(include_kv=True), peng.export_inflight(include_kv=True)
    jmeta, pmeta = jt.snapshot_meta(jsnaps), pt.snapshot_meta(psnaps)
    assert len(pmeta) == len(PROMPTS) and sum(m["has_kv"] for m in pmeta) == 2
    assert pmeta == jmeta
    # the encoder's meta is snapshot_meta's, and the KV bytes are the rows' own
    meta, _ = pt.encode_snapshots(psnaps)
    assert meta == pmeta
    per_tok, fixed = peng.kv_handoff_dims()
    assert all(m["kv_bytes"] == m["rows"] * per_tok + fixed for m in pmeta if m["has_kv"])


def _assert_snaps_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
        np.testing.assert_array_equal(g["gen_state"], np.asarray(w["gen_state"], np.uint8))
        for k in ("uid", "max_new_tokens", "out_tokens", "out_lps", "priority", "trace"):
            assert g[k] == w[k], k
        assert g["stop_sequences"] == tuple(tuple(s) for s in w["stop_sequences"])
        assert ("cache" in g) == (w.get("cache") is not None)
        if "cache" in g:
            assert g["rows"] == w["rows"]
            for name in pt.ROW_LEAVES:
                assert g["cache"][name].dtype == w["cache"][name].dtype
                assert torch.equal(g["cache"][name], w["cache"][name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_round_trip_bit_equal(engines, dtype):
    """Every field back as it went, the rows bit for bit in f32 and bf16
    (bf16 never passes through a numpy dtype), a sampled request's
    generator state and stop sequences included; a row template of another
    dtype refuses the rows."""
    _, _, model = engines
    m = create_llama_model(model.config, device="cpu", dtype=getattr(torch, dtype))
    eng = ServingEngine(m, device="cpu", temperature=0.8, top_k=20, seed=5, **ENGINE)
    for p in PROMPTS:
        eng.submit(p, 12, stop_sequences=[(7, 7), (250,)])
    eng.step()
    eng.step()
    snaps = eng.export_inflight(include_kv=True)
    assert sum(s.get("cache") is not None for s in snaps) == 2 and all(len(s["gen_state"]) for s in snaps)
    _, blob = pt.encode_snapshots(snaps)
    _assert_snaps_equal(pt.decode_snapshots(blob, eng), snaps)
    other = ServingEngine(create_llama_model(model.config, device="cpu",
                                             dtype=torch.float32 if dtype == "bfloat16" else torch.bfloat16),
                          device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="row template"):
        pt.decode_snapshots(blob, other)
    # a subset re-packs the chosen snapshots only, rows untouched
    pick = [snaps[1]["uid"], snaps[2]["uid"]]
    _assert_snaps_equal(pt.decode_snapshots(subset_snapshots(blob, pick), eng), snaps[1:])
    assert pt.decode_snapshots(subset_snapshots(blob, []), eng) == []


def test_import_of_decoded_snapshots_continues_exactly(engines):
    """Decoded snapshots fed to another engine's import_inflight finish
    each request with the tokens and logprobs the exporting engine gives."""
    _, peng, model = engines
    snaps = peng.export_inflight(include_kv=True)
    _, blob = pt.encode_snapshots(snaps)
    other = ServingEngine(model, device="cpu", **ENGINE)
    uids = {s["uid"]: other.import_inflight(s) for s in pt.decode_snapshots(blob, other)}
    done, other_done = peng.run(), other.run()
    for uid, new in uids.items():
        np.testing.assert_array_equal(other_done[new], done[uid])
        np.testing.assert_array_equal(other.logprobs(new), peng.logprobs(uid))


def test_store_dir_defaults_under_run_dir(tmp_path):
    """``ProcConfig(store_dir=...)`` is the store every worker's program
    cache opens (made by the supervisor), ``{run_dir}/store`` by default,
    as in the JAX package; an unknown device is refused before any
    directory is made."""
    with pytest.raises(ValueError, match="unsupported worker device"):
        ProcessSupervisor(ProcConfig(run_dir=str(tmp_path / "bad"), device="tpu"))
    assert not os.path.exists(tmp_path / "bad")
    sup = ProcessSupervisor(ProcConfig(run_dir=str(tmp_path / "a"), store_dir=str(tmp_path / "store"), device="cpu"))
    try:
        assert sup.store_dir == str(tmp_path / "store") and os.path.isdir(tmp_path / "store")
    finally:
        sup.shutdown()
    sup = ProcessSupervisor(ProcConfig(run_dir=str(tmp_path / "b"), device="cpu"))
    try:
        assert sup.store_dir == os.path.join(str(tmp_path / "b"), "store") and os.path.isdir(sup.store_dir)
    finally:
        sup.shutdown()
