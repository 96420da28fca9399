"""The port's TokenDataLoader against the JAX package's, on the CPU: on the
same token file, seed, batch, seq_len and dp coordinates the batches are
equal bit for bit, resume is sample-exact forward and backward, and the
elastic mode gives one global stream under any dp split."""

import os

import numpy as np
import pytest
import torch

from vescale_tpu.data.loader import TokenDataLoader as JaxLoader

from vescale_tpu_torch.data import TokenDataLoader, loader as port_loader

BATCH, SEQ = 3, 16


@pytest.fixture(scope="module")
def token_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(0)
    u16 = str(d / "u16.bin")
    rng.integers(0, 50304, 20_000).astype(np.uint16).tofile(u16)
    i32 = str(d / "i32.bin")
    rng.integers(0, 128256, 20_000).astype(np.int32).tofile(i32)
    return {np.uint16: u16, np.int32: i32}


def _pair(path, token_dtype, **kw):
    kw = {"seed": 5, "elastic": False, **kw}
    ref = JaxLoader(path, kw.pop("batch", BATCH), kw.pop("seq_len", SEQ), token_dtype=token_dtype,
                    **kw)
    port = TokenDataLoader(path, ref.batch, ref.seq_len, token_dtype=token_dtype, device="cpu",
                           **kw)
    return ref, port


def _equal(port_batch, ref_batch):
    for key in ("input", "target"):
        got = port_batch[key]
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), ref_batch[key])


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("dp", [(0, 1), (1, 3)])
@pytest.mark.parametrize("token_dtype", [np.uint16, np.int32])
def test_batches_equal_the_reference_loader(token_files, token_dtype, dp, elastic):
    ref, port = _pair(token_files[token_dtype], token_dtype, dp_rank=dp[0], dp_world=dp[1],
                      elastic=elastic)
    try:
        assert port.num_tokens == ref.num_tokens == 20_000
        for _ in range(6):
            _equal(port.next(), ref.next())
        assert port.batches_served == 6
        assert port.state() == ref.state()
        b = port.next()
        assert torch.equal(b["input"][:, 1:], b["target"][:, :-1])  # next-token pairs
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("elastic", [False, True])
def test_resume_is_sample_exact_forward_and_backward(token_files, elastic):
    path = token_files[np.uint16]
    golden = TokenDataLoader(path, BATCH, SEQ, seed=2, elastic=elastic, device="cpu")
    stream = [golden.next() for _ in range(8)]
    golden.close()
    loader = TokenDataLoader(path, BATCH, SEQ, seed=2, elastic=elastic, device="cpu")
    try:
        state = dict(loader.state(), batches_served=5)
        loader.load_state(state)  # forward: the native seek
        for want in stream[5:8]:
            got = loader.next()
            assert torch.equal(got["input"], want["input"]) and torch.equal(got["target"], want["target"])
        loader.load_state(dict(state, batches_served=2))  # backward: reopen, then seek
        assert loader.batches_served == 2
        for want in stream[2:4]:
            assert torch.equal(loader.next()["input"], want["input"])
    finally:
        loader.close()


def test_elastic_stream_is_invariant_to_the_dp_split(token_files):
    path = token_files[np.uint16]
    whole = TokenDataLoader(path, 4, SEQ, seed=9, elastic=True, device="cpu")
    halves = [TokenDataLoader(path, 2, SEQ, seed=9, dp_rank=r, dp_world=2, elastic=True,
                              device="cpu") for r in range(2)]
    try:
        for _ in range(3):
            full = whole.next()["input"]
            split = torch.cat([h.next()["input"] for h in halves])
            assert torch.equal(full, split)
        # a resume onto the other split re-derives the position from the global cursor
        state = whole.state()
        assert state["samples_served"] == 12 and state["global_batch"] == 4
        fresh = TokenDataLoader(path, 2, SEQ, seed=9, dp_rank=1, dp_world=2, elastic=True,
                                device="cpu")
        fresh.load_state(state)
        assert fresh.batches_served == 3
        assert torch.equal(fresh.next()["input"], whole.next()["input"][2:])
        fresh.close()
        with pytest.raises(ValueError, match="VSC133"):
            bad = TokenDataLoader(path, 3, SEQ, seed=9, dp_rank=0, dp_world=2, elastic=True,
                                  device="cpu")
            try:
                bad.load_state(state)
            finally:
                bad.close()
    finally:
        whole.close()
        for h in halves:
            h.close()


def test_state_of_another_stream_is_refused(token_files):
    path = token_files[np.uint16]
    loader = TokenDataLoader(path, BATCH, SEQ, seed=1, device="cpu")
    try:
        for key, value in (("seed", 2), ("dp_rank", 1), ("seq_len", 8), ("elastic", 1)):
            with pytest.raises(ValueError, match=key):
                loader.load_state(dict(loader.state(), **{key: value}))
    finally:
        loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next()


def test_too_small_a_file_is_refused(tmp_path):
    path = str(tmp_path / "tiny.bin")
    np.arange(10, dtype=np.uint16).tofile(path)
    with pytest.raises(OSError, match="cannot open"):
        TokenDataLoader(path, 1, SEQ, device="cpu")


def test_the_library_is_the_ports_own_build():
    so = port_loader.build_native()
    assert os.path.basename(so) == "libvdl.abi2.so"
    assert os.path.dirname(so) == os.path.join(os.path.dirname(port_loader.__file__), "build")
    assert port_loader._lib().vdl_abi_version() == 2


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_elastic_default_reads_the_knob_as_the_reference_does(token_files, monkeypatch, env):
    """``elastic=None`` reads ``VESCALE_ELASTIC_LOADER`` (off while unset) in
    both loaders, and their batches and states stay equal."""
    if env is None:
        monkeypatch.delenv("VESCALE_ELASTIC_LOADER", raising=False)
    else:
        monkeypatch.setenv("VESCALE_ELASTIC_LOADER", env)
    ref, port = _pair(token_files[np.uint16], np.uint16, dp_rank=1, dp_world=2, elastic=None)
    try:
        assert port.elastic == ref.elastic == (env == "1")
        for _ in range(3):
            _equal(port.next(), ref.next())
        assert port.state() == ref.state()
    finally:
        ref.close()
        port.close()
