"""``load_hf_llama`` and the port's own safetensors reader against the JAX
package's ``load_hf_llama`` on the CPU.  The tests write their shard files
themselves: safetensors shards with the ``safetensors`` package and
``pytorch_model*.bin`` shards with ``torch.save``, from the synthetic HF
state dict of ``tests/test_hf_convert.py``.  Trees are compared bitwise.

The reference reads safetensors through numpy (``safe_open(...,
framework="np")``); its bf16 read works because importing JAX registers
``ml_dtypes``' bfloat16 with numpy.  The port's bf16 safetensors read is
also held bitwise to its own ``.bin`` read of the same tensors.
"""

import json
import os

import numpy as np
import pytest
import torch

from safetensors.torch import load_file, save_file

from vescale_tpu.models import convert as ref_convert

from vescale_tpu_torch.models import LlamaConfig, load_hf_llama, read_safetensors

from test_hf_convert import CFG as REF_CFG, _fake_hf_state

CFG = LlamaConfig(vocab_size=REF_CFG.vocab_size, hidden_size=REF_CFG.hidden_size,
                  intermediate_size=REF_CFG.intermediate_size,
                  num_hidden_layers=REF_CFG.num_hidden_layers,
                  num_attention_heads=REF_CFG.num_attention_heads,
                  num_key_value_heads=REF_CFG.num_key_value_heads,
                  max_position_embeddings=REF_CFG.max_position_embeddings, dtype=torch.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _write_shards(d, sd, route, n=3):
    """``sd`` cut into ``n`` shards (keys in sorted order) in ``d``."""
    keys = sorted(sd)
    cuts = np.array_split(np.arange(len(keys)), n)
    for i, idx in enumerate(cuts):
        part = {keys[j]: sd[keys[j]].contiguous() for j in idx}
        if route == "safetensors":
            save_file(part, os.path.join(d, f"model-{i + 1:05d}-of-{n:05d}.safetensors"),
                      metadata={"format": "pt"})
        else:
            torch.save(part, os.path.join(d, f"pytorch_model-{i + 1:05d}-of-{n:05d}.bin"))
    # an index file beside the shards is not a shard
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": {}}, f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("route", ["safetensors", "bin"])
def test_tree_is_bitwise_the_references(tmp_path, route, dtype):
    sd = {k: v.to(dtype) for k, v in _fake_hf_state(REF_CFG, seed=3).items()}
    _write_shards(str(tmp_path), sd, route)
    got = _flat(load_hf_llama(str(tmp_path), CFG, device="cpu"))
    want = _flat(ref_convert.load_hf_llama(str(tmp_path), REF_CFG))
    assert set(got) == set(want) and len(got) == 3 + 9 * REF_CFG.num_hidden_layers
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        w = np.asarray(want[k])
        assert t.shape == w.shape and np.array_equal(t.numpy(), w), k


def test_bf16_safetensors_read_is_bitwise_the_bin_read(tmp_path):
    sd = {k: v.to(torch.bfloat16) for k, v in _fake_hf_state(REF_CFG, seed=4).items()}
    st, pt = tmp_path / "st", tmp_path / "pt"
    st.mkdir()
    pt.mkdir()
    _write_shards(str(st), sd, "safetensors", n=2)
    _write_shards(str(pt), sd, "bin", n=2)
    a = _flat(load_hf_llama(str(st), CFG, device="cpu"))
    b = _flat(load_hf_llama(str(pt), CFG, device="cpu"))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_a_directory_without_shards_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    for load in (lambda: load_hf_llama(str(tmp_path), CFG, device="cpu"),
                 lambda: ref_convert.load_hf_llama(str(tmp_path), REF_CFG)):
        with pytest.raises(FileNotFoundError):
            load()


def test_safetensors_beat_bin_shards_in_one_directory(tmp_path):
    sd = _fake_hf_state(REF_CFG, seed=5)
    _write_shards(str(tmp_path), sd, "safetensors", n=1)
    torch.save({"junk": torch.zeros(1)}, tmp_path / "pytorch_model.bin")
    got = _flat(load_hf_llama(str(tmp_path), CFG, device="cpu"))
    want = _flat(ref_convert.load_hf_llama(str(tmp_path), REF_CFG))
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in want)


DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
          torch.float16, torch.bfloat16, torch.float32, torch.float64]


def test_read_safetensors_is_the_packages_load_file(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3, 5, generator=g) * 100
        tensors[f"t{i}"] = x > 0 if dt == torch.bool else x.to(dt)
    tensors["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    tensors["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    tensors["odd"] = torch.arange(7, dtype=torch.int16)
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"who": "test"})
    got, want = read_safetensors(path), load_file(path)
    assert set(got) == set(want) == set(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_read_safetensors_handles_an_unaligned_tensor_and_refuses_a_bad_header(tmp_path):
    """A hand-written file whose fp32 tensor starts 2 bytes into the data
    (after a 1-element int16): read by copying it to an aligned buffer."""
    a = np.array([7], np.int16).tobytes()
    b = np.arange(3, dtype=np.float32).tobytes()
    header = {"a": {"dtype": "I16", "shape": [1], "data_offsets": [0, 2]},
              "b": {"dtype": "F32", "shape": [3], "data_offsets": [2, 14]},
              "__metadata__": {"k": "v"}}
    raw = json.dumps(header).encode()
    path = tmp_path / "u.safetensors"
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + a + b)
    got = read_safetensors(str(path))
    assert got["a"].tolist() == [7] and got["b"].tolist() == [0.0, 1.0, 2.0]
    header["b"]["shape"] = [4]
    raw = json.dumps(header).encode()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + a + b)
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(str(path))
