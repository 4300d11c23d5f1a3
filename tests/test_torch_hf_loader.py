"""The port's checkpoint loading on the CPU (models/convert.py): the reader
of Hugging Face checkpoint directories that needs neither transformers nor
safetensors (load_hf_dir and read_hf_tensors: safetensors single and
sharded, bf16/f16/f32, and pytorch_model.bin, bit for bit against the live
state dict), config.json dicts against the transformers config objects,
the command line's round trip with its tuples restored, and the refusal of
mixture-of-experts entries (ROADMAP A9). Logit parity of the converted
families: tests/test_torch_hf_convert.py."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flashattn_tpu_torch.models import convert, llama

transformers = pytest.importorskip("transformers")

from tests.test_torch_hf_convert import FAMILIES, _base  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def hf_config(family):
    """The transformers config of one of tests/test_torch_hf_convert.py's
    families."""
    cfg_cls, _, fields, _, _, _ = FAMILIES[family]
    return getattr(transformers, cfg_cls)(**fields)


def test_moe_entries_raise_naming_a9():
    """Mixtral's and the Qwen MoE families' expert entries name ROADMAP A9,
    and so does a model built from their converted configs."""
    cfg = convert.config_from_hf(dict(_base(), model_type="llama"), torch.float32)
    w = torch.zeros(128, 128)
    for name in ("model.layers.0.block_sparse_moe.gate.weight",
                 "model.layers.0.block_sparse_moe.experts.0.w1.weight",
                 "model.layers.0.mlp.gate.weight",
                 "model.layers.0.mlp.experts.0.gate_proj.weight",
                 "model.layers.0.mlp.shared_expert.up_proj.weight"):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            convert.params_from_hf({name: w}, cfg)
    moe = convert.config_from_hf(dict(_base(), model_type="mixtral", num_local_experts=4,
                                      num_experts_per_tok=2), torch.float32)
    assert moe.num_experts == 4
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        llama.Llama(moe, device="meta")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_json_dict_equals_config_object(tmp_path, family):
    """config_from_hf of the dict save_pretrained writes (which leaves out
    what equals transformers' defaults, Gemma's tied embeddings among them)
    equals that of the live object."""
    hf_cfg = hf_config(family)
    hf_cfg.save_pretrained(tmp_path)
    as_dict = json.loads((tmp_path / "config.json").read_text())
    assert (convert.config_from_hf(as_dict, torch.float32)
            == convert.config_from_hf(hf_cfg, torch.float32))


@pytest.fixture(scope="module")
def saved_qwen2(tmp_path_factory):
    """A Qwen2 model (biases, tied embeddings off) saved as safetensors and
    as pytorch_model.bin."""
    torch.manual_seed(11)
    model = transformers.Qwen2ForCausalLM(hf_config("qwen2_bias")).eval()
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(root / "st")
    model.save_pretrained(root / "bin", safe_serialization=False)
    return model, root


@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_load_hf_dir_reads_weights_bit_for_bit(saved_qwen2, fmt):
    """load_hf_dir's raw reader gives the live state_dict()'s tensors bit
    for bit, and the model it builds equals params_from_hf of the live
    state dict, with neither transformers nor safetensors imported."""
    model, root = saved_qwen2
    path = root / fmt
    assert (path / ("model.safetensors" if fmt == "st" else "pytorch_model.bin")).exists()
    live = model.state_dict()
    raw = dict(convert.read_hf_tensors(path))
    assert set(raw) <= set(live) and "model.embed_tokens.weight" in raw
    for name, value in raw.items():
        assert value.dtype == live[name].dtype and torch.equal(value, live[name]), name
    port, cfg = convert.load_hf_dir(path, torch.float32, device="cpu")
    assert cfg == convert.config_from_hf(model.config, torch.float32)
    want = convert.params_from_hf(live, cfg)
    got = port.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_read_safetensors_sharded_and_dtypes(tmp_path):
    """A checkpoint sharded by model.safetensors.index.json, in bf16, f16
    and f32, read back bit for bit."""
    safetensors = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "b": torch.randn(7, generator=g).to(torch.float16),
               "c": torch.randn(2, 2, 2, generator=g)}
    safetensors.save_file({"a": tensors["a"]}, tmp_path / "model-00001-of-00002.safetensors")
    safetensors.save_file({"b": tensors["b"], "c": tensors["c"]},
                          tmp_path / "model-00002-of-00002.safetensors")
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
        "a": "model-00001-of-00002.safetensors", "b": "model-00002-of-00002.safetensors",
        "c": "model-00002-of-00002.safetensors"}}))
    got = dict(convert.read_hf_tensors(tmp_path))
    assert set(got) == set(tensors)
    for name, value in tensors.items():
        assert got[name].dtype == value.dtype and torch.equal(got[name], value), name


def test_convert_cli_round_trip(saved_qwen2, tmp_path):
    """python -m flashattn_tpu_torch.models.convert writes model.pt and
    config.json in bf16; load_converted gives back params_from_hf's bf16
    conversion bit for bit and the config of the checkpoint, tuples of
    rope_scaling and rope_longrope restored (a hashable, equal config)."""
    model, root = saved_qwen2
    dst = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-m", "flashattn_tpu_torch.models.convert",
                           "--src", str(root / "st"), "--dst", str(dst)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    port, cfg = convert.load_converted(dst, device="cpu")
    assert cfg == convert.config_from_hf(model.config, torch.bfloat16)
    want = convert.params_from_hf(model.state_dict(), cfg)
    for name, value in port.state_dict().items():
        assert value.dtype == torch.bfloat16 and torch.equal(value, want[name]), name
    # Tuples survive the JSON round trip.
    rich = dataclasses.replace(cfg, rope_scaling=(8.0, 1.0, 4.0, 8192),
                               rope_longrope=((1.0, 1.1), (2.0, 2.5), 64, 1.19))
    fields = dataclasses.asdict(rich)
    fields["dtype"] = "bfloat16"
    (tmp_path / "rich").mkdir()
    (tmp_path / "rich" / "config.json").write_text(json.dumps(fields))
    loaded = convert.load_config(tmp_path / "rich")
    hash(loaded)
    assert loaded == rich
