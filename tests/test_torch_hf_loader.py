"""The port's checkpoint loading on the CPU (models/convert.py): the reader
of Hugging Face checkpoint directories that needs neither transformers nor
safetensors (load_hf_dir and read_hf_tensors: safetensors single and
sharded, bf16/f16/f32, and pytorch_model.bin, bit for bit against the live
state dict), config.json dicts against the transformers config objects,
the command line's round trip with its tuples restored, and the
mixture-of-experts conversion: the experts of a sharded Qwen2-MoE
directory stacked by load_hf_dir, a missing expert refused, the expert
width taken from moe_intermediate_size (a deliberate difference from the
JAX converter), dense layers among MoE ones refused. Logit parity of the
converted families: tests/test_torch_hf_convert.py."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flashattn_tpu.models import convert as jax_convert
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


@pytest.mark.parametrize("family", ["qwen3_moe_norm_topk", "qwen2_moe_shared", "mixtral_moe"])
def test_moe_config_takes_the_expert_width(family):
    """A deliberate difference from the JAX converter (ROADMAP §C): for the
    Qwen MoE families intermediate_size is moe_intermediate_size, the
    experts' width, which the port's model allocates from the config; the
    JAX function keeps HF's intermediate_size, unused by its forward, which
    takes the shapes from the weights. Mixtral's intermediate_size is its
    expert width in both."""
    hf_cfg = hf_config(family)
    cfg = convert.config_from_hf(hf_cfg, torch.float32)
    jcfg = jax_convert.config_from_hf(hf_cfg)
    width = getattr(hf_cfg, "moe_intermediate_size", hf_cfg.intermediate_size)
    assert cfg.intermediate_size == width and jcfg.intermediate_size == hf_cfg.intermediate_size
    assert (cfg.num_experts, cfg.top_k_experts, cfg.moe_norm_topk,
            cfg.moe_shared_intermediate) == (jcfg.num_experts, jcfg.top_k_experts,
                                             jcfg.moe_norm_topk, jcfg.moe_shared_intermediate)
    shapes = {k: tuple(v.shape) for k, v in llama.Llama(cfg, device="meta").state_dict().items()}
    assert shapes["layers.0.moe.w_gate"] == (4, cfg.hidden_size, width)
    assert shapes["layers.0.moe.w_down"] == (4, width, cfg.hidden_size)


def test_moe_configs_with_dense_layers_raise():
    """A Qwen MoE config with dense MLP layers among the MoE ones is refused,
    as the JAX converter refuses it."""
    for extra in (dict(decoder_sparse_step=2), dict(mlp_only_layers=[1])):
        cfg = dict(_base(), model_type="qwen2_moe", num_experts=4, num_experts_per_tok=2,
                   moe_intermediate_size=64, shared_expert_intermediate_size=64, **extra)
        with pytest.raises(NotImplementedError, match="dense MLP layers"):
            convert.config_from_hf(cfg, torch.float32)


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


@pytest.fixture(scope="module")
def saved_qwen2_moe(tmp_path_factory):
    """A Qwen2-MoE model (4 experts, a shared expert, biases) saved as
    safetensors in shards of at most 200 KB (its experts spread over them)."""
    torch.manual_seed(41)
    model = transformers.Qwen2MoeForCausalLM(hf_config("qwen2_moe_shared")).eval()
    root = tmp_path_factory.mktemp("hf_moe")
    model.save_pretrained(root, max_shard_size="200KB")
    return model, root


def test_load_hf_dir_stacks_moe_experts(saved_qwen2_moe):
    """load_hf_dir on a sharded Qwen2-MoE directory: each expert's entry
    copied into its slice of the stacked tensor, the router, the shared
    expert and its gate transposed; the model equals params_from_hf's
    conversion of the live state dict bit for bit, and its logits
    transformers'."""
    model, root = saved_qwen2_moe
    assert (root / "model.safetensors.index.json").exists()
    assert len(list(root.glob("*.safetensors"))) > 2
    live = model.state_dict()
    port, cfg = convert.load_hf_dir(root, torch.float32, device="cpu")
    assert cfg == convert.config_from_hf(model.config, torch.float32)
    want = convert.params_from_hf(live, cfg)
    got = port.state_dict()
    assert set(got) == set(want) and "layers.1.moe.shared_gate" in got
    for name in want:
        assert torch.equal(got[name], want[name]), name
    p = "model.layers.1.mlp."
    assert torch.equal(got["layers.1.moe.w_down"][3], live[p + "experts.3.down_proj.weight"].t())
    assert torch.equal(got["layers.1.moe.router"], live[p + "gate.weight"].t())
    assert torch.equal(got["layers.1.moe.shared_gate"], live[p + "shared_expert_gate.weight"].t())
    tokens = torch.tensor([[7, 3, 99, 21, 5, 18, 200, 41]])
    with torch.no_grad():
        np.testing.assert_allclose(llama.forward(port, tokens).numpy(),
                                   model(tokens).logits.numpy(), rtol=2e-3, atol=2e-3)


def test_params_from_hf_refuses_a_missing_expert(saved_qwen2_moe):
    """A checkpoint that lacks one expert's projection leaves a slice of the
    stacked tensor unwritten: the conversion raises naming it."""
    model, _ = saved_qwen2_moe
    sd = dict(model.state_dict())
    del sd["model.layers.0.mlp.experts.2.up_proj.weight"]
    cfg = convert.config_from_hf(model.config, torch.float32)
    with pytest.raises(ValueError, match=r"lacks experts \[2\] of layers.0.moe.w_up"):
        convert.params_from_hf(sd, cfg)


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


def test_convert_cli_round_trip_moe(saved_qwen2_moe, tmp_path):
    """The command line on a sharded MoE directory: load_converted gives back
    the stacked experts of params_from_hf's bf16 conversion bit for bit."""
    model, root = saved_qwen2_moe
    dst = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-m", "flashattn_tpu_torch.models.convert",
                           "--src", str(root), "--dst", str(dst)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    port, cfg = convert.load_converted(dst, device="cpu")
    assert cfg == convert.config_from_hf(model.config, torch.bfloat16) and cfg.num_experts == 4
    want = convert.params_from_hf(model.state_dict(), cfg)
    got = port.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        assert value.dtype == torch.bfloat16 and torch.equal(value, want[name]), name
