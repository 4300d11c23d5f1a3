"""The sliding window and attention sinks through the port's model,
generation and server (the plain paths on the CPU) against the JAX
package's, on the same weights (carried across by
models/convert.py::params_from_jax) and requests: a Mistral-shaped tiny
config (GQA 4/2, window 16) with window_pattern None and "alternate" and
0 or 4 sinks, prompts longer than the window, and decoding past it;
generate and InferenceServer (dense, paged with backpressure, a registered
prefix, chunked admission, an int8 KV cache) give the JAX server's greedy
tokens. Also tests/test_window.py::test_windowed_model_train_decode_agree
(the forward with a gradient, the no-grad forward and the teacher-forced
decode agree) and ::test_decode_attention_sinks on the port, and the
windowed loss's gradients (the backward kernels' plain version with the
window) against jax.value_and_grad of the JAX loss_fn, with window_pattern
None and "alternate".

float32 models. Greedy tokens must be equal; teacher-forced decode logits
against the forward's within rtol 2e-4, atol 2e-4, and the sinks against
their numpy oracle within atol 1e-5, rtol 1e-5 (the JAX tests' own
tolerances); the loss within 1e-5 of JAX's and its gradients atol 1e-5,
rtol 1e-4 (tests/test_torch_train.py's rule); MISTRAL_7B's fields equal the
JAX config's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import config as jax_config
from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import serve as jax_serve
from flashattn_tpu_torch.models import config, generate, llama
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import decode, kvcache
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=512, attn_window=16)
VARIANTS = {  # name: (window_pattern, attn_sink)
    "every_layer": (None, 0),
    "alternate_sinks": ("alternate", 4),
}


def pair(pattern, sink):
    """The JAX params and config, and the port's model with the same weights."""
    kw = dict(CFG_KW, window_pattern=pattern, attn_sink=sink)
    jcfg = jax_config.ModelConfig(dtype=jnp.float32, **kw)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


@pytest.fixture(scope="module")
def alternate():
    return pair(*VARIANTS["alternate_sinks"])


def test_mistral_7b_config_matches_jax():
    port = {f.name: getattr(config.MISTRAL_7B, f.name)
            for f in dataclasses.fields(config.MISTRAL_7B) if f.name != "dtype"}
    ref = {f.name: getattr(jax_config.MISTRAL_7B, f.name)
           for f in dataclasses.fields(jax_config.MISTRAL_7B) if f.name != "dtype"}
    assert port == ref
    config.check_supported(config.MISTRAL_7B)
    assert [llama.layer_window(config.MISTRAL_7B, i) for i in range(3)] == [4096] * 3
    alt = dataclasses.replace(config.MISTRAL_7B, window_pattern="alternate")
    assert [llama.layer_window(alt, i) for i in range(3)] == [4096, None, 4096]
    with pytest.raises(ValueError, match="window_pattern"):
        config.check_supported(dataclasses.replace(alt, window_pattern="every_third"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_windowed_generate_matches_jax(variant):
    """A 36-token prompt (past the 16-token window) and 6 new tokens."""
    jcfg, params, model = pair(*VARIANTS[variant])
    prompt = np.random.default_rng(1).integers(0, 128, (2, 36)).astype(np.int32)
    want = jax_generate.generate(params, jnp.asarray(prompt), jcfg, max_new_tokens=6,
                                 max_len=128)
    got = generate.generate(model, torch.from_numpy(prompt), max_new_tokens=6, max_len=128)
    assert got.tolist() == np.asarray(want).tolist()


REQS = [  # (uid, prompt, new tokens): prompts past the window, slots recycling
    (1, [(3 + 5 * i) % 128 for i in range(41)], 6),
    (2, [2, 7, 1], 10),
    (3, [(7 * i) % 128 for i in range(70)], 4),
    (4, list(range(20)), 7),
]
OPTIONS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=128, num_pages=3),
    "int8_kv_admit_chunk": dict(quant="int8", admit_chunk=64),
    "admit_chunk_paged": dict(admit_chunk=32, paged=True, page_size=128, num_pages=4),
}


def run_pair(jcfg, params, model, option, reqs, prefix=None):
    jsrv = jax_serve.InferenceServer(params, jcfg, max_slots=2, max_len=256, **option)
    srv = InferenceServer(model, max_slots=2, max_len=256, **option)
    jpid = pid = None
    if prefix is not None:
        jpid, pid = jsrv.register_prefix(prefix), srv.register_prefix(prefix)
    for uid, prompt, n in reqs:
        shared = prefix is not None and prompt[:len(prefix)] == prefix
        jsrv.submit(jax_serve.Request(uid=uid, prompt=prompt, max_new_tokens=n,
                                      prefix_id=jpid if shared else None))
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n,
                           prefix_id=pid if shared else None))
    return srv, jsrv.run(), srv.run()


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_windowed_server_matches_jax(alternate, name):
    jcfg, params, model = alternate
    srv, want, got = run_pair(jcfg, params, model, OPTIONS[name], REQS)
    assert got == want and sorted(got) == [1, 2, 3, 4]
    if srv.paged:
        assert srv.allocator.free_pages == srv.allocator.num_pages


def test_windowed_prefix_admission_matches_jax(alternate):
    """A registered 128-token prefix (one page) before two prompts: the
    suffix's chunk attends the gathered prefix through the window."""
    jcfg, params, model = alternate
    prefix = [(11 + 3 * i) % 128 for i in range(128)]
    reqs = [(1, prefix + [5, 6, 7], 6), (2, [9, 8], 4), (3, prefix + list(range(30)), 7)]
    option = dict(paged=True, page_size=128, num_pages=5)
    srv, want, got = run_pair(jcfg, params, model, option, reqs, prefix=prefix)
    assert got == want
    assert srv.allocator.free_pages == 4  # the registry's page is held


def test_windowed_forward_matches_decode_steps():
    """tests/test_window.py::test_windowed_model_train_decode_agree on the
    port: attn_window threads through the training forward (with a
    gradient: the autograd Function with the window), the no-grad forward
    (K1's plain version) and the decode path alike, so the three agree."""
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=2, num_kv_heads=2, head_dim=32, max_seq_len=256, attn_window=40)
    params = jax_llama.init_params(jax_config.ModelConfig(dtype=jnp.float32, **kw),
                                   jax.random.PRNGKey(0))
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (1, 96)))
    with torch.no_grad():
        forward = llama.forward(model, tokens)  # [1, S, V]
    train_logits = llama.forward(model, tokens)
    assert train_logits.requires_grad
    np.testing.assert_allclose(train_logits.detach().numpy(), forward.numpy(), rtol=2e-4,
                               atol=2e-4)
    caches = generate.init_caches(model, 1, 128)
    logits, caches = generate.prefill(model, tokens[:, :1], caches)
    np.testing.assert_allclose(logits.numpy(), forward[:, 0].numpy(), rtol=2e-4, atol=2e-4)
    for t in range(1, 96):
        logits, caches = generate.decode_step(model, tokens[:, t],
                                              torch.full((1,), t, dtype=torch.int32), caches)
        np.testing.assert_allclose(logits.numpy(), forward[:, t].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"position {t}")


@pytest.mark.parametrize("t_chunk", [1, 4])
def test_decode_attention_sinks(t_chunk):
    """tests/test_window.py::test_decode_attention_sinks on the port: the
    window plus the first `sink` tokens always visible, against a softmax
    over exactly that key set."""
    b, hq, hkv, d, s_max = 2, 4, 2, 64, 1024
    length, window, sink = 900, 256, 16
    rng = np.random.default_rng(0)
    kn = rng.standard_normal((b, hkv, length, d), dtype=np.float32)
    vn = rng.standard_normal((b, hkv, length, d), dtype=np.float32)
    q = rng.standard_normal((b, hq, t_chunk, d), dtype=np.float32)
    cache = kvcache.init_cache(b, hkv, s_max, d, dtype=torch.float32, device="cpu")
    kvcache.update_cache(cache, torch.from_numpy(kn), torch.from_numpy(vn))
    if t_chunk == 1:
        o = decode.decode_attention(torch.from_numpy(q[:, :, 0]), cache, window=window,
                                    sink=sink)[:, :, None]
    else:
        o = decode.decode_attention_chunk(torch.from_numpy(q), cache, window=window, sink=sink)
    qe = q.reshape(b, hkv, hq // hkv, t_chunk, d)
    out = np.zeros((b, hkv, hq // hkv, t_chunk, d), np.float32)
    for bi in range(b):
        for h in range(hkv):
            for g in range(hq // hkv):
                for t in range(t_chunk):
                    row_pos = length - t_chunk + t
                    vis = [p for p in range(length)
                           if p <= row_pos and (p >= row_pos - window + 1 or p < sink)]
                    s = qe[bi, h, g, t] @ kn[bi, h, vis].T / np.sqrt(d)
                    p = np.exp(s - s.max())
                    p /= p.sum()
                    out[bi, h, g, t] = p @ vn[bi, h, vis]
    np.testing.assert_allclose(o.numpy(), out.reshape(b, hq, t_chunk, d), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pattern", [None, "alternate"])
def test_windowed_loss_grads_match_jax(pattern):
    """The windowed model's loss and gradients (window 40, 96 tokens: the
    window bites) against jax.value_and_grad(llama.loss_fn)."""
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256, attn_window=40,
              window_pattern=pattern)
    jcfg = jax_config.ModelConfig(dtype=jnp.float32, **kw)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(3))
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tokens = np.random.default_rng(4).integers(0, 64, (2, 97)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jax_llama.loss_fn)(params, jnp.asarray(tokens), jcfg)
    loss = llama.loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        rep = verify_results(ref[name], p.grad, atol=1e-5, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"
