"""ALiBi through the port's paged decode, model and server on the CPU
paths, against the JAX package on the same numpy inputs: the paged kernel
in interpret mode (and the paged plain version against the dense one, bit
for bit), an ALiBi model's forward (RoPE off, ALiBi on) against JAX
llama.forward on the same parameters, the model's decode path against its
training forward, and a small ALiBi server against generate; mirrors
tests/test_alibi.py with tests/test_torch_alibi.py.

Tolerances: paged decode in float32 atol 2e-5, rtol 1e-5, with int8 and
fp8 caches atol 2e-3, rtol 1e-3 (tests/test_torch_softcap_decode.py's);
the model's logits atol 1e-4, rtol 1e-4 (tests/test_torch_model.py's);
teacher-forced decode against the training forward atol 2e-4, rtol 2e-4
(tests/test_alibi.py's); the server's tokens equal generate's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import decode, paged
from flashattn_tpu_torch.utils.verify import verify_results
from tests.test_torch_alibi import DEC_TOL, PAGE, call, filled, query

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
def test_alibi_paged_decode_matches_jax_and_dense(mode, t):
    """Through the table (pages in reversed order), with a window and sinks
    beside ALiBi; the paged plain version equals the dense one bit for bit
    (an int8 pool requantizes P per page in both packages)."""
    _, jp, pd, pp = filled(mode, seed=30 + t, pools=True)
    jq, tq = query(mode, t, seed=40 + t)
    kw = dict(window=48, sink=4, alibi=True)
    ref = call((jax_paged.paged_decode_attention, jax_paged.paged_decode_attention_chunk),
               jq, jp, t, **kw)
    out = call((paged.paged_decode_attention, paged.paged_decode_attention_chunk), tq, pp, t,
               **kw)
    dense = decode.decode_attention_reference(tq, pd, requant_block=PAGE, **kw)
    assert torch.equal(out, dense)
    rep = verify_results(np.asarray(ref), out, **DEC_TOL[mode])
    assert rep.passed, rep


CFG_KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256, use_alibi=True)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(dtype=jnp.float32, **CFG_KW)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    model = llama.Llama(ModelConfig(dtype=torch.float32, **CFG_KW), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def test_alibi_model_forward_matches_jax(models):
    """The training forward of an ALiBi model (RoPE off, ALiBi on) against
    JAX llama.forward on the same parameters."""
    jcfg, params, model = models
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 40), dtype=np.int32)
    ref = jax_llama.forward(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        out = llama.forward(model, torch.from_numpy(tokens))
    rep = verify_results(np.asarray(ref), out, atol=1e-4, rtol=1e-4)
    assert rep.passed, rep
    assert llama.rope_tables(model.cfg, torch.arange(4)) == (None, None)


def test_alibi_model_train_decode_agree(models):
    """cfg.use_alibi threads through the training forward AND the decode
    path: teacher-forced logits agree position by position."""
    _, _, model = models
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        train_logits = llama.forward(model, tokens)
    caches = generate.init_caches(model, 1, 128)
    logits, caches = generate.prefill(model, tokens[:, :1], caches)
    np.testing.assert_allclose(logits.numpy(), train_logits[:, 0].numpy(), rtol=2e-4, atol=2e-4)
    for t in range(1, 48):
        logits, caches = generate.decode_step(model, tokens[:, t],
                                              torch.full((1,), t, dtype=torch.int32), caches)
        np.testing.assert_allclose(logits.numpy(), train_logits[:, t].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"position {t}")
    # the chunked path (chunk_step, K2 at T 16) agrees too
    caches = generate.init_caches(model, 1, 128)
    _, caches = generate.prefill(model, tokens[:, :16], caches)
    chunk, _ = generate.chunk_step(model, tokens[:, 16:32], torch.arange(16, 32), caches)
    np.testing.assert_allclose(chunk[0].numpy(), train_logits[0, 16:32].numpy(), rtol=2e-4,
                               atol=2e-4)


REQS = [(1, [3, 1, 4, 1, 5], 6), (2, [2, 7], 9), (3, list(range(40)), 4), (4, [9], 7)]


@pytest.mark.parametrize("option", [
    dict(), dict(paged=True, page_size=128, num_pages=5), dict(admit_chunk=16),
])
def test_alibi_server_matches_generate(models, option):
    """A small ALiBi server (dense, paged with backpressure, chunked
    admission) gives each request generate's tokens."""
    _, _, model = models
    srv = InferenceServer(model, max_slots=2, max_len=256, **option)
    for uid, prompt, n in REQS:
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    got = srv.run()
    for uid, prompt, n in REQS:
        want = generate.generate(model, torch.tensor([prompt]), max_new_tokens=n, max_len=256)
        assert got[uid] == want[0].tolist(), uid
