"""The port's continuous-batching server against the JAX package's, on the
same weights and requests (tests/test_serve.py's config and traffic: 4
requests on 2 slots, so slots recycle mid-flight). float32 model; greedy
tokens must be equal, to the JAX server's and to the port's own isolated
generate()."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import serve as jax_serve
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.models.sampling import SamplingParams
from flashattn_tpu_torch.models.serve import InferenceServer, Request

CFG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
              max_seq_len=512)
REQS = [
    (1, [3, 1, 4, 1, 5], 6),
    (2, [2, 7], 9),
    (3, list(range(20)), 4),
    (4, [99], 7),
]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(dtype=jnp.float32, **CFG_KW)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    model = llama.Llama(ModelConfig(dtype=torch.float32, **CFG_KW), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def isolated(model, prompt, n):
    out = generate.generate(model, torch.tensor([prompt]), max_new_tokens=n,
                            max_len=512)
    return out[0].tolist()


def test_server_matches_jax_server_and_generate(models):
    jcfg, params, model = models
    jsrv = jax_serve.InferenceServer(params, jcfg, max_slots=2, max_len=512)
    srv = InferenceServer(model, max_slots=2, max_len=512)
    for uid, prompt, n in REQS:
        jsrv.submit(jax_serve.Request(uid=uid, prompt=prompt, max_new_tokens=n))
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    want = jsrv.run()
    got = srv.run()
    assert got == want
    for uid, prompt, n in REQS:
        assert got[uid] == isolated(model, prompt, n), uid
    st = srv.stats()
    assert st["admitted"] == 4 and st["active_slots"] == 0 and st["queued"] == 0
    assert st["decode_steps"] > 0 and st["wall_tokens_per_s"] > 0


def test_eos_frees_slot_early(models):
    _, _, model = models
    prompt = [5, 9, 42, 7]
    full = isolated(model, prompt, 8)
    eos = full[2]
    srv = InferenceServer(model, max_slots=1, max_len=512)
    srv.submit(Request(uid=1, prompt=prompt, max_new_tokens=8, eos_token=eos))
    srv.submit(Request(uid=2, prompt=[11, 13], max_new_tokens=3))
    got = srv.run()
    assert got[1] == full[:full.index(eos) + 1] and got[1][-1] == eos
    assert got[2] == isolated(model, [11, 13], 3)


def test_sampled_request_reproducible_across_batches(models):
    """A sampled request's tokens depend on (seed, uid, position), not on the
    batch it shares or the slot it lands in."""
    _, _, model = models
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    alone = InferenceServer(model, max_slots=1, max_len=512, seed=3)
    alone.submit(Request(uid=7, prompt=[1, 2, 3], max_new_tokens=6, sampling=sp))
    busy = InferenceServer(model, max_slots=2, max_len=512, seed=3)
    busy.submit(Request(uid=1, prompt=[9, 9], max_new_tokens=9))
    busy.submit(Request(uid=7, prompt=[1, 2, 3], max_new_tokens=6, sampling=sp))
    a, b = alone.run(), busy.run()
    assert a[7] == b[7] and len(a[7]) == 6
    assert all(0 <= t < CFG_KW["vocab_size"] for t in a[7])


@pytest.mark.parametrize("option", [
    dict(paged=True), dict(quant="int8"), dict(admit_chunk=64),
    dict(return_logprobs=True),
])
def test_unported_server_options_raise(models, option):
    _, _, model = models
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        InferenceServer(model, max_slots=1, max_len=512, **option)


def test_prefix_requests_raise(models):
    _, _, model = models
    srv = InferenceServer(model, max_slots=1, max_len=512)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        srv.register_prefix(list(range(128)))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        srv.submit(Request(uid=1, prompt=[1], max_new_tokens=1, prefix_id=0))
    with pytest.raises(ValueError):
        srv.submit(Request(uid=2, prompt=[1] * 500, max_new_tokens=13))


def test_warmup_leaves_no_state(models):
    _, _, model = models
    srv = InferenceServer(model, max_slots=2, max_len=512)
    srv.warmup()
    assert all(int(c.length.abs().sum()) == 0 for c in srv.caches)
    srv.submit(Request(uid=1, prompt=[3, 1, 4, 1, 5], max_new_tokens=6))
    assert srv.run()[1] == isolated(model, [3, 1, 4, 1, 5], 6)
