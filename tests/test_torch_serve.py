"""The port's continuous-batching server against the JAX package's, on the
same weights and requests (tests/test_serve.py's config and traffic: 4
requests on 2 slots, so slots recycle mid-flight), with each of the server's
options: the paged pool with backpressure, prefix caching, chunked
admission (dense and paged), int8/fp8 KV caches, int8/int4 weights and
logprobs. float32 model; greedy tokens must be equal, to the JAX server's
and to the port's own isolated generate(); logprobs within atol 1e-5 of the
JAX server's (float32 logits summed in another order)."""

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

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

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


def isolated(model, prompt, n, quant=None):
    out = generate.generate(model, torch.tensor([prompt]), max_new_tokens=n,
                            max_len=512, quant=quant)
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


CHUNK_REQS = [
    (1, [(3 + i) % 120 for i in range(197)], 5),  # long: many chunks
    (2, [2, 7], 6),  # shorter than one chunk
    (3, list(range(60)), 4),
]
# Each option of the JAX server with the traffic of its test in
# tests/test_serve.py; the paged pools are too small for every request at
# once (admission backpressure).
OPTIONS = {
    "paged": (dict(paged=True, page_size=128, num_pages=5), REQS),
    "quant_int8": (dict(quant="int8"), REQS),
    "admit_chunk": (dict(admit_chunk=64), CHUNK_REQS),
    "admit_chunk_paged_fp8": (dict(admit_chunk=64, paged=True, page_size=128, num_pages=4,
                                   quant="fp8"), CHUNK_REQS),
    "return_logprobs": (dict(return_logprobs=True, paged=True, page_size=128), REQS),
}


def run_pair(jcfg, params, model, option, reqs, prefix=None):
    """The JAX and the port server on the same requests; returns both
    servers and their outputs."""
    jsrv = jax_serve.InferenceServer(params, jcfg, max_slots=2, max_len=512, **option)
    srv = InferenceServer(model, max_slots=2, max_len=512, **option)
    jpid = pid = None
    if prefix is not None:
        jpid, pid = jsrv.register_prefix(prefix), srv.register_prefix(prefix)
    for uid, prompt, n in reqs:
        with_prefix = prefix is not None and prompt[:len(prefix)] == prefix
        jsrv.submit(jax_serve.Request(uid=uid, prompt=prompt, max_new_tokens=n,
                                      prefix_id=jpid if with_prefix else None))
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n,
                           prefix_id=pid if with_prefix else None))
    return jsrv, srv, jsrv.run(), srv.run()


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_server_option_matches_jax_server_and_generate(models, name):
    jcfg, params, model = models
    option, reqs = OPTIONS[name]
    jsrv, srv, want, got = run_pair(jcfg, params, model, option, reqs)
    assert got == want
    for uid, prompt, n in reqs:
        assert got[uid] == isolated(model, prompt, n, option.get("quant")), uid
    if option.get("paged"):
        assert srv.allocator.free_pages == jsrv.allocator.free_pages == srv.allocator.num_pages
    if option.get("return_logprobs"):
        assert set(srv.finished_logprobs) == {uid for uid, _, _ in reqs}
        for uid, _, n in reqs:
            lp = srv.finished_logprobs[uid]
            assert len(lp) == n and all(x <= 0.0 for x in lp)
            np.testing.assert_allclose(lp, jsrv.finished_logprobs[uid], atol=1e-5, rtol=0)
    st = srv.stats()
    assert st["admitted"] == len(reqs) and st["active_slots"] == 0 and st["queued"] == 0


def test_prefix_caching_matches_jax_server(models):
    """tests/test_serve.py's prefix test: three requests share a 256-token
    prefix (2 pages of 128), prefilled once; the pool could not hold a copy
    per request. Page counts as in the JAX test (its tokens taken modulo the
    vocabulary: the port's embedding refuses ids past it)."""
    jcfg, params, model = models
    prefix = [(40 + i) % 128 for i in range(256)]
    reqs = [(1, prefix + [7, 8, 9], 5), (2, prefix + [3], 6), (3, prefix + list(range(30)), 4)]
    option = dict(paged=True, page_size=128, num_pages=2 + 2 * 3, return_logprobs=True)
    jsrv, srv, want, got = run_pair(jcfg, params, model, option, reqs, prefix=prefix)
    assert got == want
    for uid, prompt, n in reqs:
        assert got[uid] == isolated(model, prompt, n), uid
        np.testing.assert_allclose(srv.finished_logprobs[uid], jsrv.finished_logprobs[uid],
                                   atol=1e-5, rtol=0)
    st = srv.stats()
    assert st["prefix_pages"] == 2 and st["pages_used"] == 2
    assert srv.allocator.free_pages == 6
    srv.unregister_prefix(0)
    assert srv.allocator.free_pages == 8 and srv.stats()["prefix_pages"] == 0


def test_chunked_admission_with_prefix_and_plain_requests(models):
    """Chunked admission streams from the shared boundary; a plain request
    shares the batch."""
    jcfg, params, model = models
    prefix = [(20 + i) % 128 for i in range(128)]
    reqs = [(1, prefix + list(range(70)), 5), (2, [9, 8, 7], 5)]
    option = dict(paged=True, page_size=128, num_pages=8, admit_chunk=64)
    jsrv, srv, want, got = run_pair(jcfg, params, model, option, reqs, prefix=prefix)
    assert got == want
    for uid, prompt, n in reqs:
        assert got[uid] == isolated(model, prompt, n), uid
    assert srv.allocator.free_pages == 7  # only the registry's page is held


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_and_int4_weights_match_jax_server(models, bits):
    jcfg, params, model = models
    qparams = jax_llama.quantize_params(params, bits)
    qmodel = llama.quantize_params(llama.Llama(model.cfg, device="cpu"), bits)
    qmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, qparams)))
    option = dict(paged=True, page_size=128, quant="int8")
    reqs = REQS[::2]
    _, _, want, got = run_pair(jcfg, qparams, qmodel, option, reqs)
    assert got == want
    for uid, prompt, n in reqs:
        assert got[uid] == isolated(qmodel, prompt, n, "int8"), uid


def test_requests_that_cannot_fit_raise(models):
    _, _, model = models
    dense = InferenceServer(model, max_slots=1, max_len=512)
    with pytest.raises(ValueError, match="max_len"):
        dense.submit(Request(uid=1, prompt=[1] * 500, max_new_tokens=13))
    with pytest.raises(ValueError, match="paged"):
        dense.submit(Request(uid=2, prompt=[1], max_new_tokens=1, prefix_id=0))
    with pytest.raises(ValueError, match="paged"):
        dense.register_prefix(list(range(128)))
    pool = InferenceServer(model, max_slots=2, max_len=512, paged=True, page_size=128,
                           num_pages=3)
    with pytest.raises(ValueError, match="could never be admitted"):
        pool.submit(Request(uid=3, prompt=[1] * 400, max_new_tokens=10))  # 4 pages
    pid = pool.register_prefix([i % 128 for i in range(256)])  # holds 2 of the 3 pages
    with pytest.raises(ValueError, match="registered prefix"):
        pool.submit(Request(uid=4, prompt=[5] * 300, max_new_tokens=4, prefix_id=pid))
    pool.submit(Request(uid=5, prompt=[1] * 200, max_new_tokens=10))  # 2 pages: waits forever
    with pytest.raises(RuntimeError, match="can ever be free"):
        pool.run()
    pool.unregister_prefix(pid)
    assert pool.run()[5] == isolated(model, [1] * 200, 10)


def test_warmup_leaves_no_state(models):
    _, _, model = models
    srv = InferenceServer(model, max_slots=2, max_len=512)
    srv.warmup()
    assert all(int(c.length.abs().sum()) == 0 for c in srv.caches)
    srv.submit(Request(uid=1, prompt=[3, 1, 4, 1, 5], max_new_tokens=6))
    assert srv.run()[1] == isolated(model, [3, 1, 4, 1, 5], 6)
