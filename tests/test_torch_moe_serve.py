"""The port's InferenceServer on mixture-of-experts models (the grouped
dispatch in every layer; the plain kernels on the CPU) against the JAX
package's server, on tests/test_torch_moe_model.py's two models and
weights: dense, paged (pages of 128) and int8-KV paged, both paged ones
with chunked admission; greedy tokens equal to the JAX server's of the
same options, and the paged server's (a float32 pool) equal to the dense
one's."""

import pytest
import torch

from flashattn_tpu.models import serve as jax_serve
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from tests.test_torch_moe_model import moe_models  # noqa: F401 (the fixture)

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

REQS = [  # (uid, prompt, new tokens): slots recycling, a prompt past a page
    (1, [(3 + 5 * i) % 256 for i in range(41)], 5),
    (2, [2, 7, 1], 6),
    (3, [(7 * i) % 256 for i in range(150)], 4),
]
OPTIONS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=128, admit_chunk=32),
    "int8_kv_paged": dict(quant="int8", paged=True, page_size=128, admit_chunk=32),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_moe_server_matches_jax(moe_models, name):
    _, jcfg, params, model = moe_models
    option = OPTIONS[name]
    jsrv = jax_serve.InferenceServer(params, jcfg, max_slots=2, max_len=256, **option)
    srv = InferenceServer(model, max_slots=2, max_len=256, **option)
    for uid, prompt, n in REQS:
        jsrv.submit(jax_serve.Request(uid=uid, prompt=prompt, max_new_tokens=n))
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    got = srv.run()
    assert got == jsrv.run() and sorted(got) == [1, 2, 3]
    if srv.paged:
        assert srv.allocator.free_pages == srv.allocator.num_pages
    if name == "paged":  # a float32 pool: the dense server's tokens
        dense = InferenceServer(model, max_slots=2, max_len=256)
        for uid, prompt, n in REQS:
            dense.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        assert dense.run() == got
